"""CUDA kernels of the port (``csrc/``), their plain PyTorch versions and
the device-dispatching seam ``ops``. Nothing is built on import: a kernel
is compiled by ``build`` the first time a CUDA tensor reaches it."""
