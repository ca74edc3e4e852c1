"""PyTorch + CUDA port of the decentralized autoregressive serving stack.

``repro_torch`` mirrors ``repro``'s module layout (``repro_torch.models.
attention`` is the counterpart of ``repro.models.attention`` and so on) and
keeps its public names and einsum layouts, so each part can be held against
the JAX reference on the same inputs and weights. It imports neither JAX
nor anything of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
CUDA request on a machine without a card raises. The Pallas kernels of the
reference are CUDA C++ kernels here (``repro_torch.kernels``), dispatched
on the device of the tensors they are given.
"""
