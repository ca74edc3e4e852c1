"""Host-side analysis tools of the port: the paged pool's sanitizer
(``sanitizer``) and repro-lint retargeted to torch (``lint``, rules
host-sync and retrace-hazard; ``python -m repro_torch.analysis <paths>``).
"""
