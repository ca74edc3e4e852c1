"""Device meshes (port of ``repro.launch.mesh``).

Single pod : 256 devices as (16, 16) over ("data", "model").
Multi-pod  : 2 pods = 512 devices as (2, 16, 16) over ("pod", "data",
             "model"), pod-major: rank r is in pod r // 256.

Functions only: importing this module creates no process group and no mesh.
The caller starts ``torch.distributed`` first (the dry run with the fake
backend at world 256 or 512, a card with NCCL at world 1, the tests with
gloo).
"""
from __future__ import annotations

import math
from typing import Sequence

POD_SIZE = 256


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda"):
    """``init_device_mesh`` of ``shape`` over ``names`` on the started
    process group's first ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks, the process group has "
            f"{world} — start torch.distributed at world size {n} first "
            f"(the dry run starts the fake backend: see launch/dryrun.py)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device_type)


def pod_of_device(device_id: int, *, multi_pod: bool) -> int:
    """Rank → pod index under the mesh layouts above (pod-major)."""
    return device_id // POD_SIZE if multi_pod else 0
