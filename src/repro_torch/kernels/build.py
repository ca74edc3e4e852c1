"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Builds
happen at first use, from the sources in the checkout only, into
``build/kernels/`` at the repository root (listed in ``.gitignore``). A
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and a stale
library is never loaded. ``build_all``
starts one ``nvcc`` per source together and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("decode_attention", "flash_attention", "router_scores",
           "chunk_scan", "flash_attention_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}


def build_dir() -> Path:
    """``build/kernels`` under the repository root (src/repro_torch/kernels
    → three levels up)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> Dict[str, Path]:
    """Compile every library that is not built yet, one ``nvcc`` per source,
    all started together. Raises with the compiler's output on failure.
    The compiler's output, with its resource report (``-Xptxas -v``), goes
    to ``build/kernels/<name>.log``; each compiled source's wall seconds to
    ``build_seconds``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    start = time.perf_counter()
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.parent / f"{so.stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(out_dir / f"{name}.log", "w") as log:
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT), tmp)
    failed = []
    while procs:
        time.sleep(0.05)
        for name, (proc, tmp) in list(procs.items()):
            if proc.poll() is None:
                continue
            del procs[name]
            build_seconds[name] = time.perf_counter() - start
            if proc.returncode != 0:
                log = (out_dir / f"{name}.log").read_text()
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, targets[name])  # atomic: readers see whole files
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with every C
    entry point's ``argtypes``/``restype`` declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all((name,))[name]
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "decode_attention":
        lib.paged_decode_attention.argtypes = [P] * 7 + [I] * 11 + [F, P]
        lib.paged_decode_attention.restype = I
        lib.chunk_prefill_attention.argtypes = [P] * 5 + [I] * 10 + [F, P]
        lib.chunk_prefill_attention.restype = I
        lib.decode_attention.argtypes = [P] * 6 + [I] * 9 + [F, P]
        lib.decode_attention.restype = I
        lib.paged_verify_attention.argtypes = [P] * 7 + [I] * 11 + [F, P]
        lib.paged_verify_attention.restype = I
    elif name == "flash_attention":
        lib.flash_attention.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I,
                                        I, F, P]
        lib.flash_attention.restype = I
    elif name == "flash_attention_bwd":
        lib.flash_attention_bwd.argtypes = [P] * 9 + [I] * 8 + [F, P]
        lib.flash_attention_bwd.restype = I
    elif name == "router_scores":
        lib.router_scores.argtypes = [P, P, P] + [I] * 8 + [F, P]
        lib.router_scores.restype = I
    elif name == "chunk_scan":
        lib.chunk_scan.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
        lib.chunk_scan.restype = I
        lib.chunk_scan_sm90.argtypes = [P] * 6 + [I] * 6 + [P]
        lib.chunk_scan_sm90.restype = I
        lib.chunk_scan_smem_bytes.argtypes = [I, I]
        lib.chunk_scan_smem_bytes.restype = ctypes.c_longlong
    lib.kernel_error_string.argtypes = [I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
