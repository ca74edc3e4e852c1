"""The traced run's view into the program's kernel entry points: each
entry point named by a loaded per-layer metric (its ``OPS``) is wrapped,
at run time and from the benchmark's own files, in a profiler range
``bench.op.<name>`` and a record of the call's arguments (tensor shapes
and dtypes, plain numbers, and the values of small integer tensors such as
decode positions). Nothing is wrapped in an untraced run."""
from __future__ import annotations

from typing import Dict, List

import torch

RANGE = "bench.op."
SMALL = 1024          # integer tensors up to this size keep their values


class Probe:
    def __init__(self, module, names):
        self.module, self.names = module, sorted(set(names))
        self.calls: Dict[str, List[dict]] = {n: [] for n in self.names}
        self.active = False
        self._orig = {}
        self._snap = {}

    def _summary(self, x):
        if not isinstance(x, torch.Tensor):
            return x if isinstance(x, (int, float, bool, str, type(None))) \
                else repr(type(x))
        out = {"shape": tuple(x.shape), "dtype": str(x.dtype)}
        if not x.is_floating_point() and x.numel() <= SMALL:
            key = (x.data_ptr(), x._version, tuple(x.shape))
            if key not in self._snap:
                self._snap[key] = x.detach().clone()
            out["values"] = self._snap[key]
        return out

    def _wrap(self, name, fn):
        def probed(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            self.calls[name].append({
                "args": [self._summary(a) for a in args],
                "kwargs": {k: self._summary(v) for k, v in kwargs.items()}})
            with torch.profiler.record_function(RANGE + name):
                return fn(*args, **kwargs)
        return probed

    def install(self) -> None:
        for n in self.names:
            self._orig[n] = getattr(self.module, n)
            setattr(self.module, n, self._wrap(n, self._orig[n]))

    def remove(self) -> None:
        for n, fn in self._orig.items():
            setattr(self.module, n, fn)
        self._orig = {}

    def finish(self) -> None:
        """Bring every kept integer tensor to the host, as a list."""
        for calls in self.calls.values():
            for c in calls:
                for a in list(c["args"]) + list(c["kwargs"].values()):
                    if isinstance(a, dict) and "values" in a and \
                            isinstance(a["values"], torch.Tensor):
                        a["values"] = a["values"].reshape(-1).tolist()
        self._snap = {}


def install(ops) -> Probe:
    """A probe over the program's kernel seam, installed (inactive)."""
    from bench.lib import program
    p = Probe(program.kernel_ops(), ops)
    p.install()
    return p


def profiler(device) -> torch.profiler.profile:
    """The traced window's profiler: host ranges, and the card's kernels
    where the run has one."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def warm_profiler(device, work) -> None:
    """Start and stop a profiler once around ``work()``, in set-up: the
    first start initialises the device tracer (seconds on the card), which
    must not land in the traced window."""
    prof = profiler(device)
    prof.start()
    work()
    prof.stop()
