"""The comparison that decides ``correct``: each number compared, beside
its limit (``bench/checks/<workload>.json``, where the readings each limit
was set from are kept too).

Training cells compare the program's first ``check_steps`` steps with the
reference's: ``loss``, the largest relative gap of a step's loss;
``grad``, the worst leaf's gap between the norms of the first step's
gradient as each optimizer takes it (after clipping); ``change``, the
worst leaf's gap between the norms of the parameters' change over those
steps. A leaf's gap is |program − reference| over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of ``change``.

Serving cells compare served tokens: ``gap``, the widest gap by which a
served token's reference logit lies below the reference's best at its
position."""
from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Optional

QUIET_GRAD = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             only: Optional[List[str]] = None) -> float:
    paths = sorted(ref) if only is None else only
    med = statistics.median(ref[p] for p in sorted(ref))
    return max(abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
               for p in paths)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"loss": [per step], "grad": {leaf: norm}, "change":
    {leaf: norm}}."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    med = statistics.median(ref["grad"].values())
    moving = [p for p in sorted(ref["grad"])
              if ref["grad"][p] >= QUIET_GRAD * med]
    return {"loss": loss, "grad": leaf_gap(prog["grad"], ref["grad"]),
            "change": leaf_gap(prog["change"], ref["change"], moving)}


def load_limits(path: Path) -> Dict[str, float]:
    return json.loads(path.read_text())["limits"]


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: correct where each is finite and within it. A number the limits
    file gives no limit is read but not compared (``PERF.md`` says why)."""
    table = {n: {"value": numbers[n], "limit": lim}
             for n, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in table.values())
    return ok, table
