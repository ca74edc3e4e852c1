"""``BENCHMARK.json``: reading it, checking it against the benchmark's
contract, and finding each entry's files by name: a configuration's
``file``, a mix's ``bench/traffic/<traffic>.json``, a per-layer metric's
reader ``bench/metrics/<name>.py`` and a cell's limits
``bench/checks/<workload>.json``. Adding a cell, a mix or a metric is
adding those files and entries; nothing here names one."""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
WIDTHS = re.compile(r"(hidden_size|intermediate_size|latent|state|proj|"
                    r"head_size|expan|_dim$|_rank$|experts_per_tok)")


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.doc["paths"][0]

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.doc["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def metric_file(self, name: str) -> Path:
        return self.bench / "metrics" / f"{name}.py"

    def limits_file(self, workload: str) -> Path:
        return self.bench / "checks" / f"{workload}.json"

    def metrics_of(self, kind: str, workload: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
        return [m for m in self.doc[kind]
                if workload in m.get("workloads", [workload])]


def problems(root: Path) -> List[str]:
    """Every way ``BENCHMARK.json`` and the files it names break the
    contract (empty when it keeps it)."""
    out: List[str] = []
    raw = (Path(root) / "BENCHMARK.json").read_bytes()
    if len(raw) > 64 * 1024:
        out.append("BENCHMARK.json is over 64 KiB")
    doc = json.loads(raw)
    if set(doc) != TOP:
        out.append(f"top-level keys {sorted(doc)}")
        return out
    m = Manifest(root)

    def name_ok(n, what):
        if not isinstance(n, str) or not NAME.match(n):
            out.append(f"{what} {n!r} is not a valid name")

    def line_ok(s, what):
        if not isinstance(s, str) or not 1 <= len(s) <= 200 or \
                "\n" in s or "\t" in s:
            out.append(f"{what} {s!r} is not one line of 1-200 characters")

    if not 1 <= len(doc["paths"]) <= 16:
        out.append("paths: 1 to 16 directories")
    for p in doc["paths"]:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r}")
    if not 1 <= len(doc["command"]) <= 32:
        out.append("command: 1 to 32 words")
    for w in doc["command"]:
        line_ok(w, "command word")
    rs = doc["run_seconds"]
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        out.append(f"run_seconds {rs!r}")
    configs: Dict[str, dict] = {}
    for c in doc["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config keys {sorted(c)}")
            continue
        name_ok(c["name"], "config")
        line_ok(c["source"], "source")
        line_ok(c["why"], "why")
        if c["name"] in configs:
            out.append(f"config {c['name']} twice")
        configs[c["name"]] = c
        if not any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in doc["paths"]):
            out.append(f"config file {c['file']} outside paths")
        elif not (m.root / c["file"]).is_file():
            out.append(f"config file {c['file']} missing")
        if len(c["reduced"]) > 16:
            out.append(f"{c['name']}: over 16 reduced keys")
        for k in c["reduced"]:
            name_ok(k, "reduced key")
            if WIDTHS.search(k):
                out.append(f"{c['name']}: reduced names a width {k!r}")
    if len({c["file"] for c in configs.values()}) != len(configs):
        out.append("two configurations share a file")
    cells = set()
    pairs = set()
    for w in doc["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload keys {sorted(w)}")
            continue
        for k in ("name", "config", "traffic"):
            name_ok(w[k], f"workload {k}")
        line_ok(w["why"], "why")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']}")
        if w["name"] in cells or (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']} repeats")
        cells.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        if not (m.bench / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"{w['name']}: no traffic file for {w['traffic']}")
        if not m.limits_file(w["name"]).is_file():
            out.append(f"{w['name']}: no limits file")
    used = {w["config"] for w in doc["workloads"]}
    for c in configs:
        if c not in used:
            out.append(f"config {c} is used by no cell")
    four = sum(w["chips"] == 4 for w in doc["workloads"])
    if four > max(len(doc["workloads"]) // 4, 1):
        out.append("too many four-chip cells")
    names = set()
    e2e = {}
    for kind in ("end_to_end", "per_layer"):
        n = len(doc[kind])
        if not (1 <= n <= (16 if kind == "end_to_end" else 128)):
            out.append(f"{kind}: {n} metrics")
        for x in doc[kind]:
            want = {"name", "unit", "better", "source"} | (
                {"bound"} if kind == "end_to_end" else {"layer", "moves"})
            extra = set(x) - want - {"workloads"}
            if set(x) - {"workloads"} != want:
                out.append(f"{kind} {x.get('name')}: keys {sorted(x)} "
                           f"{sorted(extra)}")
                continue
            name_ok(x["name"], "metric")
            if x["name"] in names:
                out.append(f"metric {x['name']} twice")
            names.add(x["name"])
            if not UNIT.match(x["unit"]):
                out.append(f"{x['name']}: unit {x['unit']!r}")
            if x["better"] not in ("lower", "higher"):
                out.append(f"{x['name']}: better {x['better']!r}")
            ok = SOURCES_E2E if kind == "end_to_end" else SOURCES
            if x["source"] not in ok:
                out.append(f"{x['name']}: source {x['source']}")
            for c in x.get("workloads", []):
                if c not in cells:
                    out.append(f"{x['name']}: unknown workload {c}")
            if kind == "end_to_end":
                b = x["bound"]
                if not (0.01 <= b <= 0.25):
                    out.append(f"{x['name']}: bound {b}")
                e2e[x["name"]] = x
            else:
                line_ok(x["layer"], "layer")
                if not m.metric_file(x["name"]).is_file():
                    out.append(f"{x['name']}: no reader file")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for x in doc["per_layer"]:
        if "moves" not in x:
            continue
        if x["moves"] not in e2e:
            out.append(f"{x['name']}: moves unknown {x['moves']}")
            continue
        for c in x.get("workloads", sorted(cells)):
            if c not in e2e[x["moves"]].get("workloads", [c]):
                out.append(f"{x['name']}: {c} does not report "
                           f"{x['moves']}")
    for c in cells:
        e = m.metrics_of("end_to_end", c)
        if len([x for x in e if x["name"] != "setup_s"]) < 1:
            out.append(f"{c}: no end-to-end metric besides setup_s")
        if not m.metrics_of("per_layer", c):
            out.append(f"{c}: no per-layer metric")
    layers: Dict[str, str] = {}
    for x in doc["per_layer"]:
        layers.setdefault(x["layer"].lower(), x["layer"])
        if layers[x["layer"].lower()] != x["layer"]:
            out.append(f"layer {x['layer']!r} spelled two ways")
    return out
