"""A copy of the benchmark at smoke size for the CPU tests: ``make(tmp)``
copies ``bench/`` and ``BENCHMARK.json`` under ``tmp``, links ``src``,
and rewrites each configuration and mix there in place at a size a test
run holds (same keys, small widths, two layers, short prompts and
sequences)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL_CONFIG = {
    "qwen3": {"hidden_size": 64, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16,
              "intermediate_size": 128, "vocab_size": 512,
              "num_hidden_layers": 2},
}
SMALL_MIX = {
    "train": {"seq_len": 64, "trace_seconds": 1},
    "serve": {"prompt_tokens": {"min": 16, "max": 48, "levels": 4},
              "new_tokens": 4, "fill_steps": 4, "trace_seconds": 1,
              "clients": 4,
              "check": {"requests": 3}},
}
SMALL_DEPLOYMENT = {"slots": 2, "cache_len": 56, "page_block": 8,
                    "chunk": 16}


def make(tmp: Path) -> Path:
    root = Path(tmp) / "root"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(ROOT / "src")
    for f in (root / "bench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(SMALL_CONFIG[cfg["model_type"]])
        f.write_text(json.dumps(cfg, indent=1))
    for f in (root / "bench" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update(SMALL_MIX[mix["kind"]])
        if "deployment" in mix:
            mix["deployment"].update(SMALL_DEPLOYMENT)
        f.write_text(json.dumps(mix, indent=1))
    return root
