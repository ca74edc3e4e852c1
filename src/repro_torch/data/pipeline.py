"""Sharded host data pipeline (port of ``repro.data.pipeline``, numpy
only: the same batches from the same corpus and shards).

Each decentralized expert consumes ONLY its own shard (zero data exchange —
the paper's training-isolation property). Within an expert, batches are
sliced per host process (every process materializes only its slice).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from .synthetic import SyntheticMultimodal


@dataclass
class LoaderConfig:
    batch_size: int = 32
    process_index: int = 0
    process_count: int = 1


class ShardLoader:
    """Infinite iterator over one expert's data shard."""

    def __init__(self, dataset: SyntheticMultimodal, cfg: LoaderConfig,
                 subset: Optional[np.ndarray] = None, offset: int = 0):
        if cfg.batch_size % cfg.process_count:
            raise ValueError(f"batch_size {cfg.batch_size} is not a "
                             f"multiple of process_count "
                             f"{cfg.process_count}")
        self.dataset, self.cfg, self.subset = dataset, cfg, subset
        self.offset = offset                       # step-space offset per expert
        self._step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        batch = self.dataset.sample_batch(cfg.batch_size,
                                          self._step + self.offset,
                                          self.subset)
        self._step += 1
        if cfg.process_count > 1:                  # per-host slice
            per = cfg.batch_size // cfg.process_count
            lo = cfg.process_index * per
            batch = {k: v[lo:lo + per] for k, v in batch.items()}
        return batch


def expert_loaders(dataset: SyntheticMultimodal, shards, batch_size: int,
                   process_index: int = 0, process_count: int = 1):
    """One isolated loader per decentralized expert."""
    cfg = LoaderConfig(batch_size, process_index, process_count)
    return [ShardLoader(dataset, cfg, subset=s, offset=10_000 * k)
            for k, s in enumerate(shards)]
