"""Dataset partitioning (paper §5.1): balanced spherical k-means on frozen
encoder features → K disjoint shards; centroids become the router (port
of ``repro.data.partition``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.core.clustering import (ClusterResult,
                                         spherical_balanced_kmeans,
                                         two_stage_balanced_kmeans)
from repro_torch.core.router import (CentroidRouter, RouterConfig,
                                     router_from_clustering)


@dataclass
class Partition:
    shards: List[np.ndarray]        # sample indices per expert
    clustering: ClusterResult
    router: CentroidRouter

    @property
    def K(self) -> int:
        return len(self.shards)


def partition_dataset(features: np.ndarray, K: int, *,
                      algorithm: str = "balanced",
                      router_config: RouterConfig = RouterConfig(),
                      seed: int = 0) -> Partition:
    """algorithm: 'balanced' (paper main) | 'two_stage' (Table 9 ablation)."""
    if algorithm == "balanced":
        res = spherical_balanced_kmeans(features, K, seed=seed)
    elif algorithm == "two_stage":
        res = two_stage_balanced_kmeans(features, K, seed=seed)
    else:
        raise ValueError(algorithm)
    shards = [np.where(res.assignment == k)[0] for k in range(K)]
    return Partition(shards=shards, clustering=res,
                     router=router_from_clustering(res.centroids,
                                                   router_config))
