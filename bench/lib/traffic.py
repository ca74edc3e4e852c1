"""The one generator of every traffic mix: it reads a mix's parameters
(``bench/traffic/<mix>.json``) and makes its inputs from the run's seed.

Training mixes (``"kind": "train"``): step s's batch is ``batch`` rows of
``seq_len`` token ids drawn uniformly from the vocabulary by a generator of
(seed, s), so every row of every step differs.

Serving mixes (``"kind": "serve"``): request j has a prompt length, routing
features and prompt tokens. Lengths are ``levels`` evenly spaced values
from ``prompt_tokens.min`` to ``.max``; every run of ``levels`` consecutive
requests holds each value once, in an order drawn from the seed, so any
seed sends the same sizes in another order. Features lie around K
centroids drawn from the seed (``features.dim``; each feature is a
centroid plus normal noise of std ``features.spread``): request j's lies
near centroid j mod K, so the router's pods see equal shares. Prompt
tokens are uniform over the vocabulary. ``clients`` closed-loop clients
send them: client c sends requests c, c + n, c + 2n, ... of n clients,
each when its last completes, so with n a multiple of K a client's
requests all go to one expert, as a worker that queries one document
collection."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

# independent streams of one seed
TRAIN, CENTROIDS, ORDER, REQUEST, SAMPLE = range(5)


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def train_batch(mix: dict, seed: int, step: int, vocab: int) -> np.ndarray:
    """Step ``step``'s token rows, (batch, seq_len) int64."""
    return rng(seed, TRAIN, step).integers(
        0, vocab, (mix["batch"], mix["seq_len"]), dtype=np.int64)


def centroids(mix: dict, seed: int) -> np.ndarray:
    K = mix["deployment"]["experts"]
    return rng(seed, CENTROIDS).normal(
        size=(K, mix["features"]["dim"])).astype(np.float32)


@dataclass
class Request:
    index: int
    tokens: np.ndarray          # (prompt,) int32
    features: np.ndarray        # (dim,) float32
    near: int                   # the centroid its features were drawn by
    max_new: int


class Requests:
    """The seed's sequence of requests, request j made on first use."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        p = mix["prompt_tokens"]
        self.levels = np.linspace(p["min"], p["max"], p["levels"]) \
            .round().astype(int)
        self.centroids = centroids(mix, seed)

    def get(self, j: int) -> Request:
        n = len(self.levels)      # j's place in its block's seeded order
        length = int(self.levels[rng(self.seed, ORDER, 0, j // n)
                                 .permutation(n)[j % n]])
        near = j % len(self.centroids)
        r = rng(self.seed, REQUEST, j)
        feats = self.centroids[near] + self.mix["features"]["spread"] * \
            r.normal(size=self.centroids.shape[1])
        toks = r.integers(0, self.vocab, length).astype(np.int32)
        return Request(j, toks, feats.astype(np.float32), near,
                       self.mix["new_tokens"])


def sample(seed: int, population: List[int], n: int,
           keep: List[int]) -> List[int]:
    """``keep`` and n - len(keep) more of ``population``, drawn from the
    seed."""
    rest = [p for p in population if p not in keep]
    pick = rng(seed, SAMPLE).permutation(len(rest))[:max(n - len(keep), 0)]
    return sorted(set(keep) | {rest[i] for i in pick})
