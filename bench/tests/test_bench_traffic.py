"""The traffic generator: the same seed gives the same inputs, every seed
the same sizes in another order, and steps and requests that differ."""
from collections import Counter

import numpy as np

from bench.lib import traffic
from bench.lib.manifest import Manifest
from bench.tests.conftest import ROOT

BIG = 2 ** 31 + 987654321          # more than 32 signed bits


def _mixes():
    m = Manifest(ROOT)
    return m.traffic("train_4k"), m.traffic("docqa_c32")


def test_train_batches_are_deterministic_and_distinct():
    mix, _ = _mixes()
    a = traffic.train_batch(mix, BIG, 3, 151936)
    assert a.shape == (mix["batch"], mix["seq_len"])
    assert np.array_equal(a, traffic.train_batch(mix, BIG, 3, 151936))
    assert not np.array_equal(a, traffic.train_batch(mix, BIG, 4, 151936))
    assert not np.array_equal(a, traffic.train_batch(mix, BIG + 1, 3,
                                                     151936))
    assert a.min() >= 0 and a.max() < 151936


def test_requests_are_deterministic():
    _, mix = _mixes()
    r1, r2 = traffic.Requests(mix, BIG, 151936), traffic.Requests(
        mix, BIG, 151936)
    for j in (0, 5, 40):
        a, b = r1.get(j), r2.get(j)
        assert np.array_equal(a.tokens, b.tokens)
        assert np.array_equal(a.features, b.features)
    assert not np.array_equal(r1.get(0).tokens[:100],
                              traffic.Requests(mix, 7, 151936).get(0)
                              .tokens[:100])


def test_every_seed_sends_the_same_sizes_in_another_order():
    _, mix = _mixes()
    n = mix["prompt_tokens"]["levels"]
    sizes = {}
    for seed in (1, BIG):
        reqs = traffic.Requests(mix, seed, 151936)
        sizes[seed] = [len(reqs.get(j).tokens) for j in range(3 * n)]
        for b in range(3):
            block = sizes[seed][b * n:(b + 1) * n]
            assert sorted(block) == sorted(reqs.levels.tolist())
    assert Counter(sizes[1]) == Counter(sizes[BIG])
    assert sizes[1] != sizes[BIG]
    lo, hi = mix["prompt_tokens"]["min"], mix["prompt_tokens"]["max"]
    assert min(sizes[1]) == lo and max(sizes[1]) == hi


def test_features_lie_near_their_centroids_in_equal_shares():
    _, mix = _mixes()
    reqs = traffic.Requests(mix, BIG, 151936)
    K = mix["deployment"]["experts"]
    near = [reqs.get(j).near for j in range(8 * K)]
    assert Counter(near) == {k: 8 for k in range(K)}
    n = mix["clients"]          # client c sends c, c + n, ...: one expert
    assert {reqs.get(3 + n * i).near for i in range(4)} == {3 % K}
    for j in range(8):
        r = reqs.get(j)
        c = reqs.centroids / np.linalg.norm(reqs.centroids, axis=1,
                                            keepdims=True)
        assert int(np.argmax(c @ r.features)) == r.near


def test_samples_are_seeded():
    s = traffic.sample(BIG, list(range(50)), 8, [49])
    assert 49 in s and len(s) == 8 and s == traffic.sample(
        BIG, list(range(50)), 8, [49])
    assert s != traffic.sample(BIG + 1, list(range(50)), 8, [49])
