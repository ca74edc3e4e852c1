"""Whole-batch decentralized ensemble serving (port of
``repro.serve.ensemble_engine``; paper §5.2).

Each expert is a pod; the parameter-free Eq. 28 centroid router runs at
the front end on the requests' frozen-encoder features. Two strategies:

* ``generate_top1`` — the paper's compute-matched setting: the batch is
  grouped by routed expert and each group decoded by its expert alone
  (``ServeEngine`` per group);
* ``generate_mixture`` — the general top-k path: the experts stacked on
  one dim (``core.ensemble.make_stacked_serving``), one stacked decode a
  token with the exact Eq. 27 probability mixture, no per-expert loop.

The stacked core is built on first use, so the top-1 path never pays for
the K× stacked copy. Sampling follows ``serve.engine``: a split key
chain.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.ensemble import (PROB_FLOOR, make_stacked_serving,
                                       mix_expert_logits)
from repro_torch.models.model import Model
from repro_torch.serve.api import SamplingParams

from .engine import ServeEngine, resolve_sampling, sample_next

Tensor = torch.Tensor


def _without_features(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {k: v for k, v in batch.items() if k != "features"}


@dataclass
class DecentralizedServer:
    model: Model
    expert_params: List[Any]            # K parameter trees
    router: Any                         # core.router.CentroidRouter
    cache_len: int

    def __post_init__(self):
        self.engine = ServeEngine(self.model, self.cache_len)
        self._core = None        # stacked decode core, built on first use

    def _stacked_core(self):
        """``(stacked, prefill_all, mix_decode, forward_all)``, built once:
        ``forward_all(stacked, batch)`` is the teacher-forced logits of
        every expert, (K, B, S, V)."""
        if self._core is None:
            stacked, prefill_all, mix_decode = make_stacked_serving(
                self.model, self.expert_params, self.cache_len)
            model, K = self.model, self.K

            def forward_all(sp, batch):
                return model.forward(sp, batch).unflatten(0, (K, -1))
            self._core = (stacked, prefill_all, mix_decode, forward_all)
        return self._core

    @property
    def K(self) -> int:
        return len(self.expert_params)

    @property
    def _device(self):
        return self.expert_params[0]["final_norm"].device

    def route(self, features: Tensor) -> Tensor:
        """(B, D) → top-k-filtered router weights (B, K)."""
        return self.router.route(features)

    def generate_top1(self, batch: Dict[str, Tensor],
                      n_new: Union[int, SamplingParams], key=None,
                      temperature: float = 1.0) -> np.ndarray:
        """Grouped top-1: each routed group generates on its expert alone,
        with a key split off the chain per group in expert order. Returns
        (B, n_new) int32. ``n_new`` may be a ``SamplingParams``."""
        n_new, key, temperature = resolve_sampling(n_new, key, temperature,
                                                   self._device)
        expert_of = self.router.top1(batch["features"]).cpu().numpy()
        out = np.zeros((expert_of.shape[0], n_new), dtype=np.int32)
        for k in range(self.K):
            sel = np.where(expert_of == k)[0]
            if len(sel) == 0:
                continue
            idx = torch.as_tensor(sel, device=self._device)
            sub = {name: v[idx]
                   for name, v in _without_features(batch).items()}
            key, gk = prng.split(key)
            toks = self.engine.generate(self.expert_params[k], sub, n_new,
                                        gk, temperature)
            out[sel] = toks.cpu().numpy()
        return out

    def mixture_next_probs(self, batch: Dict[str, Tensor]) -> Tensor:
        """The stacked prefill over every expert and the Eq. 27 mixture of
        their last-position distributions: (B, V) probabilities."""
        weights = self.route(batch["features"])               # (B, K)
        stacked, prefill_all, _, _ = self._stacked_core()
        logits, _ = prefill_all(stacked, _without_features(batch))
        return mix_expert_logits(logits[:, :, -1], weights)

    def generate_mixture(self, batch: Dict[str, Tensor],
                         n_new: Union[int, SamplingParams], key=None,
                         temperature: float = 1.0) -> Tensor:
        """Top-k mixture decoding: one stacked decode of the K experts a
        token, mixed by Eq. 27, then the argmax (temperature 0) or a
        ``categorical`` draw over the floored log-probabilities over the
        temperature. Returns (B, n_new) int32."""
        n_new, key, temperature = resolve_sampling(n_new, key, temperature,
                                                   self._device)
        weights = self.route(batch["features"])               # (B, K)
        stacked, prefill_all, mix_decode, _ = self._stacked_core()
        logits, caches = prefill_all(stacked, _without_features(batch))
        probs = mix_expert_logits(logits[:, :, -1], weights)  # (B, V)
        prompt_len = logits.shape[2]
        out = []
        for i in range(n_new):
            key, sk = prng.split(key)
            logp = probs if temperature == 0 else \
                torch.log(probs.clamp_min(PROB_FLOOR))
            out.append(sample_next(logp, sk, temperature))
            if i == n_new - 1:
                break
            probs, caches = mix_decode(
                stacked, caches, out[-1],
                torch.tensor(prompt_len + i, dtype=torch.int32,
                             device=probs.device), weights)
        return torch.stack(out, dim=1)

    def ensemble_eval_nll(self, batch: Dict[str, Tensor]) -> Tensor:
        """Teacher-forced mean per-token NLL of the router-weighted
        mixture, the metric the parity benchmarks report."""
        weights = self.route(batch["features"])               # (B, K)
        sub = _without_features(batch)
        stacked, _, _, forward_all = self._stacked_core()
        all_logits = forward_all(stacked, sub)                # (K,B,S,V)
        S = all_logits.shape[2]
        probs = mix_expert_logits(all_logits,
                                  weights[:, None, :].expand(-1, S, -1))
        logp = torch.log(probs.clamp_min(PROB_FLOOR))
        labels = sub["labels"]
        nll = -logp[:, :-1].gather(-1, labels[:, 1:, None].long())[..., 0]
        return nll.mean()
