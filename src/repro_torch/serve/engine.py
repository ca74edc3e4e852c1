"""Whole-batch serving (port of ``repro.serve.engine``): prefill plus
single-token decode over a fixed batch, and a sampled generation loop.

The batch is decoded in lockstep for its whole budget: no slots, no stop
ids, no early exit (the slot engines in ``serve.scheduler`` have those).
Sampling draws from a split key chain as the reference does — each token
splits the key and ``categorical`` draws from the subkey
(``core.prng``'s threefry, bit for bit with ``jax.random``) — not from
the slot engines' per-request seeded streams. Everything runs on the
device of the params.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple, Union

import torch

from repro_torch.core import prng
from repro_torch.models.model import Model
from repro_torch.serve.api import SamplingParams
from repro_torch.serve.fused import argmax_tokens

Tensor = torch.Tensor


def resolve_sampling(n_new: Union[int, SamplingParams], key,
                     temperature: float, device=None
                     ) -> Tuple[int, Any, float]:
    """Normalize the whole-batch generators' sampling arguments: either
    the ``(n_new, key, temperature)`` triple or ONE ``SamplingParams``,
    whose ``seed`` makes the key when none is given (``PRNGKey(0)``
    otherwise); the key lives on ``device``."""
    if isinstance(n_new, SamplingParams):
        sp = n_new
        if key is None:
            key = prng.PRNGKey(sp.seed, device)
        return sp.max_new, key, sp.temperature
    if key is None:
        key = prng.PRNGKey(0, device)
    return n_new, key, temperature


def sample_next(last: Tensor, sub, temperature: float) -> Tensor:
    """One whole-batch token from (B, V) float32 scores: the argmax at
    temperature 0, else ``categorical(sub, last / temperature)``. (B,)
    int32."""
    if temperature == 0:
        return argmax_tokens(last)
    return prng.categorical(sub, last / temperature).to(torch.int32)


@dataclass
class ServeEngine:
    """Prefill and decode of one model over a whole batch, contiguous
    caches of ``cache_len`` positions."""
    model: Model
    cache_len: int

    def prefill(self, params, batch):
        """(logits (B, S, V), cache) of the prompt batch."""
        return self.model.prefill(params, batch, self.cache_len)

    def decode_step(self, params, cache, tokens: Tensor,
                    pos) -> Tuple[Tensor, Any]:
        """One token for every row at the shared position ``pos`` (an
        int): (logits (B, V), cache)."""
        return self.model.decode_step(
            params, cache, tokens,
            torch.tensor(pos, dtype=torch.int32, device=tokens.device))

    def generate(self, params, batch, n_new: Union[int, SamplingParams],
                 key=None, temperature: float = 1.0) -> Tensor:
        """Prefill on the prompt, then draw ``n_new`` tokens (B, n_new)
        int32: ordinary AR decoding, the Eq. 13 rule restricted to the
        single active position. ``n_new`` may be a ``SamplingParams``
        (its max_new, temperature and seed apply to the whole batch)."""
        n_new, key, temperature = resolve_sampling(
            n_new, key, temperature, params["final_norm"].device)
        logits, cache = self.prefill(params, batch)
        prompt_len = logits.shape[1]
        last = logits[:, -1]
        out = []
        for i in range(n_new):
            key, sub = prng.split(key)
            tok = sample_next(last, sub, temperature)
            out.append(tok)
            if i == n_new - 1:
                break
            last, cache = self.decode_step(params, cache, tok,
                                           prompt_len + i)
        return torch.stack(out, dim=1)


def serve_step_fn(model: Model):
    """The raw (params, cache, tokens, pos) → (logits, cache) decode
    step."""
    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)
    return serve_step
