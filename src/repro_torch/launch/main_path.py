"""The port's main-path deployment, built in one place for ``chip_smoke.py``
and ``launch/profile_serve.py``: full-width Qwen3-8B (bf16), 2 experts of
seeded random weights behind the Eq. 28 centroid router (top-1), 8 slots
per pod over a paged pool of 16-position blocks, 256-token prefill chunks,
the fused decode step; 16 greedy requests of 256–1024 prompt tokens and
64 new tokens each. ``arch`` serves another ported config on the same
deployment and traffic: ``zamba2_2_7b`` the hybrid family (Zamba2-2.7B);
``internvl2_2b`` the vlm family (InternVL2-2B), each request with its own
seeded (256, 1024) float32 image patches ahead of its prompt, so
``cache_len`` counts the 256 prefix rows too; ``granite_3_8b``,
``phi3_medium_14b`` and ``llama3_405b`` the dense family's other
configs, Llama-3-405B cut to ``DEPTH_CUTS``' 2 of its 126 layers (its
full width, D = 16384 and d_ff = 53248, is kept: one card cannot hold
the whole model). ``smoke=True`` builds it at smoke size (2 layers,
8–32 prompt tokens, 8-position blocks and chunks; a recurrent family's
chunk is rounded up to a multiple of its chunkwise-scan length, 16 at
smoke size).

``contiguous(mp)`` builds the second deployment over the same model,
experts, router and requests: the reference's default serving path,
contiguous per-slot caches with monolithic prefill at admission.
``speculative(mp)`` builds the third: the main path's paged + chunked
config with n-gram speculative decoding (``SPEC_LEN`` 4). ``mixture(mp)``
builds the fourth: the main path's config under the Eq. 27 mixture
(``strategy="mixture"``, ``RouterConfig(top_k=2)``), so both experts
weigh in at every token; ``mixture(mp, speculative="expert")`` the same
with expert 0 drafting on the device and the stacked verify.
``sampled(mp)`` serves the main path's deployment with seeded sampling
(``SAMPLE_TEMPERATURE`` 0.8, ``SAMPLE_TOP_K`` 50). Request i's seed is
``mp.sampling.seed + i`` on every path (a greedy request ignores it),
and its modality extras are ``mp.extras[i]`` (empty but for the vlm
family's patches).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.router import CentroidRouter, RouterConfig
from repro_torch.data.synthetic import SyntheticConfig, SyntheticMultimodal
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.serve.api import EngineConfig, SamplingParams
from repro_torch.serve.scheduler import DecentralizedSlotServer, make_engine

ARCH = "qwen3_8b"
HYBRID_ARCH = "zamba2_2_7b"
N_EXPERTS = 2
N_REQUESTS = 16
NEW_TOKENS = 64
N_SLOTS = 8
# (shortest prompt, longest prompt, page block, prefill chunk)
FULL_SHAPE = (256, 1024, 16, 256)
SMOKE_SHAPE = (8, 32, 8, 8)
CORPUS_SEED = 7       # request features
PROMPT_SEED = 2       # router centroids, then prompt lengths and tokens
SAMPLE_SEED = 1000    # request i of a sampled path is seeded 1000 + i
SAMPLE_TEMPERATURE = 0.8
SAMPLE_TOP_K = 50
SPEC_LEN = 4          # positions a speculative step verifies per slot
MIXTURE_TOP_K = 2     # experts the mixture's router weighs a request over
PATCH_SEED = 3000     # request i's image patches (vlm): default_rng(3000 + i)
# full-width depth cuts of the configs one card cannot hold whole (80 GB):
# Llama-3-405B's two layers and tables are ~21 GB an expert in bf16
DEPTH_CUTS = {"llama3_405b": 2}


@dataclass
class MainPath:
    cfg: ModelConfig
    model: Model
    engine: DecentralizedSlotServer
    prompts: List[np.ndarray]
    features: np.ndarray
    sampling: SamplingParams
    experts: List[Any]
    router: CentroidRouter
    config: EngineConfig          # the main path's
    device: torch.device
    extras: List[Dict[str, np.ndarray]]   # request i's modality inputs

    def warm(self) -> None:
        """Serve one short request to completion (allocator, library
        handles, the sampler when the path samples) before anything is
        counted or timed."""
        rid = len(self.prompts)
        self.engine.add_request(self.prompts[0],
                                replace(self.params(0), max_new=2),
                                self.extras[0], features=self.features[0],
                                rid=rid)
        while self.engine.has_unfinished():
            self.engine.step()

    def params(self, i: int) -> SamplingParams:
        """Request i's sampling parameters: ``sampling`` with seed + i."""
        return replace(self.sampling, seed=self.sampling.seed + i)

    def submit(self) -> None:
        """Submit every request (rid = its index); the router places each."""
        for i, p in enumerate(self.prompts):
            self.engine.add_request(p, self.params(i), self.extras[i],
                                    features=self.features[i], rid=i)


def patches_for(cfg: ModelConfig, n: int) -> List[Dict[str, np.ndarray]]:
    """The modality extras of requests 0..n-1: for the vlm family request
    i's (n_patches, vision_dim) float32 patches, drawn from
    ``default_rng(PATCH_SEED + i)``; none for the other families."""
    if cfg.family != "vlm":
        return [{} for _ in range(n)]
    return [{"patches": np.random.default_rng(PATCH_SEED + i).normal(
        size=(cfg.n_patches, cfg.vision_dim)).astype(np.float32)}
        for i in range(n)]


def build(device="cuda", *, smoke: bool = False, arch: str = ARCH
          ) -> MainPath:
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if not smoke and arch in DEPTH_CUTS:
        cfg = cfg.reduced(n_layers=DEPTH_CUTS[arch])
    model = build_model(cfg)
    experts = [model.init(torch.Generator(device=dev).manual_seed(k))
               for k in range(N_EXPERTS)]
    features = SyntheticMultimodal(SyntheticConfig(seed=CORPUS_SEED)) \
        .sample_batch(N_REQUESTS, step=0)["features"]
    rng = np.random.default_rng(PROMPT_SEED)
    router = CentroidRouter(torch.as_tensor(
        rng.normal(size=(N_EXPERTS, features.shape[1])).astype(np.float32)))
    lo, hi, block, chunk = SMOKE_SHAPE if smoke else FULL_SHAPE
    if cfg.family == "hybrid":      # chunks whole in the scan's chunks
        chunk = -(-chunk // cfg.ssm.chunk) * cfg.ssm.chunk
    lens = rng.integers(lo, hi + 1, N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    config = EngineConfig(n_slots=N_SLOTS,
                          cache_len=hi + prefix + NEW_TOKENS, paged=True,
                          page_block=block, chunked_prefill=True,
                          chunk=chunk)
    engine = make_engine(model, experts=experts, router=router, device=dev,
                         config=config)
    return MainPath(cfg, model, engine, prompts, features,
                    SamplingParams(max_new=NEW_TOKENS), experts, router,
                    config, dev, patches_for(cfg, N_REQUESTS))


def contiguous(mp: MainPath) -> MainPath:
    """The same deployment on contiguous per-slot caches (cache_len as the
    main path's) with monolithic prefill and the fused step, over ``mp``'s
    model, expert params, router and requests: nothing is initialized
    again."""
    engine = make_engine(
        mp.model, experts=mp.experts, router=mp.router, device=mp.device,
        config=EngineConfig(n_slots=N_SLOTS, cache_len=mp.config.cache_len))
    return replace(mp, engine=engine)


def speculative(mp: MainPath) -> MainPath:
    """The main path's deployment (paged pool, chunked prefill, the fused
    step) with ``speculative="ngram"``: decode-only steps verify
    ``SPEC_LEN`` positions per slot. Over ``mp``'s model, expert params,
    router and requests: nothing is initialized again."""
    engine = make_engine(
        mp.model, experts=mp.experts, router=mp.router, device=mp.device,
        config=replace(mp.config, speculative="ngram", spec_len=SPEC_LEN))
    return replace(mp, engine=engine)


def mixture(mp: MainPath, speculative=None) -> MainPath:
    """The main path's deployment (paged pool, chunked prefill, the fused
    step) under the Eq. 27 mixture: ``strategy="mixture"`` over ``mp``'s
    experts, stacked on one tensor dim (a copy: the caller drops ``mp``'s
    engine and experts to free theirs), and its router's centroids with
    ``RouterConfig(MIXTURE_TOP_K)``, serving ``mp``'s requests.
    ``speculative`` ("expert" or "ngram") verifies ``SPEC_LEN`` positions
    a slot on decode-only steps."""
    router = CentroidRouter(mp.router.centroids, RouterConfig(
        mp.router.config.temperature, MIXTURE_TOP_K))
    engine = make_engine(
        mp.model, experts=mp.experts, router=router, device=mp.device,
        config=replace(mp.config, strategy="mixture",
                       speculative=speculative, spec_len=SPEC_LEN))
    return replace(mp, engine=engine, router=router)


def sampled(mp: MainPath) -> MainPath:
    """The main path's deployment (a new engine over ``mp``'s model,
    experts and router) serving its requests with seeded sampling at
    ``SAMPLE_TEMPERATURE`` and ``SAMPLE_TOP_K``, request i seeded
    ``SAMPLE_SEED + i``:
    served twice, it gives the same tokens."""
    engine = make_engine(mp.model, experts=mp.experts, router=mp.router,
                         device=mp.device, config=mp.config)
    return replace(mp, engine=engine, sampling=replace(
        mp.sampling, temperature=SAMPLE_TEMPERATURE, top_k=SAMPLE_TOP_K,
        seed=SAMPLE_SEED))
