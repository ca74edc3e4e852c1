"""Monolithic against chunked prefill of the hybrid family (Zamba2-2.7B) at
full width, in both packages, on the same weights.

The reference (``repro``) initialises a full-width ``zamba2_2_7b`` cut to
``--groups`` of its 9 groups (6 Mamba2 layers and one pass of the shared
attention block each), in float32; the port (``repro_torch``) gets the same
arrays through ``weights.from_tree``. One prompt of ``--width`` tokens
(made from ``--seed``) then runs through monolithic prefill and through
chunked prefill (the main path's 256-position chunks over a paged cache of
16-position blocks) in each package, on the CPU. The last row's logits give
four distances:

* ``ref_mono_vs_chunked`` and ``port_mono_vs_chunked``: the two paths of
  one package;
* ``mono_port_vs_ref`` and ``chunked_port_vs_ref``: one path across the
  packages;

and, for the scale of float32 rounding in this model, each package's
sensitivity: how far its monolithic prefill's logits move when the
embedding table is perturbed by 1e-7 of its largest element
(``ref_sensitivity``, ``port_sensitivity``). Rounding predicts port
distances of the size of those sensitivities (the reference's own two
paths run the same operations in the same order, so they may agree far
closer); a port fault shows as a port distance far above them. Last, the
error of each of the four float32 runs against the port's monolithic
prefill in float64 on the same weights (``*_vs_float64``), and against the
reference's monolithic prefill in float64 (``*_vs_ref_float64``), with the
two float64 runs' own distance (``float64_port_vs_ref``): where the two
packages agree in float64, that run stands for the exact value. Prints one
JSON line. About 1 minute and ~8 GB at one group:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_hybrid_prefill_distances.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.tree import tree_map
from repro_torch.weights import from_tree

ARCH = "zamba2_2_7b"
BLOCK, CHUNK = 16, 256       # repro_torch.launch.main_path.FULL_SHAPE


def _noise(emb):
    """A 1e-7 relative perturbation of the embedding table."""
    rng = np.random.default_rng(9)
    return (rng.normal(size=emb.shape) * 1e-7 * np.abs(emb).max()) \
        .astype(np.float32)


def _last_rows(jm, jp, tm, tp, toks):
    """Last-row logits of each package's monolithic and chunked prefill,
    and of its monolithic prefill on a perturbed embedding table."""
    width = toks.shape[1]
    cache_len = width + 8
    nb = -(-cache_len // BLOCK)
    table = np.arange(1, nb + 1, dtype=np.int32)
    padded = np.pad(toks, ((0, 0), (0, -width % CHUNK)))
    out = {}
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len)
    out["ref_mono"] = np.asarray(jl)[0, -1]
    jx = jm.embed_prompt(jp, {"tokens": jnp.asarray(padded)})
    jcache = jm.init_paged_cache(1, nb + 1, BLOCK, cache_len)
    jcarry = jm.init_chunk_carry(jp, None, cache_len)
    for start in range(0, width, CHUNK):
        jl, jcarry, jcache = jm.prefill_chunk(
            jp, jcache, jcarry, jx[:, start:start + CHUNK], jnp.int32(start),
            jnp.int32(min(CHUNK, width - start)), jnp.asarray(table))
    out["ref_chunked"] = np.asarray(jl)[0]
    del jx, jcache, jcarry
    with torch.no_grad():
        tl, _ = tm.prefill(tp, {"tokens": torch.as_tensor(toks).long()},
                           cache_len)
        out["port_mono"] = tl[0, -1].numpy()
        x = tm.embed_prompt(tp, {"tokens": torch.as_tensor(padded).long()})
        cache = tm.init_paged_cache(1, nb + 1, BLOCK, cache_len,
                                    device="cpu")
        carry = tm.init_chunk_carry(tp, None, cache_len)
        for start in range(0, width, CHUNK):
            tl, carry, cache = tm.prefill_chunk(
                tp, cache, carry, x[:, start:start + CHUNK], start,
                min(CHUNK, width - start), torch.as_tensor(table))
        out["port_chunked"] = tl[0].numpy()
        emb = tp["embed"]["embedding"]
        noise = torch.as_tensor(_noise(emb.numpy()))
        tp["embed"]["embedding"] = emb + noise
        tl, _ = tm.prefill(tp, {"tokens": torch.as_tensor(toks).long()},
                           cache_len)
        out["port_perturbed"] = tl[0, -1].numpy()
        tp["embed"]["embedding"] = emb
        tm64 = build_model(tm.cfg.reduced(param_dtype="float64",
                                          compute_dtype="float64"))
        tl, _ = tm64.prefill(tree_map(lambda t: t.double(), tp),
                             {"tokens": torch.as_tensor(toks).long()},
                             cache_len)
        out["float64"] = tl[0, -1].double().numpy()
    jpp = {**jp, "embed": {**jp["embed"], "embedding": jp["embed"][
        "embedding"] + jnp.asarray(noise.numpy())}}
    jl, _ = jm.prefill(jpp, {"tokens": jnp.asarray(toks)}, cache_len)
    out["ref_perturbed"] = np.asarray(jl)[0, -1]
    del jpp
    with jax.enable_x64(True):
        jm64 = jax_build(jm.cfg.reduced(param_dtype="float64",
                                        compute_dtype="float64"))
        jp64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
        jl, _ = jm64.prefill(jp64, {"tokens": jnp.asarray(toks)}, cache_len)
        out["ref_float64"] = np.asarray(jl, np.float64)[0, -1]
    return out


def _cut(cfg, groups, group_m):
    """``cfg`` in float32 with ``groups`` groups of ``group_m`` Mamba2
    layers (6 in the published model)."""
    return cfg.reduced(n_layers=group_m * groups, param_dtype="float32",
                       compute_dtype="float32",
                       ssm=dataclasses.replace(cfg.ssm,
                                               shared_attn_every=group_m))


def distances(groups: int = 1, width: int = 702, seed: int = 0,
              group_m: int = 6) -> dict:
    t0 = time.perf_counter()
    jm = jax_build(_cut(jax_get_config(ARCH), groups, group_m))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(_cut(get_config(ARCH), groups, group_m))
    tp = from_tree(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(seed).integers(
        0, tm.cfg.vocab, (1, width)).astype(np.int32)
    rows = _last_rows(jm, jp, tm, tp, toks)

    def dist(a, b):
        return float(np.abs(rows[a] - rows[b]).max())

    return {
        "arch": ARCH, "groups": groups, "layers": group_m * groups,
        "width": width, "seed": seed, "dtype": "float32", "device": "cpu",
        "logit_max_abs": float(np.abs(rows["ref_mono"]).max()),
        "ref_mono_vs_chunked": dist("ref_mono", "ref_chunked"),
        "port_mono_vs_chunked": dist("port_mono", "port_chunked"),
        "mono_port_vs_ref": dist("port_mono", "ref_mono"),
        "chunked_port_vs_ref": dist("port_chunked", "ref_chunked"),
        "ref_sensitivity": dist("ref_mono", "ref_perturbed"),
        "port_sensitivity": dist("port_mono", "port_perturbed"),
        **{f"{k}_vs_{w}": dist(k, w)
           for w in ("float64", "ref_float64")
           for k in ("ref_mono", "ref_chunked", "port_mono",
                     "port_chunked")},
        "float64_port_vs_ref": dist("float64", "ref_float64"),
        "same_pick": len({int(np.argmax(r)) for r in rows.values()}) == 1,
        "seconds": round(time.perf_counter() - t0, 1)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=1)
    ap.add_argument("--width", type=int, default=702)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--group-m", type=int, default=6,
                    help="Mamba2 layers a group (6 in the published model; "
                    "1 shows the distances where little amplifies them)")
    a = ap.parse_args()
    torch.set_num_threads(4)
    print(json.dumps(distances(a.groups, a.width, a.seed, a.group_m)))


if __name__ == "__main__":
    main()
