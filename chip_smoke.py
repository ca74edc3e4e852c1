#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout (it builds the
CUDA kernels from ``src/repro_torch/kernels/csrc`` into ``build/kernels``).
Phases, each fatal on failure:

1. device — prints the card's ``nvidia-smi`` name and power limit;
2. build — one ``nvcc`` per kernel source, all started together; prints
   each source's build seconds and, from ``cuobjdump -sass``, the count of
   tensor-core instructions (``HGMMA``, ``HMMA``) in each library, and
   fails if a library of bf16 tensor-core kernels (``TENSOR_CORE_LIBS``)
   has no ``HGMMA``;
3. kernels — each kernel against its plain PyTorch version at the main
   paths' shapes (bf16 and float32), at the hybrid family's shapes (the
   chunk scan at the chunked and the monolithic prefill's shapes; the five
   attention kernels at Zamba2's MHA heads, H = KV = 32, dh = 80) and at
   small float32 edge shapes (the chunk scan's include mLSTM's H = 4,
   dk = 384, dv = 385, and run in bf16 too: on the tensor cores where
   ``tensor_core_route`` sends them, with a steep-decay case and two
   column slices of dv, each call's route checked, every TMA-kernel case
   also with each part count of ``SCAN_PART_COUNTS``; the flash
   forward's and backward's run in bf16 as well, on the tensor-core
   kernels; the flash backward also at the
   contiguous path's and Zamba2's prefill shapes; the paged kernels' and
   contiguous decode's run in bf16 as well, on the tensor-core kernels,
   with more bf16 edges: page blocks 8 to 128, groups of 1 to 64 rows, dh
   40 to 128, ragged chunks and S, S under 64 and rings shorter than a
   tile, rings wrapped and far past, two row tiles, spans past the table
   horizon, idle slots, splits whose keys some rows do not see; every
   bf16 verify row is also held against paged decode's plain version at
   pos + j), with the stated tolerances (bf16 kernels against their
   plain versions run in float32 on the same values), and timed (kernel,
   plain version, one library call) with CUDA events, the kernel and the
   library call also replayed from a CUDA graph (device ms: the events'
   mean of back-to-back calls measures the host where a call's kernels
   are short); the two decode kernels are also timed at every number of
   key tiles a split (the sweep record, each setting held against the
   plain version; the paged one at the main path's and at Zamba2's
   heads), and their float32 (scalar) wrappers at the same shapes; the
   kernels the Eq. 27 mixture changed: chunk prefill with a batch axis (B =
   2 chunks at one start, each through its own table row) at Qwen3-8B's
   and Zamba2's heads in bf16 and float32, the B = 2 call timed; paged
   decode as the stacked decode step launches it (2 experts' pools as one
   pool, each slot's table offset by k·P, 16 rows) at the same heads and
   dtypes; the redesigned router (a few lanes a row, one group of rows a
   block) at the path's D = 32, K = 2 for B = 1, 16 and 65536, each timed
   with its bound, and at its edges (K = 6, bf16, scalar loads, unaligned
   rows, rows past B in a warp, K·D staged in slabs of D); and the card's
   floor for one launch in a graph (an in-place add on one element); paged
   verify as the mixture's stacked verify launches it (2 experts' pools as
   one, tables offset by k·P, 16 span rows of ``SPEC_LEN``) in both
   dtypes, the bf16 call timed with its bound; seeded sampling's threefry
   keys, bits and uniforms at V = 151936 on the card equal to the CPU's
   bit for bit, and the sampler timed at 32 rows; and the kernels the
   vlm and dense-config paths run at their new heads (InternVL2-2B's 16
   query heads over 8 KV heads, Phi-3-medium's 40/10, Llama-3-405B's
   128/8, dh 128, at the vlm path's dimensions: 8 slots over 84 blocks of
   16, a 256-row chunk at position 0 that is all image prefix and a
   ragged one after it, flash over a ragged S = 256 + 777, spans of
   ``SPEC_LEN``, contiguous rows of 1344; the Phi and Llama smoke
   configs' dh 40 and 64 at small shapes), paged decode, chunk prefill,
   flash, paged verify and contiguous decode in bf16 and float32, each
   case with its device ms and bound (``new_config_shapes`` in the
   record), and the flash backward there; the same six at the moe
   configs' heads (``MOE_HEADS``: DeepSeek-MoE-16B's 16/16 and
   Qwen3-MoE-235B-A22B's 64/4, dh 128) at the main path's 1088 rows; and
   chunk prefill as a prefix
   hit launches it (2 rows at start 512 whose tables share their first 32
   permuted blocks), in both dtypes; the chunk scan at mLSTM's
   full-width shape (``MLSTM_SCAN``: bf16 on the tensor cores' wide
   kernel, float32 scalar), with device ms and bound, and at the wide
   kernel's edges in both dtypes; and the kernels at Whisper-small's shapes
   (``_audio_kernel_cases``: 12/12 heads of dh 64; the five serving
   attention kernels at 8 slots over 448 positions, and the encoder's
   flash forward, non-causal and causal, and its backward, non-causal,
   at S = 1500), both dtypes, each with device ms and bound; and the
   flash forward and backward at the hybrid training path's shape
   (``_hybrid_training_kernel_cases``: Zamba2's 32/32 heads of dh 80, S =
   4096, causal, bf16), each with device ms and bound; and the contiguous
   decode's lse (``_split_decode_kernel_cases``): out and lse with
   ``return_lse`` against the plain version in bf16 and float32 at the
   contiguous path's shape and at a device's shard of ``decode_32k`` as
   the dry run places it (``SHARD_DECODE``), rows with an empty fence (pos
   −1: a 0 row, lse −inf) among them, the lse within ``LSE_TOL``; the
   output without ``return_lse`` bit for bit that with it; the seam's
   split-and-merge on the card (4 key ranges of the shard's row, one of
   them an empty fence for a row, rows whose ring is full, merged by
   ``ops.merge_key_ranges``) against the whole-row kernel; and the device
   ms of the shard's decode with the lse and without it;
3a. theory — the paper's §4 theory in float64 on the card
   (``phase_theory``): the walkthrough twin, then the reference tests'
   grids (``THEORY_DFM_GRID``, ``THEORY_SPLIT_GRID``); every CE
   residual, decomposition residual and distance of the decoded chain to
   its target within ``THEORY_TOL``, and every tensor equal to the
   CPU's within it;
4. parity — the smoke-size float32 Qwen3 deployment (2 pods, top-1) served
   on the card (kernels) and on the CPU (plain versions) in four
   configurations (paged + chunked, paged + chunked + n-gram speculation,
   paged + monolithic, contiguous + monolithic), then the three without
   speculation under the Eq. 27 mixture (top_k 2), then the mixture with
   n-gram and with expert-0 speculation, then seeded sampling
   (temperature 0.7, top_k 0 and 40) on top-1 and the mixture, speculation
   off and on: tokens, finish reasons, routing and the spec counters must
   be equal, and the n-gram ones must accept drafts (``spec_tokens >
   spec_steps``); a sampled token that differs is printed with its
   Gumbel-plus-logit margin and fails unless that margin is within
   ``SAMPLE_MARGIN_ULPS`` ulps; then the smoke-size float32 Zamba2
   deployment in the three configurations without speculation, top-1 and
   mixture, and sampled, top-1 and mixture, with the same checks; then
   every configuration of Qwen3's for the smoke-size InternVL2-2B (each
   request with its own patches), Granite-3-8B, Phi-3-medium-14B and
   Llama-3-405B; then the serving host layer's configurations
   (``HOST_LAYER_ARCHS``: Qwen3's prefix cache top-1 and mixture, swap
   and recompute preemption top-1 and mixture, DRR over two tenants;
   InternVL2-2B's prefix cache under one image; Zamba2's swap and
   recompute with the cache asked for and not built), where every pod's
   ``stats()`` must be equal too; then every configuration of Qwen3's for
   the smoke-size DeepSeek-MoE-16B and Qwen3-MoE-235B-A22B, at their
   capacity factor 8.0 (no pair may drop) and at ``MOE_DROP_CF`` (pairs
   must drop; the dropped pairs by group width are printed); the
   smoke-size xLSTM-125M (ssm) in every configuration without
   speculation, and contiguous + chunked (it has no pool); Qwen3's and
   xLSTM's configurations without speculation again with the unfused step
   (``fused_step=False``), and their whole-batch engines
   (``ServeEngine.generate``, ``DecentralizedServer.generate_top1`` and
   ``generate_mixture`` greedy: tokens equal, a row differing only at a
   near-tie within ``SAMPLE_MARGIN_ULPS`` ulps; the mixture's
   probabilities and eval NLL within 1e-4); the smoke-size Whisper-small
   (each request with its own frames) in every configuration of Qwen3's,
   again unfused, and its host layer (the prefix cache under one set of
   frames, and the repeat of request 0 under another, which must skip
   fewer tokens; swap preemption). Under expert drafting request 1 sits
   on expert 0's centroid, so the mixture takes its drafts, which must be
   accepted on every config; the n-gram acceptance requirement holds on Qwen3's
   traffic, built for it;
5. main path — full-width Qwen3-8B (36 layers, bf16, 2 experts of seeded
   random weights) served through ``make_engine`` → ``add_request``/
   ``step`` with the paged pool, chunked prefill and the fused decode
   step; every request must finish, every logit the engine sampled from
   (each decode step and each prefill chunk) must be finite, and each of
   the path's kernels (paged decode, chunk prefill, router) must have
   launched;
5a. unfused path — the main path's deployment with the unfused step: its
   greedy tokens must be the main path's (a request differing only at a
   near-tie); it prints ms a step and the registry's dispatch /
   device_get split beside the fused path's;
5b. batch engine — the whole-batch ``DecentralizedServer`` over the main
   path's model and experts, its first ``BATCH_REQUESTS`` prompts cut to
   one length, ``BATCH_NEW_TOKENS`` greedy tokens, top-1 and the Eq. 27
   mixture: tokens/s, peak GiB and launches printed, and the top-1
   tokens' equality with the slot path (information only);
6. speculative path — the main path's deployment with n-gram speculation
   (``spec_len`` 4) over the same model, experts and requests; the same
   checks (the sampled logits now include every row of each span verify),
   with the paged verify kernel launched besides the main path's three. It
   prints the spec counters, the accept rate and how many requests got the
   same tokens as on the main path (information only, as below);
6b. sampled path — the main path's deployment with seeded sampling
   (``main_path.sampled``: temperature 0.8, top_k 50, a seed a request),
   served twice on fresh engines: the main path's checks, the two runs
   must give the same tokens, and it prints ms a step and tokens/s beside
   the greedy main path's;
7. contiguous path — the reference's default serving configuration over
   the same model, experts and requests: contiguous per-slot caches,
   monolithic prefill at admission, the fused step; the same checks (the
   sampled logits are each decode step's and each prefill's last row), with
   the flash-attention, contiguous decode and router kernels launched. It
   prints how many requests got the same tokens, and the same first token,
   on both paths (information only: in bf16 the two paths' logits differ
   by rounding, and greedy picks with close runners-up fall either way);
7a. prefix path — the main path's deployment with ``prefix_cache=True``
   on 16 requests behind one 512-token preamble (the first request of
   each pod served to its first token before the other 14 arrive),
   traced, against the same traffic without the cache: exactly 14 × 512
   prompt tokens from the cache, no leaked block, every request finished
   with ``length``; it prints both runs' chunk-prefill launches, TTFT,
   ms a step, tokens/s and peak GiB, and the registry's and the trace's
   dispatch/device_get split (the trace is written to
   ``build/prefix_path_trace.json`` and read back);
7b. preemption path — the main path's experts, two tenants (8 batch
   requests at priority 0, 8 interactive ones at priority 1 arriving
   after step ``PREEMPT_ARRIVAL_STEP``), a pool of ``PREEMPT_POOL``
   blocks a pod, served with preemption off (full pool), by swap under
   the PoolSanitizer and by recompute: each preempting mode must park at
   least 2 decoding requests, resume every one, end with nothing parked
   and finish every request with ``length``; it prints TTFT by tenant,
   swapped bytes and host ms per swap out and in;
7b. mixture path — the main path's deployment under the Eq. 27 mixture
   (``main_path.mixture``: both experts stacked on one tensor dim, top_k
   2) over the same model, experts and requests at a decode budget of
   ``MIXTURE_NEW_TOKENS``, once the per-expert tensors are dropped: the
   main path's checks, and each stacked decode step must launch paged
   decode once per attention layer (36), not once per expert;
7c. mixture speculative path — the same deployment with expert-0
   drafting and the stacked verify (``main_path.mixture(speculative=
   "expert")``, ``spec_len`` 4, ``MIXTURE_NEW_TOKENS`` a request), built
   from views of the mixture path's stack: the main path's checks, and
   each verify step must launch paged verify once per attention layer (36
   for both experts) and paged decode 3 × 36 times for the drafts; it
   prints steps, ms a step, tokens/s, mean TTFT, peak GiB and the accept
   rate (information only: random weights accept few drafts);
8. float32 agreement — one expert of full-width Qwen3-8B in float32: the
   monolithic prefill (flash-attention kernel) and the chunked prefill
   (chunk-prefill kernel over the paged pool) of two prompts, then one
   decode step on each cache (contiguous and paged decode kernels), must
   give the same last-row logits within ``F32_LOGIT_TOL``; and a span
   verify of ``SPEC_LEN`` positions over the paged cache (verify kernel)
   must give, in row j, the logits of paged decode steps at pos + j after
   the drafts are committed, within the same tolerance and with the same
   greedy picks. The drafts are the decode steps' own greedy chain, so the
   fused verify step run on them must accept every draft: it must emit
   ``SPEC_LEN`` tokens and leave pos and tok where the decode steps leave
   them, and stop where a stop id, the token budget or the context end
   falls inside the span;
8b. mixture float32 — full-width Qwen3-8B in float32 at
   ``MIXTURE_F32_LAYERS`` layers, 2 experts: each expert's logits from the
   stacked chunked prefill (every chunk) and one stacked paged decode step
   against its own single-model steps, within ``F32_LOGIT_TOL``, with one
   kernel launch a layer a stacked step;
9. hybrid path — full-width Zamba2-2.7B (54 Mamba2 layers in 9 groups
   with one shared attention block, bf16, 2 experts of seeded random
   weights) on the main path's deployment and traffic, after the Qwen3
   tensors are freed: the main path's checks, with the chunk-scan,
   chunk-prefill, paged-decode and router kernels launched, and every
   chunk-scan call on the tensor cores; then the same deployment under the
   Eq. 27 mixture (``MIXTURE_NEW_TOKENS`` a request), with the same checks and one paged-decode launch per
   attention layer (9) a stacked decode step;
10. hybrid float32 agreement — one expert of full-width Zamba2-2.7B in
   float32: the monolithic prefill (chunk scan over 3 and 4 chunks, flash
   attention) and the chunked prefill (the chunk scan one chunk at a time
   with the recurrent carry between chunks, chunk-prefill attention) of
   prompts of 702 and 1024 tokens, then one decode step on each cache
   (contiguous and paged decode, the Mamba2 step), must give the same
   greedy picks and last-row logits within ``HYBRID_F32_LOGIT_TOL``, and
   the first Mamba2 layer's final SSM state within ``HYBRID_STATE_TOL``
   (the tolerances and why they differ from Qwen3's are stated where they
   are defined);
10a. ssm path — full-width xLSTM-125M (12 layers: 3 groups of 3 mLSTM
   layers and an sLSTM layer, bf16, 2 experts) on the main path's
   deployment and traffic (paged, which serves its per-slot states) with
   ``SSM_NEW_TOKENS`` a request, top-1 then under the Eq. 27 mixture: the
   main path's checks with the chunk-scan and router kernels launched,
   every chunk-scan call on the tensor cores, the first mLSTM layer's
   operands held against the plain version; ms a step, tokens/s, peak
   GiB and the dispatch / device_get split printed;
10b. vlm paths — full-width InternVL2-2B (24 layers, bf16, 2 experts of
   seeded random weights, 256 rows of seeded image patches ahead of each
   prompt) on the main path's deployment and traffic, then on contiguous
   caches with monolithic prefill, then under the Eq. 27 mixture
   (``MIXTURE_NEW_TOKENS``), each with the main path's checks;
10c. vlm float32 — full-width InternVL2-2B in float32 at
   ``VLM_F32_LAYERS`` layers: monolithic prefill then a contiguous decode
   step against chunked prefill then a paged decode step, on two prompts
   behind their prefix, within ``F32_LOGIT_TOL`` (printed beside Qwen3's
   measured difference);
10d. dense-config paths — full-width Granite-3-8B (40 layers, tied
   table), Phi-3-medium-14B (40 layers) and Llama-3-405B (cut to 2 of
   126 layers by ``main_path.DEPTH_CUTS``), each on the main path's
   deployment and traffic, top-1, with the main path's checks and its
   cut printed;
10e. moe_ffn — one full-width layer of each moe config on the card
   against the same function on the CPU, a 256-row chunk and 8 decode
   rows, bf16 and float32: every token's routing compared, the tokens
   routed alike within ``MOE_FFN_TOL``, at most ``MOE_ROUTE_FLIP_SHARE``
   routed otherwise in bf16 (none in float32), each at a near-tie; the
   dropped share and the device ms printed;
10f. moe paths — full-width DeepSeek-MoE-16B (all 28 layers, 2 experts),
   its Eq. 27 mixture (built at 12 layers: the stack is made beside the
   experts) and Qwen3-MoE-235B-A22B (cut to 4 of 94 layers), each on the
   main path's deployment and traffic with the main path's checks; each
   prints its dropped share by group width and the registry's
   dispatch/device_get split;
10g. audio paths — full-width Whisper-small (12 encoder and 12 decoder
   layers, 2 experts, each request with its own 1500 seeded frames,
   prompts of 32–384 tokens, cache_len 448) paged + chunked top-1, then
   contiguous + monolithic, then under the Eq. 27 mixture, each with the
   main path's checks; the flash forward must launch 12 times a request
   on the chunked paths (the encoder at admission, the mixture's experts
   in one launch) and 24 times a request on the contiguous one;
11. training parity — the smoke-size float32 training deployment
   (``repro_torch/launch/train_path.py``: the launcher's partition,
   loaders and schedule) trains expert 0 for 3 steps on the card (flash
   forward and backward kernels) and on the CPU (plain versions) from the
   same params: losses, grad norms and lrs, and params, m and v after the
   third step, within ``TRAIN_PARITY``'s tolerances; then one step's loss
   and gradients of the smoke-size InternVL2-2B (the projector's among
   them), Granite-3-8B (the tied table's), Zamba2-2.7B (the shared
   block's, the Mamba2 scans in their training form) and xLSTM-125M (the
   sLSTM's) on the card and on the CPU, each against the CPU's float64
   gradient, within ``TRAIN_STEP_PARITY``;
12. training path — full-width Qwen3-8B cut to 8 layers (bf16, remat
   "full"), 2 experts on the launcher's k-means partition, 8 steps each
   of one 4096-token sequence, through ``train_host_loop``; prints each
   expert's first and last loss, median ms per step, tokens/s, peak GiB
   and the launches; fails on a non-finite loss, a last loss not below
   the first, a parameter leaf whose step-1 gradient is missing or zero
   (its m after step 1 has no nonzero element), or launch counts other
   than layers with attention x steps x experts (backward) and twice that
   (forward, run again by the recomputation), or any chunk-scan launch;
   then the same for DeepSeek-MoE-16B cut to 4 layers (its dropped share
   printed), for Whisper-small whole (4 steps of 8 sequences of 448
   tokens and their frames; the encoder's 12 layers count among the
   layers), for Zamba2-2.7B whole (4 steps; its 9 shared-block
   applications are its layers with attention: 72 backward and 144
   forward flash launches) and for xLSTM-125M whole (4 steps of 2048
   tokens, its training context; no flash launch; expert 0's final state
   written with ``checkpoint/ckpt.py`` and restored bit for bit, its bytes
   and seconds printed); the hybrid and
   ssm scans take their training form, so no chunk-scan launch;
13. float32 gradients — full-width Qwen3-8B, 2 layers, in float32 on one
   1024-token sequence: the gradient of ``Model.loss`` through the kernel
   path (flash forward and backward kernels) against autograd through the
   plain attention on the card, each leaf within ``F32_GRAD_TOL`` of its
   largest element;
13a. remat — full-width Qwen3-8B cut to ``REMAT_LAYERS`` layers (bf16,
   one ``REMAT_SEQ``-token sequence), one step's loss and gradients from
   the same params under remat "none", "full" and "dots": equal losses,
   gradients within the bf16 tolerance of "none"'s, and peak GiB above
   the state ordered full < dots < none (``phase_remat``);
13b. examples — the end-to-end example twins on the card, each a
   subprocess that must exit 0: ``train_decentralized`` (xLSTM-125M at
   the launchers' smoke size, ``EXAMPLE_STEPS`` steps), ``serve_ensemble``
   on its run, ``quickstart`` (``phase_examples``);
13c. placed training — train_path's deployment (full-width Qwen3-8B,
   bf16, cut to ``PLACED_LAYERS`` layers: two stacked experts' AdamW
   state at its 8 would not fit the card), 2 experts stacked, through the
   placed decentralized step on a (1, 1, 1) ("pod", "data", "model")
   DeviceMesh over NCCL at world size 1 (``phase_placed_train``): the
   state placed by ``state_shardings`` under the decentralized rules,
   ``PLACED_STEPS`` steps against the unplaced step from the same seeds
   and batches — losses, grad norms and params after them within
   ``TRAIN_PARITY``, the flash forward and backward launched as often
   through the kernel seam's DTensor path; both runs' ms a step and peak
   GiB printed; the first placed step under the dry run's memory counter
   (``roofline.LocalMemory``), its arguments + peak within
   ``MEMORY_COUNTER_TOL`` of ``torch.cuda.max_memory_allocated()``;
13d. dry run — ``repro_torch.launch.dryrun`` of ``DRYRUN_CASE`` on the
   multi-pod mesh (512 fake ranks, fake CPU tensors, ``--probe``),
   decentralized and dense, and of ``DRYRUN_DECODE_CASES`` (decode on a
   cache split along its sequence), decentralized, each a subprocess
   started right after the build and run beside the card's phases
   (``phase_dryrun``): every case must be ``ok``, the decentralized ones
   must record no collective whose group spans pods, the dense control at
   least one; the decode cases' schedules must hold the seam's merge (a
   SUM all-reduce of the (B, H, dh + 1) float32 numerator) and
   ``decode_32k``'s device shard must be ``SHARD_DECODE``'s; prints the
   three roofline terms at the H100's data-sheet peaks and the
   per-device state GiB;
14. moe launches — ``torch.profiler``'s count of the card's kernels in
   one ``moe_ffn`` call (decode rows, a chunk) and in one DeepSeek-MoE-16B
   decode layer (a paged decode step at 2 layers less one at 1), run last
   since the profiler stays attached to the process.

The second-to-last line is the ``{"kernels": [...]}`` JSON record (each
kernel's launches on the full-width path that runs it, and on every path
in ``launches_by_path``), the last
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
there is no card or no checkout around the script.
"""
from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

# peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain version: float32 differs only by summation order and the
# blocked online softmax; bf16 by where each side rounds (the plain version
# rounds the softmax weights to bf16 before the PV product, as ref.py does),
# which is one bf16 ulp (3.9e-3 for outputs in [0.5, 1)) on these inputs:
# the bf16 tolerance is twice that
TOL = {"float32": 5e-5, "bfloat16": 8e-3}
# the chunk scan and its plain version both compute in float32 from the
# inputs' values and write float32, whatever the input dtype, so both dtypes
# are held at the float32 tolerance. On the bf16 tensor-core route the
# float32 operands of the second products (P and the decayed K) reach the
# tensor cores as SCAN_PARTS bf16 parts whose sum is the float32 value (three
# parts carry all 24 bits, two about 16), so the kernel still differs from
# the plain version by summation order, not by a bf16 rounding (one part
# alone would put it ~4e-3 off)
SCAN_TOL = TOL["float32"]
# the part counts the chunk scan's tensor-core route is measured with
SCAN_PART_COUNTS = (2, 3)

KERNEL_META = {
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:454"),
    "chunk_prefill_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:240"),
    "router_scores": (
        "src/repro_torch/kernels/csrc/router_scores.cu",
        "src/repro/kernels/router_scores.py:34"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:83"),
    "decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:85"),
    "paged_verify_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:381"),
    "chunk_scan": (
        "src/repro_torch/kernels/csrc/chunk_scan.cu",
        "src/repro/kernels/chunk_scan.py:50"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention_bwd.py:121"),
}
# full-width float32 logits (std ~1) of two paths that differ only by
# summation order: measured within 1e-4 of each other; ten times that
F32_LOGIT_TOL = 1e-3
# Full-width random Zamba2 in float32 is far more sensitive to rounding:
# the chunkwise scan forms its decays from log-decay sums over 256 steps,
# which multiply a relative rounding of its inputs by about L * dt (~200)
# in each of 54 layers. On the card a 1e-7 relative perturbation of the
# embedding moved the last-row logits (std ~1) of the monolithic path
# alone by 0.0135, and monolithic and chunked prefill, whose products
# differ in shape and so in rounding, ended 0.0144 apart (PERF.md). A
# fault in the carry, the conv window or the padded tail moves them by
# O(1). The logits are held at seven times that sensitivity, which the
# phase measures again and prints, and the first Mamba2 layer's final SSM
# state, which carries one layer's rounding only (measured 1.8e-6), at
# HYBRID_STATE_TOL of its largest element.
HYBRID_F32_LOGIT_TOL = 0.1
HYBRID_STATE_TOL = 1e-3
# the kernels each full-width path runs (its launch counts go in the record)
MAIN_KERNELS = ("paged_decode_attention", "chunk_prefill_attention",
                "router_scores")
CONTIGUOUS_KERNELS = ("flash_attention", "decode_attention",
                      "router_scores")
SPEC_KERNELS = MAIN_KERNELS + ("paged_verify_attention",)
HYBRID_KERNELS = ("chunk_scan",) + MAIN_KERNELS
# the ssm family has no attention: its paths run the chunk scan (every
# mLSTM layer of every prefill chunk) and the router
SSM_KERNELS = ("chunk_scan", "router_scores")
SSM_ARCH = "xlstm_125m"
# the ssm path's decode budget a request (8 slots a pod, 256-token chunks)
SSM_NEW_TOKENS = 32
# mLSTM's chunk-scan shape at full width (xLSTM-125M): L = 256 positions a
# chunk, H = 4 heads of dk = 384, dv = 385 with the normalizer channel
MLSTM_SCAN = (256, 4, 384, 385)
# the archs whose parity phase also serves the unfused step and holds the
# whole-batch engines (``ServeEngine``, ``DecentralizedServer``) card vs CPU
UNFUSED_PARITY_ARCHS = ("qwen3_8b", SSM_ARCH)
# the full-width batch-engine phase: the main path's first prompts, cut to
# the shortest prompt length, and its decode budget a request
BATCH_REQUESTS = 8
BATCH_NEW_TOKENS = 32
SPEC_LEN = 4          # positions a speculative step verifies per slot
# depth of the float32 stacked-vs-single mixture check (full width)
MIXTURE_F32_LAYERS = 2
# the full-width mixture paths' decode budget a request (the top-1 paths
# serve main_path.NEW_TOKENS): one pod serves all 16 requests in two waves
# of 8 slots, so a budget of 64 doubled their steps; 32 keeps two waves,
# every kernel and the one-launch-a-layer check at half the decode steps
MIXTURE_NEW_TOKENS = 32
# card vs CPU training at smoke size, float32: the two sides' gradients
# differ by summation order (kernels against plain versions, ~1e-6 of a
# leaf's largest element), which the losses and grad norms carry at about
# that size, and AdamW turns into parameter noise of up to ~lr on elements
# whose gradient is near zero (its normalised step moves an element by
# ~lr whatever the gradient's size; the CPU tests measure 0.045·lr between
# the port and the reference). m and v carry the gradient's own
# difference, v quadratically. Losses, grad norms and lrs relative;
# params absolute as a fraction of the peak lr; m and v as a fraction of
# each leaf's largest element.
TRAIN_PARITY = {"metrics_rtol": 1e-4, "params_of_lr": 0.1,
                "moments_of_max": 1e-4}
# full-width float32 gradients, kernel path vs plain autograd: both sum the
# same float32 products in another order; each leaf is held at this
# fraction of its largest element
F32_GRAD_TOL = 1e-3
# the remat phase: full-width Qwen3-8B at this depth, one sequence of this
# length, under each remat policy
REMAT_LAYERS = 2
REMAT_SEQ = 4096
# steps of each expert in the examples phase's train_decentralized run
EXAMPLE_STEPS = 20
EXAMPLE_TIMEOUT = 300     # seconds an example twin may take
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd")
# the libraries whose bf16 kernels run on the tensor cores (wgmma)
TENSOR_CORE_LIBS = ("decode_attention", "flash_attention",
                    "flash_attention_bwd", "chunk_scan")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back launches,
    timed with CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """Mean device milliseconds per call: ``iters`` calls of ``fn``
    captured in one CUDA graph (the wrappers launch on the current stream,
    the capturing one), replayed three times between CUDA events. Where a
    call's kernels are short, ``cuda_ms`` of back-to-back calls measures
    the host's time to launch them instead. (Not ``torch.profiler``: the
    serving paths run after this phase in the same process, and what a
    profiler leaves attached to it would be timed with them.) Returns
    None, and says why, if the capture fails: the number is a record, not
    a check."""
    import torch
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm up off the capture stream
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (3 * iters)
    except RuntimeError as err:
        log(f"device_ms: CUDA graph capture failed ({err}); not measured")
        torch.cuda.synchronize()
        return None


def compare(name, got, want, dtype_name, cases, tol=None):
    import torch
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype_name] if tol is None else tol
    bad = (err > tol + tol * want.float().abs()).sum().item()
    finite = bool(torch.isfinite(got.float()).all())
    cases.append({"kernel": name, "max_abs_err": err.max().item(),
                  "dtype": dtype_name, "ok": bad == 0 and finite})
    if bad or not finite:
        raise AssertionError(
            f"{name} ({dtype_name}): {bad} elements beyond atol=rtol={tol} "
            f"(max abs err {err.max().item():.3e}, finite={finite})")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _paged_case(B, NB, block, H, KV, dh, pos, dtype, gen, window=0,
                scratch_tail=True, idle=()):
    """q, pools, pos, tables on the card: distinct physical blocks per slot
    (block 0 is scratch); table entries past a slot's horizon point at the
    scratch block, as the scheduler leaves them; ``idle`` slots sit at pos
    0 with zeroed tables."""
    import torch
    dev = "cuda"
    P = B * NB + 1
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, block, KV, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, block, KV, dh), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = perm[:B * NB].reshape(B, NB).to(torch.int32)
    pos = list(pos)
    for b in idle:
        pos[b] = 0
        bt[b] = 0
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    if scratch_tail and window <= 0:
        cols = torch.arange(NB, device=dev)[None, :]
        bt = torch.where(cols <= (pos_t[:, None] // block), bt, 0) \
            .to(torch.int32).contiguous()
    return q, kp, vp, pos_t, bt


def _chunk_case(C, NB, block, H, KV, dh, start, dtype, gen):
    import torch
    dev = "cuda"
    P = 2 * NB + 1
    q = torch.randn((C, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, block, KV, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, block, KV, dh), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = perm[:NB].to(torch.int32).contiguous()
    return q, kp, vp, start, bt


def _verify_case(B, NB, block, L, H, KV, dh, pos, dtype, gen, *,
                 inactive=(), scratch_tail=True):
    """(B, L, H, dh) span queries, pools, pos and tables on the card; table
    entries past a slot's span horizon (pos + L - 1) // block point at the
    scratch block; ``inactive`` slots sit at pos 0 with zeroed tables, as
    the scheduler leaves idle ones."""
    import torch
    dev = "cuda"
    P = B * NB + 1
    q = torch.randn((B, L, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, block, KV, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, block, KV, dh), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = perm[:B * NB].reshape(B, NB).to(torch.int32)
    pos = list(pos)
    for b in inactive:
        pos[b] = 0
        bt[b] = 0
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    if scratch_tail:
        cols = torch.arange(NB, device=dev)[None, :]
        bt = torch.where(cols <= (pos_t[:, None] + L - 1) // block, bt, 0)
    return q, kp, vp, pos_t, bt.to(torch.int32).contiguous()


def _flash_case(B, S, H, KV, dh, dtype, gen):
    import torch
    q = torch.randn((B, S, H, dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, dh), generator=gen, device="cuda").to(dtype)
    return q, k, v


def _decode_case(B, S, H, KV, dh, pos, dtype, gen):
    import torch
    q = torch.randn((B, H, dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, dh), generator=gen, device="cuda").to(dtype)
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda")


def _heads_first(t, group):
    """(B,S,KV,dh) → contiguous (B,H,S,dh) with each KV head repeated for
    its query heads: the library call's layout (made outside its timing)."""
    return t.permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()


def _up(*ts):
    """Float tensors in float32 (the plain versions' inputs beside a bf16
    kernel), the others as they are."""
    return [t.float() if t.is_floating_point() else t for t in ts]


# key tiles a split in the decode kernels' sweep (17: one split at the main
# path's 17 tiles)
DECODE_SWEEP_TILES = (1, 2, 3, 4, 6, 8, 17)


def _decode_sweep(dk, cases, name, shape, call, want, keys, pairs):
    """Device ms of a bf16 decode kernel and its merge at each number of key
    tiles a split, then at the plan in use, each output held against
    ``want``; logged for the record and returned."""
    chosen, sweep = dk.DECODE_SPLIT_TILES, {}
    try:
        for tiles in DECODE_SWEEP_TILES:
            dk.DECODE_SPLIT_TILES = tiles
            compare(name, call(), want, "bfloat16", cases)
            splits = dk.decode_splits(keys, pairs)[0]
            sweep[f"{tiles} ({splits} splits)"] = device_ms(call)
    finally:
        dk.DECODE_SPLIT_TILES = chosen
    splits, tps = dk.decode_splits(keys, pairs)
    sweep[f"in use: {tps} ({splits} splits)"] = device_ms(call)
    log(f"{name} sweep at {shape} bf16: device ms by key tiles a split: "
        f"{json.dumps(sweep)}")
    return sweep


def _time_scalar(r, call):
    """The float32 (scalar) wrapper's event and device ms at the record's
    shape, beside the bf16 kernel's."""
    r["float32_ms"] = cuda_ms(call)
    r["float32_device_ms"] = device_ms(call)


def _check_flash(fk, cases, dtype_name, q, k, v, causal=True, window=0):
    """out and lse of the forward kernel against the plain version run in
    float32 on the same values. In bf16 the plain version rounds the
    softmax weights and its product to bf16 at other places than the
    kernel, which at outputs near 0 can put them two bf16 ulps apart,
    beyond the tolerance there (the first run of the tensor-core kernel
    failed one element of 4.2 M by 0.0156 so at S = 1024, as the scalar
    kernel once did at Zamba2's shapes); against the float32 values the
    kernel's error is its own rounding."""
    out, lse = fk.flash_attention_with_lse(q, k, v, causal=causal,
                                           window=window)
    want, want_lse = fk.flash_attention_with_lse_ref(
        q.float(), k.float(), v.float(), causal=causal, window=window)
    compare("flash_attention", out, want, dtype_name, cases)
    compare("flash_attention", lse, want_lse, dtype_name, cases)


def _check_verify(dk, cases, dtype_name, q, kp, vp, pos_t, bt):
    """The verify kernel against its plain version, and its row j against
    paged decode's plain version at pos + j, both plain versions run in
    float32 on the same values (in bf16 two rounded kernels held against
    each other would stack their roundings past the tolerance); returns
    the kernel's output."""
    got = dk.paged_verify_attention(q, kp, vp, pos_t, bt)
    qf, kf, vf = q.float(), kp.float(), vp.float()
    compare("paged_verify_attention", got,
            dk.paged_verify_attention_ref(qf, kf, vf, pos_t, bt), dtype_name,
            cases)
    for j in range(q.shape[1]):
        compare("paged_verify_attention", got[:, j],
                dk.paged_decode_attention_ref(qf[:, j].contiguous(), kf, vf,
                                              pos_t + j, bt), dtype_name,
                cases)
    return got


def _scan_case(B, NC, L, H, dk, dv, dtype, gen, decay=0.1):
    """qc, kc (B,NC,L,H,dk), vc (B,NC,L,H,dv) in ``dtype`` and cum
    (B,NC,L,H) float32 on the card: q and k scaled by dk^-1/4 so q·k is of
    unit size, decays as ``tests/test_kernels.py``'s (cumulative sums of
    −|N|·decay; 0.1 there, 5 in the steep case, where cum reaches −1000s
    and an unmasked exp(cum_t − cum_s) overflows)."""
    import torch
    dev = "cuda"
    s = dk ** -0.25
    qc = (torch.randn((B, NC, L, H, dk), generator=gen, device=dev) * s)
    kc = (torch.randn((B, NC, L, H, dk), generator=gen, device=dev) * s)
    vc = torch.randn((B, NC, L, H, dv), generator=gen, device=dev)
    logg = -torch.randn((B, NC, L, H), generator=gen,
                        device=dev).abs() * decay
    return (qc.to(dtype), kc.to(dtype), vc.to(dtype),
            torch.cumsum(logg, dim=2).contiguous())


def _check_scan(cs, cases, dtype_name, args):
    """The chunk scan against its plain version at ``SCAN_TOL``; the call
    must take the route ``tensor_core_route`` gives its dtype and widths
    (the tensor-core counter moves for that route only)."""
    qc, _, vc, _ = args
    tensor_cores = cs.tensor_core_route(qc.dtype, qc.shape[-1],
                                        vc.shape[-1])
    before = cs.chunk_scan.tensor_core_launches
    got = cs.chunk_scan(*args)
    took = cs.chunk_scan.tensor_core_launches - before
    if took != int(tensor_cores):
        raise AssertionError(
            f"chunk_scan {tuple(qc.shape)} dv={vc.shape[-1]} {qc.dtype}: "
            f"took the {'tensor-core' if took else 'scalar'} route, the rule "
            f"gives the {'tensor-core' if tensor_cores else 'scalar'} one")
    want = cs.chunk_scan_ref(*args)
    for g, w in zip(got, want):
        compare("chunk_scan", g, w, dtype_name, cases, tol=SCAN_TOL)


def _check_scan_exact(cs, dtype_name, args):
    """The chunk scan on operands whose float32 arithmetic is itself off
    by more than ``SCAN_TOL`` (the ssm path's own: random gates put cum
    in the −10⁴s and q·k sums of ~1e6-sized terms near 0, so the float32
    plain version lies up to ~130 from float64 there): the kernel and the
    float32 plain version are each held against the plain version in
    float64, per element, at ``SCAN_TOL`` plus the float32 error bound of
    the computation, γ_n times the same sums over absolute values (|q|·|k|,
    |v|; Higham's |fl(x·y) − x·y| ≤ γ_n |x|·|y|, γ_n = n u / (1 − n u), u =
    2⁻²⁴, n = dk + L + 2: the dot product, the sum over keys, the exp and
    the weight). The call must take ``tensor_core_route``'s route.
    Returns {"kernel"/"plain": (max abs err, largest share of the
    allowance)}."""
    import torch
    qc, _, vc, cum = args
    tensor_cores = cs.tensor_core_route(qc.dtype, qc.shape[-1],
                                        vc.shape[-1])
    before = cs.chunk_scan.tensor_core_launches
    got = cs.chunk_scan(*args)
    if cs.chunk_scan.tensor_core_launches - before != int(tensor_cores):
        raise AssertionError(f"chunk_scan {dtype_name}: not the route "
                             f"tensor_core_route gives")
    exact = cs.chunk_scan_ref(*(t.double() for t in args))
    mag = cs.chunk_scan_ref(*(t.double().abs() for t in args[:3]),
                            cum.double())
    n, u = qc.shape[-1] + qc.shape[2] + 2, 2.0 ** -24
    gamma = n * u / (1 - n * u)
    out = {}
    for who, res in (("kernel", got), ("plain", cs.chunk_scan_ref(*args))):
        err, share = 0.0, 0.0
        for g, w, m in zip(res, exact, mag):
            e = (g.double() - w).abs()
            bound = SCAN_TOL + SCAN_TOL * w.abs() + gamma * m
            err = max(err, e.max().item())
            share = max(share, (e / bound).max().item())
            if who == "kernel" and (not bool(torch.isfinite(g).all())
                                    or bool((e > bound).any())):
                raise AssertionError(
                    f"chunk_scan ({dtype_name}): {int((e > bound).sum())} "
                    f"elements beyond SCAN_TOL + γ_n·|terms| of float64 "
                    f"(max abs err {e.max().item():.3e})")
        out[who] = (err, share)
    return out


def _scan_parts(cs, cases, shapes, gen, timed):
    """Every part count of ``SCAN_PART_COUNTS`` on each bf16 tensor-core
    case of ``shapes`` ((B, NC, L, H, dk, dv, decay)): the largest error,
    the largest share of the allowance it used (|err| over SCAN_TOL +
    SCAN_TOL·|want|), and the device ms at ``timed``'s inputs. Counts from
    ``SCAN_PARTS`` up are held at ``SCAN_TOL``; fewer are recorded only.
    Returns {parts: {...}}."""
    import torch
    chosen, out = cs.SCAN_PARTS, {}
    try:
        for parts in SCAN_PART_COUNTS:
            cs.SCAN_PARTS = parts
            worst, share = 0.0, 0.0
            for B, NC, L, H, dk, dv, decay in shapes:
                args = _scan_case(B, NC, L, H, dk, dv, torch.bfloat16, gen,
                                  decay)
                got, want = cs.chunk_scan(*args), cs.chunk_scan_ref(*args)
                for g, w in zip(got, want):
                    err = (g - w).abs()
                    worst = max(worst, err.max().item())
                    share = max(share, (err / (SCAN_TOL + SCAN_TOL * w.abs()))
                                .max().item())
                    if parts >= chosen:
                        compare("chunk_scan", g, w, "bfloat16", cases,
                                tol=SCAN_TOL)
            out[parts] = {"max_abs_err": worst, "allowance_used": share,
                          "device_ms": device_ms(
                              lambda: cs.chunk_scan(*timed)),
                          "held": parts >= chosen}
    finally:
        cs.SCAN_PARTS = chosen
    log(f"chunk_scan by bf16 parts (in use: {chosen}) over {len(shapes)} "
        f"tensor-core cases: {json.dumps(out)}")
    return out


def _hybrid_kernel_cases(cases, rec, gen):
    """The chunk scan against its plain version (timed at the chunked
    prefill's shape), and the four attention kernels of the hybrid paths,
    and paged verify, at Zamba2's heads (MHA, H = KV = 32, dh = 80) at the
    main paths' other dimensions."""
    import numpy as np
    import torch
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    bf16, f32 = torch.bfloat16, torch.float32
    # -- chunk scan at Zamba2's shapes: one 256-position chunk (chunked
    #    prefill, timed) and the four chunks of a 1024-token monolithic
    #    prefill; bf16 (tensor cores) then float32 (scalar)
    H, N, P, L = 32, 64, 160, 256
    timed = _scan_case(1, 1, L, H, N, P, bf16, gen)
    for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
        for NC in (1, 4):
            _check_scan(cs, cases, name, timed if dtype is bf16 and NC == 1
                        else _scan_case(1, NC, L, H, N, P, dtype, gen))
    pairs = L * (L + 1) // 2
    rec["chunk_scan"] = {
        "shape": f"B=1 NC=1 L={L} H={H} dk={N} dv={P} bf16",
        "ms": cuda_ms(lambda: cs.chunk_scan(*timed)),
        "device_ms": device_ms(lambda: cs.chunk_scan(*timed)),
        "plain_ms": cuda_ms(lambda: cs.chunk_scan_ref(*timed)),
        "library_ms": None,   # no single PyTorch call computes it
        "bytes": L * H * (2 * N * 2 + P * 2 + 4 + P * 4) + H * N * P * 4,
        # the causal q·k and P·v products and the dk x dv summary that the
        # function needs, at the rate of its inputs' type
        "flops": H * (pairs * 2 * (N + P) + 2 * L * N * P),
        "dtype": "bfloat16", "tol": SCAN_TOL}
    timed_f32 = _up(*timed)
    _time_scalar(rec["chunk_scan"], lambda: cs.chunk_scan(*timed_f32))
    # bf16 shapes of the tensor-core route: the smoke config's L = 16, dk !=
    # dv, ragged rows and keys, B > 1 and NC > 1, dk past one slab with dv
    # cut into two column slices, dk and dv not multiples of 16, the steep
    # decay (cum reaches -1000s: masked pairs must never reach the exp) and
    # the slow one (a long-memory head: all 256 terms of unit size, where
    # P's rounding adds up most); (B, NC, L, H, dk, dv, decay)
    tc_scan = [
        (1, 2, 16, 4, 16, 16, 0.1),
        (2, 3, 32, 4, 16, 48, 0.1),
        (1, 2, 100, 2, 16, 24, 0.1),
        (2, 3, 64, 4, 32, 32, 0.1),
        (1, 1, 192, 2, 128, 200, 0.1),
        (1, 1, 64, 2, 24, 72, 0.1),
        (1, 1, L, H, N, P, 5.0),
        (1, 4, L, H, N, P, 0.001),
    ]
    for B, NC, Ls, Hh, dkk, dvv, decay in tc_scan:
        _check_scan(cs, cases, "bfloat16",
                    _scan_case(B, NC, Ls, Hh, dkk, dvv, bf16, gen, decay))
    rec["chunk_scan"]["parts"] = _scan_parts(
        cs, cases, [(1, 1, L, H, N, P, 0.1), (1, 4, L, H, N, P, 0.1)]
        + tc_scan, gen, timed)
    # the scalar route: float32 at every edge (the wide tensor-core
    # kernel's bf16 edges are _mlstm_scan_cases')
    edge_scan = [
        # B, NC, L, H, dk, dv
        (1, 2, 16, 4, 16, 16),        # L = 16, the smoke config's chunk
        (2, 3, 32, 4, 16, 48),        # dk != dv
        (1, 1, 128, 2, 64, 65),       # odd dv
        (1, 2, 100, 2, 16, 24),       # ragged row and key tiles
        (1, 1, 256, 4, 384, 385),     # mLSTM's full-width shape
        (2, 3, 64, 4, 32, 32),        # B > 1, NC > 1
    ]
    for B, NC, Ls, Hh, dkk, dvv in edge_scan:
        _check_scan(cs, cases, "float32",
                    _scan_case(B, NC, Ls, Hh, dkk, dvv, f32, gen))

    # -- the attention kernels at Zamba2's heads. The plain versions run in
    #    float32 on the same (bf16) input values: in bf16 they round the
    #    softmax weights before the PV product, which at outputs near 0 can
    #    put them further from the exact value than the bf16 tolerance
    #    allows there (the first run of these shapes failed one flash
    #    element by 0.0156 so). Against the float32 values the kernel's
    #    error is its one rounding of the output to bf16.
    H = KV = 32
    dh, block = 80, 16
    pos = np.random.default_rng(4).integers(200, 64 * block, 8)
    pos[0] = 64 * block - 1

    for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
        args = _paged_case(8, 64, block, H, KV, dh, pos.tolist(), dtype, gen)
        compare("paged_decode_attention", dk.paged_decode_attention(*args),
                dk.paged_decode_attention_ref(*_up(*args)), name, cases)
        q, kp, vp, start, bt = _chunk_case(256, 48, block, H, KV, dh, 512,
                                           dtype, gen)
        compare("chunk_prefill_attention",
                dk.chunk_prefill_attention(q, kp, vp, start, bt),
                dk.chunk_prefill_attention_ref(*_up(q, kp, vp), start, bt),
                name, cases)
        for S in (1024, 702):
            _check_flash(fk, cases, name, *_flash_case(1, S, H, KV, dh,
                                                       dtype, gen))
        args = _decode_case(8, 1088, H, KV, dh,
                            [1087, 300, 702, 1023, 256, 999, 500, 1024],
                            dtype, gen)
        compare("decode_attention", dk.decode_attention(*args),
                dk.decode_attention_ref(*_up(*args)), name, cases)
        _check_verify(dk, cases, name, *_verify_case(
            8, 64, block, SPEC_LEN, H, KV, dh,
            [64 * block - SPEC_LEN, 250, 701, 1000, 300, 999, 512, 900],
            dtype, gen))

    # -- the bf16 decode kernels' split plan at the hybrid path's shape:
    #    8 slots of MHA heads (256 (slot, KV head) pairs) over the main
    #    path's table (NB = 68) and over cache rows of the same 1088
    #    positions, with SDPA's device ms on the gathered paged KV
    S = 68 * block
    pos68 = np.random.default_rng(7).integers(200, S, 8)
    pos68[0] = S - 1
    args = _paged_case(8, 68, block, H, KV, dh, pos68.tolist(), bf16, gen)
    shape = f"B=8 H={H} KV={KV} dh={dh}"
    _decode_sweep(dk, cases, "paged_decode_attention",
                  f"{shape} block={block} NB=68",
                  lambda: dk.paged_decode_attention(*args),
                  dk.paged_decode_attention_ref(*_up(*args)), S, 8 * KV)
    q, kp, vp, pos_t, bt = args
    kf, vf = (t[bt.long()].reshape(8, S, KV, dh).permute(0, 2, 1, 3)
              .contiguous() for t in (kp, vp))
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos_t[:, None].long())[:, None, None, :]
    sdpa = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kf, vf, attn_mask=mask))
    log(f"paged_decode_attention at {shape} block={block} NB=68 bf16: SDPA "
        f"on the gathered KV, device ms {sdpa}")
    args = _decode_case(8, S, H, KV, dh, pos68.tolist(), bf16, gen)
    _decode_sweep(dk, cases, "decode_attention", f"{shape} S={S}",
                  lambda: dk.decode_attention(*args),
                  dk.decode_attention_ref(*_up(*args)), S, 8 * KV)


def _mlstm_scan_cases(cases, rec, gen):
    """The chunk scan at mLSTM's widths (``MLSTM_SCAN``: one 256-position
    chunk of the ssm path's chunked prefill, dk = 384, dv = 385 with the
    ones channel): bf16 on the tensor cores' wide kernel (V through
    registers, K a slab at a time) and float32 on the scalar kernels, each
    against its plain version at ``SCAN_TOL`` — at that shape and at the
    wide kernel's edges (odd dv, ragged L, NC > 1, the mixture's B = 2,
    dk of three and four slabs, the steep and the slow decay, dk at
    ``TC_MAX_DK``), each in both dtypes. At mLSTM's shape each dtype's ms,
    device ms, plain ms and bound (the bytes of its inputs and outputs
    over the HBM rate, the causal q·k and P·v products and the dk × dv
    summary over the peak rate of its inputs' type) are kept in the
    record's ``new_config_shapes``."""
    import torch
    from repro_torch.kernels import chunk_scan as cs

    L, H, dk, dv = MLSTM_SCAN
    wide_scan = [
        # B, NC, L, H, dk, dv, decay
        (1, 1, 128, 2, 64, 65, 0.1),            # odd dv
        (1, 1, 200, H, dk, dv, 0.1),            # ragged L
        (1, 3, L, H, dk, dv, 0.1),              # NC > 1
        (2, 1, L, H, dk, dv, 0.1),              # B = 2: the mixture's
        (1, 1, L, 2, 192, dv, 0.1),             # dk of three slabs
        (1, 1, L, 2, 256, dv, 0.1),             # dk of four slabs
        (1, 1, L, H, dk, dv, 5.0),              # steep decay
        (1, 1, L, H, dk, dv, 0.001),            # slow decay
        (1, 1, 64, 1, cs.TC_MAX_DK, 24, 0.1),   # dk at the route's limit
    ]
    for B, NC, Ls, Hh, dkk, dvv, decay in wide_scan:
        # (float32 at dk = TC_MAX_DK: the scalar kernels' tiles pass a
        # block's shared memory, and the wrapper refuses the shape)
        for dtype, name in ((torch.bfloat16, "bfloat16"),
                            (torch.float32, "float32"))[
                                :1 if dkk == cs.TC_MAX_DK else 2]:
            _check_scan(cs, cases, name, _scan_case(B, NC, Ls, Hh, dkk, dvv,
                                                    dtype, gen, decay))
    flops = H * (L * (L + 1) // 2 * 2 * (dk + dv) + 2 * L * dk * dv)
    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        args = _scan_case(1, 1, L, H, dk, dv, dtype, gen)
        _check_scan(cs, cases, name, args)
        es = args[0].element_size()
        nbytes = L * H * (2 * dk * es + dv * es + 4 + dv * 4) \
            + H * dk * dv * 4
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        entry = {
            "config": f"{SSM_ARCH} (mLSTM)",
            "shape": f"B=1 NC=1 L={L} H={H} dk={dk} dv={dv}",
            "dtype": name, "route": "tensor cores" if cs.tensor_core_route(
                dtype, dk, dv) else "scalar",
            "max_abs_err": max(c["max_abs_err"] for c in cases[-2:]),
            "ms": cuda_ms(lambda a=args: cs.chunk_scan(*a)),
            "device_ms": device_ms(lambda a=args: cs.chunk_scan(*a)),
            "plain_ms": cuda_ms(lambda a=args: cs.chunk_scan_ref(*a)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        rec["chunk_scan"].setdefault("new_config_shapes", []).append(entry)
        log(f"new-shape case chunk_scan {entry['config']} {entry['shape']} "
            f"{name} ({entry['route']} route): max abs err "
            f"{entry['max_abs_err']:.3e}, ms {entry['ms']:.4f}, device ms "
            f"{entry['device_ms']}, plain {entry['plain_ms']:.4f} ms, bound "
            f"{entry['bound_ms']:.4f} by {entry['bound_by']}")


def _router_bound(B, D, K):
    """(bytes, operations) of Eq. 28 on x (B, D) and K centroids in
    float32: x, the centroids and the output each moved once; per row the
    K dot products, |x|^2 and the softmax, and the centroid norms once."""
    return ((B * D + K * D + B * K) * 4,
            B * (2 * K * D + 2 * D + 6 * K) + 2 * K * D)


def _mixture_kernel_cases(cases, rec, gen):
    """The kernels the Eq. 27 mixture changed, at its path's shapes: chunk
    prefill with a batch axis (B = 2, one chunk per expert at one start,
    each through its own table row) at Qwen3-8B's and Zamba2's heads, in
    bf16 and float32, against the plain version, with the B = 2 call timed
    beside the B = 1 row; paged decode as a stacked decode step launches
    it (2 experts' pools as one of 2·P pages, 8 shared slot tables offset
    by ``Model._expert_tables``: 16 rows) at the same heads and dtypes,
    the bf16 call at Qwen3-8B's heads timed; the redesigned router at the
    path's shape (D = 32, K = 2, float32) for B = 1, 16 and 65536, timed
    at each (device ms and bound), and at its edges (K = 6, D = 64; bf16;
    D not a multiple of a 16-byte load; unaligned rows; rows past B in a
    warp; a lane a row; K·D past the shared-memory budget, so staged in
    slabs of D; K past one chunk of centroids, past a row's lanes and
    past 32 lanes); and the card's floor for one launch in a graph, an
    in-place add on a one-element tensor."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import SyntheticConfig
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import router_scores as rk

    bf16, f32 = torch.bfloat16, torch.float32
    block, C, NB, start, B = 16, 256, 48, 512, 2
    for H, KV, dh in ((32, 8, 128), (32, 32, 80)):
        for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
            P = B * NB + 1
            q = torch.randn((B, C, H, dh), generator=gen,
                            device="cuda").to(dtype)
            kp, vp = (torch.randn((P, block, KV, dh), generator=gen,
                                  device="cuda").to(dtype) for _ in range(2))
            bt = (torch.randperm(P - 1, generator=gen, device="cuda")[
                :B * NB] + 1).reshape(B, NB).to(torch.int32).contiguous()
            got = dk.chunk_prefill_attention(q, kp, vp, start, bt)
            compare("chunk_prefill_attention", got,
                    dk.chunk_prefill_attention_ref(*_up(q, kp, vp), start,
                                                   bt), name, cases)
            if dtype is bf16 and dh == 128:
                S = start + C
                keys = sum(start + c + 1 for c in range(C))
                nbytes = B * (2 * C * H * dh * 2 + S * KV * dh * 2 * 2
                              + (S // block) * 4)
                rec["chunk_prefill_attention"]["batched"] = {
                    "shape": f"B={B} C={C} start={start} H={H} KV={KV} "
                             f"dh={dh} block={block} NB={NB} bf16",
                    "device_ms": device_ms(lambda: dk.chunk_prefill_attention(
                        q, kp, vp, start, bt)),
                    "bound_ms": max(nbytes / HBM_BPS, B * 4 * H * dh * keys
                                    / PEAK_FLOPS["bfloat16"]) * 1e3}
    log(f"chunk_prefill_attention batched: "
        f"{json.dumps(rec['chunk_prefill_attention']['batched'])}")

    # -- paged decode as a stacked decode step launches it: K = 2 experts'
    #    pools viewed as one pool of K·P pages, the 8 slots' shared tables
    #    offset by k·P for expert k (Model._expert_tables), K·B = 16 rows
    #    (scratch entries past a slot's horizon land on expert k's page
    #    k·P), at Qwen3-8B's and Zamba2's heads
    from repro_torch.models.model import Model
    Kx, Bs, NB = 2, 8, 64
    pos = np.random.default_rng(8).integers(200, NB * block, Bs).tolist()
    pos[0] = NB * block - 1
    for H, KV, dh in ((32, 8, 128), (32, 32, 80)):
        for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
            _, kp0, vp0, pos_t, bt = _paged_case(Bs, NB, block, H, KV, dh,
                                                 pos, dtype, gen)
            _, kp1, vp1, _, _ = _paged_case(Bs, NB, block, H, KV, dh, pos,
                                            dtype, gen)
            kp, vp = torch.stack([kp0, kp1]), torch.stack([vp0, vp1])
            tables = Model._expert_tables(bt, kp[None], Kx)
            q = torch.randn((Kx * Bs, H, dh), generator=gen,
                            device="cuda").to(dtype)
            args = (q, kp.flatten(0, 1), vp.flatten(0, 1),
                    pos_t.repeat(Kx), tables)
            compare("paged_decode_attention", dk.paged_decode_attention(*args),
                    dk.paged_decode_attention_ref(*_up(*args)), name, cases)
            if dtype is bf16 and dh == 128:
                keys = Kx * sum(p + 1 for p in pos)
                nbytes = (2 * Kx * Bs * H * dh * 2 + keys * KV * dh * 2 * 2
                          + Kx * Bs * NB * 4)
                rec["paged_decode_attention"]["batched"] = {
                    "shape": f"K={Kx} experts x B={Bs} slots H={H} KV={KV} "
                             f"dh={dh} block={block} NB={NB} bf16, tables "
                             f"offset by k*P",
                    "device_ms": device_ms(
                        lambda: dk.paged_decode_attention(*args)),
                    "bound_ms": max(nbytes / HBM_BPS, 4 * H * dh * keys
                                    / PEAK_FLOPS["bfloat16"]) * 1e3}
    log(f"paged_decode_attention batched: "
        f"{json.dumps(rec['paged_decode_attention']['batched'])}")

    D, K = SyntheticConfig().feature_dim, 2
    cent = torch.randn((K, D), generator=gen, device="cuda")
    by_b = {}
    for Bx in (16, 65536, 1):
        x = torch.randn((Bx, D), generator=gen, device="cuda")
        compare("router_scores", rk.router_scores(x, cent, 10.0),
                rk.router_scores_ref(x, cent, 10.0), "float32", cases)
        nbytes, flops = _router_bound(Bx, D, K)
        by_b[Bx] = {"plan (warps, span, slab, vec)":
                    rk.router_plan(Bx, D, K, 4),
                    "device_ms": device_ms(
                        lambda: rk.router_scores(x, cent, 10.0)),
                    "bound_ms": max(nbytes / HBM_BPS,
                                    flops / PEAK_FLOPS["float32"]) * 1e3}
    one = torch.zeros(1, device="cuda")
    floor = device_ms(lambda: one.add_(1.0))
    nbytes, flops = _router_bound(1, D, K)
    rec["router_scores"] = {
        "shape": f"B=1 D={D} K={K} f32",
        "ms": cuda_ms(lambda: rk.router_scores(x, cent, 10.0), iters=100),
        "device_ms": by_b[1]["device_ms"],
        "plain_ms": cuda_ms(lambda: rk.router_scores_ref(x, cent, 10.0),
                            iters=100),
        "library_ms": None,   # no single PyTorch call computes Eq. 28
        "bytes": nbytes, "flops": flops, "dtype": "float32",
        "by_batch": by_b, "launch_floor_device_ms": floor}
    log(f"router_scores by batch at D={D} K={K} f32: {json.dumps(by_b)}; "
        f"the launch floor (an in-place add on one element, in a graph): "
        f"device ms {floor}")
    edges = [
        # B, D, K, dtype, offset (elements) of x's first row
        (100, 64, 6, f32, 0),
        (8, 32, 2, bf16, 0),
        (9, 64, 6, bf16, 0),
        (5, 33, 3, f32, 0),
        (5, 32, 2, f32, 1),
        (5, 32, 2, f32, 0),
        (40, 4, 3, f32, 0),
        (6, 32, 12, f32, 0),
        (12, 8192, 8, f32, 0),
        (3, 5000, 4, bf16, 0),
        (7, 64, 9, f32, 0),
        (5, 96, 40, f32, 0),
    ]
    for Bx, Dx, Kx, dtype, offset in edges:
        flat = torch.randn(Bx * Dx + offset, generator=gen, device="cuda")
        x = flat[offset:].view(Bx, Dx).to(dtype)
        c = torch.randn((Kx, Dx), generator=gen, device="cuda").to(dtype)
        name = "float32" if dtype is f32 else "bfloat16"
        compare("router_scores", rk.router_scores(x, c, 10.0),
                rk.router_scores_ref(x.float(), c.float(), 10.0), name,
                cases)


def _speculation_kernel_cases(cases, rec, gen):
    """Paged verify as the mixture's stacked verify launches it: K = 2
    experts' pools viewed as one pool of K·P pages, the 8 slots' shared
    tables offset by k·P (``Model._expert_tables``), K·B = 16 span rows of
    ``SPEC_LEN`` at Qwen3-8B's heads, in bf16 and float32, against the
    plain version run in float32 (and each row against paged decode's plain
    version at pos + j); the bf16 call timed in device ms beside its bound
    (each expert's keys read once: about twice the single-model row's)."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.models.model import Model

    Kx, Bs, NB, block, L, H, KV, dh = 2, 8, 64, 16, SPEC_LEN, 32, 8, 128
    pos = np.random.default_rng(9).integers(200, NB * block - L + 1, Bs)
    pos[0] = NB * block - L
    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        _, kp0, vp0, pos_t, bt = _verify_case(Bs, NB, block, L, H, KV, dh,
                                              pos.tolist(), dtype, gen)
        _, kp1, vp1, _, _ = _verify_case(Bs, NB, block, L, H, KV, dh,
                                         pos.tolist(), dtype, gen)
        kp, vp = torch.stack([kp0, kp1]), torch.stack([vp0, vp1])
        tables = Model._expert_tables(bt, kp[None], Kx)
        q = torch.randn((Kx * Bs, L, H, dh), generator=gen,
                        device="cuda").to(dtype)
        args = (q, kp.flatten(0, 1), vp.flatten(0, 1), pos_t.repeat(Kx),
                tables)
        _check_verify(dk, cases, name, *args)
        if dtype is torch.bfloat16:
            keys = Kx * int((pos + L).sum())
            pairs = Kx * int(sum(p * L + L * (L + 1) // 2 for p in pos))
            live = Kx * int(((pos + L - 1) // block + 1).sum())
            nbytes = (2 * Kx * Bs * L * H * dh * 2 + keys * KV * dh * 2 * 2
                      + Kx * Bs * 4 + live * 4)
            t_bytes = nbytes / HBM_BPS * 1e3
            t_ops = 4 * H * dh * pairs / PEAK_FLOPS["bfloat16"] * 1e3
            rec["paged_verify_attention"]["batched"] = {
                "shape": f"K={Kx} experts x B={Bs} slots L={L} H={H} "
                         f"KV={KV} dh={dh} block={block} NB={NB} bf16, "
                         f"tables offset by k*P",
                "device_ms": device_ms(
                    lambda: dk.paged_verify_attention(*args)),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log(f"paged_verify_attention batched: "
        f"{json.dumps(rec['paged_verify_attention']['batched'])}")


#: (seed, count) pairs whose threefry keys, bits and uniforms the card
#: must reproduce bit for bit
PRNG_CASES = ((0, 0), (123, 3), (7, 31), (2**32 - 1, 2**31 - 1),
              (2**31, 2**31 - 1))


def _sampling_bits_cases():
    """Seeded sampling's random numbers at Qwen3-8B's vocabulary (V =
    151936) for ``PRNG_CASES``: the card's keys, 32-bit words and float32
    uniforms must equal the CPU's bit for bit; and the sampler at the
    speculative verify's shape (8 slots x ``SPEC_LEN`` rows) timed, for the
    record."""
    import torch
    from repro_torch.core import prng
    from repro_torch.serve import fused

    V = 151936
    seeds = torch.tensor([s for s, _ in PRNG_CASES], dtype=torch.int64)
    counts = torch.tensor([c for _, c in PRNG_CASES], dtype=torch.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        key = prng.fold_in(prng.threefry_seed(seeds.to(dev)),
                           counts.to(dev))
        bits = prng.random_bits(key, V)
        out[dev] = [t.cpu() for t in (*key, bits,
                                      prng.uniform(bits).view(torch.int32))]
    for name, a, b in zip(("key0", "key1", "bits", "uniform bits"),
                          out["cuda"], out["cpu"]):
        if not torch.equal(a, b):
            raise AssertionError(
                f"seeded sampling: {name} differ between the card and the "
                f"CPU at V={V} for (seed, count) {PRNG_CASES}")
    R = 8 * SPEC_LEN
    gen = torch.Generator(device="cuda").manual_seed(5)
    scores = torch.randn((R, V), generator=gen, device="cuda")
    temps = torch.full((R,), 0.8, device="cuda")
    top_ks = torch.full((R,), 50, dtype=torch.int32, device="cuda")
    sd = torch.arange(R, dtype=torch.int64, device="cuda")
    ct = torch.zeros(R, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: fused._sample_tokens(scores, temps, top_ks, sd, ct))
    log(f"seeded sampling: threefry keys, random bits and uniforms at "
        f"V={V} bit-equal on the card and the CPU for (seed, count) "
        f"{list(PRNG_CASES)}; the sampler (torch ops) at {R} rows x {V}: "
        f"{ms:.3f} ms (events)")


def _check_flash_bwd(fk, fbk, cases, dtype_name, q, k, v, do, causal=True,
                     window=0):
    """The backward kernel against its plain version on the same q, k, v,
    do and the forward kernel's out and lse; returns those."""
    out, lse = fk.flash_attention_with_lse(q, k, v, causal=causal,
                                           window=window)
    got = fbk.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                  window=window)
    want = fbk.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                       window=window)
    for g, w in zip(got, want):
        compare("flash_attention_bwd", g, w, dtype_name, cases)
    return out, lse


def _sdpa_flash_bwd_device_ms(q, k, v, do):
    """Device ms of SDPA's flash-backend backward on these heads-first
    causal operands, called as its aten op so that its launches land on
    the capturing stream (autograd would launch them on the forward's).
    None, with the reason printed, where the op refuses the operands."""
    import torch
    aten = torch.ops.aten
    q, k, v, do = (t.detach() for t in (q, k, v, do))
    try:
        out, lse, cq, ck, mq, mk, seed, offset, _ = \
            aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True)
    except RuntimeError as e:
        log(f"SDPA's flash backward: not measured ({e})")
        return None
    return device_ms(
        lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, True, seed, offset),
        iters=5)


def _training_kernel_cases(cases, rec, gen):
    """The flash-attention forward and backward against their plain
    versions at the training path's shape (one 4096-token sequence of
    Qwen3-8B heads, causal; bf16, timed, then float32) and the backward at
    the contiguous path's and Zamba2's prefill shapes and at edge shapes,
    in both dtypes. The forward is held on its own at the
    training shape because the backward's check feeds the forward kernel's
    out and lse to both sides, where a wrong forward would cancel."""
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as fbk

    bf16, f32 = torch.bfloat16, torch.float32
    B, S, H, KV, dh = 1, 4096, 32, 8, 128
    for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
        q, k, v = _flash_case(B, S, H, KV, dh, dtype, gen)
        do = torch.randn((B, S, H, dh), generator=gen, device="cuda") \
            .to(dtype)
        _check_flash(fk, cases, name, q, k, v)
        out, lse = _check_flash_bwd(fk, fbk, cases, name, q, k, v, do)
        if dtype is not bf16:
            continue
        # the library call: SDPA's backward on the same values, heads
        # first and K/V repeated to H outside the timing
        qh, kh, vh = (_heads_first(t, g).requires_grad_() for t, g in
                      ((q, 1), (k, H // KV), (v, H // KV)))
        oh = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)
        doh = _heads_first(do, 1)
        pairs = S * (S + 1) // 2
        rec["flash_attention_bwd"] = {
            "shape": f"B={B} S={S} H={H} KV={KV} dh={dh} causal bf16",
            "ms": cuda_ms(lambda: fbk.flash_attention_bwd(
                q, k, v, out, lse, do), iters=5, warmup=1),
            "device_ms": device_ms(lambda: fbk.flash_attention_bwd(
                q, k, v, out, lse, do), iters=5),
            "plain_ms": cuda_ms(lambda: fbk.flash_attention_bwd_ref(
                q, k, v, out, lse, do), iters=5, warmup=1),
            "library_ms": cuda_ms(lambda: torch.autograd.grad(
                oh, (qh, kh, vh), doh, retain_graph=True), iters=5,
                warmup=1),
            # autograd launches SDPA's backward (cuDNN's on this card) on
            # the streams its forward and leaves were made on, not the
            # capturing one, and the capture is invalidated: no device ms
            # for it. SDPA's flash backend's backward, called as its aten
            # op, is graphed instead
            "library_device_ms": None,
            "library_flash_device_ms": _sdpa_flash_bwd_device_ms(
                qh, kh, vh, doh),
            # q, out, do, k, v and lse read; dq, dk, dv written
            "bytes": (4 * B * S * H * dh + 4 * B * S * KV * dh) * 2
            + B * S * H * 4,
            # s = q·kᵀ, dp = do·vᵀ, dv, dk and dq: five causal products
            "flops": 10 * B * H * dh * pairs, "dtype": "bfloat16"}
        del qh, kh, vh, oh, doh
        fwd_ms = cuda_ms(lambda: fk.flash_attention_with_lse(q, k, v),
                         iters=5, warmup=1)
        qh, kh, vh = (_heads_first(t, g) for t, g in
                      ((q, 1), (k, H // KV), (v, H // KV)))
        sdpa_ms = cuda_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(qh, kh, vh,
                                                        is_causal=True),
                          iters=5, warmup=1)
        del qh, kh, vh
        log(f"kernel flash_attention at the training shape: B={B} S={S} "
            f"H={H} KV={KV} dh={dh} causal bf16: {fwd_ms:.4f} ms (library "
            f"{sdpa_ms:.4f}: SDPA, causal)")
    edge = [
        # B, S, H, KV, dh, causal, window
        (1, 1024, 32, 8, 128, True, 0),     # the contiguous path's prompts,
        (1, 777, 32, 8, 128, True, 0),      # where the forward is held too
        (1, 1024, 32, 32, 80, True, 0),     # Zamba2's shared block at its
        (1, 702, 32, 32, 80, True, 0),      # prefill widths
        (1, 1, 4, 2, 64, True, 0),          # one position
        (2, 77, 8, 2, 64, True, 0),         # ragged last key tile, B > 1
        (1, 200, 4, 1, 128, True, 0),       # MQA
        (1, 150, 8, 8, 64, False, 0),       # MHA, not causal
        (1, 300, 8, 2, 64, True, 50),       # window across key tiles
        (2, 64, 4, 4, 32, True, 16),        # window inside one key tile
        (1, 333, 32, 32, 80, True, 0),      # Zamba2's shared block, dh 80
        (3, 129, 8, 2, 128, True, 0),       # B > 1, one key past a tile
        (1, 100, 6, 2, 40, True, 0),        # dh 40, a group of 3
    ]
    for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
        for B, S, H, KV, dh, causal, window in edge:
            q, k, v = _flash_case(B, S, H, KV, dh, dtype, gen)
            do = torch.randn((B, S, H, dh), generator=gen, device="cuda") \
                .to(dtype)
            _check_flash_bwd(fk, fbk, cases, name, q, k, v, do, causal,
                             window)


# the heads of the configs the vlm and dense-config paths serve at full
# width, (config, H, KV, dh), and the smoke configs' new head sizes
NEW_CONFIG_HEADS = (("internvl2_2b", 16, 8, 128),
                    ("phi3_medium_14b", 40, 10, 128),
                    ("llama3_405b", 128, 8, 128))
NEW_SMOKE_HEADS = (("phi3 smoke", 4, 2, 40), ("llama3 smoke", 4, 2, 64))
# the vlm main path's rows: 1024 text positions + 256 prefix + 64 new
VLM_CACHE_LEN = 1344
# the moe configs' heads at full width: DeepSeek-MoE-16B's MHA, 16/16, and
# Qwen3-MoE-235B-A22B's 64/4 (16 query heads a KV head, qk-norm), dh 128;
# held at the main path's rows, 1024 prompt positions + 64 new
MOE_HEADS = (("deepseek_moe_16b", 16, 16, 128),
             ("qwen3_moe_235b_a22b", 64, 4, 128))
MOE_CACHE_LEN = 1088


def _new_shape_case(cases, rec, kernel, config, shape, dtype_name, call,
                    want, nbytes, flops):
    """``call()`` against ``want`` at the tolerance of ``dtype_name``,
    then its device ms beside its bound (``nbytes`` over the HBM rate,
    ``flops`` over the dtype's peak), kept in the kernel's record under
    ``new_config_shapes``."""
    compare(kernel, call(), want, dtype_name, cases)
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    rec[kernel].setdefault("new_config_shapes", []).append({
        "config": config, "shape": shape,
        "dtype": dtype_name, "max_abs_err": cases[-1]["max_abs_err"],
        "device_ms": device_ms(call), "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations"})


def _new_config_kernel_cases(cases, rec, gen, full_heads=NEW_CONFIG_HEADS,
                             smoke_heads=NEW_SMOKE_HEADS,
                             cache_len=VLM_CACHE_LEN):
    """Kernels 1, 2, 4, 5 and 6 (paged decode, chunk prefill, flash,
    paged verify, contiguous decode) at the heads of InternVL2-2B (16/8),
    Phi-3-medium (40/10) and Llama-3-405B (128/8), dh 128, at the vlm main
    path's dimensions, in bf16 and float32, each against its plain version
    run in float32 on the same values and timed beside its bound: 8 slots
    over 84 blocks of 16 (cache_len 1344), a 256-row chunk at position 0
    (all image prefix) and a ragged 100-row chunk after it, flash over a
    ragged S = 256 + 777, spans of ``SPEC_LEN``, contiguous rows of 1344.
    Then the smoke configs' dh 40 and 64 at small shapes, and the flash
    backward at the new heads. ``full_heads``, ``smoke_heads`` and
    ``cache_len`` take other configs' heads at another path's rows (the
    moe configs': ``MOE_HEADS`` at the main path's 1088)."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as fbk

    bf16, f32 = torch.bfloat16, torch.float32
    block, B, L = 16, 8, SPEC_LEN
    NB = cache_len // block
    rng = np.random.default_rng(23)
    pos = rng.integers(256, cache_len, B)
    pos[0] = cache_len - 1
    vpos = rng.integers(256, cache_len - L + 1, B)
    vpos[0] = cache_len - L
    heads = [(c, H, KV, dh, True) for c, H, KV, dh in full_heads] \
        + [(c, H, KV, dh, False) for c, H, KV, dh in smoke_heads]
    names = {c for c, *_ in heads}
    for config, H, KV, dh, full in heads:
        for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
            es = 2 if dtype is bf16 else 4
            hd = f"H={H} KV={KV} dh={dh}"
            # paged decode
            nb = NB if full else 8
            p = pos if full else np.array([0, 60, 127])
            args = _paged_case(len(p), nb, block, H, KV, dh, p.tolist(),
                               dtype, gen)
            keys, live = int((p + 1).sum()), int((p // block + 1).sum())
            _new_shape_case(
                cases, rec, "paged_decode_attention", config,
                f"B={len(p)} {hd} block={block} NB={nb}", name,
                lambda: dk.paged_decode_attention(*args),
                dk.paged_decode_attention_ref(*_up(*args)),
                2 * len(p) * H * dh * es + keys * KV * dh * 2 * es
                + len(p) * 4 + live * 4, 4 * H * dh * keys)
            # chunk prefill: the image prefix's chunk, then a ragged one
            for C, start in (((256, 0), (100, 256)) if full
                             else ((40, 0), (13, 40))):
                q, kp, vp, start, bt = _chunk_case(C, nb, block, H, KV, dh,
                                                   start, dtype, gen)
                S = start + C
                _new_shape_case(
                    cases, rec, "chunk_prefill_attention", config,
                    f"C={C} start={start} {hd} block={block}", name,
                    lambda: dk.chunk_prefill_attention(q, kp, vp, start,
                                                       bt),
                    dk.chunk_prefill_attention_ref(*_up(q, kp, vp), start,
                                                   bt),
                    2 * C * H * dh * es + S * KV * dh * 2 * es
                    + -(-S // block) * 4,
                    4 * H * dh * sum(start + c + 1 for c in range(C)))
            # flash, ragged S (the vlm's 256 prefix rows and a prompt)
            S = 256 + 777 if full else 77
            q, k, v = _flash_case(1, S, H, KV, dh, dtype, gen)
            want, want_lse = fk.flash_attention_with_lse_ref(*_up(q, k, v))
            compare("flash_attention", fk.flash_attention_with_lse(
                q, k, v)[1], want_lse, name, cases)
            _new_shape_case(
                cases, rec, "flash_attention", config,
                f"B=1 S={S} {hd} causal",
                name, lambda: fk.flash_attention_with_lse(q, k, v)[0], want,
                (2 * S * H * dh + 2 * S * KV * dh) * es + S * H * 4,
                4 * H * dh * S * (S + 1) // 2)
            # paged verify, and each row against paged decode at pos + j
            vp_ = vpos if full else np.array([5, 60, 124])
            args = _verify_case(len(vp_), nb, block, L, H, KV, dh,
                                vp_.tolist(), dtype, gen)
            _check_verify(dk, cases, name, *args)
            keys = int((vp_ + L).sum())
            live = int(((vp_ + L - 1) // block + 1).sum())
            pairs = int(sum(x * L + L * (L + 1) // 2 for x in vp_))
            _new_shape_case(
                cases, rec, "paged_verify_attention", config,
                f"B={len(vp_)} L={L} {hd} block={block} NB={nb}", name,
                lambda: dk.paged_verify_attention(*args),
                dk.paged_verify_attention_ref(*_up(*args)),
                2 * len(vp_) * L * H * dh * es + keys * KV * dh * 2 * es
                + len(vp_) * 4 + live * 4, 4 * H * dh * pairs)
            # contiguous decode over the path's rows
            S = cache_len if full else 128
            args = _decode_case(len(p), S, H, KV, dh, p.tolist(), dtype,
                                gen)
            keys = int((p + 1).sum())
            _new_shape_case(
                cases, rec, "decode_attention", config,
                f"B={len(p)} S={S} {hd}",
                name, lambda: dk.decode_attention(*args),
                dk.decode_attention_ref(*_up(*args)),
                2 * len(p) * H * dh * es + keys * KV * dh * 2 * es
                + len(p) * 4, 4 * H * dh * keys)
            # the flash backward (vlm and dense-config training)
            Sb = 333 if full else 77
            q, k, v = _flash_case(1, Sb, H, KV, dh, dtype, gen)
            do = torch.randn((1, Sb, H, dh), generator=gen,
                             device="cuda").to(dtype)
            _check_flash_bwd(fk, fbk, cases, name, q, k, v, do)
    for name, r in rec.items():
        for c in r.get("new_config_shapes", ()):
            if c["config"] not in names:
                continue
            log(f"new-shape case {name} ({c['config']}, {c['shape']}, "
                f"{c['dtype']}): max abs err {c['max_abs_err']:.3e}, device "
                f"ms {c['device_ms']}, bound {c['bound_ms']:.4f} by "
                f"{c['bound_by']}")


def _prefix_kernel_cases(cases, gen):
    """Chunk prefill as a prefix-cache hit launches it: a 256-row chunk at
    start 512 (the cached run of 32 blocks of 16), B = 2 rows whose tables
    map the SAME 32 non-contiguous physical blocks first (the shared run,
    in a seeded permuted order) and private blocks after them, at
    Qwen3-8B's heads, in bf16 (against the plain version run in float32 on
    the same values) and float32."""
    import torch
    from repro_torch.kernels import decode_attention as dk

    block, C, NB, start, B, H, KV, dh = 16, 256, 48, 512, 2, 32, 8, 128
    P = 2 * NB + 1
    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        q = torch.randn((B, C, H, dh), generator=gen,
                        device="cuda").to(dtype)
        kp, vp = (torch.randn((P, block, KV, dh), generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
        shared = perm[:32]
        bt = torch.stack([
            torch.cat([shared, perm[32 + r * (NB - 32):
                                    32 + (r + 1) * (NB - 32)]])
            for r in range(B)]).to(torch.int32).contiguous()
        assert not bool((shared[1:] - shared[:-1] == 1).all())
        compare("chunk_prefill_attention",
                dk.chunk_prefill_attention(q, kp, vp, start, bt),
                dk.chunk_prefill_attention_ref(*_up(q, kp, vp), start, bt),
                name, cases)
    log("chunk_prefill_attention over a shared prefix run: 2 rows sharing "
        "their first 32 table entries, start 512, bf16 and float32 within "
        "tolerance")


# a device's shard of decode_32k as the dry run places it on the multi-pod
# mesh, decentralized (its record's kv_local: 8 of the 128 slots, 2048 of
# the 32768 positions, the 8 KV heads of 128), with Qwen3-8B's 32 query
# heads whole there (the seam gathers them): B, S, H, KV, dh
SHARD_DECODE = (8, 2048, 32, 8, 128)
# the lse against the plain version's on the same float32 values: both are
# float32 sums of the exponentials of the same scores (|lse| < ~20 here),
# the bf16 kernel's in log2 units and over its own split plan, so they
# should be a few float32 ulps of the lse apart; 1e-4 (atol = rtol) leaves
# two orders of that, and a fault (a key tile dropped or counted twice, a
# natural-log/log2 slip) moves it by 1e-2 or more
LSE_TOL = 1e-4


def _check_lse(label, got, got_lse, want, want_lse, pos, dtype_name, cases):
    """out and lse of the decode with ``return_lse`` against the plain
    version's: rows with an empty fence (pos < 0) exactly 0 and −inf, the
    others within the dtype's tolerance (out) and ``LSE_TOL`` (lse)."""
    import torch
    empty = pos < 0
    if not (bool((got[empty] == 0).all())
            and bool(torch.isneginf(got_lse[empty]).all())):
        raise AssertionError(f"{label} ({dtype_name}): an empty fence gave "
                             f"no 0 row or no −inf lse")
    compare(label, got[~empty], want[~empty], dtype_name, cases)
    compare(label + " lse", got_lse[~empty], want_lse[~empty], dtype_name,
            cases, tol=LSE_TOL)


def _split_decode_kernel_cases(cases, rec, gen):
    """The contiguous decode's lse output (the seam's decode over a cache
    split along its sequence runs it on every key range): out and lse
    with ``return_lse`` against the plain version (run in float32 on the
    same values) at the contiguous path's shape and at ``SHARD_DECODE``,
    bf16 and float32, with empty fences and fences past S; the output
    without ``return_lse`` bit for bit that with it; the seam's
    split-and-merge on the card — the shard's rows cut into 4 key ranges
    of 512, each run with the fence min(pos, S − 1) − s0 (−1 at least),
    merged by ``ops.merge_key_ranges`` — against the whole-row kernel with
    a window of S (rows 6 and 7 past it: their ring is full; row 0 sees
    only the first range, an empty fence in the other three), and the
    device ms of the shard's bf16 decode with and without the lse. Adds
    ``rec["decode_attention"]["lse"]``."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ops

    bf16, f32 = torch.bfloat16, torch.float32
    B, S, H, KV, dh = SHARD_DECODE
    shapes = {
        "contiguous path": (8, 1088, [-1, 0, 1087, 500, 63, 64, 200, 5000]),
        "decode_32k shard": (B, S, [-1, 0, 2047, 700, 64, 1500, 5000, -1])}
    for label, (b, s, pos) in shapes.items():
        for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
            q, k, v, pos_t = _decode_case(b, s, H, KV, dh, pos, dtype, gen)
            out, lse = dk.decode_attention(q, k, v, pos_t, return_lse=True)
            _check_lse("decode_attention (lse)", out, lse,
                       *dk.decode_attention_ref(*_up(q, k, v, pos_t),
                                                return_lse=True),
                       pos_t, name, cases)
            if not torch.equal(dk.decode_attention(q, k, v, pos_t), out):
                raise AssertionError(f"decode_attention at the {label} "
                                     f"({name}): the output without the lse "
                                     f"differs from the output with it")
    log("decode_attention return_lse: out and lse against the plain version "
        "at the contiguous path's shape and the decode_32k shard, bf16 and "
        "float32, empty fences 0 and -inf; without the lse bit for bit")

    bounds = (0, 512, 1024, 1536, S)
    pos = [100, 600, 1023, 1024, 2047, 1500, 3000, 5000]

    def stacked(t, op):
        return t.amax(0) if op == "max" else t.sum(0)

    for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
        q, k, v, pos_t = _decode_case(B, S, H, KV, dh, pos, dtype, gen)
        parts = [dk.decode_attention(
            q, k[:, s0:s1].contiguous(), v[:, s0:s1].contiguous(),
            (pos_t.clamp(max=S - 1) - s0).clamp(min=-1), return_lse=True)
            for s0, s1 in zip(bounds[:-1], bounds[1:])]
        if not all(bool(torch.isneginf(lse[0]).all())
                   for _, lse in parts[1:]):
            raise AssertionError("split decode: row 0's empty fences gave "
                                 "no −inf lse")
        merged, merged_lse = ops.merge_key_ranges(
            torch.stack([o for o, _ in parts]),
            torch.stack([lse for _, lse in parts]), stacked)
        whole, whole_lse = dk.decode_attention(q, k, v, pos_t, window=S,
                                               return_lse=True)
        compare("decode_attention (split and merge)", merged, whole, name,
                cases)
        compare("decode_attention (split and merge) lse", merged_lse,
                whole_lse, name, cases, tol=LSE_TOL)
        compare("decode_attention (split and merge)", merged,
                dk.decode_attention_ref(*_up(q, k, v, pos_t), window=S),
                name, cases)
    log("decode_attention split and merge: 4 key ranges of the decode_32k "
        "shard (an empty fence among them, two full rings) against the "
        "whole-row kernel and the plain version, bf16 and float32")

    pos = np.random.default_rng(3).integers(0, S, B)
    pos[0] = S - 1
    q, k, v, pos_t = _decode_case(B, S, H, KV, dh, pos.tolist(), bf16, gen)
    timed = {}
    for lse_on in (False, True, False, True):      # off, on, off, on
        timed.setdefault(lse_on, []).append(device_ms(
            lambda: dk.decode_attention(q, k, v, pos_t, return_lse=lse_on)))
    keys = int((pos + 1).sum())
    nbytes = 2 * B * H * dh * 2 + keys * KV * dh * 2 * 2 + B * 4 + B * H * 4

    def worst(label):
        return max(c["max_abs_err"] for c in cases if c["kernel"] == label)

    r = rec["decode_attention"]["lse"] = {
        "shape": f"B={B} S={S} H={H} KV={KV} dh={dh} pos<= {int(pos.max())} "
                 f"bf16 (a decode_32k shard)",
        "device_ms_with_lse": timed[True], "device_ms_without": timed[False],
        "splits": list(dk.decode_splits(S, B * KV)),
        "bound_ms": max(nbytes / HBM_BPS,
                        4 * H * dh * keys / PEAK_FLOPS["bfloat16"]) * 1e3,
        "max_abs_err": {n: worst(n) for n in (
            "decode_attention (lse)", "decode_attention (lse) lse",
            "decode_attention (split and merge)",
            "decode_attention (split and merge) lse")},
        "tol": {"bfloat16": TOL["bfloat16"], "float32": TOL["float32"],
                "lse": LSE_TOL}}
    log(f"decode_attention lse at {r['shape']}: device ms with the lse "
        f"{r['device_ms_with_lse']}, without {r['device_ms_without']} "
        f"(bound {r['bound_ms']:.4f}, splits {r['splits']}); max abs err "
        f"{json.dumps(r['max_abs_err'])}")


def phase_kernels():
    """Compare and time every kernel; returns {name: record}."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    rec = {}

    # -- paged decode at the main path's shapes: 8 slots of Qwen3-8B heads,
    #    positions up to ~1k, 16-position blocks
    B, NB, block, H, KV, dh = 8, 64, 16, 32, 8, 128
    pos = np.random.default_rng(0).integers(200, NB * block, B)
    pos[0] = NB * block - 1
    q, kp, vp, pos_t, bt = _paged_case(B, NB, block, H, KV, dh, pos.tolist(),
                                       bf16, gen)
    got = dk.paged_decode_attention(q, kp, vp, pos_t, bt)
    want = dk.paged_decode_attention_ref(q.float(), kp.float(), vp.float(),
                                         pos_t, bt)
    compare("paged_decode_attention", got, want, "bfloat16", cases)
    S = NB * block
    # the library call gets the gathered span with its KV heads repeated to
    # H (head h reads KV head h // group); gathering is not timed
    kf = kp[bt.long()].reshape(B, S, KV, dh).permute(0, 2, 1, 3) \
        .repeat_interleave(H // KV, dim=1).contiguous()
    vf = vp[bt.long()].reshape(B, S, KV, dh).permute(0, 2, 1, 3) \
        .repeat_interleave(H // KV, dim=1).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos_t[:, None].long())[:, None, None, :]
    keys = int((pos + 1).sum())
    live = int((pos // block + 1).sum())
    nbytes = (2 * B * H * dh * 2 + keys * KV * dh * 2 * 2 + B * 4
              + live * 4)
    flops = 4 * H * dh * keys
    rec["paged_decode_attention"] = {
        "shape": f"B={B} H={H} KV={KV} dh={dh} block={block} NB={NB} "
                 f"pos<= {int(pos.max())} bf16",
        "ms": cuda_ms(lambda: dk.paged_decode_attention(q, kp, vp, pos_t,
                                                        bt)),
        "device_ms": device_ms(lambda: dk.paged_decode_attention(
            q, kp, vp, pos_t, bt)),
        "plain_ms": cuda_ms(lambda: dk.paged_decode_attention_ref(
            q, kp, vp, pos_t, bt)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kf, vf, attn_mask=mask)),
        "library_device_ms": device_ms(
            lambda: F.scaled_dot_product_attention(q[:, :, None], kf, vf,
                                                   attn_mask=mask)),
        "bytes": nbytes, "flops": flops, "dtype": "bfloat16"}
    # the split plan at the main path's table (NB = 68: 17 key tiles), each
    # setting held against the plain version too
    pos68 = np.random.default_rng(5).integers(200, 68 * block, B)
    pos68[0] = 68 * block - 1
    args = _paged_case(B, 68, block, H, KV, dh, pos68.tolist(), bf16, gen)
    _decode_sweep(dk, cases, "paged_decode_attention",
                  f"B={B} H={H} KV={KV} dh={dh} block={block} NB=68",
                  lambda: dk.paged_decode_attention(*args),
                  dk.paged_decode_attention_ref(*_up(*args)),
                  68 * block, B * KV)

    # -- chunk prefill at the main path's shapes: a 256-row chunk at
    #    position 512 of a Qwen3-8B prompt; the bf16 tensor-core kernel is
    #    held against the plain version in float32 on the same values (the
    #    kernel rounds P to bf16 for its product, as flash does)
    C, NB, start = 256, 48, 512
    q, kp, vp, start, bt = _chunk_case(C, NB, block, H, KV, dh, start, bf16,
                                       gen)
    got = dk.chunk_prefill_attention(q, kp, vp, start, bt)
    want = dk.chunk_prefill_attention_ref(q.float(), kp.float(), vp.float(),
                                          start, bt)
    compare("chunk_prefill_attention", got, want, "bfloat16", cases)
    S = start + C
    kf = kp[bt.long()].reshape(NB * block, KV, dh)[:S].permute(1, 0, 2)[None]
    vf = vp[bt.long()].reshape(NB * block, KV, dh)[:S].permute(1, 0, 2)[None]
    kf = kf.repeat_interleave(H // KV, dim=1).contiguous()
    vf = vf.repeat_interleave(H // KV, dim=1).contiguous()
    cmask = (torch.arange(S, device="cuda")[None, :]
             <= start + torch.arange(C, device="cuda")[:, None])
    keys = sum(start + c + 1 for c in range(C))
    nbytes = 2 * C * H * dh * 2 + S * KV * dh * 2 * 2 + (S // block) * 4
    rec["chunk_prefill_attention"] = {
        "shape": f"C={C} start={start} H={H} KV={KV} dh={dh} block={block} "
                 f"NB={NB} bf16",
        "ms": cuda_ms(lambda: dk.chunk_prefill_attention(q, kp, vp, start,
                                                         bt)),
        "device_ms": device_ms(lambda: dk.chunk_prefill_attention(
            q, kp, vp, start, bt)),
        "plain_ms": cuda_ms(lambda: dk.chunk_prefill_attention_ref(
            q, kp, vp, start, bt)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q.permute(1, 0, 2)[None], kf, vf, attn_mask=cmask)),
        "library_device_ms": device_ms(
            lambda: F.scaled_dot_product_attention(
                q.permute(1, 0, 2)[None], kf, vf, attn_mask=cmask)),
        "bytes": nbytes, "flops": 4 * H * dh * keys, "dtype": "bfloat16"}

    # -- float32 at the main path's shapes: here the two sides differ only
    #    by summation order, so a fault confined to one block of a long span
    #    (a dropped horizon block, a wrong table entry) cannot hide in bf16
    #    rounding
    B, NB, H, KV, dh = 8, 64, 32, 8, 128
    q, kp, vp, pos_t, bt = _paged_case(B, NB, block, H, KV, dh, pos.tolist(),
                                       f32, gen)
    compare("paged_decode_attention",
            dk.paged_decode_attention(q, kp, vp, pos_t, bt),
            dk.paged_decode_attention_ref(q, kp, vp, pos_t, bt),
            "float32", cases)
    _time_scalar(rec["paged_decode_attention"],
                 lambda: dk.paged_decode_attention(q, kp, vp, pos_t, bt))
    q, kp, vp, start, bt = _chunk_case(256, 48, block, H, KV, dh, 512, f32,
                                       gen)
    compare("chunk_prefill_attention",
            dk.chunk_prefill_attention(q, kp, vp, start, bt),
            dk.chunk_prefill_attention_ref(q, kp, vp, start, bt),
            "float32", cases)

    # -- small float32 edge shapes
    edge_decode = [
        # B, NB, block, H, KV, dh, pos, window
        (3, 8, 16, 8, 2, 64, [0, 64, 127], 0),        # GQA 4:1, boundaries
        (2, 4, 32, 4, 4, 64, [5, 127], 0),            # MHA
        (1, 4, 64, 4, 1, 128, [200], 0),              # MQA, > 48 KB smem
        (2, 4, 16, 4, 2, 64, [3, 60], 64),            # ring, not wrapped
        (2, 4, 16, 4, 2, 64, [64, 200], 64),          # ring, wrapped
    ]
    for B, NB, block, H, KV, dh, pos, window in edge_decode:
        q, kp, vp, pos_t, bt = _paged_case(B, NB, block, H, KV, dh, pos,
                                           f32, gen, window=window)
        compare("paged_decode_attention",
                dk.paged_decode_attention(q, kp, vp, pos_t, bt,
                                          window=window),
                dk.paged_decode_attention_ref(q, kp, vp, pos_t, bt,
                                              window=window),
                "float32", cases)
    # their bf16 twins on the split-key tensor-core kernel, and its own
    # edges, against the plain version in float32 on the same values
    edge_decode_bf16 = [(*e, ()) for e in edge_decode] + [
        # B, NB, block, H, KV, dh, pos, window, idle
        (2, 16, 8, 16, 2, 64, [60, 127], 0, ()),           # block 8, group 8
        (2, 2, 128, 8, 2, 64, [100, 255], 0, ()),          # block 128
        (2, 8, 16, 64, 1, 64, [50, 127], 0, ()),           # a group of 64
        (3, 8, 16, 32, 32, 80, [0, 70, 127], 0, ()),       # Zamba2's heads
        (4, 68, 16, 32, 8, 128, [0, 1087, 500, 0], 0, (0, 3)),  # idle slots,
        #                                                    pos = capacity - 1
        (2, 100, 16, 8, 2, 64, [1599, 5000], 1600, ()),    # ring over 25
        #                                             tiles, wrapped far past
        (2, 8, 16, 8, 2, 128, [20, 100000], 128, ()),      # ring, far past
        (3, 4, 16, 6, 2, 40, [0, 33, 63], 0, ()),          # dh 40, group 3
    ]
    for B, NB, block, H, KV, dh, pos, window, idle in edge_decode_bf16:
        args = _paged_case(B, NB, block, H, KV, dh, pos, bf16, gen,
                           window=window, idle=idle)
        compare("paged_decode_attention",
                dk.paged_decode_attention(*args, window=window),
                dk.paged_decode_attention_ref(*_up(*args), window=window),
                "bfloat16", cases)
    edge_chunk = [
        # C, NB, block, H, KV, dh, start
        (8, 4, 16, 4, 4, 64, 0),        # MHA, first chunk
        (6, 8, 8, 8, 2, 64, 34),        # GQA 4:1, straddles a block
        (16, 4, 32, 4, 1, 128, 112),    # MQA, ends at capacity
    ]
    for C, NB, block, H, KV, dh, start in edge_chunk:
        q, kp, vp, start, bt = _chunk_case(C, NB, block, H, KV, dh, start,
                                           f32, gen)
        compare("chunk_prefill_attention",
                dk.chunk_prefill_attention(q, kp, vp, start, bt),
                dk.chunk_prefill_attention_ref(q, kp, vp, start, bt),
                "float32", cases)
    # their bf16 twins on the tensor-core kernel, and its own edges
    edge_chunk_bf16 = edge_chunk + [
        (40, 8, 16, 64, 1, 64, 50),       # a group of 64 rows
        (100, 16, 8, 8, 2, 64, 20),       # ragged C over two row tiles
        (77, 4, 64, 8, 2, 128, 150),      # block 64
        (50, 2, 128, 8, 2, 64, 100),      # block 128: 64 rows of one page
        (33, 8, 32, 32, 32, 80, 200),     # Zamba2's heads, ragged C
        (30, 8, 16, 6, 2, 40, 70),        # dh 40, a group of 3
    ]
    for C, NB, block, H, KV, dh, start in edge_chunk_bf16:
        q, kp, vp, start, bt = _chunk_case(C, NB, block, H, KV, dh, start,
                                           bf16, gen)
        compare("chunk_prefill_attention",
                dk.chunk_prefill_attention(q, kp, vp, start, bt),
                dk.chunk_prefill_attention_ref(q.float(), kp.float(),
                                               vp.float(), start, bt),
                "bfloat16", cases)

    # -- flash attention at the contiguous path's shapes: one Qwen3-8B
    #    prompt of 1024 tokens (timed) and a ragged 777, causal, bf16 then
    #    float32; out and lse are both compared
    B, H, KV, dh = 1, 32, 8, 128
    for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
        for S in (1024, 777):
            q, k, v = _flash_case(B, S, H, KV, dh, dtype, gen)
            _check_flash(fk, cases, name, q, k, v)
            if dtype is bf16 and S == 1024:
                qh, kh, vh = (_heads_first(t, g) for t, g in
                              ((q, 1), (k, H // KV), (v, H // KV)))
                pairs = S * (S + 1) // 2
                rec["flash_attention"] = {
                    "shape": f"B={B} S={S} H={H} KV={KV} dh={dh} causal "
                             f"bf16",
                    "ms": cuda_ms(lambda: fk.flash_attention_with_lse(
                        q, k, v)),
                    "device_ms": device_ms(
                        lambda: fk.flash_attention_with_lse(q, k, v)),
                    "plain_ms": cuda_ms(
                        lambda: fk.flash_attention_with_lse_ref(q, k, v)),
                    "library_ms": cuda_ms(
                        lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, is_causal=True)),
                    "library_device_ms": device_ms(
                        lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, is_causal=True)),
                    "bytes": (2 * B * S * H * dh + 2 * B * S * KV * dh) * 2
                    + B * S * H * 4,
                    "flops": 4 * B * H * dh * pairs, "dtype": "bfloat16"}

    # -- contiguous decode at the contiguous path's shapes: 8 slots of
    #    Qwen3-8B heads over cache rows of 1088 (the main path's
    #    cache_len), positions up to 1087
    B, S = 8, 1088
    pos = np.random.default_rng(1).integers(200, S, B)
    pos[0] = S - 1
    for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
        q, k, v, pos_t = _decode_case(B, S, H, KV, dh, pos.tolist(), dtype,
                                      gen)
        compare("decode_attention", dk.decode_attention(q, k, v, pos_t),
                dk.decode_attention_ref(*_up(q, k, v, pos_t)), name, cases)
        if dtype is f32:
            _time_scalar(rec["decode_attention"],
                         lambda: dk.decode_attention(q, k, v, pos_t))
        else:
            kh, vh = _heads_first(k, H // KV), _heads_first(v, H // KV)
            dmask = (torch.arange(S, device="cuda")[None, :]
                     <= pos_t[:, None].long())[:, None, None, :]
            keys = int((pos + 1).sum())
            rec["decode_attention"] = {
                "shape": f"B={B} S={S} H={H} KV={KV} dh={dh} "
                         f"pos<= {int(pos.max())} bf16",
                "ms": cuda_ms(lambda: dk.decode_attention(q, k, v, pos_t)),
                "device_ms": device_ms(
                    lambda: dk.decode_attention(q, k, v, pos_t)),
                "plain_ms": cuda_ms(lambda: dk.decode_attention_ref(
                    q, k, v, pos_t)),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kh, vh, attn_mask=dmask)),
                "library_device_ms": device_ms(
                    lambda: F.scaled_dot_product_attention(
                        q[:, :, None], kh, vh, attn_mask=dmask)),
                "bytes": 2 * B * H * dh * 2 + keys * KV * dh * 2 * 2 + B * 4,
                "flops": 4 * H * dh * keys, "dtype": "bfloat16"}
            _decode_sweep(dk, cases, "decode_attention",
                          f"B={B} S={S} H={H} KV={KV} dh={dh}",
                          lambda: dk.decode_attention(q, k, v, pos_t),
                          dk.decode_attention_ref(*_up(q, k, v, pos_t)), S,
                          B * KV)

    # -- paged verify at the speculative path's shapes: 8 slots of Qwen3-8B
    #    heads, spans of SPEC_LEN at positions up to 1023 (slot 0's span
    #    ends on the table's last position), 16-position blocks; in float32
    #    row j is also held against the paged decode kernel at pos + j, in
    #    bf16 (the tensor-core kernel, split over key ranges) against paged
    #    decode's plain version there
    B, NB, block, L, H, KV, dh = 8, 64, 16, SPEC_LEN, 32, 8, 128
    pos = np.random.default_rng(2).integers(200, NB * block - L + 1, B)
    pos[0] = NB * block - L
    for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
        q, kp, vp, pos_t, bt = _verify_case(B, NB, block, L, H, KV, dh,
                                            pos.tolist(), dtype, gen)
        if dtype is f32:
            got = dk.paged_verify_attention(q, kp, vp, pos_t, bt)
            compare("paged_verify_attention", got,
                    dk.paged_verify_attention_ref(q, kp, vp, pos_t, bt),
                    name, cases)
            for j in range(L):
                compare("paged_verify_attention", got[:, j],
                        dk.paged_decode_attention(q[:, j].contiguous(), kp,
                                                  vp, pos_t + j, bt),
                        name, cases)
            continue
        _check_verify(dk, cases, name, q, kp, vp, pos_t, bt)
        S = NB * block
        kf = _heads_first(kp[bt.long()].reshape(B, S, KV, dh), H // KV)
        vf = _heads_first(vp[bt.long()].reshape(B, S, KV, dh), H // KV)
        rows = pos_t[:, None].long() + torch.arange(L, device="cuda")
        vmask = (torch.arange(S, device="cuda")[None, None, :]
                 <= rows[:, :, None])[:, None]              # (B,1,L,S)
        qh = q.permute(0, 2, 1, 3).contiguous()             # (B,H,L,dh)
        keys = int((pos + L).sum())         # positions 0..pos+L-1 per slot
        pairs = int(sum(p * L + L * (L + 1) // 2 for p in pos))
        live = int(((pos + L - 1) // block + 1).sum())
        rec["paged_verify_attention"] = {
            "shape": f"B={B} L={L} H={H} KV={KV} dh={dh} block={block} "
                     f"NB={NB} pos+L-1<= {int(pos.max()) + L - 1} bf16",
            "ms": cuda_ms(lambda: dk.paged_verify_attention(q, kp, vp, pos_t,
                                                            bt)),
            "device_ms": device_ms(lambda: dk.paged_verify_attention(
                q, kp, vp, pos_t, bt)),
            "plain_ms": cuda_ms(lambda: dk.paged_verify_attention_ref(
                q, kp, vp, pos_t, bt)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kf, vf, attn_mask=vmask)),
            "library_device_ms": device_ms(
                lambda: F.scaled_dot_product_attention(qh, kf, vf,
                                                       attn_mask=vmask)),
            "bytes": 2 * B * L * H * dh * 2 + keys * KV * dh * 2 * 2 + B * 4
            + live * 4,
            "flops": 4 * H * dh * pairs, "dtype": "bfloat16"}
        # the split plan's one setting: device ms (kernel and merge) at
        # each number of key tiles a split, for the record
        chosen, sweep = dk.VERIFY_SPLIT_TILES, {}
        try:
            for tiles in (1, 2, 4, 8, 16):
                dk.VERIFY_SPLIT_TILES = tiles
                sweep[f"{tiles} ({dk.verify_splits(NB, block)[0]} splits)"] \
                    = device_ms(lambda: dk.paged_verify_attention(
                        q, kp, vp, pos_t, bt))
        finally:
            dk.VERIFY_SPLIT_TILES = chosen
        log(f"paged verify at {rec['paged_verify_attention']['shape']}: "
            f"device ms by key tiles a split ({chosen} in use): {sweep}")

    # -- their small float32 edge shapes
    edge_verify = [
        # B, NB, block, L, H, KV, dh, pos, inactive, scratch_tail
        (2, 4, 16, 4, 4, 4, 64, [5, 40], (), True),          # MHA
        (2, 4, 32, 4, 4, 1, 128, [100, 7], (), True),        # MQA, > 48 KB
        (3, 8, 16, 2, 8, 2, 64, [0, 63, 100], (), True),     # L = 2
        (2, 8, 16, 8, 8, 2, 64, [10, 120], (), True),        # two row tiles
        (3, 4, 16, 4, 8, 2, 64, [62, 63, 61], (), False),    # past horizon
        (4, 4, 16, 4, 8, 2, 64, [15, 16, 31, 32], (), True),  # block edges
        (4, 4, 16, 4, 8, 2, 64, [30, 0, 45, 0], (1, 3), True),  # idle slots
    ]
    from repro_torch.models.attention import scatter_span
    for B, NB, block, L, H, KV, dh, pos_e, idle, tail in edge_verify:
        q, kp, vp, pos_t, bt = _verify_case(B, NB, block, L, H, KV, dh,
                                            pos_e, f32, gen, inactive=idle,
                                            scratch_tail=tail)
        if idle:
            # the layer's scatter of a whole span, idle slots included, on
            # the card and on the CPU: the pools agree outside block 0
            kn = torch.randn((B, L, KV, dh), generator=gen, device="cuda")
            vn = torch.randn((B, L, KV, dh), generator=gen, device="cuda")
            host = scatter_span((kp.cpu(), vp.cpu()), kn.cpu(), vn.cpu(),
                                pos_t.cpu(), bt.cpu())
            scatter_span((kp, vp), kn, vn, pos_t, bt)
            for dev_pool, cpu_pool in zip((kp, vp), host):
                compare("paged_verify_attention", dev_pool[1:].cpu(),
                        cpu_pool[1:], "float32", cases)
        compare("paged_verify_attention",
                dk.paged_verify_attention(q, kp, vp, pos_t, bt),
                dk.paged_verify_attention_ref(q, kp, vp, pos_t, bt),
                "float32", cases)
    # their bf16 twins on the tensor-core kernel, and its own edges
    edge_verify_bf16 = edge_verify + [
        (2, 8, 16, 8, 32, 2, 64, [10, 120], (), True),      # 2 row tiles
        (3, 64, 16, 4, 8, 2, 64, [510, 511, 900], (), True),  # masked splits
        (2, 100, 16, 4, 8, 2, 64, [1500, 700], (), True),   # 4 splits
        (3, 40, 16, 4, 8, 2, 64, [637, 638, 100], (), False),  # past the
        #                                          horizon, over 2 splits
        (2, 16, 8, 4, 8, 2, 64, [60, 100], (), True),       # block 8
        (2, 4, 64, 4, 8, 2, 64, [130, 250], (), True),      # block 64
        (2, 4, 128, 4, 8, 2, 64, [300, 505], (), True),     # block 128
        (2, 8, 16, 4, 64, 1, 64, [50, 100], (), True),      # group of 64
        (2, 8, 16, 4, 6, 2, 40, [33, 90], (), True),        # dh 40, group 3
    ]
    for B, NB, block, L, H, KV, dh, pos_e, idle, tail in edge_verify_bf16:
        _check_verify(dk, cases, "bfloat16", *_verify_case(
            B, NB, block, L, H, KV, dh, pos_e, bf16, gen, inactive=idle,
            scratch_tail=tail))
    edge_flash = [
        # B, S, H, KV, dh, causal, window
        (1, 1, 4, 2, 64, True, 0),          # one position
        (2, 77, 8, 2, 64, True, 0),         # ragged last key tile
        (1, 200, 4, 1, 128, True, 0),       # MQA, > 48 KB shared memory
        (1, 150, 8, 8, 64, False, 0),       # MHA, not causal
        (1, 300, 8, 2, 64, True, 50),       # window across key tiles
        (2, 64, 4, 4, 32, True, 16),        # window inside one key tile
        (1, 100, 6, 2, 40, True, 0),        # dh 40, a group of 3
    ]
    for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
        for B, S, H, KV, dh, causal, window in edge_flash:
            q, k, v = _flash_case(B, S, H, KV, dh, dtype, gen)
            _check_flash(fk, cases, name, q, k, v, causal, window)
    edge_decode = [
        # B, S, H, KV, dh, pos, window
        (3, 100, 8, 2, 64, [0, 63, 99], 0),     # ragged, tile boundary
        (2, 128, 4, 4, 64, [64, 127], 0),       # MHA
        (1, 300, 4, 1, 128, [299], 0),          # MQA, ragged
        (2, 100, 4, 2, 64, [50, 99], 100),      # ring, not wrapped
        (2, 100, 4, 2, 64, [100, 350], 100),    # ring, pos >= S
        (2, 8, 4, 2, 64, [3, 20], 8),           # ring shorter than a tile
    ]
    for B, S, H, KV, dh, pos_e, window in edge_decode:
        q, k, v, pos_t = _decode_case(B, S, H, KV, dh, pos_e, f32, gen)
        compare("decode_attention",
                dk.decode_attention(q, k, v, pos_t, window=window),
                dk.decode_attention_ref(q, k, v, pos_t, window=window),
                "float32", cases)
    edge_decode_bf16 = edge_decode + [
        (2, 40, 8, 2, 64, [0, 39], 0),           # S < 64
        (2, 200, 64, 1, 64, [150, 199], 0),      # a group of 64
        (2, 150, 16, 2, 128, [0, 149], 0),       # a group of 8, dh 128
        (3, 1088, 32, 32, 80, [1087, 0, 600], 0),  # Zamba2's heads
        (2, 1000, 8, 2, 64, [999, 5000], 1000),  # ring over 16 tiles,
        #                                          wrapped far past
        (2, 8, 4, 2, 64, [0, 7], 8),             # ring < a tile, pos 0, S-1
        (3, 100, 6, 2, 40, [0, 64, 99], 0),      # dh 40, a group of 3
    ]
    for B, S, H, KV, dh, pos_e, window in edge_decode_bf16:
        args = _decode_case(B, S, H, KV, dh, pos_e, bf16, gen)
        compare("decode_attention",
                dk.decode_attention(*args, window=window),
                dk.decode_attention_ref(*_up(*args), window=window),
                "bfloat16", cases)
    _hybrid_kernel_cases(cases, rec, gen)
    _mlstm_scan_cases(cases, rec, gen)
    _mixture_kernel_cases(cases, rec, gen)
    _speculation_kernel_cases(cases, rec, gen)
    _sampling_bits_cases()
    _training_kernel_cases(cases, rec, gen)
    _new_config_kernel_cases(cases, rec, gen)
    _new_config_kernel_cases(cases, rec, gen, MOE_HEADS, (),
                             MOE_CACHE_LEN)
    _audio_kernel_cases(cases, rec, gen)
    _hybrid_training_kernel_cases(cases, rec, gen)
    _prefix_kernel_cases(cases, gen)
    _split_decode_kernel_cases(cases, rec, gen)
    torch.cuda.synchronize()

    for name, r in rec.items():
        mine = [c for c in cases if c["kernel"] == name]
        r["cases"] = len(mine)
        # the error at the main path's dtype (its tolerance is the one the
        # record states), and per dtype over every case
        r["max_abs_err_by_dtype"] = {
            d: max(c["max_abs_err"] for c in mine if c["dtype"] == d)
            for d in sorted({c["dtype"] for c in mine})}
        r["max_abs_err"] = r["max_abs_err_by_dtype"][r["dtype"]]
        t_bytes = r["bytes"] / HBM_BPS * 1e3
        t_ops = r["flops"] / PEAK_FLOPS[r.get("rate_dtype", r["dtype"])] \
            * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"kernel {name}: {r['shape']}: {r['cases']} cases within "
            f"tolerance, max abs err by dtype {r['max_abs_err_by_dtype']}; "
            f"{r['ms']:.4f} ms, device {r['device_ms']} (plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']}, device "
            f"{r.get('library_device_ms')}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}"
            + (f"; float32 scalar wrapper {r['float32_ms']:.4f} ms, device "
               f"{r['float32_device_ms']})" if "float32_ms" in r else ")"))
    return rec


# ---------------------------------------------------------------------------
# Phases 4-5: serving
# ---------------------------------------------------------------------------

def _serve(engine, prompts, feats, params, extras=None):
    """Drive ``engine`` to completion, request i with ``params(i)`` and
    its modality ``extras[i]`` (none when ``extras`` is None); returns
    ({rid: (tokens, reason)}, [[rids] per pod], outputs-by-rid, steps,
    wall seconds)."""
    import torch
    for i, p in enumerate(prompts):
        engine.add_request(p, params(i), extras[i] if extras else None,
                           features=feats[i], rid=i)
    routing = [[r.rid for r in pod.waiting] for pod in engine.pods]
    res, outs, steps = {}, {}, 0
    t0 = time.perf_counter()
    while engine.has_unfinished():
        for o in engine.step():
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
                outs[o.rid] = o
        steps += 1
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return res, routing, outs, steps, time.perf_counter() - t0


#: a sampled draw may change with the last ulp of the Gumbel noise's two
#: float32 logs (torch's and XLA's, or the card's and the CPU's) only
#: where its top-two gap is within this many ulps of its top value
#: (tests/test_torch_sampling.py)
SAMPLE_MARGIN_ULPS = 4


def _sample_margin(host, model, prompt, toks, t, sp, feats, route,
                   extras=None):
    """The Gumbel-plus-logit margin of token ``t`` of a sampled request on
    the CPU engine ``host``: its scores recomputed by a prefill of the
    prompt (behind its ``extras``' image prefix, if any) and its first
    ``t`` tokens (the top-1 pod ``route``'s expert, or the Eq. 27 mixture
    under the router's weights), then ``fused.sample_margin`` at count
    ``t``. Returns (margin, allowed)."""
    import numpy as np
    import torch
    from repro_torch.core.ensemble import mix_expert_logits
    from repro_torch.serve import fused

    seq = np.concatenate([prompt, np.asarray(toks[:t], np.int32)])
    batch = {"tokens": torch.as_tensor(seq[None].astype(np.int64))}
    for name, v in (extras or {}).items():
        batch[name] = torch.as_tensor(np.asarray(v)[None])
    width = len(seq) + (model.cfg.n_patches if extras else 0)
    if host.config.strategy == "mixture":
        core = host.core
        logits, _ = model.prefill(core.stacked, batch, width)
        w = core.router.route(torch.as_tensor(np.asarray(feats,
                                                         np.float32)[None]))
        row = torch.log(mix_expert_logits(logits[:, :, -1], w).clamp_min(
            fused.PROB_FLOOR))
    else:
        logits, _ = model.prefill(host.pods[route].params, batch, width)
        row = logits[0, -1:]
    margin = float(fused.sample_margin(
        row, torch.tensor([sp.temperature]),
        torch.tensor([sp.top_k], dtype=torch.int32),
        torch.tensor([sp.seed & 0xFFFFFFFF]),
        torch.tensor([t], dtype=torch.int32))[0])
    top = float(row.abs().max()) / sp.temperature + 16.0
    return margin, SAMPLE_MARGIN_ULPS * float(np.spacing(np.float32(top)))


def phase_parity(arch="qwen3_8b", cf=None):
    """Smoke-size float32 deployment of ``arch`` (a moe config at capacity
    factor ``cf`` when given: ``MOE_DROP_CF`` drops (token, choice) pairs,
    which the phase counts and requires; the smoke configs' own 8.0 drops
    none, which it requires too): card (kernels) vs CPU
    (plain), top-1 in the paged + chunked, paged + chunked + n-gram
    speculative (a ``speculative_capable`` model only), paged + monolithic
    and contiguous + monolithic configurations, then the same three
    without speculation under the Eq. 27 mixture (``strategy="mixture"``,
    top_k 2), then the mixture's paged + chunked with n-gram and with
    expert speculation, then seeded sampling (temperature 0.7, top_k 0 and
    40 on alternate requests) on top-1 and the mixture, paged + chunked,
    speculation off and on. The n-gram ones serve period-4 prompts of the
    same lengths (the traffic n-gram drafts target), so drafts are
    accepted. Tokens, finish reasons, routing and the spec counters must
    be equal; a sampled token that differs is reported with its
    Gumbel-plus-logit margin and fails unless that margin is within
    ``SAMPLE_MARGIN_ULPS`` ulps. A family with no pageable leaves (ssm)
    also serves contiguous + chunked. For ``UNFUSED_PARITY_ARCHS`` and the
    audio family every configuration without speculation is served again
    with the unfused step (``fused_step=False``), and for
    ``UNFUSED_PARITY_ARCHS`` the whole-batch engines are held card vs CPU
    (``_batch_engine_parity``). Each vlm request carries its own image
    patches and each audio request its own frames."""
    from dataclasses import replace

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.router import CentroidRouter, RouterConfig
    from repro_torch.models import build_model
    from repro_torch.serve.api import (EngineConfig, SamplingParams,
                                       effective_page_block)
    from repro_torch.serve.scheduler import make_engine

    from repro_torch.models import moe as moe_lib

    cfg = get_smoke_config(arch)
    if cf is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
        moe_lib.DROP_TALLY = {}
    model = build_model(cfg)
    experts = [model.init(torch.Generator().manual_seed(k)) for k in (0, 1)]
    rng = np.random.default_rng(1)
    router = CentroidRouter(torch.as_tensor(
        rng.normal(size=(2, 32)).astype(np.float32)))
    lens = [5, 13, 19, 8, 30, 3, 40, 17]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    periodic = [np.tile(rng.integers(1, cfg.vocab, 4), n // 4 + 1)[:n]
                .astype(np.int32) for n in lens]
    feats = rng.normal(size=(len(lens), 32)).astype(np.float32)
    # the vlm family's image patches, one set a request (its prefix of
    # n_patches rows goes ahead of each prompt); the audio family's frames,
    # one set a request (its encoder's input)
    extras = [{"patches": rng.normal(size=(cfg.n_patches, cfg.vision_dim))
               .astype(np.float32)} for _ in lens] \
        if cfg.family == "vlm" else None
    if cfg.family == "audio":
        extras = [{"frames": rng.normal(size=(
            cfg.n_audio_frames, cfg.audio_dim)).astype(np.float32)}
            for _ in lens]

    def greedy(i):
        return SamplingParams(max_new=12)

    def sampled(i):
        return SamplingParams(max_new=12, temperature=0.7,
                              top_k=40 * (i % 2), seed=500 + i)

    chunked = dict(paged=True, chunked_prefill=True)
    ngram = dict(chunked, speculative="ngram", spec_len=SPEC_LEN)
    expert = dict(chunked, strategy="mixture", speculative="expert",
                  spec_len=SPEC_LEN)
    configs = [("paged + chunked", chunked, prompts),
               ("paged + chunked + speculative", ngram, periodic),
               ("paged + monolithic", dict(paged=True), prompts),
               ("contiguous + monolithic", {}, prompts)]
    configs += [(f"mixture, {kind}", dict(over, strategy="mixture"), reqs)
                for kind, over, reqs in configs if "speculative" not in over]
    configs += [
        ("mixture, paged + chunked + ngram speculative",
         dict(ngram, strategy="mixture"), periodic),
        ("mixture, paged + chunked + expert speculative", expert, prompts)]
    configs = [(kind, over, reqs, greedy) for kind, over, reqs in configs]
    configs += [
        ("paged + chunked, sampled", chunked, prompts, sampled),
        ("paged + chunked + speculative, sampled", ngram, periodic, sampled),
        ("mixture, paged + chunked, sampled",
         dict(chunked, strategy="mixture"), prompts, sampled),
        ("mixture, paged + chunked + expert speculative, sampled", expert,
         prompts, sampled)]
    if not model.speculative_capable:
        configs = [c for c in configs if "speculative" not in c[1]]
    if effective_page_block(model, 8) == 0:       # no pool: chunks direct
        configs += [(f"{mix}contiguous + chunked", dict(
            chunked_prefill=True, **over), prompts, greedy)
            for mix, over in (("", {}), ("mixture, ",
                                         dict(strategy="mixture")))]
    if arch in UNFUSED_PARITY_ARCHS + (AUDIO_ARCH,):
        configs += [(f"{kind}, unfused", dict(over, fused_step=False), reqs,
                     params) for kind, over, reqs, params in configs
                    if "speculative" not in over]
    mix_router = CentroidRouter(router.centroids, RouterConfig(top_k=2))
    # under expert drafting request 1 sits on expert 0's centroid, so the
    # mixture weighs expert 0 at > 0.99 and takes its drafts
    on_expert0 = feats.copy()
    on_expert0[1] = router.centroids[0].numpy()
    # the longest prompt and its budget, behind any image prefix
    cache_len = 56 + (cfg.n_patches if extras else 0)
    for kind, over, reqs, params in configs:
        ecfg = EngineConfig(n_slots=2, cache_len=cache_len, page_block=8,
                            chunk=16, **over)
        card, host = (make_engine(
            model, experts=experts, config=ecfg, device=dev,
            router=mix_router if "strategy" in over else router)
            for dev in ("cuda", "cpu"))
        fts = on_expert0 if over.get("speculative") == "expert" else feats
        gpu, groute, *_ = _serve(card, reqs, fts, params, extras)
        cpu, croute, *_ = _serve(host, reqs, fts, params, extras)
        if groute != croute:
            raise AssertionError(f"{cfg.arch_id}, {kind}: routing differs: "
                                 f"card {groute}, CPU {croute}")
        diverged = []
        for i in cpu:
            if gpu.get(i) == cpu[i]:
                continue
            sp = params(i)
            if sp.temperature <= 0 or gpu.get(i) is None:
                raise AssertionError(
                    f"{cfg.arch_id}, {kind}: card and CPU disagree on "
                    f"request {i}: {gpu.get(i)} vs {cpu[i]}")
            a, b = gpu[i][0], cpu[i][0]
            t = next(j for j in range(min(len(a), len(b)) + 1)
                     if j == min(len(a), len(b)) or a[j] != b[j])
            route = next(k for k, rids in enumerate(croute) if i in rids)
            margin, allowed = _sample_margin(host, model, reqs[i], b, t, sp,
                                             fts[i], route,
                                             extras[i] if extras else None)
            log(f"{cfg.arch_id}, {kind}: request {i} sampled token {t} "
                f"differs (card {a[t:t + 1]}, CPU {b[t:t + 1]}): its "
                f"Gumbel-plus-logit margin {margin:.3e}, allowed "
                f"{allowed:.3e}")
            if margin > allowed:
                raise AssertionError(
                    f"{cfg.arch_id}, {kind}: request {i}'s sampled token "
                    f"{t} differs at a margin of {margin:.3e}, past the "
                    f"{SAMPLE_MARGIN_ULPS} ulps ({allowed:.3e}) a log's "
                    f"last ulp can move")
            diverged.append(i)
        extra = f"; requests {diverged} diverged at a near-tie" \
            if diverged else ""
        if "speculative" in over:
            on_card, on_cpu = _spec_counts(card), _spec_counts(host)
            steps, toks = on_card
            # a trajectory that diverged at a near-tie speculates otherwise
            same = on_card == on_cpu or bool(diverged)
            # drafts must be accepted where the traffic is built for it:
            # expert drafting with request 1 on expert 0, and n-gram drafts
            # on Qwen3's periodic prompts (the other configs' random smoke
            # weights do not continue the period: InternVL2's, Granite's
            # and Llama's accept no n-gram draft on this traffic)
            accepts = over.get("speculative") == "expert" or (
                reqs is periodic and arch == "qwen3_8b")
            if not same or not steps or (
                    params is greedy and accepts and not toks > steps):
                raise AssertionError(
                    f"{kind}: (spec_steps, spec_tokens) card {on_card}, "
                    f"CPU {on_cpu}: they must be equal and nonzero, with "
                    f"spec_tokens > spec_steps on traffic built for "
                    f"acceptance")
            extra += f"; spec_steps, spec_tokens {on_card} on the card, " \
                f"{on_cpu} on the CPU"
        log(f"parity ({cfg.arch_id}{'' if cf is None else f', cf {cf}'}, "
            f"{kind}): {len(cpu)} requests, "
            f"routing {groute}, tokens and finish reasons equal on the "
            f"card and the CPU{extra}")
    if cf is not None:
        tally, moe_lib.DROP_TALLY = _drop_tally(), None
        log(f"parity ({cfg.arch_id}, cf {cf}): dropped (token, choice) "
            f"pairs by group width over every configuration, card and "
            f"CPU: {json.dumps(tally)}")
        dropped = sum(t["dropped"] for t in tally.values())
        if (dropped > 0) != (cf == MOE_DROP_CF):
            raise AssertionError(
                f"{cfg.arch_id} at cf {cf}: {dropped} pairs dropped; the "
                f"smoke configs' cf 8.0 drops none, {MOE_DROP_CF} must")
    if arch in HOST_LAYER_ARCHS:
        _host_layer_parity(arch, model, experts, router, mix_router)
    if arch in UNFUSED_PARITY_ARCHS:
        _batch_engine_parity(model, experts, router, mix_router, prompts,
                             feats)


def _greedy_gap(model, params, seq, weights=None):
    """The top-two gap of the CPU's greedy scores after ``seq`` — one
    model's logits, or with ``weights`` (1, K) the Eq. 27 mixture of an
    expert stack's — and the gap ``SAMPLE_MARGIN_ULPS`` ulps of the top
    value allow: a greedy pick can change between the card and the CPU
    only within it."""
    import numpy as np
    import torch
    from repro_torch.core.ensemble import mix_expert_logits

    batch = {"tokens": torch.as_tensor(np.asarray(seq)[None]
                                       .astype(np.int64))}
    logits, _ = model.prefill(params, batch, len(seq))
    row = logits[0, -1] if weights is None else \
        mix_expert_logits(logits[:, :, -1], weights)[0]
    top2 = torch.topk(row.float(), 2).values
    return (float(top2[0] - top2[1]),
            SAMPLE_MARGIN_ULPS * float(np.spacing(np.float32(abs(top2[0])))))


def _check_greedy_rows(label, got, want, gap):
    """Rows of greedy tokens, card against CPU: a row may differ only from
    a near-tie, where ``gap(row, prefix)`` (the CPU's scores after the
    prompt and the row's first tokens) is within its allowance. Returns
    the rows that diverged."""
    diverged = []
    for b, (a, w) in enumerate(zip(got, want)):
        if list(a) == list(w):
            continue
        t = next(j for j in range(len(w)) if a[j] != w[j])
        g, allowed = gap(b, list(w[:t]))
        log(f"{label}: row {b} token {t} differs (card {a[t]}, CPU {w[t]}): "
            f"its top-two gap {g:.3e}, allowed {allowed:.3e}")
        if g > allowed:
            raise AssertionError(f"{label}: row {b} token {t} differs at a "
                                 f"gap of {g:.3e}, past {allowed:.3e}")
        diverged.append(b)
    return diverged


def _batch_engine_parity(model, experts, router, mix_router, prompts,
                         feats, new=8):
    """The whole-batch engines at smoke size, card (kernels) vs CPU
    (plain): ``ServeEngine.generate`` greedy on expert 0 and
    ``DecentralizedServer.generate_top1`` and ``generate_mixture``
    (top_k 2) greedy over the prompts at least 13 tokens long, cut to 13:
    tokens equal, a row diverging only at a near-tie
    (``_check_greedy_rows``); ``mixture_next_probs`` and
    ``ensemble_eval_nll`` within rtol 1e-4."""
    import numpy as np
    import torch
    from repro_torch.serve.api import SamplingParams
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.ensemble_engine import DecentralizedServer
    from repro_torch.tree import tree_map

    S = 13
    keep = [i for i, p in enumerate(prompts) if len(p) >= S]
    toks = np.stack([prompts[i][:S] for i in keep])
    labels = np.roll(toks, -1, axis=1)
    greedy = SamplingParams(max_new=new, temperature=0.0)
    out = {}
    for dev in ("cpu", "cuda"):
        ex = [tree_map(lambda t: t.to(dev), p) for p in experts]
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "labels": torch.as_tensor(labels, device=dev),
                 "features": torch.as_tensor(feats[keep], device=dev)}
        top1 = DecentralizedServer(model, ex, router.to(dev), S + new)
        mix = DecentralizedServer(model, ex, mix_router.to(dev), S + new)
        out[dev] = {
            "ServeEngine.generate": ServeEngine(model, S + new).generate(
                ex[0], {"tokens": batch["tokens"]}, greedy).cpu().numpy(),
            "generate_top1": top1.generate_top1(batch, greedy),
            "generate_mixture": mix.generate_mixture(batch, greedy)
            .cpu().numpy(),
            "mixture_next_probs": mix.mixture_next_probs(batch).cpu(),
            "ensemble_eval_nll": mix.ensemble_eval_nll(batch).cpu()}
        if dev == "cpu":
            cpu_mix, routes = mix, router.top1(batch["features"]).numpy()
    stacked = cpu_mix._stacked_core()[0]
    weights = cpu_mix.route(torch.as_tensor(feats[keep]))
    gaps = {
        "ServeEngine.generate": lambda b, pre: _greedy_gap(
            model, experts[0], np.concatenate([toks[b], pre])),
        "generate_top1": lambda b, pre: _greedy_gap(
            model, experts[int(routes[b])], np.concatenate([toks[b], pre])),
        "generate_mixture": lambda b, pre: _greedy_gap(
            model, stacked, np.concatenate([toks[b], pre]),
            weights[b:b + 1])}
    notes = []
    for name, gap in gaps.items():
        d = _check_greedy_rows(f"parity ({model.cfg.arch_id}, {name})",
                               out["cuda"][name], out["cpu"][name], gap)
        notes.append(f"{name} {len(toks)} rows x {new} tokens equal"
                     + (f" but rows {d} (near-ties)" if d else ""))
    for name in ("mixture_next_probs", "ensemble_eval_nll"):
        torch.testing.assert_close(out["cuda"][name], out["cpu"][name],
                                   rtol=1e-4, atol=1e-9)
    log(f"parity ({model.cfg.arch_id}, whole-batch engines): "
        + "; ".join(notes) + f"; mixture probs and eval NLL within 1e-4 "
        f"(NLL card {float(out['cuda']['ensemble_eval_nll']):.6f}, CPU "
        f"{float(out['cpu']['ensemble_eval_nll']):.6f})")


#: the smoke-size configurations of the serving host layer, by arch: the
#: prefix cache (top-1 and mixture), preemption by swap and by recompute
#: (top-1 and mixture) and DRR admission over two tenants for Qwen3; the
#: prefix cache with one image for every request for InternVL2; swap and
#: recompute with the prefix cache asked for (and not built) for Zamba2
HOST_LAYER_ARCHS = {
    "qwen3_8b": ("prefix", "mixture prefix", "swap", "recompute",
                 "mixture swap", "mixture recompute", "drr"),
    "internvl2_2b": ("prefix",),
    "zamba2_2_7b": ("swap", "recompute"),
    "whisper_small": ("prefix", "prefix other frames", "swap"),
}
#: the preempting smoke configurations' pool: 8 usable blocks of 8 for two
#: slots whose requests grow to 7 blocks each
HOST_LAYER_POOL = 9


def _host_layer_parity(arch, model, experts, router, mix_router,
                       devices=("cuda", "cpu")):
    """The serving host layer at smoke size in float32, card ≡ CPU: each
    of ``HOST_LAYER_ARCHS[arch]``'s configurations served on both, with
    equal tokens, finish reasons, routing and ``occupancy()`` (every
    pod's ``stats()``: prefix, park and tenant counters). The prefix
    traffic shares a 19-token preamble (it splits a page block of 8) and
    routes to pod 0, so later requests hit; the preemption traffic's last
    three requests outrank the first three and the pool cannot hold two
    grown requests, so both preempting modes must park (or requeue) at
    least once; DRR serves two tenants weighted 1 : 3."""
    import numpy as np
    from repro_torch.serve.api import EngineConfig, QoSConfig, SamplingParams
    from repro_torch.serve.scheduler import make_engine

    cfg = model.cfg
    rng = np.random.default_rng(9)
    pre = rng.integers(0, cfg.vocab, 19).astype(np.int32)
    prefix_prompts = [np.concatenate([pre, rng.integers(
        0, cfg.vocab, n).astype(np.int32)]) for n in (5, 13, 9, 21, 3)]
    prefix_prompts.append(prefix_prompts[0].copy())        # a repeat
    lens = (30, 22, 8, 14, 26, 19)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    image = rng.normal(size=(cfg.n_patches, cfg.vision_dim)) \
        .astype(np.float32) if cfg.family == "vlm" else None
    # the audio family's frames: the prefix traffic's one set (the repeat
    # of request 0 under another set in "prefix other frames", where the
    # digest must miss) and the preemption traffic's one set a request
    frames = [rng.normal(size=(cfg.n_audio_frames, cfg.audio_dim))
              .astype(np.float32) for _ in range(len(lens))] \
        if cfg.family == "audio" else None
    on_pod0 = np.repeat(router.centroids[:1].cpu().numpy(), 6, 0)
    feats = rng.normal(size=(6, router.centroids.shape[1])) \
        .astype(np.float32)
    prefix = 56 + (cfg.n_patches if image is not None else 0)
    qos = QoSConfig(tenant_weights=(("a", 1.0), ("b", 3.0)))

    def greedy(i):
        return SamplingParams(max_new=12)

    def ranked(i):
        return SamplingParams(max_new=24, priority=int(i >= 3),
                              tenant="ab"[i % 2])

    base = dict(n_slots=2, cache_len=56, page_block=8, paged=True,
                chunked_prefill=True, chunk=16)
    kinds = {
        "prefix": (dict(prefix_cache=True, cache_len=prefix),
                   prefix_prompts, on_pod0, greedy),
        "swap": (dict(preemption="swap", pool_blocks=HOST_LAYER_POOL,
                      prefix_cache=True), prompts, feats, ranked),
        "recompute": (dict(preemption="recompute",
                           pool_blocks=HOST_LAYER_POOL, prefix_cache=True),
                      prompts, feats, ranked),
        "drr": (dict(qos=qos), prompts, on_pod0, ranked),
    }
    kinds["prefix other frames"] = kinds["prefix"]
    skipped_by_kind = {}
    for kind in HOST_LAYER_ARCHS[arch]:
        mixture = kind.startswith("mixture ")
        over, reqs, fts, params = kinds[kind.removeprefix("mixture ")]
        ecfg = EngineConfig(**dict(base, **over),
                            strategy="mixture" if mixture else "top1")
        extras = [{"patches": image}] * len(reqs) if image is not None \
            else None
        if frames is not None:
            extras = [{"frames": frames[i]} for i in range(len(reqs))] \
                if "preemption" in over else \
                [{"frames": frames[0]}] * len(reqs)
            if kind == "prefix other frames":
                extras[-1] = {"frames": frames[1]}
        runs = []
        for dev in devices:
            eng = make_engine(model, experts=experts, config=ecfg,
                              device=dev,
                              router=mix_router if mixture else router)
            res, routing, *_ = _serve(eng, reqs, fts, params, extras)
            runs.append((res, routing, eng.occupancy()))
            if over.get("prefix_cache") and not model.prefix_cacheable \
                    and any(p.prefix is not None for p in eng.pods):
                raise AssertionError(f"{arch}, {kind}: the prefix cache "
                                     f"was built for a hybrid model")
        if runs[0] != runs[1]:
            raise AssertionError(
                f"{arch}, host layer {kind}: card and CPU differ: "
                f"{runs[0]} vs {runs[1]}")
        res, routing, occ = runs[0]
        preempted = sum(t["preemptions"] for p in occ
                        for t in p.get("tenants", {}).values())
        skipped = sum(p.get("prefix_skipped_tokens", 0) for p in occ)
        if "preemption" in over and not preempted:
            raise AssertionError(f"{arch}, {kind}: nothing was preempted")
        if "prefix" in kind and not skipped:
            raise AssertionError(f"{arch}, {kind}: no prefix hit")
        skipped_by_kind[kind] = skipped
        if kind == "prefix other frames" and \
                not skipped < skipped_by_kind["prefix"]:
            raise AssertionError(
                f"{arch}, {kind}: the repeat of request 0 under other "
                f"frames skipped prompt tokens ({skipped} skipped, "
                f"{skipped_by_kind['prefix']} under the same frames)")
        if {r for _, r in res.values()} != {"length"}:
            raise AssertionError(f"{arch}, {kind}: finish reasons "
                                 f"{sorted(set(r for _, r in res.values()))}")
        log(f"parity ({cfg.arch_id}, host layer {kind}): {len(res)} "
            f"requests, routing {routing}, tokens, finish reasons and "
            f"every pod's stats equal on the card and the CPU; "
            f"{skipped} prompt tokens from the prefix cache, "
            f"{preempted} preemptions")


def _spec_counts(engine):
    """(spec_steps, spec_tokens) summed over the pods."""
    pods = engine.occupancy()
    return (sum(p["spec_steps"] for p in pods),
            sum(p["spec_tokens"] for p in pods))


def _serve_watched(label, mp, watch, kernels):
    """Serve ``mp``'s requests on its engine after a warm-up, with every
    logit the engine samples from — the first element returned by each
    ``(method, rows)`` of ``watch`` (``rows`` picks the sampled rows) —
    folded into one finiteness flag kept on the card and read once after
    the run. The launch counts are zeroed just before the run and read
    just after; each of ``kernels`` must have launched. Under the mixture
    the stacked decode steps and verify steps are counted over the same
    run: each decode step must have launched paged decode once per
    attention layer (not once per expert), each verify step paged verify
    once per attention layer and, when expert 0 drafts, paged decode
    ``SPEC_LEN - 1`` times per attention layer. Request i is served with
    ``mp.params(i)``. Returns (results, launches); the stats printed are
    kept in ``PATH_STATS[label]``."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_lib

    model = mp.model
    mp.warm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def watched(fn, rows):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            finite.logical_and_(torch.isfinite(rows(out[0])).all())
            return out
        return run

    for name, rows in watch:
        setattr(model, name, watched(getattr(model, name), rows))
    mixture = mp.engine.config.strategy == "mixture"
    calls, fused = {"_fstep": 0, "_fstep_chunk": 0, "_vstep": 0}, {}
    if mixture:                   # each fused step runs one stacked decode
        core = mp.engine.core
        fused = {name: getattr(core, name) for name in calls
                 if hasattr(core, name)}
        for name, fn in fused.items():
            def counted(*args, _fn=fn, _name=name):
                calls[_name] += 1
                return _fn(*args)
            setattr(core, name, counted)
    moe = model.cfg.family == "moe"
    try:
        ops.reset_launch_counts()
        calls.update(dict.fromkeys(calls, 0))
        if moe:
            moe_lib.DROP_TALLY = {}
        res, routing, outs, steps, wall = _serve(
            mp.engine, mp.prompts, mp.features, mp.params, mp.extras)
        launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    finally:
        drops = _drop_tally() if moe else None
        moe_lib.DROP_TALLY = None
        for name, _ in watch:
            delattr(model, name)
        for name, fn in fused.items():
            setattr(core, name, fn)
    n_req = len(mp.prompts)
    if len(res) != n_req or any(r is None for _, r in res.values()):
        raise AssertionError(f"{label}: unfinished requests: {sorted(res)}")
    zero = [n for n in kernels if launches[n] == 0]
    if zero:
        raise AssertionError(f"kernels never launched on the {label}: "
                             f"{zero}")
    if not bool(finite):
        raise AssertionError(f"non-finite logits on the {label}")
    n_tok = sum(len(t) for t, _ in res.values())
    stats = {"requests": n_req,
             "prompt_tokens": int(sum(len(p) for p in mp.prompts)),
             "image_prefix_rows": model.cfg.n_patches
             if model.cfg.family == "vlm" else 0,
             "new_tokens": mp.sampling.max_new, "generated_tokens": n_tok,
             "requests_per_pod": [len(r) for r in routing],
             "finish_reasons": sorted({r for _, r in res.values()}),
             "logits_finite": True,
             "steps": steps, "wall_s": wall, "tok_per_s": n_tok / wall,
             "mean_ttft_s": float(np.mean([o.ttft for o in outs.values()])),
             "step_ms": wall / steps * 1e3, "launches": launches,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "step_split": _registry_split(mp.engine)}
    if drops is not None:
        pairs = sum(t["pairs"] for t in drops.values())
        stats.update(
            dropped_share=sum(t["dropped"] for t in drops.values())
            / max(pairs, 1), drops_by_group_width=drops)
    if mixture:
        # the attention layers (the ssm family has none)
        n = 0 if model.cfg.family == "ssm" else model.n_groups
        decodes, verifies = (calls["_fstep"] + calls["_fstep_chunk"],
                             calls["_vstep"])
        drafts = verifies * (SPEC_LEN - 1) if core._can_spec \
            and core._ngram is None else 0
        stats.update(experts=core.K, decode_steps=decodes,
                     verify_steps=verifies, attention_layers=n,
                     paged_decode_launches_per_decode_step=(
                         launches["paged_decode_attention"] - drafts * n)
                     / max(decodes, 1))
        if launches["paged_decode_attention"] != (decodes + drafts) * n:
            raise AssertionError(
                f"{label}: {launches['paged_decode_attention']} paged "
                f"decode launches over {decodes} stacked decode steps and "
                f"{drafts} expert-0 draft micro-steps: not one per "
                f"attention layer ({n}) a step")
        if verifies:
            stats.update(
                paged_verify_launches_per_verify_step=launches[
                    "paged_verify_attention"] / verifies,
                draft_decode_launches_per_verify_step=drafts * n / verifies)
            if launches["paged_verify_attention"] != verifies * n:
                raise AssertionError(
                    f"{label}: {launches['paged_verify_attention']} paged "
                    f"verify launches over {verifies} stacked verify "
                    f"steps: not one per attention layer ({n}) a step")
    if mp.engine.config.speculative is not None:
        steps, toks = _spec_counts(mp.engine)
        stats.update(spec_steps=steps, spec_tokens=toks,
                     spec_tokens_per_step=toks / steps if steps else 0.0,
                     accept_rate=(toks - steps) / (steps * (SPEC_LEN - 1))
                     if steps else 0.0)
    log(f"{label}: " + json.dumps(stats))
    PATH_STATS[label] = stats
    return res, launches


#: each full-width path's printed stats, by label
PATH_STATS = {}


def phase_main_path():
    """Full-width Qwen3-8B, 2 experts, top-1, paged + chunked + fused
    (``repro_torch/launch/main_path.py``). Returns the deployment, its
    results and its launch counts."""
    import torch
    from repro_torch.launch import main_path

    t0 = time.perf_counter()
    mp = main_path.build("cuda")
    torch.cuda.synchronize()
    cfg = mp.cfg
    log(f"main path: {main_path.N_EXPERTS} experts of {cfg.arch_id} "
        f"({cfg.n_layers} layers, D={cfg.d_model}, bf16) initialized in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    # the decode forward inside each fused step, the last row of each
    # prefill chunk
    res, launches = _serve_watched(
        "main path", mp, (("decode_step_paged", lambda x: x),
                          ("prefill_chunk", lambda x: x)), MAIN_KERNELS)
    return mp, res, launches


def _greedy_divergence(label, mp, res, ref_res):
    """Requests whose greedy tokens in ``res`` differ from ``ref_res``'s
    (both served from ``mp``'s requests on the card): each must differ
    first at a near-tie, where the top-two gap of the card's scores (a
    prefill of the prompt and the tokens before it on the request's pod's
    expert, in the model's dtype) is within ``SAMPLE_MARGIN_ULPS`` ulps of
    the top value in that dtype. Returns the diverging requests."""
    import numpy as np
    import torch

    model, diverged = mp.model, []
    ulp_rel = torch.finfo(model.cfg.cdtype).eps
    for i, (toks, _) in ref_res.items():
        if res[i][0] == toks:
            continue
        route = mp.router.to(mp.device).top1(torch.as_tensor(
            mp.features, device=mp.device)).cpu().numpy()
        got = res[i][0]
        t = next(j for j in range(min(len(got), len(toks)))
                 if got[j] != toks[j])
        seq = np.concatenate([mp.prompts[i], np.asarray(toks[:t], np.int32)])
        with torch.no_grad():
            logits, _ = model.prefill(
                mp.experts[int(route[i])],
                {"tokens": torch.as_tensor(seq[None].astype(np.int64),
                                           device=mp.device)}, len(seq))
        top2 = torch.topk(logits[0, -1].float(), 2).values
        gap = float(top2[0] - top2[1])
        allowed = SAMPLE_MARGIN_ULPS * ulp_rel * float(abs(top2[0]))
        log(f"{label}: request {i} token {t} differs ({got[t]} vs "
            f"{toks[t]}): top-two gap {gap:.3e}, allowed {allowed:.3e}")
        if gap > allowed:
            raise AssertionError(f"{label}: request {i} token {t} differs "
                                 f"at a gap of {gap:.3e}, past {allowed:.3e}")
        diverged.append(i)
    return diverged


def phase_unfused_path(mp, main_res):
    """The main path's deployment (paged + chunked, the same model,
    experts and requests) with the unfused step (``main_path.unfused``):
    the same forwards at the same batch shapes, so its greedy tokens must
    be the main path's, a request differing only at a near-tie
    (``_greedy_divergence``). Prints its ms a step and the registry's
    dispatch / device_get split beside the fused main path's."""
    import torch
    from repro_torch.launch import main_path

    up = main_path.unfused(mp)
    torch.cuda.empty_cache()
    res, launches = _serve_watched(
        "unfused path", up, (("decode_step_paged", lambda x: x),
                             ("prefill_chunk", lambda x: x)), MAIN_KERNELS)
    diverged = _greedy_divergence("unfused path", mp, res, main_res)
    fused, st = PATH_STATS["main path"], PATH_STATS["unfused path"]
    log(f"unfused path: {len(main_res) - len(diverged)} of {len(main_res)} "
        f"requests got the main path's tokens"
        + (f", requests {diverged} diverged at near-ties" if diverged else "")
        + f"; ms a step {st['step_ms']:.2f} (fused {fused['step_ms']:.2f}), "
        f"tokens/s {st['tok_per_s']:.1f} (fused {fused['tok_per_s']:.1f}); "
        f"dispatch / device_get ms a step by pod "
        f"{json.dumps(st['step_split'])} (fused "
        f"{json.dumps(_registry_split(mp.engine))})")
    _drop(up.engine)
    return launches


def phase_batch_engine(mp):
    """The whole-batch ``DecentralizedServer`` at full width over the main
    path's model, experts and router: its first ``BATCH_REQUESTS``
    prompts cut to the shortest one's length, ``BATCH_NEW_TOKENS`` greedy
    tokens each, top-1 (grouped by routed expert) and the Eq. 27 mixture
    (top_k 2, the experts stacked). Tokens must be ids of the
    vocabulary; the top-1 run's equality with the slot path (the main
    engine serving the same cut prompts) is printed as information only,
    since the batch shapes differ and bf16 rounds them otherwise. Prints
    tokens/s and the kernel launches of each run."""
    from dataclasses import replace

    import numpy as np
    import torch
    from repro_torch.core.router import CentroidRouter, RouterConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import main_path
    from repro_torch.serve.api import SamplingParams
    from repro_torch.serve.ensemble_engine import DecentralizedServer

    B, new = BATCH_REQUESTS, BATCH_NEW_TOKENS
    S = min(len(p) for p in mp.prompts[:B])
    toks = np.stack([p[:S] for p in mp.prompts[:B]])
    batch = {"tokens": torch.as_tensor(toks, device=mp.device),
             "features": torch.as_tensor(mp.features[:B], device=mp.device)}
    greedy = SamplingParams(max_new=new, temperature=0.0)
    # the slot path over the same cut prompts, for the information line
    slot = replace(mp, prompts=list(toks), features=mp.features[:B],
                   sampling=replace(mp.sampling, max_new=new),
                   extras=mp.extras[:B])
    slot_res = _serve(slot.engine, slot.prompts, slot.features, slot.params,
                      slot.extras)[0]
    top1_router = mp.router.to(mp.device)
    mix_router = CentroidRouter(top1_router.centroids, RouterConfig(
        mp.router.config.temperature, main_path.MIXTURE_TOP_K))
    launches = {}
    for label, router, gen in (("top1", top1_router, "generate_top1"),
                               ("mixture", mix_router, "generate_mixture")):
        server = DecentralizedServer(mp.model, mp.experts, router,
                                     cache_len=S + new)
        getattr(server, gen)({k: v[:1] for k, v in batch.items()},
                             replace(greedy, max_new=2))        # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = np.asarray(torch.as_tensor(getattr(server, gen)(
            batch, greedy)).cpu())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = {n: fn.launches for n, fn in ops.KERNELS.items()}
        if out.shape != (B, new) or not ((out >= 0)
                                         & (out < mp.cfg.vocab)).all():
            raise AssertionError(f"batch engine ({label}): tokens of shape "
                                 f"{out.shape} outside [0, vocab)")
        same = f"; {sum(out[i].tolist() == slot_res[i][0] for i in range(B))}" \
            f" of {B} rows equal the top-1 slot path's tokens (information " \
            f"only: bf16, other batch shapes)" if label == "top1" else ""
        log(f"batch engine ({label}): {B} prompts of {S} tokens, {new} "
            f"greedy tokens each in {wall:.2f} s, "
            f"{B * new / wall:.1f} tok/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{same}; "
            f"launches "
            f"{json.dumps({k: v for k, v in launches[label].items() if v})}")
        del server                  # the mixture's stack is a copy
        torch.cuda.empty_cache()
    return launches


def phase_speculative_path(mp, main_res):
    """The main path's deployment with n-gram speculation over the same
    model, experts and requests (``main_path.speculative``)."""
    import torch
    from repro_torch.launch import main_path

    sp = main_path.speculative(mp)
    torch.cuda.empty_cache()
    # each span verify's rows, the decode forward of the steps that carry a
    # chunk or fall back, the last row of each prefill chunk
    res, launches = _serve_watched(
        "speculative path", sp, (("verify_step_paged", lambda x: x),
                                 ("decode_step_paged", lambda x: x),
                                 ("prefill_chunk", lambda x: x)),
        SPEC_KERNELS)
    same = sum(res[i][0] == main_res[i][0] for i in main_res)
    log(f"speculative path: {same} of {len(main_res)} requests got the same "
        f"tokens as on the main path (information only: in bf16 a span's "
        f"{SPEC_LEN}-row products round otherwise than one-row decode)")
    sp.engine = None                 # its paged pool is not needed again
    return launches


def phase_contiguous_path(mp, main_res):
    """The same model, experts and requests on contiguous caches with
    monolithic prefill and the fused step (``main_path.contiguous``)."""
    import torch
    from repro_torch.launch import main_path

    cp = main_path.contiguous(mp)
    mp.engine = None                 # its paged pool is not needed again
    torch.cuda.empty_cache()
    # the decode forward inside each fused step, each prefill's last row
    res, launches = _serve_watched(
        "contiguous path", cp, (("decode_step", lambda x: x),
                                ("prefill", lambda x: x[:, -1])),
        CONTIGUOUS_KERNELS)
    same = sum(res[i][0] == main_res[i][0] for i in main_res)
    first = sum(res[i][0][0] == main_res[i][0][0] for i in main_res)
    log(f"contiguous path: {same} of {len(main_res)} requests got the same "
        f"tokens as on the main path, {first} the same first token "
        f"(information only: bf16 rounding differs between the paths)")
    return launches


#: the prefix path's traffic: one shared preamble of 512 tokens (32 full
#: blocks of 16, two whole chunks of 256) ahead of each request's own
#: 128-448 seeded tokens
PREFIX_PREAMBLE = 512
PREFIX_SUFFIX = (128, 448)
PREFIX_SEED = 4000
#: the preemption path: a pool of 160 blocks a pod (full capacity is
#: 8 x 68 + 1 = 545), the main path's first 8 prompts as tenant "batch"
#: (priority 0, weight 1) and 8 seeded 256-token prompts as tenant
#: "interactive" (priority 1, weight 3), arriving after step 16: by then
#: every admitted batch request decodes (at step 6 most still prefilled,
#: so every victim was a mid-prefill requeue, no swap or recompute park)
PREEMPT_POOL = 160
PREEMPT_ARRIVAL_STEP = 16
PREEMPT_NEW_TOKENS = 32
PREEMPT_SEED = 5000


def _step_split_by_kind(doc):
    """Mean host ms of each step kind's ``dispatch`` (launches queued) and
    ``device_get`` (the one readback) from an exported trace: on every
    pod's step track a ``step:<kind>`` span encloses one of each."""
    from repro_torch.obs.trace import STEP_TID
    spans = sorted((e for e in doc["traceEvents"]
                    if e["ph"] == "X" and e["tid"] == STEP_TID),
                   key=lambda e: (e["pid"], e["ts"], -e["dur"]))
    split, kind = {}, None
    for e in spans:
        if e["name"].startswith("step:"):
            kind = e["name"][5:]
            split.setdefault(kind, {"steps": 0, "dispatch": 0.0,
                                    "device_get": 0.0})
            split[kind]["steps"] += 1
        elif kind is not None:
            split[kind][e["name"]] += e["dur"] / 1e3
    return {k: {"steps": v["steps"],
                "dispatch_ms": v["dispatch"] / v["steps"],
                "device_get_ms": v["device_get"] / v["steps"]}
            for k, v in split.items()}


def _registry_split(engine):
    """Per pod, the registry's mean ``serve_step_dispatch_seconds`` and
    ``serve_step_device_get_seconds`` in ms over every step."""
    return [{"pod": p.obs.pod, "steps": p.obs.dispatch_s.count,
             "dispatch_ms": p.obs.dispatch_s.sum / p.obs.dispatch_s.count
             * 1e3 if p.obs.dispatch_s.count else 0.0,
             "device_get_ms": p.obs.readback_s.sum / p.obs.readback_s.count
             * 1e3 if p.obs.readback_s.count else 0.0}
            for p in engine.pods]


def _drop(engine):
    """Free an engine's pools now: its pods hold reference cycles (the
    sanitizer's table, the swap timers' bound methods) that only the
    collector breaks, and the next full-width path needs the memory."""
    import gc
    import torch
    engine.pods.clear()
    del engine
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _serve_staged(engine, prompts, feats, params, stages):
    """Serve ``prompts`` submitted in ``stages``: ``(rids, until)`` pairs,
    each stage's requests submitted once ``until(step, outputs)`` of the
    stage before holds; then step to the end. Returns (results, outputs,
    steps, wall seconds, launches)."""
    import torch
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    res, outs, steps = {}, {}, 0
    t0 = time.perf_counter()
    for rids, until in stages:
        while not until(steps, outs):
            for o in engine.step():
                outs[o.rid] = o
                if o.finished:
                    res[o.rid] = (o.token_ids, o.finish_reason)
            steps += 1
        for i in rids:
            engine.add_request(prompts[i], params(i), features=feats[i],
                               rid=i)
    while engine.has_unfinished():
        for o in engine.step():
            outs[o.rid] = o
            if o.finished:
                res[o.rid] = (o.token_ids, o.finish_reason)
        steps += 1
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, outs, steps, wall, {n: fn.launches
                                    for n, fn in ops.KERNELS.items()}


def phase_prefix_path(mp, preamble=PREFIX_PREAMBLE, suffix=PREFIX_SUFFIX):
    """Full-width Qwen3-8B on the main path's deployment with
    ``prefix_cache=True``: 16 requests of one shared 512-token preamble and
    their own 128-448 tokens, 64 new tokens each. The first request routed
    to each pod is served until both have emitted their first token, then
    the other 14 arrive at once; each must map the preamble's 32 blocks
    from the cache, so the pods skip exactly 14 x 512 prompt tokens. The
    same traffic is served without the cache. Every request must finish
    with ``length`` and no block may leak (a pod's free list holds all but
    its cached blocks). The cached run is traced and its metrics
    published: the trace is written under ``build/``, read back and its
    spans counted."""
    import numpy as np
    import torch
    from dataclasses import replace
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve.api import SamplingParams
    from repro_torch.serve.scheduler import make_engine

    rng = np.random.default_rng(PREFIX_SEED)
    vocab, n = mp.cfg.vocab, len(mp.prompts)
    pre = rng.integers(0, vocab, preamble).astype(np.int32)
    lo, hi = suffix
    prompts = [np.concatenate([pre, rng.integers(0, vocab, m)
                               .astype(np.int32)])
               for m in rng.integers(lo, hi + 1, n)]
    route = mp.router.top1(torch.as_tensor(
        mp.features, device=mp.router.centroids.device)).cpu().numpy()
    firsts = sorted({int(k): i for i, k in
                     reversed(list(enumerate(route)))}.values())
    rest = [i for i in range(n) if i not in firsts]
    cap = max(len(p) for p in prompts) + mp.sampling.max_new
    runs = {}
    for cached in (False, True):
        engine = make_engine(
            mp.model, experts=mp.experts, router=mp.router,
            device=mp.device, config=replace(
                mp.config, cache_len=max(mp.config.cache_len, cap),
                prefix_cache=cached, trace=cached, metrics=cached))
        if mp.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        stages = [(firsts, lambda s, o: True),
                  (rest, lambda s, o: all(i in o and o[i].t_first > 0
                                          for i in firsts))]
        res, outs, steps, wall, launches = _serve_staged(
            engine, prompts, mp.features,
            lambda i: replace(mp.sampling, seed=mp.sampling.seed + i),
            stages)
        reasons = sorted({r for _, r in res.values()})
        if len(res) != n or reasons != ["length"]:
            raise AssertionError(f"prefix path (cache {cached}): "
                                 f"{len(res)} of {n} finished, {reasons}")
        occ = engine.occupancy()
        n_tok = sum(len(t) for t, _ in res.values())
        stats = {
            "prefix_cache": cached, "requests": n,
            "preamble_tokens": preamble,
            "prompt_tokens": int(sum(len(p) for p in prompts)),
            "first_requests": firsts, "steps": steps, "wall_s": wall,
            "step_ms": wall / steps * 1e3, "tok_per_s": n_tok / wall,
            "chunk_prefill_launches": launches["chunk_prefill_attention"],
            "paged_decode_launches": launches["paged_decode_attention"],
            "hit_requests_mean_ttft_s": float(np.mean(
                [outs[i].ttft for i in rest])),
            "first_requests_mean_ttft_s": float(np.mean(
                [outs[i].ttft for i in firsts])),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30
            if mp.device.type == "cuda" else None,
            "registry_step_split": _registry_split(engine)}
        if cached:
            skipped = sum(p["prefix_skipped_tokens"] for p in occ)
            if skipped != len(rest) * preamble:
                raise AssertionError(
                    f"prefix path: {skipped} prompt tokens from the cache, "
                    f"not {len(rest)} x {preamble}")
            for pod, st in zip(engine.pods, occ):
                a = pod.allocator
                if a.n_free != a.n_blocks - 1 - st["prefix_cached_blocks"]:
                    raise AssertionError(
                        f"prefix path: pod {pod.obs.pod} leaked blocks: "
                        f"{a.n_free} free of {a.n_blocks}, "
                        f"{st['prefix_cached_blocks']} cached")
            path = HERE / "build" / "prefix_path_trace.json"
            path.parent.mkdir(exist_ok=True)
            engine.export_trace(str(path))
            doc = json.loads(path.read_text())
            stats.update(
                prefix_skipped_tokens=skipped,
                prefix_cached_blocks=[p["prefix_cached_blocks"]
                                      for p in occ],
                trace_file=str(path.relative_to(HERE)),
                trace_events=len(doc["traceEvents"]),
                trace_spans=sum(e["ph"] == "X" for e in doc["traceEvents"]),
                trace_split_by_kind=_step_split_by_kind(doc),
                published_series=len(obs_metrics.snapshot()["metrics"]))
        runs[cached] = (res, stats)
        log(f"prefix path: " + json.dumps(stats))
        _drop(engine)
    same = sum(runs[True][0][i][0] == runs[False][0][i][0] for i in range(n))
    log(f"prefix path: {same} of {n} requests got the same tokens with and "
        f"without the cache (information only: in bf16 a chunk starting "
        f"at 512 rounds otherwise than the same rows inside a longer "
        f"prefill); chunk-prefill launches "
        f"{runs[True][1]['chunk_prefill_launches']} cached, "
        f"{runs[False][1]['chunk_prefill_launches']} uncached")
    PATH_STATS["prefix path"] = {
        "cached": runs[True][1], "uncached": runs[False][1],
        "same_tokens": same}
    return launches


class _TimedSpec:
    """A pod's ``CacheSpec`` with its ``swap_in`` timed (host ms, after a
    device synchronisation the measurement adds) and counted."""

    def __init__(self, spec, log_):
        self._spec, self._log = spec, log_

    def __getattr__(self, name):
        return getattr(self._spec, name)

    def swap_in(self, cache, payload, slot, blocks):
        import torch
        t = time.perf_counter()
        out = self._spec.swap_in(cache, payload, slot, blocks)
        if next(iter(cache.values())).is_cuda:
            torch.cuda.synchronize()
        self._log.append(("in", (time.perf_counter() - t) * 1e3,
                          sum(v.nbytes for v in payload.values())))
        return out


def _time_swaps(engine, log_):
    """Wrap every pod's swap out (its one readback) and swap in."""
    for pod in engine.pods:
        fn = pod._swap_out_host

        def timed(slot, blocks, _fn=fn):
            t = time.perf_counter()
            out = _fn(slot, blocks)
            log_.append(("out", (time.perf_counter() - t) * 1e3,
                         sum(v.nbytes for v in out.values())))
            return out
        pod._swap_out_host = timed
        pod.spec = _TimedSpec(pod.spec, log_)


def phase_preemption_path(mp, pool=PREEMPT_POOL,
                          arrival=PREEMPT_ARRIVAL_STEP, inter_len=256):
    """Full-width Qwen3-8B on the main path's experts with ``pool`` blocks a
    pod and a ``QoSConfig`` of two tenants: the main path's first 8 prompts
    as ``batch`` (priority 0, weight 1), then, after step ``arrival``, 8
    seeded ``inter_len``-token prompts as ``interactive`` (priority 1,
    weight 3), ``PREEMPT_NEW_TOKENS`` new tokens each. Served three times:
    ``preemption="off"`` on a full-capacity pool (``pool`` blocks without
    preemption run out while the admitted requests grow: the engine then
    raises, as the reference's does), ``"swap"`` with the PoolSanitizer,
    and ``"recompute"``. In both preempting modes at least 2 decoding
    requests must be parked in that mode, every preempted one resumed, nothing parked at the end, no sanitizer
    violation and every request finished with ``length``."""
    import numpy as np
    import torch
    from dataclasses import replace
    from repro_torch.serve.api import QoSConfig, SamplingParams
    from repro_torch.serve.scheduler import make_engine

    rng = np.random.default_rng(PREEMPT_SEED)
    n_batch = 8
    prompts = list(mp.prompts[:n_batch]) + [
        rng.integers(0, mp.cfg.vocab, inter_len).astype(np.int32)
        for _ in range(8)]
    feats = mp.features[:len(prompts)]
    qos = QoSConfig(tenant_weights=(("batch", 1.0), ("interactive", 3.0)))

    def params(i):
        inter = i >= n_batch
        return SamplingParams(max_new=PREEMPT_NEW_TOKENS,
                              priority=int(inter),
                              tenant="interactive" if inter else "batch")

    runs = {}
    for mode in ("off", "swap", "recompute"):
        engine = make_engine(
            mp.model, experts=mp.experts, router=mp.router,
            device=mp.device, config=replace(
                mp.config, pool_blocks=pool if mode != "off" else 0,
                qos=qos, preemption=mode, sanitize=mode == "swap"))
        swaps = []
        _time_swaps(engine, swaps)
        stages = [(range(n_batch), lambda s, o: True),
                  (range(n_batch, len(prompts)),
                   lambda s, o: s >= arrival)]
        res, outs, steps, wall, launches = _serve_staged(
            engine, prompts, feats, params, stages)
        occ = engine.occupancy()
        tenants = {}
        for st in occ:
            for t, d in st["tenants"].items():
                for k in ("preemptions", "resumes", "rejections", "tokens"):
                    tenants.setdefault(t, {}).setdefault(k, 0)
                    tenants[t][k] += d[k]
        preempted = sum(d["preemptions"] for d in tenants.values())
        by_mode = {}
        for m in engine.export_metrics()["metrics"]:
            if m["name"] == "serve_preemptions_total":
                k = m["labels"]["mode"]
                by_mode[k] = by_mode.get(k, 0) + int(m["value"])
        resumed = sum(d["resumes"] for d in tenants.values())
        parked = sum(st["parked"] for st in occ)
        reasons = sorted({r for _, r in res.values()})
        out_ = [s for s in swaps if s[0] == "out"]
        in_ = [s for s in swaps if s[0] == "in"]
        stats = {
            "mode": mode, "pool_blocks": engine.pods[0].allocator.n_blocks,
            "arrival_step": arrival,
            "steps": steps, "wall_s": wall, "step_ms": wall / steps * 1e3,
            "tok_per_s": sum(len(t) for t, _ in res.values()) / wall,
            "interactive_mean_ttft_s": float(np.mean(
                [outs[i].ttft for i in range(n_batch, len(prompts))])),
            "batch_mean_ttft_s": float(np.mean(
                [outs[i].ttft for i in range(n_batch)])),
            "preemptions": preempted, "resumes": resumed,
            "preemptions_by_mode": by_mode,
            "parked_at_end": parked, "tenants": tenants,
            "chunk_prefill_launches": launches["chunk_prefill_attention"],
            "swap_outs": len(out_), "swap_ins": len(in_),
            "swapped_out_bytes": sum(b for _, _, b in out_),
            "swapped_in_bytes": sum(b for _, _, b in in_),
            "swap_out_host_ms_mean": float(np.mean([m for _, m, _ in out_]))
            if out_ else None,
            "swap_in_host_ms_mean": float(np.mean([m for _, m, _ in in_]))
            if in_ else None,
            "registry_step_split": _registry_split(engine)}
        if mode == "swap":
            stats["sanitizer"] = [{k: st[k] for k in st
                                   if k.startswith("sanitize_")}
                                  for st in occ]
        if len(res) != len(prompts) or reasons != ["length"]:
            raise AssertionError(f"preemption path ({mode}): {len(res)} of "
                                 f"{len(prompts)} finished, {reasons}")
        if mode != "off" and (by_mode.get(mode, 0) < 2
                              or resumed != preempted or parked):
            raise AssertionError(
                f"preemption path ({mode}): {preempted} preemptions, "
                f"{resumed} resumes, {parked} parked at the end (pool "
                f"{pool}, arrival step {arrival})")
        if mode == "swap" and any(st["sanitize_violations"] for st in occ):
            raise AssertionError("preemption path: sanitizer violations")
        runs[mode] = (res, stats)
        log(f"preemption path: " + json.dumps(stats))
        _drop(engine)
    same = {m: sum(runs[m][0][i][0] == runs["off"][0][i][0]
                   for i in runs["off"][0]) for m in ("swap", "recompute")}
    log(f"preemption path: requests with the same tokens as the run "
        f"without preemption: {same} of {len(prompts)} (information "
        f"only: in bf16 a resumed request's rows round otherwise)")
    PATH_STATS["preemption path"] = {m: r[1] for m, r in runs.items()}
    PATH_STATS["preemption path"]["same_tokens"] = same
    return launches


def _mixture_of(mp, **kw):
    """``main_path.mixture(mp, **kw)`` with ``MIXTURE_NEW_TOKENS`` a
    request."""
    from dataclasses import replace
    from repro_torch.launch import main_path

    return replace(main_path.mixture(mp, **kw), sampling=replace(
        mp.sampling, max_new=MIXTURE_NEW_TOKENS))


def phase_sampled_path(mp, main_res):
    """The main path's deployment with seeded sampling
    (``main_path.sampled``: temperature 0.8, top_k 50, request i seeded
    ``SAMPLE_SEED + i``) over the same model, experts and requests, served
    twice on fresh engines: the main path's checks, and the two runs must
    give the same tokens. Prints its ms a step and tokens/s beside the
    greedy main path's."""
    import torch
    from repro_torch.launch import main_path

    runs = []
    for label in ("sampled path", "sampled path, again"):
        sp = main_path.sampled(mp)
        torch.cuda.empty_cache()
        res, launches = _serve_watched(
            label, sp, (("decode_step_paged", lambda x: x),
                        ("prefill_chunk", lambda x: x)), MAIN_KERNELS)
        runs.append(res)
        sp.engine = None
    if runs[0] != runs[1]:
        diff = [i for i in runs[0] if runs[0][i] != runs[1].get(i)]
        raise AssertionError(f"sampled path: two runs of the same seeded "
                             f"requests differ on requests {diff}")
    same = sum(runs[0][i][0] == main_res[i][0] for i in main_res)
    greedy, st = PATH_STATS["main path"], PATH_STATS["sampled path"]
    log(f"sampled path: both runs gave the same tokens; {same} of "
        f"{len(main_res)} requests match the greedy main path; ms a step "
        f"{st['step_ms']:.2f} (greedy {greedy['step_ms']:.2f}), tokens/s "
        f"{st['tok_per_s']:.1f} (greedy {greedy['tok_per_s']:.1f})")
    return launches


def phase_mixture_path(mp, main_res):
    """The main path's deployment under the Eq. 27 mixture
    (``main_path.mixture``: both experts stacked, top_k 2, so both weigh
    in at every token) over the same model, experts and requests. The
    stack is a copy: the per-expert tensors are dropped once it is made.
    Returns the deployment (the stack is kept for the speculative mixture
    path) and its launch counts."""
    import torch

    t0 = time.perf_counter()
    xp = _mixture_of(mp)
    mp.experts = xp.experts = None      # the stack holds the weights now
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"mixture path: {xp.engine.core.K} experts stacked in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    res, launches = _serve_watched(
        "mixture path", xp, (("decode_step_paged", lambda x: x),
                             ("prefill_chunk", lambda x: x)), MAIN_KERNELS)
    same = sum(res[i][0] == main_res[i][0][:MIXTURE_NEW_TOKENS]
               for i in main_res)
    log(f"mixture path: {same} of {len(main_res)} requests got the top-1 "
        f"main path's first {MIXTURE_NEW_TOKENS} tokens (information only: "
        f"the mixture weighs both experts in)")
    return xp, launches


def phase_mixture_speculative_path(xp):
    """The mixture path's deployment with ``speculative="expert"`` and
    ``spec_len`` = ``SPEC_LEN`` (``main_path.mixture``): expert 0 drafts
    on the device, the stacked verify checks all K·B rows at once. Its
    experts are views of the mixture path's stack, stacked again before
    that engine is dropped, so the card holds two stacks at most. The
    main path's checks, and each verify step must launch paged verify once
    per attention layer and paged decode ``SPEC_LEN - 1`` times per layer
    for the drafts. Prints steps, ms a step, tokens/s, mean TTFT, peak GiB
    and the accept rate (information only: random weights accept few
    drafts). Returns its launch counts."""
    from dataclasses import replace

    import torch
    from repro_torch.core.ensemble import expert_slice

    t0 = time.perf_counter()
    core = xp.engine.core
    views = [expert_slice(core.stacked, k) for k in range(core.K)]
    sp = _mixture_of(replace(xp, experts=views), speculative="expert")
    # the views hold the old stack: drop them with its engine
    xp.engine = sp.experts = core = views = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"mixture speculative path: {sp.engine.core.K} experts stacked in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    # each span verify's rows, each decode forward (the expert-0 draft
    # micro-steps' included), the last row of each prefill chunk
    _, launches = _serve_watched(
        "mixture speculative path", sp,
        (("verify_step_paged", lambda x: x),
         ("decode_step_paged", lambda x: x),
         ("prefill_chunk", lambda x: x)), SPEC_KERNELS)
    sp.engine = None
    return launches


def phase_mixture_float32():
    """Full-width Qwen3-8B in float32 at ``MIXTURE_F32_LAYERS`` layers, 2
    experts: each expert's logits from the stacked chunked prefill (every
    chunk) and one stacked paged decode step against that expert's own
    single-model steps on the same inputs, within ``F32_LOGIT_TOL``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.ensemble import stack_experts_for_decode
    from repro_torch.launch import main_path
    from repro_torch.models import build_model

    cfg = get_config(main_path.ARCH).reduced(
        n_layers=MIXTURE_F32_LAYERS, param_dtype="float32",
        compute_dtype="float32")
    model = build_model(cfg)
    experts = [model.init(torch.Generator(device="cuda").manual_seed(k))
               for k in range(main_path.N_EXPERTS)]
    stacked = stack_experts_for_decode(experts)
    lo, hi, block, chunk = main_path.FULL_SHAPE
    cache_len = hi + main_path.NEW_TOKENS
    nb = -(-cache_len // block)
    table = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")
    width = 702
    toks = np.random.default_rng(5).integers(0, cfg.vocab, width)
    batch = {"tokens": torch.nn.functional.pad(torch.as_tensor(
        toks[None], device="cuda"), (0, -width % chunk))}
    pos = torch.tensor([width], dtype=torch.int32, device="cuda")

    tok = torch.tensor([int(toks[0])], dtype=torch.int32, device="cuda")

    def steps(params, experts_dim):
        """The chunk steps' logits, then one paged decode step's."""
        pool = model.init_paged_cache(1, nb + 1, block, cache_len,
                                      device="cuda", experts=experts_dim)
        x = model.embed_prompt(params, batch)
        carry = model.init_chunk_carry(params, batch, cache_len)
        out = []
        for start in range(0, width, chunk):
            logits, carry, pool = model.prefill_chunk(
                params, pool, carry, x[:, start:start + chunk], start,
                min(chunk, width - start), table)
            out.append(logits)
        out.append(model.decode_step_paged(params, pool, tok, pos,
                                           table[None])[0])
        return out

    before = _launches()
    mixed = steps(stacked, len(experts))
    launched = {k: v - before[k] for k, v in _launches().items()}
    worst = 0.0
    for k, params in enumerate(experts):
        for one, both in zip(steps(params, 0), mixed):
            worst = max(worst, (one - both[k]).abs().max().item())
    log(f"mixture float32: full-width {cfg.arch_id} at {cfg.n_layers} "
        f"layers, {len(experts)} experts, a {width}-token prompt in "
        f"{len(mixed) - 1} chunks and one paged decode step: each expert's "
        f"logits from the stacked steps vs its own single-model steps, max "
        f"abs diff {worst:.3e} (tolerance {F32_LOGIT_TOL}); the stacked "
        f"steps launched {launched['chunk_prefill_attention']} chunk-prefill "
        f"and {launched['paged_decode_attention']} paged-decode kernels "
        f"({cfg.n_layers} a step)")
    want = {"chunk_prefill_attention": (len(mixed) - 1) * cfg.n_layers,
            "paged_decode_attention": cfg.n_layers}
    if not worst <= F32_LOGIT_TOL or any(launched[k] != v
                                         for k, v in want.items()):
        raise AssertionError(
            f"mixture float32: stacked vs single {worst:.3e} (tolerance "
            f"{F32_LOGIT_TOL}), launches {launched} (want {want})")


def _launches():
    from repro_torch.kernels import ops
    return {n: fn.launches for n, fn in ops.KERNELS.items()}


def phase_float32_agreement():
    """Full-width Qwen3-8B, one expert in float32: monolithic prefill then
    a contiguous decode step, against chunked prefill then a paged decode
    step, on two prompts; then a span verify against paged decode steps,
    and the fused verify step with oracle drafts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import main_path
    from repro_torch.models import build_model

    cfg = get_config(main_path.ARCH).reduced(param_dtype="float32",
                                             compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    lo, hi, block, chunk = main_path.FULL_SHAPE
    cache_len = hi + main_path.NEW_TOKENS
    nb = -(-cache_len // block)
    table = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(3)
    # the span at 702 crosses a block edge (704), the one at 1024 starts on
    # one
    worst, agree, widths = 0.0, 0, (702, hi)
    v_worst, v_agree, fused_bad = 0.0, 0, []
    for width in widths:
        toks = rng.integers(0, cfg.vocab, width)
        batch = {"tokens": torch.as_tensor(toks[None], device="cuda")}
        logits, row = model.prefill(params, batch, cache_len)
        mono = logits[0, -1]
        cache = model.cache_spec().insert(
            model.init_cache(1, cache_len, device="cuda"), row, 0)
        pool = model.init_paged_cache(1, nb + 1, block, cache_len,
                                      device="cuda")
        x = model.embed_prompt(params, {"tokens": torch.nn.functional.pad(
            batch["tokens"], (0, -width % chunk))})
        carry = model.init_chunk_carry(params, batch, cache_len)
        for start in range(0, width, chunk):
            chunked, carry, pool = model.prefill_chunk(
                params, pool, carry, x[:, start:start + chunk], start,
                min(chunk, width - start), table)
        tok = mono.argmax()[None].to(torch.int32)
        pos = torch.tensor([width], dtype=torch.int32, device="cuda")
        dec, _ = model.decode_step(params, cache, tok, pos)
        dec_paged, _ = model.decode_step_paged(params, pool, tok, pos,
                                               table[None])
        agree += int(mono.argmax() == chunked[0].argmax()) \
            + int(dec[0].argmax() == dec_paged[0].argmax())
        worst = max(worst, (mono - chunked[0]).abs().max().item(),
                    (dec - dec_paged).abs().max().item())
        # the greedy chain from `tok`: paged decode steps that each commit
        # the previous step's pick, from a copy of the pool as the chunked
        # prefill left it (the decode step above wrote position `width`
        # with the same token); its picks are the oracle drafts
        span, rows = [tok], []
        step_pool = {k: v.clone() for k, v in pool.items()}
        for j in range(SPEC_LEN):
            row, step_pool = model.decode_step_paged(
                params, step_pool, span[j], pos + j, table[None])
            rows.append(row[0])
            span.append(row[0].argmax()[None].to(torch.int32))
        picks = torch.cat(span[1:])
        ver, _ = model.verify_step_paged(
            params, {k: v.clone() for k, v in pool.items()},
            torch.cat(span[:-1])[None], pos, table[None])
        for j in range(SPEC_LEN):
            v_worst = max(v_worst, (ver[0, j] - rows[j]).abs().max().item())
            v_agree += int(ver[0, j].argmax() == picks[j])
        fused_bad += _check_fused_verify(model, params, pool, table, tok,
                                         pos, picks, cache_len)
    log(f"float32 agreement: full-width {cfg.arch_id}, prompts of {widths} "
        f"tokens: monolithic + contiguous vs chunked + paged last-row logits "
        f"max abs diff {worst:.3e} (tolerance {F32_LOGIT_TOL}), greedy "
        f"picks equal {agree} of 4")
    n_rows = SPEC_LEN * len(widths)
    log(f"float32 agreement: span verify of {SPEC_LEN} positions vs paged "
        f"decode at pos + j after the drafts are committed: logits max abs "
        f"diff {v_worst:.3e} (tolerance {F32_LOGIT_TOL}), greedy picks "
        f"equal {v_agree} of {n_rows}")
    n_fused = len(FUSED_VERIFY_CASES) * len(widths)
    log(f"float32 agreement: fused verify step with the greedy chain as "
        f"drafts: {n_fused - len(fused_bad)} of {n_fused} cases (full accept, "
        f"stop, length and context halts mid-span) gave the decode steps' "
        f"tokens, emit count, done code, pos and tok")
    if not worst <= F32_LOGIT_TOL:
        raise AssertionError(f"float32 paths disagree: {worst:.3e} > "
                             f"{F32_LOGIT_TOL}")
    if not v_worst <= F32_LOGIT_TOL or v_agree != n_rows:
        raise AssertionError(
            f"float32 span verify disagrees with decode: {v_worst:.3e} "
            f"(tolerance {F32_LOGIT_TOL}), picks equal {v_agree} of "
            f"{n_rows}")
    if fused_bad:
        raise AssertionError(f"fused verify step: {fused_bad}")


def phase_hybrid_path():
    """Full-width Zamba2-2.7B, 2 experts, top-1, paged + chunked + fused:
    the main path's deployment and traffic (``main_path.build(arch=
    HYBRID_ARCH)``); every chunk-scan call must take the tensor cores.
    Then the same deployment under the Eq. 27 mixture
    (``main_path.mixture``, top_k 2), with the same checks. Returns the
    top-1 run's launch counts, the chunk scan's tensor-core calls in it,
    and the mixture run's launch counts."""
    import torch
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.launch import main_path

    t0 = time.perf_counter()
    mp = main_path.build("cuda", arch=main_path.HYBRID_ARCH)
    torch.cuda.synchronize()
    cfg = mp.cfg
    log(f"hybrid path: {main_path.N_EXPERTS} experts of {cfg.arch_id} "
        f"({cfg.n_layers} Mamba2 layers in {mp.model.n_groups} groups + a "
        f"shared attention block, D={cfg.d_model}, bf16) initialized in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    _, launches = _serve_watched(
        "hybrid path", mp, (("decode_step_paged", lambda x: x),
                            ("prefill_chunk", lambda x: x)), HYBRID_KERNELS)
    # zeroed with the launch counts just before the run; nothing has
    # launched since it ended
    tensor_core = cs.chunk_scan.tensor_core_launches
    log(f"hybrid path: {tensor_core} of {launches['chunk_scan']} chunk-scan "
        f"calls took the tensor cores")
    if tensor_core != launches["chunk_scan"]:
        raise AssertionError(
            f"hybrid path: {launches['chunk_scan'] - tensor_core} of "
            f"{launches['chunk_scan']} chunk-scan calls took the scalar "
            f"route")
    mp.engine = None                 # the top-1 pools, before the stack
    xp = _mixture_of(mp)
    mp.experts = xp.experts = None   # the stack holds the weights now
    torch.cuda.empty_cache()
    _, mix_launches = _serve_watched(
        "hybrid mixture path", xp, (("decode_step_paged", lambda x: x),
                                    ("prefill_chunk", lambda x: x)),
        HYBRID_KERNELS)
    mix_tc = cs.chunk_scan.tensor_core_launches
    log(f"hybrid mixture path: {mix_tc} of {mix_launches['chunk_scan']} "
        f"chunk-scan calls took the tensor cores")
    if mix_tc != mix_launches["chunk_scan"]:
        raise AssertionError("hybrid mixture path: a chunk-scan call took "
                             "the scalar route")
    return launches, tensor_core, mix_launches


def phase_ssm_path():
    """Full-width xLSTM-125M (12 layers: 3 groups of 3 mLSTM layers and one
    sLSTM layer, D = 768, vocab 50304, bf16), 2 experts, top-1, on the main
    path's deployment and traffic (``main_path.build(arch=SSM_ARCH)``: 8
    slots a pod, prompts of 256-1024 tokens in chunks of 256; paged, which
    for this family serves its per-slot states) with ``SSM_NEW_TOKENS`` a
    request; then the same under the Eq. 27 mixture. Every chunk-scan
    call takes the tensor cores (mLSTM's dk = 384, dv = 385 on the wide
    kernel). The operands of the top-1 run's first chunk-scan call (the
    first mLSTM layer's first chunk) are kept and held against the plain
    version in float64 (``_check_scan_exact``), as the path passes them
    (bf16, tensor cores) and in float32 (scalar). Returns the two runs'
    launch counts and their tensor-core chunk-scan counts."""
    from dataclasses import replace

    import torch
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.kernels import ops
    from repro_torch.launch import main_path

    t0 = time.perf_counter()
    mp = main_path.build("cuda", arch=SSM_ARCH)
    mp = replace(mp, sampling=replace(mp.sampling, max_new=SSM_NEW_TOKENS))
    torch.cuda.synchronize()
    cfg = mp.cfg
    log(f"ssm path: {main_path.N_EXPERTS} experts of {cfg.arch_id} "
        f"({cfg.n_layers} layers in {mp.model.n_groups} groups of "
        f"{mp.model.group_m} mLSTM + 1 sLSTM, D={cfg.d_model}, bf16) "
        f"initialized in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; "
        f"pods paged: {[p.paged for p in mp.engine.pods]}")
    scan, first = ops.chunk_scan, []

    def capture(*args):
        if not first:
            first.extend(t.clone() for t in args)
        return scan(*args)

    out, on_tc = [], []
    for label in ("ssm path", "ssm mixture path"):
        if label == "ssm mixture path":
            mp.engine = None
            mp = _mixture_of(mp)
            mp = replace(mp, sampling=replace(mp.sampling,
                                              max_new=SSM_NEW_TOKENS))
        ops.chunk_scan = capture
        try:
            _, launches = _serve_watched(
                label, mp, (("decode_step", lambda x: x),
                            ("prefill_chunk", lambda x: x)), SSM_KERNELS)
        finally:
            ops.chunk_scan = scan
        tc = cs.chunk_scan.tensor_core_launches
        log(f"{label}: chunk_scan launches {launches['chunk_scan']}, of "
            f"them on the tensor cores {tc}; ms a step "
            f"{PATH_STATS[label]['step_ms']:.2f}, dispatch / device_get "
            f"ms a step by pod {json.dumps(PATH_STATS[label]['step_split'])}")
        if tc != launches["chunk_scan"]:
            raise AssertionError(
                f"{label}: {launches['chunk_scan'] - tc} of "
                f"{launches['chunk_scan']} chunk-scan calls took the scalar "
                f"route at mLSTM's widths")
        out.append(launches)
        on_tc.append(tc)
    mp.engine = None
    held = {name: _check_scan_exact(cs, name, a) for name, a in
            (("bfloat16", first), ("float32", _up(*first)))}
    log(f"ssm path: the first mLSTM layer's chunk-scan operands "
        f"{[tuple(t.shape) for t in first]} (cum down to "
        f"{first[3].min().item():.6g}) against the plain version in "
        f"float64, at SCAN_TOL {SCAN_TOL} + the float32 bound γ_n·|terms|: "
        f"(max abs err, largest share of the allowance) "
        f"{json.dumps(held)}")
    del first[:]
    torch.cuda.empty_cache()
    return out, on_tc


def phase_hybrid_float32_agreement():
    """Full-width Zamba2-2.7B, one expert in float32: monolithic prefill
    then a contiguous decode step, against chunked prefill (the recurrent
    carry spliced into the slot after the last chunk) then a paged decode
    step, on prompts of 702 and 1024 tokens: last-row logits within
    ``HYBRID_F32_LOGIT_TOL``, equal greedy picks, and the first Mamba2
    layer's final SSM state within ``HYBRID_STATE_TOL``. Also prints the
    rounding sensitivity of the monolithic path (its logits under a 1e-7
    relative perturbation of the embedding), for information."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import main_path
    from repro_torch.models import build_model

    cfg = get_config(main_path.HYBRID_ARCH).reduced(
        param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    lo, hi, block, chunk = main_path.FULL_SHAPE
    cache_len = hi + main_path.NEW_TOKENS
    nb = -(-cache_len // block)
    table = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(4)
    worst, agree, state_worst, widths = 0.0, 0, 0.0, (702, hi)
    for width in widths:
        toks = rng.integers(0, cfg.vocab, width)
        batch = {"tokens": torch.as_tensor(toks[None], device="cuda")}
        logits, row = model.prefill(params, batch, cache_len)
        mono = logits[0, -1]
        del logits
        cache = model.cache_spec().insert(
            model.init_cache(1, cache_len, device="cuda"), row, 0)
        pool = model.init_paged_cache(1, nb + 1, block, cache_len,
                                      device="cuda")
        x = model.embed_prompt(params, {"tokens": torch.nn.functional.pad(
            batch["tokens"], (0, -width % chunk))})
        carry = model.init_chunk_carry(params, batch, cache_len)
        for start in range(0, width, chunk):
            chunked, carry, pool = model.prefill_chunk(
                params, pool, carry, x[:, start:start + chunk], start,
                min(chunk, width - start), table)
        first = row["ssm"][0, 0]
        state_worst = max(state_worst, ((first - carry["ssm"][0, 0]).abs()
                                        .max() / first.abs().max()).item())
        del row
        pool = model.cache_spec(block).insert_direct(pool, carry, 0)
        tok = mono.argmax()[None].to(torch.int32)
        pos = torch.tensor([width], dtype=torch.int32, device="cuda")
        dec, _ = model.decode_step(params, cache, tok, pos)
        dec_paged, _ = model.decode_step_paged(params, pool, tok, pos,
                                               table[None])
        agree += int(mono.argmax() == chunked[0].argmax()) \
            + int(dec[0].argmax() == dec_paged[0].argmax())
        worst = max(worst, (mono - chunked[0]).abs().max().item(),
                    (dec - dec_paged).abs().max().item())
        del cache, pool, carry
    emb = params["embed"]["embedding"]
    noise = torch.randn(emb.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(9)) * (1e-7 * emb.abs().max())
    params["embed"]["embedding"] = emb + noise
    moved, _ = model.prefill(params, batch, cache_len)
    sensitivity = (moved[0, -1] - mono).abs().max().item()
    log(f"hybrid float32 agreement: full-width {cfg.arch_id}, prompts of "
        f"{widths} tokens: monolithic + contiguous vs chunked + paged "
        f"last-row logits max abs diff {worst:.3e} (tolerance "
        f"{HYBRID_F32_LOGIT_TOL}; the monolithic path alone moves "
        f"{sensitivity:.3e} under a 1e-7 relative perturbation of its "
        f"embedding), greedy picks equal {agree} of 4; first Mamba2 layer's "
        f"final SSM state max diff {state_worst:.3e} of its largest element "
        f"(tolerance {HYBRID_STATE_TOL})")
    if not worst <= HYBRID_F32_LOGIT_TOL or agree != 4 \
            or not state_worst <= HYBRID_STATE_TOL:
        raise AssertionError(
            f"hybrid float32 paths disagree: logits {worst:.3e} (tolerance "
            f"{HYBRID_F32_LOGIT_TOL}), picks equal {agree} of 4, first "
            f"layer's state {state_worst:.3e} (tolerance "
            f"{HYBRID_STATE_TOL})")


VLM_ARCH = "internvl2_2b"
# the dense family's other configs at full width: each served on the
# main path's deployment and traffic, top-1 (main_path.DEPTH_CUTS cuts
# Llama-3-405B to 2 layers)
DENSE_CONFIG_ARCHS = ("granite_3_8b", "phi3_medium_14b", "llama3_405b")
# the vlm float32 check's depth (full width)
VLM_F32_LAYERS = 2
# the largest logit difference the Qwen3 float32 agreement phase measured
# between its two prefill/decode paths (PERF.md), printed beside the vlm's
QWEN3_F32_LOGIT_DIFF = 9.8e-5
# card vs CPU training at smoke size (float32, kernels vs plain versions),
# both held against the CPU's float64 gradient: the loss relative, and the
# card's worst leaf (its largest difference over its largest element) at
# most this many times the CPU's. The vlm and Granite smoke configs have no
# qk-norm, so their large random attention logits magnify summation order:
# on the card the two float32 sides ended 5.7e-4 of a leaf's largest
# element apart at 64 tokens (the CPU tests measure each package up to
# 2.0e-4 from a float64 gradient at 16), while a fault in a gradient puts
# it O(1) away; the ratio holds the card to the CPU's own rounding
TRAIN_STEP_PARITY = {"loss_rtol": 1e-4, "grad_vs_cpu": 4.0}
# (config, a leaf whose gradient must be nonzero) of the one-step parity
TRAIN_STEP_PARITY_KEYS = ((VLM_ARCH, "projector/w1"),
                          ("granite_3_8b", "embed/embedding"),
                          ("zamba2_2_7b", "shared_attn/attn/wq"),
                          (SSM_ARCH, "blocks/slstm/r_gates"))


def phase_vlm_paths():
    """Full-width InternVL2-2B (24 layers, D = 2048, bf16, 2 experts of
    seeded random weights) on the main path's deployment and traffic, each
    request behind its 256 rows of seeded image patches
    (``main_path.build(arch="internvl2_2b")``): paged + chunked top-1, then
    contiguous + monolithic, then the Eq. 27 mixture (top_k 2,
    ``MIXTURE_NEW_TOKENS``). Returns the three runs' launch counts."""
    import torch
    from repro_torch.launch import main_path

    t0 = time.perf_counter()
    mp = main_path.build("cuda", arch=VLM_ARCH)
    torch.cuda.synchronize()
    cfg = mp.cfg
    log(f"vlm path: {main_path.N_EXPERTS} experts of {cfg.arch_id} "
        f"({cfg.n_layers} layers, D={cfg.d_model}, {cfg.n_patches} patch "
        f"rows of {cfg.vision_dim} a request, cache_len "
        f"{mp.config.cache_len}, bf16) initialized in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    main_res, main = _serve_watched(
        "vlm path", mp, (("decode_step_paged", lambda x: x),
                         ("prefill_chunk", lambda x: x)), MAIN_KERNELS)
    cp = main_path.contiguous(mp)
    mp.engine = None
    torch.cuda.empty_cache()
    res, contiguous = _serve_watched(
        "vlm contiguous path", cp, (("decode_step", lambda x: x),
                                    ("prefill", lambda x: x[:, -1])),
        CONTIGUOUS_KERNELS)
    same = sum(res[i][0] == main_res[i][0] for i in main_res)
    log(f"vlm contiguous path: {same} of {len(main_res)} requests got the "
        f"same tokens as on the vlm path (information only: bf16 rounding "
        f"differs between the paths)")
    cp.engine = None
    xp = _mixture_of(mp)
    mp.experts = xp.experts = None      # the stack holds the weights now
    torch.cuda.empty_cache()
    _, mixture = _serve_watched(
        "vlm mixture path", xp, (("decode_step_paged", lambda x: x),
                                 ("prefill_chunk", lambda x: x)),
        MAIN_KERNELS)
    xp.engine = None
    return main, contiguous, mixture


def phase_vlm_float32():
    """Full-width InternVL2-2B in float32 at ``VLM_F32_LAYERS`` layers,
    one expert: monolithic prefill (the 256-row image prefix and the
    prompt through flash) then a contiguous decode step, against chunked
    prefill (the prefix fills the first chunk) then a paged decode step,
    on two prompts; the largest logit difference within
    ``F32_LOGIT_TOL``, printed beside Qwen3's."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import main_path
    from repro_torch.models import build_model

    cfg = get_config(VLM_ARCH).reduced(
        n_layers=VLM_F32_LAYERS, param_dtype="float32",
        compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    lo, hi, block, chunk = main_path.FULL_SHAPE
    cache_len = hi + cfg.n_patches + main_path.NEW_TOKENS
    nb = -(-cache_len // block)
    table = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(8)
    worst, agree, widths = 0.0, 0, (446, hi)
    for text in widths:
        width = cfg.n_patches + text
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, text)),
                               device="cuda")
        patches = torch.as_tensor(rng.normal(
            size=(1, cfg.n_patches, cfg.vision_dim)).astype(np.float32),
            device="cuda")
        logits, row = model.prefill(params, {"tokens": toks,
                                             "patches": patches}, cache_len)
        mono = logits[0, -1]
        cache = model.cache_spec().insert(
            model.init_cache(1, cache_len, device="cuda"), row, 0)
        pool = model.init_paged_cache(1, nb + 1, block, cache_len,
                                      device="cuda")
        padded = {"tokens": torch.nn.functional.pad(toks,
                                                    (0, -width % chunk)),
                  "patches": patches}
        x = model.embed_prompt(params, padded)
        carry = model.init_chunk_carry(params, padded, cache_len)
        for start in range(0, width, chunk):
            chunked, carry, pool = model.prefill_chunk(
                params, pool, carry, x[:, start:start + chunk], start,
                min(chunk, width - start), table)
        tok = mono.argmax()[None].to(torch.int32)
        pos = torch.tensor([width], dtype=torch.int32, device="cuda")
        dec, _ = model.decode_step(params, cache, tok, pos)
        dec_paged, _ = model.decode_step_paged(params, pool, tok, pos,
                                               table[None])
        agree += int(mono.argmax() == chunked[0].argmax()) \
            + int(dec[0].argmax() == dec_paged[0].argmax())
        worst = max(worst, (mono - chunked[0]).abs().max().item(),
                    (dec - dec_paged).abs().max().item())
    log(f"vlm float32 agreement: full-width {cfg.arch_id} at "
        f"{cfg.n_layers} layers, prompts of {widths} text tokens behind "
        f"{cfg.n_patches} patch rows: monolithic + contiguous vs chunked + "
        f"paged last-row logits max abs diff {worst:.3e} (Qwen3-8B's "
        f"{QWEN3_F32_LOGIT_DIFF:.1e}; tolerance {F32_LOGIT_TOL}), greedy "
        f"picks equal {agree} of 4")
    if not worst <= F32_LOGIT_TOL:
        raise AssertionError(f"vlm float32 paths disagree: {worst:.3e} > "
                             f"{F32_LOGIT_TOL}")


def phase_dense_config_path(arch):
    """Full-width ``arch`` (bf16, 2 experts of seeded random weights,
    depth cut by ``main_path.DEPTH_CUTS``) on the main path's deployment
    and traffic, top-1, paged + chunked. Returns its launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import main_path
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    mp = main_path.build("cuda", arch=arch)
    torch.cuda.synchronize()
    cfg = mp.cfg
    full = get_config(arch).n_layers
    cut = f"cut from {full} to {cfg.n_layers} layers" \
        if cfg.n_layers != full else f"all {full} layers"
    n_params = sum(t.numel() for _, t in tree_leaves(mp.experts[0]))
    log(f"{arch} path: {main_path.N_EXPERTS} experts of {cfg.arch_id} "
        f"({cut}, D={cfg.d_model}, H={cfg.n_heads}, KV={cfg.n_kv_heads}, "
        f"d_ff={cfg.d_ff}, vocab {cfg.vocab}"
        f"{', tied table' if cfg.tie_embeddings else ''}, "
        f"{n_params / 1e9:.2f} B parameters an expert, bf16) initialized in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    _, launches = _serve_watched(
        f"{arch} path", mp, (("decode_step_paged", lambda x: x),
                             ("prefill_chunk", lambda x: x)), MAIN_KERNELS)
    mp.engine = mp.experts = None
    return launches


def phase_train_step_parity():
    """One smoke-size training step's loss and gradients of each config of
    ``TRAIN_STEP_PARITY_KEYS`` (its key leaf's gradient printed on its
    own): ``internvl2_2b`` (the projector's), ``granite_3_8b`` (the tied
    table's summed gradient), ``zamba2_2_7b`` (the shared block's, summed
    over its groups; the Mamba2 scans in their training form) and
    ``xlstm_125m`` (the sLSTM's recurrent gates, through its per-position
    loop), from the same params and batch: float32 on the card (flash
    forward and backward kernels) and on the CPU (plain versions), each
    held against the CPU's float64 gradient within
    ``TRAIN_STEP_PARITY``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_from_leaves, tree_leaves, tree_map

    def loss_and_grads(model, params, batch):
        paths, leaves = zip(*tree_leaves(params))
        live = [t.detach().requires_grad_() for t in leaves]
        loss, _ = model.loss(tree_from_leaves(paths, live), batch)
        grads = torch.autograd.grad(loss, live)
        return loss.item(), {n: g.double().cpu() for n, g in
                             zip(paths, grads)}

    def worst(grads, want):
        """(largest difference over the leaf's largest element, leaf)."""
        return max((((grads[n] - w).abs().max() / w.abs().max()).item(), n)
                   for n, w in want.items())

    tol = TRAIN_STEP_PARITY
    for arch, key in TRAIN_STEP_PARITY_KEYS:
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(3))
        rng = np.random.default_rng(4)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)))
        batch = {"tokens": toks, "labels": toks}
        if cfg.family == "vlm":
            batch["patches"] = torch.as_tensor(rng.normal(
                size=(2, cfg.n_patches, cfg.vision_dim)).astype(np.float32))
        l_gpu, g_gpu = loss_and_grads(
            model, tree_map(lambda t: t.to("cuda"), params),
            {k: v.to("cuda") for k, v in batch.items()})
        l_cpu, g_cpu = loss_and_grads(model, params, batch)
        l_64, g_64 = loss_and_grads(
            build_model(cfg.reduced(param_dtype="float64",
                                    compute_dtype="float64")),
            tree_map(torch.Tensor.double, params),
            {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()})
        card, cpu = worst(g_gpu, g_64), worst(g_cpu, g_64)
        between = worst(g_gpu, g_cpu)
        loss_diff = abs(l_gpu - l_64) / abs(l_64)
        log(f"training step parity ({cfg.arch_id}, float32 against the "
            f"CPU's float64): loss {l_gpu:.6f} on the card, {l_cpu:.6f} on "
            f"the CPU, {l_64:.6f} in float64 (card relative diff "
            f"{loss_diff:.3e}, tolerance {tol['loss_rtol']}); worst "
            f"gradient leaf on the card {card[1]} {card[0]:.3e} of its "
            f"largest element, on the CPU {cpu[1]} {cpu[0]:.3e} (the card "
            f"within {tol['grad_vs_cpu']}x the CPU's); card vs CPU "
            f"{between[0]:.3e} at {between[1]}; {key} on the card "
            f"{worst({key: g_gpu[key]}, {key: g_64[key]})[0]:.3e}")
        if not (loss_diff <= tol["loss_rtol"]
                and card[0] <= tol["grad_vs_cpu"] * cpu[0]
                and float(g_64[key].abs().max()) > 0):
            raise AssertionError(
                f"training step on the card is off the float64 gradient "
                f"for {arch}: loss {loss_diff:.3e}, gradients {card[0]:.3e} "
                f"at {card[1]} against the CPU's {cpu[0]:.3e}")


# ---------------------------------------------------------------------------
# Phases 10e-10g: the moe family
# ---------------------------------------------------------------------------

MOE_ARCHS = ("deepseek_moe_16b", "qwen3_moe_235b_a22b")
# a capacity factor that drops (token, choice) pairs at smoke size: C =
# int(S·2·1.0/4) slots an expert for a row of S tokens choosing 2 of 4
# experts (the smoke configs' own 8.0 drops none)
MOE_DROP_CF = 1.0
# moe_ffn on the card against the same function on the CPU, one full-width
# layer: the routing of every token (its choices, positions and drops) is
# compared, and the outputs of the tokens routed alike are held at these
# fractions of the output's largest magnitude. float32 differs only by
# summation order (the products' blocking), so every token must route
# alike. In bf16 the router logits are rounded to bf16 on both sides, so a
# logit whose float32 sum lies at a rounding boundary can round otherwise
# on the card; where that logit ties or crosses a neighbour, that token's
# choice differs: at most MOE_ROUTE_FLIP_SHARE of the tokens may route
# otherwise, and each such token's top-(k+1) logits on the CPU must lie
# within 2 bf16 ulps of each other at the flipped choice. The expert
# products round each output to bf16 on both sides (a few ulps of ~4e-3 of
# an element), and a token sums top_k of them
MOE_FFN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MOE_ROUTE_FLIP_SHARE = 0.02
# the moe_ffn phase's rows: one bf16 chunk of the main path's chunk width,
# and the decode rows of a pod's 8 slots
MOE_CHUNK, MOE_DECODE_ROWS = 256, 8


def _drop_tally():
    """``models.moe.DROP_TALLY`` read back (one sync): {group width S:
    {"pairs", "dropped", "share"}}."""
    from repro_torch.models import moe as moe_lib

    out = {}
    for S, (kept, pairs) in sorted((moe_lib.DROP_TALLY or {}).items()):
        kept = int(kept)
        out[S] = {"pairs": pairs, "dropped": pairs - kept,
                  "share": (pairs - kept) / pairs if pairs else 0.0}
    return out


def _moe_routing(p, x, cfg):
    """(idx, pos, keep) of ``moe_ffn``'s routing of x, one model's params."""
    from repro_torch.models import moe as moe_lib

    _, idx = moe_lib.route_topk(moe_lib._product(x, p["router"], 0),
                                cfg.moe.top_k)
    C = moe_lib._capacity(x.shape[1], cfg.moe.n_experts, cfg.moe.top_k,
                          cfg.moe.capacity_factor)
    pos, keep = moe_lib.capacity_slots(idx, C, cfg.moe.n_experts)
    return idx, pos, keep, C


def phase_moe_ffn():
    """``moe_ffn`` on the card against the same function on the CPU, at one
    full-width layer of each moe config (its routed, shared and router
    weights drawn by ``init_params`` from ``moe_specs``, capacity factor
    1.25), on a chunk of ``MOE_CHUNK`` rows and on ``MOE_DECODE_ROWS``
    decode rows, in bf16 and float32, within ``MOE_FFN_TOL``; the tokens
    routed otherwise on the card are counted against
    ``MOE_ROUTE_FLIP_SHARE``. Prints the dropped share of (token, choice)
    pairs at each width and the card's device ms a call beside the time to
    read every routed weight once (the dense dispatch reads them all).
    Returns the records."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.params import init_params
    from repro_torch.tree import tree_leaves, tree_map

    out = []
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        E, top_k, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            gen = torch.Generator(device="cuda").manual_seed(25)
            p = init_params(gen, moe_lib.moe_specs(cfg), dtype)
            p_cpu = tree_map(lambda t: t.cpu(), p)
            routed = sum(t.numel() * t.element_size()
                         for n, t in tree_leaves(p) if n.startswith("w_"))
            for R, S in ((1, MOE_CHUNK), (MOE_DECODE_ROWS, 1)):
                x = torch.randn((R, S, D), generator=gen,
                                device="cuda").to(dtype)
                got = moe_lib.moe_ffn(p, x, cfg)
                want = moe_lib.moe_ffn(p_cpu, x.cpu(), cfg)
                r_card = _moe_routing(p, x, cfg)
                r_cpu = _moe_routing(p_cpu, x.cpu(), cfg)
                C = r_cpu[3]
                # a token whose choices differ, and (through the positions
                # its choices take) a later one whose drops differ
                chose = (r_card[0].cpu() == r_cpu[0]).all(-1)
                same = chose & (r_card[2].cpu() == r_cpu[2]).all(-1)
                flips = int((~same).sum())
                if not bool(chose.all()):
                    # each token that chose otherwise: its top-(k+1) CPU
                    # logits lie within 2 bf16 ulps of each other somewhere
                    lg = moe_lib._product(x.cpu(), p_cpu["router"], 0) \
                        .float()[~chose]
                    top = lg.topk(min(top_k + 1, E), -1).values
                    gaps = (top[:, :-1] - top[:, 1:]).min(-1).values
                    ulps = 2 * 2.0 ** (torch.floor(torch.log2(
                        top.abs().max(-1).values)) - 7)
                    near = bool((gaps <= ulps).all())
                else:
                    near = True
                err = (got.cpu().float() - want.float())[same].abs()
                scale = want.float().abs().max().item()
                worst = err.max().item() / scale if err.numel() else 0.0
                dropped = int((~r_cpu[2]).sum())
                pairs = r_cpu[2].numel()
                ms = device_ms(lambda: moe_lib.moe_ffn(p, x, cfg), iters=10)
                r = {"config": arch, "dtype": name, "rows": R,
                     "group_width": S, "capacity": C,
                     "max_err_of_max": worst, "tol": MOE_FFN_TOL[name],
                     "tokens_routed_otherwise": flips,
                     "dropped_pairs": dropped, "pairs": pairs,
                     "dropped_share": dropped / pairs, "device_ms": ms,
                     "routed_weight_read_ms": routed / HBM_BPS * 1e3}
                out.append(r)
                log("moe_ffn card vs CPU: " + json.dumps(r))
                allowed = MOE_ROUTE_FLIP_SHARE * R * S \
                    if dtype == torch.bfloat16 else 0
                if not (worst <= MOE_FFN_TOL[name] and flips <= allowed
                        and near and bool(torch.isfinite(got).all())):
                    raise AssertionError(
                        f"moe_ffn ({arch}, {name}, {R} x {S}): card vs "
                        f"CPU {worst:.3e} of the largest output (tolerance "
                        f"{MOE_FFN_TOL[name]}), {flips} tokens routed "
                        f"otherwise (allowed {allowed}, near a tie: "
                        f"{near})")
            del p, p_cpu
            torch.cuda.empty_cache()
    return out


def _moe_path_stats(label):
    """The printed stats of a moe path, trimmed to what PERF.md keeps."""
    st = PATH_STATS[label]
    return {k: st.get(k) for k in (
        "steps", "step_ms", "tok_per_s", "mean_ttft_s", "peak_mem_gib",
        "dropped_share", "step_split")}


def phase_moe_paths():
    """Full-width moe serving on the main path's deployment and traffic
    (bf16, 2 experts of seeded random weights, top-1, paged + chunked):
    DeepSeek-MoE-16B at all 28 layers; DeepSeek-MoE-16B under the Eq. 27
    mixture (both experts stacked, top_k 2, ``MIXTURE_NEW_TOKENS``), built
    at ``main_path.MIXTURE_DEPTH_CUTS``' 12 layers since the stack is made
    beside the experts; Qwen3-MoE-235B-A22B cut to
    ``main_path.DEPTH_CUTS``' 4 of 94 layers. Each with the main path's
    checks; each prints its dropped share of (token, choice) pairs by group
    width and the registry's dispatch/device_get split. Returns the launch
    counts by path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import main_path
    from repro_torch.tree import tree_leaves

    launches = {}
    for arch, mixture in (("deepseek_moe_16b", False),
                          ("deepseek_moe_16b", True),
                          ("qwen3_moe_235b_a22b", False)):
        t0 = time.perf_counter()
        mp = main_path.build("cuda", arch=arch, mixture=mixture)
        torch.cuda.synchronize()
        cfg = mp.cfg
        full = get_config(arch).n_layers
        cut = f"cut from {full} to {cfg.n_layers} layers" \
            if cfg.n_layers != full else f"all {full} layers"
        n_params = sum(t.numel() for _, t in tree_leaves(mp.experts[0]))
        label = f"{arch} {'mixture ' if mixture else ''}path"
        log(f"{label}: {main_path.N_EXPERTS} experts of {cfg.arch_id} "
            f"({cut}, D={cfg.d_model}, H={cfg.n_heads}, KV={cfg.n_kv_heads}"
            f", {cfg.moe.n_experts} routed experts of {cfg.moe.d_ff_expert}"
            f" top-{cfg.moe.top_k}, {cfg.moe.n_shared} shared, capacity "
            f"factor {cfg.moe.capacity_factor}, vocab {cfg.vocab}, "
            f"{n_params / 1e9:.2f} B parameters an expert, bf16) "
            f"initialized in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
        if mixture:
            _drop(mp.engine)             # the top-1 pools, before the stack
            mp.engine = None
            xp = _mixture_of(mp)
            mp.experts = xp.experts = None
            torch.cuda.empty_cache()
            mp = xp
        _, launches[label] = _serve_watched(
            label, mp, (("decode_step_paged", lambda x: x),
                        ("prefill_chunk", lambda x: x)), MAIN_KERNELS)
        log(f"{label} (summary): " + json.dumps(_moe_path_stats(label)))
        _drop(mp.engine)
        mp.engine = mp.experts = None
        del mp
        torch.cuda.empty_cache()
    return launches


def phase_moe_launches():
    """Launches on the card (``torch.profiler``'s CUDA kernel and memset
    events) of one ``moe_ffn`` call at full width, on the decode rows and
    on a chunk, and of one paged decode step of DeepSeek-MoE-16B at 1 and
    at 2 layers (full width, bf16): their difference is one layer's. Run
    last: the profiler stays attached to the process. Returns the counts;
    "not measured" where the profiler saw no device events."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.params import init_params

    def launches(fn):
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        return n or "not measured"

    out = {}
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(5)
        p = init_params(gen, moe_lib.moe_specs(cfg), torch.bfloat16)
        for R, S in ((MOE_DECODE_ROWS, 1), (1, MOE_CHUNK)):
            x = torch.randn((R, S, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            out[f"{arch} moe_ffn {R}x{S}"] = launches(
                lambda: moe_lib.moe_ffn(p, x, cfg))
        del p
    step = {}
    for layers in (1, 2):
        cfg = get_config("deepseek_moe_16b").reduced(n_layers=layers)
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(6))
        block, nb = 16, 68
        pool = model.init_paged_cache(8, 8 * nb + 1, block, block * nb,
                                      device="cuda")
        tables = torch.arange(1, 8 * nb + 1, dtype=torch.int32,
                              device="cuda").reshape(8, nb)
        tok = torch.zeros(8, dtype=torch.int32, device="cuda")
        pos = torch.full((8,), 700, dtype=torch.int32, device="cuda")
        step[layers] = launches(lambda: model.decode_step_paged(
            params, pool, tok, pos, tables))
        del params, pool
        torch.cuda.empty_cache()
    out["deepseek_moe_16b decode step, 1 layer"] = step[1]
    out["deepseek_moe_16b decode step, 2 layers"] = step[2]
    if isinstance(step[1], int) and isinstance(step[2], int):
        out["deepseek_moe_16b decode step, per layer"] = step[2] - step[1]
    log("moe launches on the card: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phases 11-13: training
# ---------------------------------------------------------------------------

def _train_expert(tp, k, state, on_step=None):
    """Expert k's ``tp.steps`` steps through ``train_host_loop`` with the
    metrics read back every step. ``on_step(step)`` runs after each step's
    readback. Returns (history, per-step wall seconds)."""
    from repro_torch.train.trainer import train_host_loop

    walls = []
    t_prev = [time.perf_counter()]

    def callback(step, _):
        now = time.perf_counter()
        walls.append(now - t_prev[0])
        if on_step:
            on_step(step)
        t_prev[0] = time.perf_counter()

    _, hist = train_host_loop(tp.model, state, tp.loaders[k], tp.steps,
                              tp.config, log_every=1, callback=callback)
    return hist, walls


def phase_train_parity():
    """Expert 0 of the smoke-size float32 training deployment, 3 steps on
    the card and on the CPU from the same params (drawn on the CPU)."""
    import torch
    from repro_torch.launch import train_path
    from repro_torch.tree import tree_leaves, tree_map

    host = train_path.build("cpu", smoke=True)
    card = train_path.build("cuda", smoke=True)
    s_cpu = host.init_state(0)
    s_gpu = tree_map(lambda t: t.to("cuda", copy=True), s_cpu)
    h_gpu, _ = _train_expert(card, 0, s_gpu)
    h_cpu, _ = _train_expert(host, 0, s_cpu)
    tol = TRAIN_PARITY
    worst = {"metrics": 0.0, "params": 0.0, "moments": 0.0}
    for a, b in zip(h_gpu, h_cpu):
        for name in ("loss", "grad_norm", "lr"):
            worst["metrics"] = max(worst["metrics"],
                                   abs(a[name] - b[name]) / abs(b[name]))
    peak = host.config.opt.lr
    for (path, g), (_, c) in zip(tree_leaves(s_gpu["params"]),
                                 tree_leaves(s_cpu["params"])):
        worst["params"] = max(worst["params"],
                              (g.cpu() - c).abs().max().item() / peak)
    for key in ("m", "v"):
        for (path, g), (_, c) in zip(tree_leaves(s_gpu["opt"][key]),
                                     tree_leaves(s_cpu["opt"][key])):
            worst["moments"] = max(worst["moments"], (
                (g.cpu() - c).abs().max() / c.abs().max()).item())
    log(f"training parity ({card.cfg.arch_id}, expert 0, {card.steps} "
        f"steps of {card.tokens_per_step} tokens, float32): losses "
        f"{[round(h['loss'], 6) for h in h_gpu]} on the card, "
        f"{[round(h['loss'], 6) for h in h_cpu]} on the CPU; worst "
        f"loss/grad-norm/lr relative diff {worst['metrics']:.3e} "
        f"(tolerance {tol['metrics_rtol']}), params {worst['params']:.3e} "
        f"of the peak lr (tolerance {tol['params_of_lr']}), m and v "
        f"{worst['moments']:.3e} of a leaf's largest element (tolerance "
        f"{tol['moments_of_max']})")
    if not (worst["metrics"] <= tol["metrics_rtol"]
            and worst["params"] <= tol["params_of_lr"]
            and worst["moments"] <= tol["moments_of_max"]):
        raise AssertionError(f"training on the card and the CPU disagree: "
                             f"{worst} against {tol}")


def phase_train_path(arch="qwen3_8b"):
    """Full-width Qwen3-8B cut to 8 layers, 2 experts, 8 steps each
    (``repro_torch/launch/train_path.py``), or ``arch`` at its
    ``train_path.DEPTH_CUTS`` (DeepSeek-MoE-16B at 4 layers: the moe
    training path, which also prints the dropped share of its (token,
    choice) pairs; Whisper-small whole, 4 steps of 8 sequences of 448
    tokens and their frames, the flash kernels launched by the encoder
    too; Zamba2-2.7B whole, 4 steps of 4096 tokens, and xLSTM-125M whole,
    4 steps of 2048, their scans in the training form, so no chunk-scan
    launch; xLSTM's expert 0
    also writes its final state with ``checkpoint/ckpt.py``, which must
    restore bit for bit). Returns the kernels' launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train_path
    from repro_torch.models import moe as moe_lib
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    tp = train_path.build("cuda", arch=arch)
    cfg = tp.cfg
    label = "training path" if arch == train_path.ARCH \
        else f"{arch} training path"
    log(f"{label}: {cfg.arch_id} at full width cut to "
        f"{cfg.n_layers} layers (D={cfg.d_model}, vocab {cfg.vocab}, "
        f"{cfg.param_dtype}, remat {cfg.remat}), {tp.args.experts} experts "
        f"on shards of {[len(s) for s in tp.partition.shards]} samples, "
        f"{tp.steps} steps of {tp.tokens_per_step} tokens each; built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bad = []
    ops.reset_launch_counts()
    if cfg.family == "moe":
        moe_lib.DROP_TALLY = {}
    experts = []
    for k in range(tp.args.experts):
        state = tp.init_state(k)
        n_params = sum(p.numel() for _, p in tree_leaves(state["params"]))

        def first_step_grads(step, state=state, k=k):
            if step != 0:
                return
            for path, m in tree_leaves(state["opt"]["m"]):
                if not (bool(torch.isfinite(m).all())
                        and bool(m.abs().amax() > 0)):
                    bad.append(f"expert {k}: step-1 gradient of {path} is "
                               f"zero or not finite")
        hist, walls = _train_expert(tp, k, state, first_step_grads)
        if arch == SSM_ARCH and k == 0:
            bad += _checkpoint_round_trip(label, tp, state)
        losses = [h["loss"] for h in hist]
        med = float(np.median(walls))
        experts.append({
            "expert": k, "params": n_params, "first_loss": losses[0],
            "last_loss": losses[-1], "losses": losses,
            "grad_norms": [h["grad_norm"] for h in hist],
            "median_step_ms": med * 1e3,
            "step_ms": [w * 1e3 for w in walls],
            "tok_per_s": tp.tokens_per_step / med})
        if not all(np.isfinite(losses)):
            bad.append(f"expert {k}: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            bad.append(f"expert {k}: last loss {losses[-1]} not below the "
                       f"first {losses[0]}")
        # the check's defaults hold the state too: free both before the
        # next expert is built, as the launcher does
        del state, first_step_grads
        torch.cuda.empty_cache()
    launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    # the layers with attention: the audio family's encoder's too, one a
    # group for the hybrid family (the shared block), none for the ssm one
    attention_layers = {"hybrid": tp.model.n_groups, "ssm": 0}.get(
        cfg.family, cfg.n_layers + cfg.n_enc_layers)
    want_bwd = attention_layers * tp.steps * tp.args.experts
    if launches["flash_attention_bwd"] != want_bwd \
            or launches["flash_attention"] != 2 * want_bwd:
        bad.append(f"launches {launches}: want {want_bwd} backward and "
                   f"{2 * want_bwd} forward (layers with attention x steps "
                   f"x experts, the forward twice under remat)")
    if launches["chunk_scan"]:
        bad.append(f"{launches['chunk_scan']} chunk-scan launches: training "
                   f"takes the scan's training form")
    stats = {"experts": experts,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
             "launches": launches}
    if cfg.family == "moe":
        # the forward and its recomputation under remat both route
        drops = _drop_tally()
        moe_lib.DROP_TALLY = None
        stats["dropped_share"] = sum(t["dropped"] for t in drops.values()) \
            / max(sum(t["pairs"] for t in drops.values()), 1)
    log(f"{label}: " + json.dumps(stats))
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))
    return launches


def _checkpoint_round_trip(label, tp, state):
    """Write ``state`` (expert 0's after its last step) with
    ``checkpoint/ckpt.py`` into a directory under the ignored ``build/``,
    restore it and compare every leaf bit for bit; print the file's bytes
    and the seconds of each way. Returns the failures."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import from_tree

    (HERE / "build").mkdir(exist_ok=True)
    base = tempfile.mkdtemp(dir=HERE / "build", prefix="ckpt_")
    try:
        t0 = time.perf_counter()
        path = ckpt.save_expert(base, 0, tp.steps, state)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, step = ckpt.restore_expert(base, 0)
        back = from_tree(back)
        t_load = time.perf_counter() - t0
        size = Path(path).stat().st_size
    finally:
        shutil.rmtree(base)
    want = dict(tree_leaves(state))
    got = dict(tree_leaves(back))
    bad = [] if step == tp.steps and sorted(got) == sorted(want) else \
        [f"checkpoint: step {step} or leaves differ"]
    bad += [f"checkpoint leaf {n} is not restored bit for bit"
            for n, w in want.items() if n in got and not (
                got[n].dtype == w.dtype and got[n].shape == w.shape
                and torch.equal(got[n], w.cpu()))]
    log(f"{label}: expert 0's final state ({len(want)} leaves, "
        f"{sum(w.numel() for w in want.values())} elements) written with "
        f"checkpoint/ckpt.py: {size} bytes in {t_save:.2f} s, restored in "
        f"{t_load:.2f} s, {'bit for bit' if not bad else 'NOT EQUAL'}")
    return bad


def phase_remat():
    """``remat`` "none", "full" and "dots" on one step of full-width
    Qwen3-8B cut to ``REMAT_LAYERS`` layers (bf16, one ``REMAT_SEQ``-token
    sequence), from the same params and batch: the loss and every
    gradient leaf, and the peak GiB the step allocates above the state it
    starts from. Losses must be equal, each leaf of "full" and "dots"
    within the bf16 tolerance (``TOL``) of "none"'s largest element, and
    the peaks must order full < dots < none: "dots" keeps each layer's
    matrix products with no batch dims (``aten.mm``), "full" none of its
    activations, "none" all of them."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train_path
    from repro_torch.models import build_model
    from repro_torch.tree import tree_from_leaves, tree_leaves

    cfg = get_config(train_path.ARCH).reduced(n_layers=REMAT_LAYERS)
    params = build_model(cfg).init(torch.Generator(device="cuda")
                                   .manual_seed(8))
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (1, REMAT_SEQ)), device="cuda")
    batch = {"tokens": toks, "labels": toks}
    paths, leaves = zip(*tree_leaves(params))
    runs = {}
    for remat in ("none", "full", "dots"):
        model = build_model(cfg.reduced(remat=remat))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        live = [p.detach().requires_grad_() for p in leaves]
        loss, _ = model.loss(tree_from_leaves(paths, live), batch)
        grads = torch.autograd.grad(loss, live)
        torch.cuda.synchronize()
        runs[remat] = {
            "loss": loss.item(), "grads": grads,
            "ms": (time.perf_counter() - t0) * 1e3,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
            "flash_forward": ops.KERNELS["flash_attention"].launches,
            "flash_backward": ops.KERNELS["flash_attention_bwd"].launches}
        del live, loss
    worst = {}
    for remat in ("full", "dots"):
        worst[remat] = max(
            ((a.float() - b.float()).abs().max()
             / b.float().abs().max()).item()
            for a, b in zip(runs[remat]["grads"], runs["none"]["grads"]))
    log(f"remat: full-width {cfg.arch_id} cut to {cfg.n_layers} layers, "
        f"bf16, one {REMAT_SEQ}-token sequence: " + json.dumps({
            r: {k: v for k, v in run.items() if k != "grads"}
            for r, run in runs.items()})
        + f"; worst gradient leaf against none's, of its largest element: "
          f"full {worst['full']:.3e}, dots {worst['dots']:.3e} (tolerance "
          f"{TOL['bfloat16']})")
    peaks = [runs[r]["peak_gib"] for r in ("full", "dots", "none")]
    if len({run["loss"] for run in runs.values()}) != 1 \
            or max(worst.values()) > TOL["bfloat16"] \
            or not peaks[0] < peaks[1] < peaks[2]:
        raise AssertionError(f"remat: losses, gradients or peaks off: "
                             f"worst {worst}, peaks full/dots/none {peaks}")


# the placed training phase: train_path's deployment cut to this depth —
# two stacked experts' AdamW state (16 bytes a parameter with the bf16
# gradient) would be 2 x 41.5 GiB at train_path's 8 layers, more than the
# card holds; at 4 layers it is 2 x 28.2 GB
PLACED_LAYERS = 4
PLACED_STEPS = 2
# the dry run's memory counter (arguments + peak) against the card's
# max_memory_allocated on the placed step, relative
MEMORY_COUNTER_TOL = 0.10
# the dry run's case, run in both modes on the multi-pod mesh with the
# depth probe (two shallow runs, G = 1 and 2, fitted to the full depth)
DRYRUN_CASE = ("qwen3_8b", "train_4k")
# decode on a cache the rules split along its sequence (multi-pod mesh,
# decentralized): over ``model`` at decode_32k, over ``data`` at long_500k
DRYRUN_DECODE_CASES = (("qwen3_8b", "decode_32k"), ("qwen3_8b", "long_500k"))
DRYRUN_TIMEOUT = 600


def _stacked_expert_state(tp, K):
    """``stack_expert_states`` of ``tp.init_state(k)`` for k < K, built
    without holding K separate states beside the stack: the params drawn
    from each expert's seed and stacked, then the AdamW state of the
    stack (zero moments, the float32 masters, a step count an expert)."""
    import torch
    from repro_torch.launch import train
    from repro_torch.optim.adamw import init_state
    from repro_torch.tree import tree_map

    params = [tp.model.init(train.expert_generator(tp.args, k, tp.device))
              for k in range(K)]
    stacked = tree_map(lambda *ps: torch.stack(ps), *params)
    del params
    opt = init_state(stacked)
    opt["count"] = torch.zeros((K,), dtype=torch.int32, device=tp.device)
    return {"params": stacked, "opt": opt}


def _placed_run(tp, K, steps, mesh=None, count_first=False):
    """``steps`` decentralized steps of the K stacked experts on
    ``tp``'s loaders: the unplaced step, or with ``mesh`` the placed one
    on DTensors. With ``count_first`` the first step runs under the dry
    run's memory counter (``roofline.LocalMemory``), right after the
    peak-memory reset. Returns (metrics a step, ms a step, peak GiB,
    launches, final state, the counter's record or None: its memory keys,
    its peak, the bytes allocated before the step and the card's peak
    after it)."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import LocalMemory
    from repro_torch.sharding import rules as R
    from repro_torch.train import trainer as T

    dev = tp.device
    state = _stacked_expert_state(tp, K)
    batches = []
    for _ in range(steps):
        rows = [T.to_batch(next(tp.loaders[k]), dev) for k in range(K)]
        batches.append({n: torch.stack([r[n] for r in rows])
                        for n in rows[0]})
    if mesh is None:
        step = T.make_decentralized_train_step(tp.model, tp.config)
    else:
        rules = R.logical_rules(multi_pod=True, decentralized=True)
        T.distribute_state(state, T.state_shardings(
            tp.model, rules, mesh, K, count_over_experts=True), mesh)
        spec = R.data_shardings(rules, mesh, tp.cfg, "train", K)
        batches = [{n: distribute_tensor(b, mesh, R.placements(spec[n], mesh))
                    for n, b in batch.items()} for batch in batches]
        step = T.make_placed_decentralized_train_step(tp.model, tp.config,
                                                      mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        sync()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    metrics, walls, counted = [], [], None
    for i, batch in enumerate(batches):
        t = time.perf_counter()
        if count_first and i == 0:
            held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
            with LocalMemory() as counter:
                out = step(state, batch)
            sync()
            counted = {"memory": counter.memory((state, batch), out),
                       "peak": counter.peak, "held": held,
                       "max_allocated": torch.cuda.max_memory_allocated()
                       if dev.type == "cuda" else None}
            _, m = out
            del out
        else:
            _, m = step(state, batch)
        sync()
        walls.append((time.perf_counter() - t) * 1e3)
        metrics.append({n: (v.full_tensor() if hasattr(v, "full_tensor")
                            else v).tolist() for n, v in m.items()})
    launches = {n: fn.launches for n, fn in ops.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30 \
        if dev.type == "cuda" else 0.0
    return metrics, walls, peak, launches, state, counted


def _check_counted(counted):
    """The dry run's memory counter on the placed step: its arguments +
    peak against ``torch.cuda.max_memory_allocated()`` after the step
    (the peak was reset just before it), both printed, with the bytes the
    card held before the step beside the arguments; more than
    ``MEMORY_COUNTER_TOL`` apart is a fault. Returns the faults."""
    mem, gib = counted["memory"], 2 ** 30
    args = mem["argument_size_in_bytes"]
    total = args + counted["peak"]
    line = (f"placed training: memory counter on step 1: arguments "
            f"{args / gib:.4f} + peak {counted['peak'] / gib:.4f} = "
            f"{total / gib:.4f} GiB (outputs {mem['output_size_in_bytes']} "
            f"B, temp {mem['temp_size_in_bytes'] / gib:.4f} GiB)")
    alloc = counted["max_allocated"]
    if alloc is None:
        log(line)
        return []
    held = counted["held"]
    log(f"{line} against torch.cuda.max_memory_allocated() "
        f"{alloc / gib:.4f} GiB ({(total - alloc) / alloc:+.2%}); held "
        f"before the step {held / gib:.4f} GiB ({(held - args) / 2**20:.1f} "
        f"MiB besides the arguments), the allocator's peak above it "
        f"{(alloc - held) / gib:.4f} GiB against the counter's "
        f"{counted['peak'] / gib:.4f}")
    if abs(total - alloc) > MEMORY_COUNTER_TOL * alloc:
        return [f"memory counter {total / gib:.4f} GiB against "
                f"max_memory_allocated {alloc / gib:.4f} GiB"]
    return []


def phase_placed_train(device="cuda", backend="nccl", smoke=False):
    """train_path's deployment (Qwen3-8B at full width cut to
    ``PLACED_LAYERS``, 2 experts, the same seeds and loaders) through the
    placed decentralized step on a (1, 1, 1) ("pod", "data", "model")
    mesh at world size 1: the state placed by ``state_shardings`` under
    the decentralized rules, the flash kernels reached through the
    DTensor seam. ``PLACED_STEPS`` steps must give the unplaced step's
    losses and grad norms within ``TRAIN_PARITY``'s metrics tolerance, and
    its params after them within its params tolerance (the float32
    masters; the bf16 params within that plus one bf16 step of their
    size), with the flash forward and backward launched as often; prints
    both runs' ms a step and peak GiB. The first placed step runs under
    the dry run's memory counter, whose arguments + peak must lie within
    ``MEMORY_COUNTER_TOL`` of ``torch.cuda.max_memory_allocated()``
    (``_check_counted``). ``smoke=True`` with ``device="cpu"``
    and ``backend="gloo"`` rehearses it at smoke size."""
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch.launch import train_path
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    K = train_path.N_EXPERTS

    def deployment():
        tp = train_path.build(device, smoke=smoke)
        if not smoke:
            tp.cfg = tp.cfg.reduced(n_layers=PLACED_LAYERS)
            tp.model = build_model(tp.cfg)
        return tp

    tp = deployment()
    want, want_ms, want_peak, want_launches, ref, _ = _placed_run(
        tp, K, PLACED_STEPS)
    lr = tp.config.opt.lr
    host = {key: {p: t.to("cpu") for p, t in tree_leaves(tree)}
            for key, tree in (("params", ref["params"]),
                              ("master", ref["opt"].get("master", {})))}
    del ref
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.set_device(0)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device)
        got, got_ms, got_peak, got_launches, placed, counted = _placed_run(
            deployment(), K, PLACED_STEPS, mesh, count_first=True)
        if device == "cuda":
            log(f"placed training: {torch.cuda.memory_allocated() / 2**30:.2f}"
                f" GiB held after the placed steps")
        bad = _check_counted(counted)
        tol = TRAIN_PARITY
        worst = {"metrics": 0.0, "params": 0.0, "masters": 0.0}
        for a, b in zip(got, want):
            for name in ("loss", "grad_norm", "lr"):
                for x, y in zip(a[name], b[name]):
                    worst["metrics"] = max(worst["metrics"],
                                           abs(x - y) / abs(y))
        for key, tree in (("params", placed["params"]),
                          ("master", placed["opt"].get("master", {}))):
            for path, t in tree_leaves(tree):
                # a bf16 param is its master rounded: one bf16 step
                step = 2.0 ** -7 if t.dtype == torch.bfloat16 else 0.0
                d_max, excess = 0.0, -1.0
                # in slices of 2^26 elements: the card holds the state
                for ours, theirs in zip(t.to_local().flatten().split(1 << 26),
                                        host[key][path].flatten().split(
                                            1 << 26)):
                    ours = ours.float()
                    theirs = theirs.to(ours.device).float()
                    d = (ours - theirs).abs()
                    d_max = max(d_max, float(d.max()))
                    excess = max(excess, float((d - tol["params_of_lr"] * lr
                                                - step * theirs.abs()).max()))
                if key == "params":
                    worst["params"] = max(worst["params"], d_max / lr)
                    if excess > 0:
                        bad.append(f"param {path}: {d_max:.3e}")
                else:
                    worst["masters"] = max(worst["masters"], d_max / lr)
        del placed
        if worst["metrics"] > tol["metrics_rtol"]:
            bad.append(f"metrics differ by {worst['metrics']:.3e} (rel)")
        if worst["masters"] > tol["params_of_lr"]:
            bad.append(f"masters differ by {worst['masters']:.3e} of lr")
        for name in TRAIN_KERNELS:
            if device == "cuda" and not got_launches[name]:
                bad.append(f"{name} never launched on the placed path")
            if got_launches[name] != want_launches[name]:
                bad.append(f"{name}: {got_launches[name]} launches placed, "
                           f"{want_launches[name]} unplaced")
        log(f"placed training: {tp.cfg.arch_id} at full width cut to "
            f"{tp.cfg.n_layers} layers, {K} stacked experts on mesh "
            f"(pod=1, data=1, model=1), {PLACED_STEPS} steps; losses "
            f"{[m['loss'] for m in got]} (unplaced "
            f"{[m['loss'] for m in want]}), grad norms "
            f"{[m['grad_norm'] for m in got]}; largest difference: "
            f"metrics {worst['metrics']:.3e} rel, masters "
            f"{worst['masters']:.3e} of lr, params "
            f"{worst['params']:.3e} of lr; ms a step placed "
            f"{[round(w, 1) for w in got_ms]} vs unplaced "
            f"{[round(w, 1) for w in want_ms]}, peak GiB placed "
            f"{got_peak:.2f} vs unplaced {want_peak:.2f}; launches "
            f"{ {n: got_launches[n] for n in TRAIN_KERNELS} } (unplaced "
            f"{ {n: want_launches[n] for n in TRAIN_KERNELS} })")
        if bad:
            raise AssertionError("placed training: " + "; ".join(bad[:8]))
        return got_launches
    finally:
        dist.destroy_process_group()


def _stop(procs):
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_dryruns(out_dir):
    """The dry runs of ``DRYRUN_CASE`` on the multi-pod mesh, both modes,
    and of ``DRYRUN_DECODE_CASES``, decentralized (their depth-1
    schedules kept), each in a subprocess of its own started now: they
    run on fake CPU tensors, beside the card's phases."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cases = [(*DRYRUN_CASE, mode) for mode in ("decentralized", "dense")]
    cases += [(arch, shape, "decentralized")
              for arch, shape in DRYRUN_DECODE_CASES]
    procs = {}
    for arch, shape, mode in cases:
        extra = ["--save-schedule"] if (arch, shape) != DRYRUN_CASE else []
        procs[arch, shape, mode] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "multi", "--mode", mode,
             "--probe", "--out", str(out_dir), *extra],
            env=env, cwd=str(HERE), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    return procs


def _merge_sums(path, dh):
    """The seam's merge in a dry run's schedule: the SUM all-reduces of the
    packed (B, H, dh + 1) float32 numerator and weight."""
    return [o for o in json.loads(path.read_text())
            if o["op"] == "all-reduce" and o["bytes"] % (4 * (dh + 1)) == 0]


def phase_dryrun(procs, out_dir):
    """The dry runs ``start_dryruns`` started: each must exit 0 with
    status ok on 512 devices; a decentralized case must show no collective
    whose group spans pods, and the dense case (batch and FSDP over
    ("pod", "data")) at least one; a decode case's depth-1 schedule must
    hold the merge of partial softmaxes, and ``decode_32k``'s device
    shard of the K cache must be the one the kernel phase checked
    (``SHARD_DECODE``). Prints the three roofline terms against the
    H100's data-sheet peaks, the per-device state GiB and the device's
    peak GiB; every record must hold the reference's four memory keys
    (three counted and above 0, the generated code's null)."""
    from repro_torch.launch.dryrun import MEMORY_KEYS, device_peak

    bad = []
    for (arch, shape, mode), proc in procs.items():
        name = f"{arch} {shape} {mode}"
        try:
            out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"dry run {name}: past {DRYRUN_TIMEOUT} s")
        if proc.returncode != 0:
            raise AssertionError(f"dry run {name} exited {proc.returncode}: "
                                 f"{out[-1500:]}")
        cid = f"{arch}.{shape}.multi.{mode}.probe"
        rec = json.loads((Path(out_dir) / f"{cid}.json").read_text())
        c, r = rec["collectives"], rec["roofline"]
        decode = (arch, shape) != DRYRUN_CASE
        merges = _merge_sums(Path(out_dir) / f"{cid}.schedule.json",
                             SHARD_DECODE[-1]) if decode else []
        log(f"dry run {arch} {shape} multi {mode} (--probe, "
            f"{rec['n_devices']} fake ranks): compute {r['compute_s']:.4g} s, "
            f"memory {r['memory_s']:.4g} s (unfused bytes), collective "
            f"{r['collective_s']:.4g} s at {r['link_bw'] / 1e9:.0f} GB/s, "
            f"bottleneck {r['bottleneck']}; state "
            f"{rec['memory']['argument_size_in_bytes'] / 2**30:.3f} GiB a "
            f"device, peak {device_peak(rec['memory']) / 2**30:.3f} GiB "
            f"(arguments + temp + outputs); collectives "
            f"{c['total_bytes']:.4g} B, cross-pod "
            f"{c['cross_pod_bytes']:.4g} B in {c['cross_pod_ops']:g} ops"
            + (f"; K cache shard {tuple(rec['kv_local'])}, merge sums "
               f"{[o['bytes'] for o in merges]} B over "
               f"{sorted({len(o['ranks']) for o in merges})} ranks"
               if decode else ""))
        if rec["status"] != "ok" or rec["n_devices"] != 512:
            bad.append(f"{name}: status {rec['status']}, "
                       f"{rec['n_devices']} devices")
        mem = rec["memory"]
        if not all(mem[k] > 0 for k in MEMORY_KEYS) or \
                mem.get("generated_code_size_in_bytes", 0) is not None:
            bad.append(f"{name}: memory record {mem}")
        if mode == "decentralized" and (c["cross_pod_bytes"]
                                        or c["cross_pod_ops"]):
            bad.append(f"{name} crosses pods: {c}")
        if mode == "dense" and not c["cross_pod_ops"] > 0:
            bad.append(f"dense control shows no cross-pod collective: {c}")
        if decode and not merges:
            bad.append(f"{name}: no merge of partial softmaxes recorded")
        if shape == "decode_32k" and rec["kv_local"] != [
                SHARD_DECODE[0], SHARD_DECODE[1], *SHARD_DECODE[3:]]:
            bad.append(f"{name}: device shard {rec['kv_local']}, the kernel "
                       f"phase checked {SHARD_DECODE}")
    if bad:
        raise AssertionError("dry run: " + "; ".join(bad))


def phase_examples():
    """The end-to-end example twins on the card, each a subprocess that
    must exit 0: ``train_decentralized --steps EXAMPLE_STEPS`` (xLSTM-125M
    at the launchers' smoke size, 2 experts) into a directory under the
    ignored ``build/``, ``serve_ensemble`` on that run, then
    ``quickstart``. Prints each one's seconds and the last lines of its
    output."""
    import os
    import shutil
    import signal
    import tempfile

    (HERE / "build").mkdir(exist_ok=True)
    run = tempfile.mkdtemp(dir=HERE / "build", prefix="example_run_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    try:
        for name, args in (
                ("train_decentralized", ["--steps", str(EXAMPLE_STEPS),
                                         "--out", run]),
                ("serve_ensemble", ["--run", run]),
                ("quickstart", [])):
            t0 = time.perf_counter()
            # its own process group: the twins start the launchers as
            # their own subprocesses, and a timeout ends them all
            proc = subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.examples.{name}",
                 *args, "--device", "cuda"], env=env, cwd=str(HERE),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                start_new_session=True)
            try:
                out, _ = proc.communicate(timeout=EXAMPLE_TIMEOUT)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
                raise AssertionError(f"examples: {name} ran past "
                                     f"{EXAMPLE_TIMEOUT} s")
            tail = out.strip().splitlines()[-4:]
            log(f"examples: {name} exited {proc.returncode} in "
                f"{time.perf_counter() - t0:.1f} s; last lines: "
                + " | ".join(tail))
            if proc.returncode:
                raise AssertionError(
                    f"examples: {name} exited {proc.returncode}:\n"
                    + out[-4000:])
        with open(f"{run}/train_summary.json") as f:
            summary = json.load(f)
        log("examples: train_decentralized's experts " + json.dumps(
            summary["experts"]))
    finally:
        shutil.rmtree(run)


def phase_train_float32_gradients():
    """Full-width Qwen3-8B, 2 layers, float32, one 1024-token sequence:
    the gradient through the kernels against autograd through the plain
    attention, on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.launch import train_path
    from repro_torch.models import build_model
    from repro_torch.tree import tree_from_leaves, tree_leaves

    cfg = get_config(train_path.ARCH).reduced(
        n_layers=2, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(5))
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, (1, 1024)), device="cuda")
    batch = {"tokens": toks, "labels": toks}
    paths, leaves = zip(*tree_leaves(params))

    def loss_and_grads():
        live = [p.detach().requires_grad_() for p in leaves]
        loss, _ = model.loss(tree_from_leaves(paths, live), batch)
        return loss.item(), torch.autograd.grad(loss, live)

    ops.reset_launch_counts()
    loss_k, grads_k = loss_and_grads()
    launched = ops.KERNELS["flash_attention_bwd"].launches
    kernel_seam = ops.flash_attention
    ops.flash_attention = fk.flash_attention_ref    # plain, autograd
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        ops.flash_attention = kernel_seam
    worst, where = 0.0, ""
    for path, a, b in zip(paths, grads_k, grads_p):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        if not rel <= worst:
            worst, where = rel, path
    log(f"float32 gradients: full-width {cfg.arch_id}, 2 layers, 1024 "
        f"tokens: loss {loss_k:.6f} (kernels) vs {loss_p:.6f} (plain); "
        f"worst leaf {where}: max abs diff {worst:.3e} of its largest "
        f"element (tolerance {F32_GRAD_TOL}); backward kernel launched "
        f"{launched} times")
    if not worst <= F32_GRAD_TOL or launched != cfg.n_layers:
        raise AssertionError(f"float32 gradients disagree: {worst:.3e} at "
                             f"{where}, backward launches {launched}")


# (case, stop id: the pick at this offset or none, max_new, context left
# after the span's first position or none)
# ---------------------------------------------------------------------------
# The paper's §4 theory, and the audio family (Whisper-small)
# ---------------------------------------------------------------------------

#: the theory phase's bound on every residual and on card vs CPU
THEORY_TOL = 1e-12
#: the reference tests' grids: test_dfm.py's (d, N, P) and
#: test_decentralize.py's (d, N, P, K)
THEORY_DFM_GRID = ((3, 3, 0), (3, 3, 1), (2, 4, 2), (4, 2, 0))
THEORY_SPLIT_GRID = ((3, 3, 0, 2), (3, 3, 1, 3), (2, 4, 0, 2), (4, 2, 0, 4))
AUDIO_ARCH = "whisper_small"
# Whisper-small's heads (12 query and 12 KV heads of 64) at the audio main
# path's rows: 384 prompt positions + 64 new = 448, its decoder context
AUDIO_HEADS = (("whisper_small", 12, 12, 64),)
AUDIO_CACHE_LEN = 448


def _theory_tensors(dev):
    """Every theory quantity the phase checks, computed in float64 on
    ``dev`` (CPU copies): over ``THEORY_DFM_GRID`` the AR path's marginal
    velocities, Continuity Equation residuals and the sampling-rule
    chain's distance to q; over ``THEORY_SPLIT_GRID`` the exact router and
    the decomposition residual at every step. The inputs are the reference
    tests' numpy-seeded ones."""
    import numpy as np
    import torch
    from repro_torch.core import autoregressive as ar
    from repro_torch.core import decentralize as dec
    from repro_torch.core import dfm

    f64 = dict(dtype=torch.float64, device=dev)
    out = {}
    for d, N, P in THEORY_DFM_GRID:
        mask = d - 1
        q = np.random.default_rng(0).random(d**N)
        q[(dfm.enumerate_states(d, N) == mask).any(1)] = 0.0
        q = torch.as_tensor(q / q.sum(), **f64)
        path, nbr = ar.ar_path(q, P, d, N, mask), dfm.neighbor_table(d, N)
        us = []
        for t in range(N - P):
            u = ar.ar_marginal_velocity(q, P, t, d, N, mask)
            us.append(u)
            out[f"velocity {d},{N},{P} t={t}"] = u
            out[f"CE residual {d},{N},{P} t={t}"] = dfm.continuity_residual(
                path.marginal(t), path.marginal(t + 1), u, nbr)
        out[f"chain - q {d},{N},{P}"] = \
            dfm.chain_marginals(path.marginal(0), us, nbr)[-1] - q
    for d, N, P, K in THEORY_SPLIT_GRID:
        rng = np.random.default_rng(0)
        states = dfm.enumerate_states(d, N)
        q = rng.random(d**N)
        q[(states == d - 1).any(1)] = 0.0
        q[rng.random(d**N) < 0.3] = 0.0
        q = q / q.sum()
        assignment = rng.integers(0, K, size=d**N)
        for k, x in enumerate(np.where(q > 0)[0][:K]):
            assignment[x] = k
        split = dec.ClusterSplit(torch.as_tensor(q, **f64), assignment, K)
        for t in range(N - P):
            out[f"router {d},{N},{P},{K} t={t}"] = dec.router_weights(
                split, P, t, d, N, d - 1)
            out[f"decomposition residual {d},{N},{P},{K} t={t}"] = \
                dec.decomposition_residual(split, P, t, d, N, d - 1)
    return {k: v.cpu() for k, v in out.items()}


def phase_theory():
    """The paper's §4 theory in float64 on the card: the walkthrough twin
    (``repro_torch.examples.theory_walkthrough``), then the reference
    tests' grids (``_theory_tensors``). Fails unless every CE residual,
    decomposition residual, chain-to-target distance and TV(decoded, q) is
    within ``THEORY_TOL``, and every tensor equals the CPU's within it."""
    from repro_torch.examples import theory_walkthrough

    walk = theory_walkthrough.run("cuda", log=lambda m: log(f"theory: {m}"))
    walk_cpu = theory_walkthrough.run("cpu", log=lambda _: None)
    card, host = _theory_tensors("cuda"), _theory_tensors("cpu")
    worst = {"residual": max(walk["ce"] + [walk["tv_chain"],
                                           walk["tv_decoded"],
                                           walk["ce_counterexample"]]),
             "card_vs_cpu": max(abs(walk[k] - walk_cpu[k]) for k in
                                ("tv_chain", "tv_decoded",
                                 "tv_counterexample"))}
    for name, t in card.items():
        worst["card_vs_cpu"] = max(worst["card_vs_cpu"],
                                   (t - host[name]).abs().max().item())
        if not name.startswith(("velocity", "router")):
            worst["residual"] = max(worst["residual"], t.abs().max().item())
    log(f"theory: walkthrough on the card: CE residuals "
        f"{[f'{r:.2e}' for r in walk['ce']]}, 1-sparse "
        f"{walk['one_sparse']}, counterexample TV "
        f"{walk['tv_counterexample']:.3f}, TV(decoded, q) "
        f"{walk['tv_decoded']:.2e}; over the grids {len(card)} float64 "
        f"tensors: worst residual {worst['residual']:.3e}, worst card vs "
        f"CPU {worst['card_vs_cpu']:.3e} (tolerance {THEORY_TOL})")
    if not (worst["residual"] <= THEORY_TOL
            and worst["card_vs_cpu"] <= THEORY_TOL
            and all(walk["one_sparse"])
            and abs(walk["tv_counterexample"] - 0.5) <= THEORY_TOL):
        raise AssertionError(f"theory: {worst}, walkthrough {walk}")


def _audio_kernel_cases(cases, rec, gen):
    """The kernels at Whisper-small's shapes, each against its plain
    version run in float32 on the same values and timed beside its bound:
    paged decode, chunk prefill (C = 256 at 0, C = 100 at 256), paged
    verify (L = ``SPEC_LEN``) and contiguous decode at 8 slots over 448
    positions, 12/12 heads of dh 64 (``_new_config_kernel_cases``); then
    the encoder's flash forward, non-causal and causal, and its backward,
    non-causal, at B = 1, S = 1500 (one request's frames), in bf16 and
    float32."""
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as fbk

    _new_config_kernel_cases(cases, rec, gen, AUDIO_HEADS, (),
                             AUDIO_CACHE_LEN)
    (config, H, KV, dh), = AUDIO_HEADS
    S = 1500
    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        es = 2 if dtype is torch.bfloat16 else 4
        q, k, v = _flash_case(1, S, H, KV, dh, dtype, gen)
        for causal in (False, True):
            want, want_lse = fk.flash_attention_with_lse_ref(
                *_up(q, k, v), causal=causal)
            compare("flash_attention", fk.flash_attention_with_lse(
                q, k, v, causal=causal)[1], want_lse, name, cases)
            pairs = S * (S + 1) // 2 if causal else S * S
            _new_shape_case(
                cases, rec, "flash_attention", config,
                f"B=1 S={S} H={H} KV={KV} dh={dh} "
                f"{'causal' if causal else 'non-causal'}", name,
                lambda c=causal: fk.flash_attention_with_lse(
                    q, k, v, causal=c)[0], want,
                (2 * S * H * dh + 2 * S * KV * dh) * es + S * H * 4,
                4 * H * dh * pairs)
        do = torch.randn((1, S, H, dh), generator=gen, device="cuda") \
            .to(dtype)
        out, lse = _check_flash_bwd(fk, fbk, cases, name, q, k, v, do,
                                    causal=False)
        # q, out, do, k, v and lse read; dq, dk, dv written; five
        # products over every (query, key) pair
        t_bytes = ((4 * S * H * dh + 4 * S * KV * dh) * es
                   + S * H * 4) / HBM_BPS * 1e3
        t_ops = 10 * H * dh * S * S / PEAK_FLOPS[name] * 1e3
        rec["flash_attention_bwd"].setdefault("new_config_shapes", []).append(
            {"config": config,
             "shape": f"B=1 S={S} H={H} KV={KV} dh={dh} non-causal",
             "dtype": name,
             "max_abs_err": max(c["max_abs_err"] for c in cases[-3:]),
             "device_ms": device_ms(lambda: fbk.flash_attention_bwd(
                 q, k, v, out, lse, do, causal=False), iters=5),
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    for kname in ("flash_attention", "flash_attention_bwd"):
        for c in rec[kname]["new_config_shapes"]:
            if c["config"] == config and f"S={S}" in c["shape"]:
                log(f"new-shape case {kname} ({config}, {c['shape']}, "
                    f"{c['dtype']}): max abs err {c['max_abs_err']:.3e}, "
                    f"device ms {c['device_ms']}, bound "
                    f"{c['bound_ms']:.4f} by {c['bound_by']}")


def _hybrid_training_kernel_cases(cases, rec, gen):
    """The flash forward and backward at the hybrid training path's shape
    (Zamba2-2.7B's shared block: H = KV = 32, dh = 80, B = 1, S = 4096,
    causal, bf16), each against its plain version run in float32 on the
    same values, timed beside its bound (``new_config_shapes``)."""
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as fbk

    config, S, H, dh, name = "zamba2_2_7b", 4096, 32, 80, "bfloat16"
    q, k, v = _flash_case(1, S, H, H, dh, torch.bfloat16, gen)
    shape = f"B=1 S={S} H={H} KV={H} dh={dh} causal (training)"
    pairs = S * (S + 1) // 2
    want, want_lse = fk.flash_attention_with_lse_ref(*_up(q, k, v))
    compare("flash_attention", fk.flash_attention_with_lse(q, k, v)[1],
            want_lse, name, cases)
    _new_shape_case(cases, rec, "flash_attention", config, shape, name,
                    lambda: fk.flash_attention_with_lse(q, k, v)[0], want,
                    (4 * S * H * dh) * 2 + S * H * 4, 4 * H * dh * pairs)
    do = torch.randn((1, S, H, dh), generator=gen, device="cuda") \
        .to(torch.bfloat16)
    out, lse = _check_flash_bwd(fk, fbk, cases, name, q, k, v, do)
    # q, out, do, k, v and lse read; dq, dk, dv written; five products
    # over every (query, key) pair the causal mask keeps
    t_bytes = (8 * S * H * dh * 2 + S * H * 4) / HBM_BPS * 1e3
    t_ops = 10 * H * dh * pairs / PEAK_FLOPS[name] * 1e3
    rec["flash_attention_bwd"].setdefault("new_config_shapes", []).append(
        {"config": config, "shape": shape, "dtype": name,
         "max_abs_err": max(c["max_abs_err"] for c in cases[-3:]),
         "device_ms": device_ms(lambda: fbk.flash_attention_bwd(
             q, k, v, out, lse, do), iters=5),
         "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    for kname in ("flash_attention", "flash_attention_bwd"):
        c = rec[kname]["new_config_shapes"][-1]
        log(f"new-shape case {kname} ({config}, {c['shape']}, "
            f"{c['dtype']}): max abs err {c['max_abs_err']:.3e}, device ms "
            f"{c['device_ms']}, bound {c['bound_ms']:.4f} by "
            f"{c['bound_by']}")


def _flash_per_request(label, launches, n_req, per_request):
    """The flash-forward launches of a full-width audio path must be
    ``per_request`` for each admitted request."""
    if launches["flash_attention"] != per_request * n_req:
        raise AssertionError(
            f"{label}: {launches['flash_attention']} flash-forward "
            f"launches for {n_req} requests, not {per_request} a request")


def phase_audio_paths():
    """Full-width Whisper-small (12 encoder and 12 decoder layers, D = 768,
    bf16, 2 experts of seeded random weights) on the audio deployment of
    ``main_path.build(arch="whisper_small")`` (each request with its own
    seeded 1500 frames, prompts of 32–384 tokens, cache_len 448): paged +
    chunked top-1, then contiguous + monolithic, then the Eq. 27 mixture
    (top_k 2, ``MIXTURE_NEW_TOKENS``), each with the main path's checks.
    The flash forward must launch 12 times a request on the chunked paths
    (the encoder alone, once at admission; the mixture's K experts in one
    launch) and 12 + 12 times a request on the contiguous path (the
    encoder, then the decoder's monolithic prefill). Returns the three
    runs' launch counts."""
    import torch
    from repro_torch.launch import main_path
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    mp = main_path.build("cuda", arch=AUDIO_ARCH)
    torch.cuda.synchronize()
    cfg, n = mp.cfg, len(mp.prompts)
    n_params = sum(t.numel() for _, t in tree_leaves(mp.experts[0]))
    log(f"audio path: {main_path.N_EXPERTS} experts of {cfg.arch_id} "
        f"({cfg.n_enc_layers} encoder and {cfg.n_layers} decoder layers, "
        f"D={cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, {cfg.n_audio_frames} frames of {cfg.audio_dim} "
        f"a request, cache_len {mp.config.cache_len}, "
        f"{n_params / 1e9:.3f} B parameters an expert, bf16) initialized "
        f"in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    watch = (("decode_step_paged", lambda x: x),
             ("prefill_chunk", lambda x: x))
    kernels = MAIN_KERNELS + ("flash_attention",)
    main_res, main = _serve_watched("audio path", mp, watch, kernels)
    _flash_per_request("audio path", main, n, cfg.n_enc_layers)
    cp = main_path.contiguous(mp)
    mp.engine = None
    torch.cuda.empty_cache()
    res, contiguous = _serve_watched(
        "audio contiguous path", cp, (("decode_step", lambda x: x),
                                      ("prefill", lambda x: x[:, -1])),
        CONTIGUOUS_KERNELS)
    _flash_per_request("audio contiguous path", contiguous, n,
                       cfg.n_enc_layers + cfg.n_layers)
    same = sum(res[i][0] == main_res[i][0] for i in main_res)
    log(f"audio contiguous path: {same} of {len(main_res)} requests got "
        f"the same tokens as on the audio path (information only: bf16 "
        f"rounding differs between the paths)")
    cp.engine = None
    xp = _mixture_of(mp)
    mp.experts = xp.experts = None      # the stack holds the weights now
    torch.cuda.empty_cache()
    _, mixture = _serve_watched("audio mixture path", xp, watch, kernels)
    _flash_per_request("audio mixture path", mixture, n, cfg.n_enc_layers)
    xp.engine = None
    return main, contiguous, mixture


FUSED_VERIFY_CASES = (("full accept", None, None, None),
                      ("stop", 1, None, None),
                      ("length", None, 3, None),
                      ("truncated", None, None, 2))


def _check_fused_verify(model, params, pool, table, tok, pos, picks,
                        cache_len):
    """``Model.fused_verify_step`` at one slot with the greedy chain
    ``picks`` (SPEC_LEN,) as drafts, so every draft is accepted: with no
    halt it must emit all SPEC_LEN picks and leave pos and tok where
    SPEC_LEN decode steps leave them; with a stop id, a token budget or a
    context end inside the span it must stop there and retire the slot.
    Returns the cases that disagree."""
    import torch

    dev, i32 = pos.device, torch.int32
    width, p = int(pos[0]), picks.tolist()
    bad = []
    for label, stop_at, max_new, room in FUSED_VERIFY_CASES:
        stop = -1 if stop_at is None else p[stop_at]
        clen = cache_len if room is None else width + room
        # the first halting offset, as the decode steps would meet it
        halts = [j for j in range(SPEC_LEN)
                 if p[j] == stop or (max_new is not None and j + 1 >= max_new)
                 or width + 1 + j >= clen]
        m = halts[0] + 1 if halts else SPEC_LEN
        code = 0 if not halts else 1 if p[halts[0]] == stop else \
            2 if max_new is not None and halts[0] + 1 >= max_new else 3
        state = {"tok": tok, "pos": pos,
                 "active": torch.ones(1, dtype=torch.bool, device=dev),
                 "counts": torch.zeros(1, dtype=i32, device=dev),
                 "max_new": torch.tensor([max_new or 2**31 - 1], dtype=i32,
                                         device=dev),
                 "stop_ids": torch.tensor([[stop]], dtype=i32, device=dev),
                 "tables": table[None]}
        _, new, toks, n_emit, done = model.fused_verify_step(
            params, {k: v.clone() for k, v in pool.items()}, state,
            picks[None, :SPEC_LEN - 1], cache_len=clen)
        got = (toks[0, :int(n_emit[0])].tolist(), int(n_emit[0]),
               int(done[0]), int(new["pos"][0]), int(new["tok"][0]),
               bool(new["active"][0]))
        want = (p[:m], m, code, 0 if code else width + m,
                0 if code else p[m - 1], not code)
        if got != want:
            bad.append(f"{label} at {width}: (toks, n_emit, done, pos, tok, "
                       f"active) {got}, want {want}")
    return bad


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name} "
              f"— run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this check "
              "needs the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    for name, path in libs.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
        secs = build.build_seconds.get(name)
        built = f"built in {secs:.1f} s" if secs is not None \
            else "built before this run"
        hgmma = sum('HGMMA' in ln for ln in sass)
        log(f"  {name}: {built}; tensor-core instructions in its SASS: HGMMA "
            f"{hgmma}, HMMA {sum('HMMA' in ln for ln in sass)}")
        if name in TENSOR_CORE_LIBS and not hgmma:
            raise AssertionError(f"{name}: no HGMMA in its SASS: its bf16 "
                                 f"kernels do not reach the tensor cores")
    for name in libs:
        logf = build.build_dir() / f"{name}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                # the resource report only (ptxas' notes on wgmma
                # scheduling stay in the log file)
                if ": Used" in line or "spill stores" in line:
                    log(f"  {name}: {line.strip()}")

    seconds = {"build": round(time.perf_counter() - t0, 1)}
    # the dry runs need no card: they run beside the card's phases
    dry_out = build.build_dir().parent / "dryrun"
    dry_out.mkdir(parents=True, exist_ok=True)
    dry_procs = start_dryruns(dry_out)
    atexit.register(_stop, dry_procs)

    def timed(phase, *args):
        """Run one phase, keeping its wall seconds for the record."""
        t = time.perf_counter()
        out = phase(*args)
        name = phase.__name__.removeprefix("phase_")
        if args and isinstance(args[0], str):
            name += "".join(f" {a}" for a in args
                            if isinstance(a, (str, float)))
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    rec = timed(phase_kernels)
    timed(phase_theory)
    for arch in ("qwen3_8b", "zamba2_2_7b", VLM_ARCH, SSM_ARCH) \
            + DENSE_CONFIG_ARCHS + (AUDIO_ARCH,):
        timed(phase_parity, arch)
    for arch in MOE_ARCHS:
        for cf in (None, MOE_DROP_CF):
            timed(phase_parity, arch, cf)
    mp, main_res, main_launches = timed(phase_main_path)
    unfused_launches = timed(phase_unfused_path, mp, main_res)
    batch_launches = timed(phase_batch_engine, mp)
    torch.cuda.empty_cache()
    spec_launches = timed(phase_speculative_path, mp, main_res)
    sampled_launches = timed(phase_sampled_path, mp, main_res)
    contiguous_launches = timed(phase_contiguous_path, mp, main_res)
    torch.cuda.empty_cache()
    prefix_launches = timed(phase_prefix_path, mp)
    preemption_launches = timed(phase_preemption_path, mp)
    xp, mixture_launches = timed(phase_mixture_path, mp, main_res)
    del mp                           # the bf16 experts
    torch.cuda.empty_cache()         # their segments, for the second stack
    mixspec_launches = timed(phase_mixture_speculative_path, xp)
    del xp
    torch.cuda.empty_cache()
    timed(phase_float32_agreement)
    torch.cuda.empty_cache()
    timed(phase_mixture_float32)
    torch.cuda.empty_cache()
    hybrid_launches, scan_tensor_core, hybrid_mix_launches = \
        timed(phase_hybrid_path)
    torch.cuda.empty_cache()
    timed(phase_hybrid_float32_agreement)
    torch.cuda.empty_cache()
    (ssm_launches, ssm_mix_launches), ssm_on_tc = timed(phase_ssm_path)
    torch.cuda.empty_cache()
    vlm_launches, vlm_contiguous_launches, vlm_mixture_launches = \
        timed(phase_vlm_paths)
    torch.cuda.empty_cache()
    timed(phase_vlm_float32)
    dense_launches = {}
    for arch in DENSE_CONFIG_ARCHS:
        torch.cuda.empty_cache()
        dense_launches[arch] = timed(phase_dense_config_path, arch)
    torch.cuda.empty_cache()
    timed(phase_moe_ffn)
    torch.cuda.empty_cache()
    moe_launches = timed(phase_moe_paths)
    torch.cuda.empty_cache()
    audio_launches, audio_contiguous_launches, audio_mixture_launches = \
        timed(phase_audio_paths)
    torch.cuda.empty_cache()
    timed(phase_train_parity)
    timed(phase_train_step_parity)
    train_launches = timed(phase_train_path)
    torch.cuda.empty_cache()
    moe_train_launches = timed(phase_train_path, "deepseek_moe_16b")
    torch.cuda.empty_cache()
    audio_train_launches = timed(phase_train_path, AUDIO_ARCH)
    torch.cuda.empty_cache()
    hybrid_train_launches = timed(phase_train_path, "zamba2_2_7b")
    torch.cuda.empty_cache()
    ssm_train_launches = timed(phase_train_path, SSM_ARCH)
    torch.cuda.empty_cache()
    timed(phase_train_float32_gradients)
    torch.cuda.empty_cache()
    timed(phase_remat)
    torch.cuda.empty_cache()
    placed_launches = timed(phase_placed_train)
    torch.cuda.empty_cache()
    timed(phase_examples)
    timed(phase_dryrun, dry_procs, dry_out)
    timed(phase_moe_launches)
    log(f"wall seconds by phase: {json.dumps(seconds)}")
    # each kernel's launches on the full-width path that runs it (the
    # verify kernel runs on the speculative path only, the chunk scan on
    # the hybrid path only, the flash backward on the training path only;
    # flash attention keeps the contiguous serving path's count, the
    # training path prints its own)
    launches = dict(contiguous_launches,
                    **{n: main_launches[n] for n in MAIN_KERNELS},
                    paged_verify_attention=spec_launches[
                        "paged_verify_attention"],
                    chunk_scan=hybrid_launches["chunk_scan"],
                    flash_attention_bwd=train_launches[
                        "flash_attention_bwd"])
    # every full-width path's count of each kernel, for the record
    by_path = {"main": main_launches, "unfused": unfused_launches,
               "batch top1": batch_launches["top1"],
               "batch mixture": batch_launches["mixture"],
               "ssm": ssm_launches, "ssm mixture": ssm_mix_launches,
               "speculative": spec_launches,
               "sampled": sampled_launches,
               "contiguous": contiguous_launches, "mixture": mixture_launches,
               "prefix": prefix_launches, "preemption": preemption_launches,
               "mixture speculative": mixspec_launches,
               "hybrid": hybrid_launches, "hybrid mixture": hybrid_mix_launches,
               "vlm": vlm_launches, "vlm contiguous": vlm_contiguous_launches,
               "vlm mixture": vlm_mixture_launches,
               **dense_launches, **moe_launches, "training": train_launches,
               "deepseek_moe_16b training": moe_train_launches,
               "audio": audio_launches,
               "audio contiguous": audio_contiguous_launches,
               "audio mixture": audio_mixture_launches,
               "whisper_small training": audio_train_launches,
               "zamba2_2_7b training": hybrid_train_launches,
               "xlstm_125m training": ssm_train_launches,
               "placed training": placed_launches}

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        r = rec[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "tol": r.get("tol", TOL[r["dtype"]]),
            "max_abs_err_by_dtype": r["max_abs_err_by_dtype"],
            "shape": r["shape"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_device_ms": r.get("library_device_ms"),
            "launches_by_path": {p: n[name] for p, n in by_path.items()
                                 if n.get(name)},
            "new_config_shapes": r.get("new_config_shapes", []),
            **{k: r[k] for k in ("float32_ms", "float32_device_ms",
                                 "batched", "by_batch",
                                 "launch_floor_device_ms", "lse",
                                 "library_flash_device_ms") if k in r}})
        if name == "chunk_scan":
            # the hybrid path's calls by route, and the ssm paths' (every
            # one on the tensor cores at mLSTM's widths)
            kernels[-1].update(
                tensor_core_launches=scan_tensor_core,
                scalar_launches=launches[name] - scan_tensor_core,
                scan_parts=r["parts"],
                **{key: {"launches": n[name], "tensor_core_launches": tc,
                         "scalar_launches": n[name] - tc}
                   for key, n, tc in (("ssm_path", ssm_launches,
                                       ssm_on_tc[0]),
                                      ("ssm_mixture_path", ssm_mix_launches,
                                       ssm_on_tc[1]))})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
