// Flash attention forward for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see kernels/build.py).
//
// Replaces the Pallas TPU kernel flash_attention_with_lse of
// src/repro/kernels/flash_attention.py (:83, body _flash_kernel :26):
// full-sequence grouped-query self-attention, q (B,S,H,dh) against k, v
// (B,S,KV,dh) with query head h on KV head h // (H/KV), causal and/or a
// sliding window (row - col < window, applied with causal as in the Pallas
// body), online softmax in float32; writes out (B,S,H,dh) in q's dtype and
// the per-row log-sum-exp lse (B,S,H) in float32 (natural log), the
// residual the backward pass needs.
//
// What bounds it on the card: at a prompt of 1024 tokens the operations
// (about 4 * H * dh * S^2 / 2 for causal attention, 8.6 GFLOP at
// Qwen3-8B's heads) take ~9 us at the bf16 tensor-core rate, the bytes
// (q, k, v, out) ~6 us at 3.35 TB/s, so it is bound by operations, and
// only the tensor cores come near the bound.
//
// Two kernels behind one entry point, chosen by dtype:
//
// * bfloat16: flash_fwd_sm90, on the tensor cores (flash_sm90.cuh). A
//   block owns 2 x 64 flattened query rows of one KV head -- (position,
//   group head) pairs, position-major, so the group's heads share every
//   K/V tile; 64 // group positions a warpgroup. A producer warp loads the
//   block's Q once and keeps a three-stage ring of 64-key K and V tiles
//   full with TMA (4-D tensor maps over (dh, heads, S, B): a ragged last
//   tile reads zeros, never the next batch row). Each of two consumer
//   warpgroups holds its Q tile in registers and runs S = Q.K^T with
//   wgmma (float32 accumulators in registers), the online softmax on the
//   accumulator fragment (exp2 with log2 e folded into the scale; lse
//   converted back to the natural log when written), converts P to bf16
//   in registers and runs O += P.V with P as the register A operand. The
//   two products are software-pipelined: S of tile i is issued with P.V
//   of tile i - 1 behind it, and the softmax of tile i waits for the first
//   only. Only tiles that cross the diagonal, the window's start or S are
//   masked; tiles wholly above the diagonal or before the window are not
//   loaded, and tiles that no row of a warpgroup sees are skipped by it.
//   Under a causal mask the row tiles with the most key tiles are launched
//   first. dh is any multiple of 8 up to 128 (the tensor maps' strides are
//   whole 16 bytes; above 128 a thread's float32 O accumulator and Q
//   fragments, 4 x 32 and 4 x 16 registers at dh = 256, leave no room
//   under its 255 for the scores and P); the score product runs ceil(dh / 16) k-steps over
//   zero-filled columns, the P.V product one 64-column wgmma per 64
//   columns of dh. P is rounded to bf16 for its product, as in every
//   flash design; the normaliser l sums the float32 weights.
// * float32: flash_kernel, the first, scalar design (float32 FMAs out of
//   shared memory through attention_tile.cuh's tile loop, 16 query rows a
//   block, 32-key tiles). Tensor cores take no float32 inputs, and TF32
//   keeps about three digits, which would break the float32 tolerance
//   (5e-5) that the card's checks and the full-width float32 phases hold
//   it to, so this path stays scalar.
//
// Build: one nvcc, no extra include path, about 8 s (nvcc 12.9 on the
// H100 machine's host). <cuda.h> is read for the CUtensorMap type only;
// cuTensorMapEncodeTiled is looked up in the libcuda that the CUDA
// runtime has loaded (cudaGetDriverEntryPoint), so nothing links it.

#include "attention_tile.cuh"
#include "flash_sm90.cuh"

namespace {

// ---------------------------------------------------------------- float32

namespace scalar {

using namespace attn_tile;

constexpr int kKeyBlock = 32;   // key positions per staged tile

// grid (KV, ceil(S * group / kRows), B): row r0 + r of KV head kvh is
// query position c = (r0 + r) / group of head kvh * group + (r0 + r) %
// group.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int S, int H, int KV, int dh,
             int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.z, group = H / KV;
  const int r0 = blockIdx.y * kRows;
  const int R = min(kRows, S * group - r0);
  const int block = kKeyBlock;
  const Tile t = carve(smem, R, block, dh);
  const ContiguousRows rows{S, block};
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    t.q[i] = to_f32(q[((size_t(b) * S + c) * H + h) * dh + d]);
  }
  const bool windowed = causal && window > 0;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int c = (r0 + r) / group;
    t.lo[r] = windowed ? max(0, c - window + 1) : 0;
    t.hi[r] = causal ? c : S - 1;
  }
  init_state(t, R, dh);
  __syncthreads();
  const int c_first = r0 / group, c_last = (r0 + R - 1) / group;
  const int first = windowed ? max(0, c_first - window + 1) / block : 0;
  const int last = causal ? c_last / block : (S - 1) / block;
  for (int ki = first; ki <= last; ++ki) {
    load_kv(t, k, v, rows, b, ki, kvh, block, KV, dh);
    __syncthreads();
    accum_block(t, R, block, dh, ki * block, scale);
  }
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    out[((size_t(b) * S + c) * H + h) * dh + d] =
        from_f32<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    lse[(size_t(b) * S + c) * H + h] =
        t.m[r] + logf(fmaxf(t.l[r], 1e-30f));
  }
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 void* lse, int B, int S, int H, int KV, int dh, int causal,
                 int window, float scale, cudaStream_t stream) {
  const size_t bytes = tile_bytes(kRows, kKeyBlock, dh);
  cudaError_t err = set_smem(flash_kernel<T>, bytes);
  if (err != cudaSuccess) return int(err);
  const int tiles = (S * (H / KV) + kRows - 1) / kRows;
  flash_kernel<T><<<dim3(KV, tiles, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, H, KV, dh, causal, window, scale);
  return int(cudaGetLastError());
}

}  // namespace scalar

// ---------------------------------------------------------------- bf16

namespace fwd {

using namespace sm90;

// Shared memory, from a 1024-byte boundary: Q (NS slabs of 2 x 64 rows),
// then kStages K tiles and kStages V tiles (NS slabs of 64 keys each),
// then the barriers.
template <int NS>
struct Smem {
  static constexpr int kStages = 3;   // a consumer holds two tiles at once
  static constexpr int kQSlab = kConsumers * kSlabBytes;
  static constexpr int kKV = NS * kSlabBytes;        // one K or V tile
  static constexpr int kK = NS * kQSlab;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBar = kV + kStages * kKV;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// grid (KV, row tiles, B), kThreads threads: warpgroups 0 and 1 consume,
// warp 0 of warpgroup 2 loads. Block tile y holds positions
// [y * 2P, y * 2P + 2P), P = 64 / group, P of them a warpgroup.
template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int S, int H, int KV, int dh, int causal, int window,
               float scale_log2) {
  using L = Smem<NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;
  const int group = H / KV, P = kTile / group, rows = P * group;
  const int kvh = blockIdx.x, b = blockIdx.z;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int c_first = tile * kConsumers * P;
  const int c_last = min(S - 1, c_first + kConsumers * P - 1);
  const bool windowed = causal && window > 0;
  const int kt_first = windowed ? max(0, c_first - window + 1) / kTile : 0;
  const int kt_last = causal ? c_last / kTile : (S - 1) / kTile;
  const int n_kt = kt_last - kt_first + 1;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers * 128);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {                               // producer
    reg_dealloc<40>();
    if (threadIdx.x != kConsumers * 128) return;
    bar_expect_tx(q_full, NS * kConsumers * rows * 128);
    for (int w = 0; w < kConsumers; ++w)
      for (int s = 0; s < NS; ++s)
        tma_load(sm + s * L::kQSlab + w * kSlabBytes, &mq, q_full,
                 s * kSlab, kvh * group, c_first + w * P, b);
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % L::kStages;
      bar_wait(&empty[st], ((i / L::kStages) & 1) ^ 1);
      bar_expect_tx(&full[st], 2 * L::kKV);
      const int key0 = (kt_first + i) * kTile;
      for (int s = 0; s < NS; ++s) {
        tma_load(sm + L::kK + st * L::kKV + s * kSlabBytes, &mk, &full[st],
                 s * kSlab, kvh, key0, b);
        tma_load(sm + L::kV + st * L::kKV + s * kSlabBytes, &mv, &full[st],
                 s * kSlab, kvh, key0, b);
      }
    }
    return;
  }

  reg_alloc<232>();                                     // consumers
  const int t = threadIdx.x % 128, lane = t % 32, quad = lane % 4;
  const int r0 = (t / 32) * 16 + lane / 4;   // rows r0 and r0 + 8
  const int cw = c_first + wg * P;           // the warpgroup's positions
  const int cw_last = min(S - 1, cw + P - 1);
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = cw + (r0 + 8 * h) / group;
    lo[h] = windowed ? max(0, c - window + 1) : 0;
    hi[h] = causal ? c : S - 1;
  }
  // the warpgroup's key tiles are [i0, i1] of the block's: those past
  // its last row's diagonal, and those wholly before its first row's
  // window, hold no key it sees
  int i0 = 0, i1 = n_kt - 1;
  if (cw > S - 1) {
    i0 = n_kt;
  } else {
    if (causal) i1 = cw_last / kTile - kt_first;
    if (windowed && cw - window + 1 > 0)
      i0 = (cw - window + 1) / kTile - kt_first;
  }
  const int ksteps = (dh + 15) / 16;
  auto wait_tile = [&](int i) {
    bar_wait(&full[i % L::kStages], (i / L::kStages) & 1);
  };
  auto release = [&](int i) { bar_arrive(&empty[i % L::kStages]); };
  for (int i = 0; i < min(i0, n_kt); ++i) {
    wait_tile(i);
    release(i);
  }
  float o[NS][32];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[s][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  if (i0 <= i1) {
    uint32_t qf[4 * NS][4];
    bar_wait(q_full, 0);
    load_a_frags<NS>(sm + wg * kSlabBytes, L::kQSlab, qf);
    float sc[32], alpha[2];
    uint32_t pa[4][4];
    // S = Q.K^T of tile i into sc (one commit group)
    auto issue_s = [&](int i) {
      const uint8_t* kt = sm + L::kK + (i % L::kStages) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < 4 * NS; ++kk) {
        if (kk >= ksteps) break;
        wgmma_rs<0>(sc, qf[kk],
                    desc_k(kt + (kk >> 2) * kSlabBytes + (kk & 3) * 32),
                    kk > 0);
      }
      wg_commit();
    };
    // O += P.V of tile i, P in pa (one commit group)
    auto issue_pv = [&](int i) {
      const uint8_t* vt = sm + L::kV + (i % L::kStages) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int s = 0; s < NS; ++s)
          wgmma_rs<1>(o[s], pa[kk], desc_mn(vt + s * kSlabBytes +
                                             kk * 2048));
      wg_commit();
    };
    auto softmax = [&](int i) {
      const int key0 = (kt_first + i) * kTile, key_end = key0 + kTile - 1;
      const bool whole = key_end <= S - 1 && (!causal || key_end <= cw) &&
                         (!windowed || cw_last - key0 < window);
      softmax_step(sc, m, l, alpha, whole, key0, quad, lo, hi, scale_log2);
    };
    wait_tile(i0);
    fence_regs(qf);
    wg_fence();
    issue_s(i0);
    wg_wait<0>();
    fence_regs(qf);
    fence_regs(sc);
    softmax(i0);
    to_a_frags(sc, pa);
    // Software pipeline: S of tile i runs on the tensor cores with P.V
    // of tile i - 1 behind it, while the softmax of tile i waits only for
    // the first.
    for (int i = i0 + 1; i <= i1; ++i) {
      wait_tile(i);
      fence_regs(pa);
      fence_regs(o);
      wg_fence();
      issue_s(i);
      issue_pv(i - 1);
      wg_wait<1>();
      fence_regs(sc);
      softmax(i);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(i - 1);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[s][e] *= alpha[(e >> 1) & 1];
      to_a_frags(sc, pa);
    }
    fence_regs(pa);
    fence_regs(o);
    wg_fence();
    issue_pv(i1);
    wg_wait<0>();
    fence_regs(o);
    release(i1);
  }
  for (int i = max(i0, i1 + 1); i < n_kt; ++i) {
    wait_tile(i);
    release(i);
  }

  // epilogue: rows r0 and r0 + 8 of the warpgroup's tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lh = quad_sum(l[h]);
    const int rl = r0 + 8 * h, c = cw + rl / group;
    if (rl >= rows || c > S - 1) continue;
    const size_t row = (size_t(b) * S + c) * H + kvh * group + rl % group;
    const float inv = 1.f / fmaxf(lh, 1e-30f);
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = s * kSlab + 8 * j + 2 * quad;
        if (col < dh)
          *reinterpret_cast<__nv_bfloat162*>(out + row * dh + col) =
              __floats2bfloat162_rn(o[s][4 * j + 2 * h] * inv,
                                    o[s][4 * j + 2 * h + 1] * inv);
      }
    if (quad == 0) lse[row] = (m[h] + log2f(fmaxf(lh, 1e-30f))) * kLn2;
  }
}

template <int NS>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int S, int H, int KV, int dh, int causal,
           int window, float scale, cudaStream_t stream) {
  const int group = H / KV, P = kTile / group;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, B, S, H, dh, group, P);
  if (!err) err = make_map(&mk, k, B, S, KV, dh, 1, kTile);
  if (!err) err = make_map(&mv, v, B, S, KV, dh, 1, kTile);
  if (err) return err;
  const size_t bytes = Smem<NS>::kBytes;
  cudaError_t e = allow_smem(flash_fwd_sm90<NS>, bytes);
  if (e != cudaSuccess) return int(e);
  const int tiles = (S + kConsumers * P - 1) / (kConsumers * P);
  flash_fwd_sm90<NS><<<dim3(KV, tiles, B), kThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), S, H, KV, dh, causal, window,
      scale * kLog2e);
  return int(cudaGetLastError());
}

}  // namespace fwd

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor cores; dh a
// multiple of 8 up to 128, H / KV <= 64, 16-byte aligned operands: the
// wrapper checks). Returns the cudaError_t of the launch, or
// sm90::kEncodeError + the CUresult of a failed tensor-map encoding.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int dtype, int B, int S,
                               int H, int KV, int dh, int causal, int window,
                               float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return scalar::launch_flash<float>(q, k, v, out, lse, B, S, H, KV, dh, causal,
                               window, scale, s);
  if (dtype != 1 || dh % 8 || dh > 128 || H % KV || H / KV > 64)
    return int(cudaErrorInvalidValue);
  if (dh <= 64)
    return fwd::launch<1>(q, k, v, out, lse, B, S, H, KV, dh, causal,
                          window, scale, s);
  return fwd::launch<2>(q, k, v, out, lse, B, S, H, KV, dh, causal, window,
                        scale, s);
}

extern "C" const char* kernel_error_string(int err) {
  return sm90::error_string(err);
}
