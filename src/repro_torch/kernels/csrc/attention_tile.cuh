// Device-side tile loop shared by the attention kernels of
// decode_attention.cu (paged decode, chunk prefill, contiguous decode) and
// flash_attention.cu (monolithic prefill).
//
// A thread block owns R query rows of one KV head and walks key tiles of
// `block` rows in ascending order: each tile is staged in shared memory as
// float32, scored against the rows, and folded into the online softmax
// (m, l, acc) kept in float32 shared memory. Row r sees key position x
// iff lo[r] <= x <= hi[r]; every kernel states its visibility rule by
// filling lo/hi. Where a key tile's rows sit in device memory is the only
// thing the layouts differ in, so it is a template parameter (`Rows`) of
// the loader: a block table lookup for the paged pool, (b, s) arithmetic
// for contiguous rows.
//
// Numerics mirror the Pallas bodies (repro/kernels/decode_attention.py
// _accum_block, repro/kernels/flash_attention.py _flash_kernel): scores in
// float32 scaled by 1/sqrt(dh), the masking constant -1e30, the m/l/acc
// recurrence in ascending key order, and the final divide by
// max(l, 1e-30). A row that sees no key of a tile takes exp(0) weights
// there until a tile with a visible key arrives, whose rescale factor
// exp(-1e30 - m) is 0 and wipes them, as in the Pallas kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace attn_tile {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kRows = 16;   // query rows per prefill thread block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory tile for R query rows against one key tile. K rows are
// padded to dh + 1 floats so that threads reading neighbouring keys at the
// same feature hit different banks.
struct Tile {
  float* q;      // R * dh
  float* k;      // block * (dh + 1)
  float* v;      // block * dh
  float* s;      // R * block   scores, then probabilities
  float* m;      // R           running max
  float* l;      // R           running denominator
  float* alpha;  // R           rescale factor of this tile
  float* acc;    // R * dh      running numerator
  int* lo;       // R           first key position the row may attend
  int* hi;       // R           last key position the row may attend
};

__host__ __device__ inline size_t tile_floats(int R, int block, int dh) {
  return size_t(R) * dh * 2 + size_t(block) * (2 * dh + 1) +
         size_t(R) * block + 3 * size_t(R);
}

__host__ __device__ inline size_t tile_bytes(int R, int block, int dh) {
  return tile_floats(R, block, dh) * sizeof(float) + 2 * size_t(R) *
         sizeof(int);
}

__device__ inline Tile carve(float* smem, int R, int block, int dh) {
  Tile t;
  t.q = smem;
  t.k = t.q + size_t(R) * dh;
  t.v = t.k + size_t(block) * (dh + 1);
  t.s = t.v + size_t(block) * dh;
  t.m = t.s + size_t(R) * block;
  t.l = t.m + R;
  t.alpha = t.l + R;
  t.acc = t.alpha + R;
  t.lo = reinterpret_cast<int*>(t.acc + size_t(R) * dh);
  t.hi = t.lo + R;
  return t;
}

__device__ inline void init_state(const Tile& t, int R, int dh) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    t.m[r] = kNegInf;
    t.l[r] = 0.f;
  }
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) t.acc[i] = 0.f;
}

// Key tile `ki` of a (P, block, KV, dh) pool: physical block
// table[b * NB + ki], all of its rows.
struct PagedRows {
  const int* table;
  int NB, block;
  __device__ size_t first(int b, int ki) const {
    return size_t(table[size_t(b) * NB + ki]) * block;
  }
  __device__ int count(int) const { return block; }
};

// Key tile `ki` of contiguous (B, S, KV, dh) rows: positions
// ki * block .. of row b; the last tile of a ragged S is short.
struct ContiguousRows {
  int S, block;
  __device__ size_t first(int b, int ki) const {
    return size_t(b) * S + size_t(ki) * block;
  }
  __device__ int count(int ki) const { return min(block, S - ki * block); }
};

// Copy `block` rows starting at row r0 of KV head `kvh` into shared memory
// as float32. kRagged: rows from n on are zeros instead (a ragged last
// tile; the callers' hi <= S - 1 keeps them invisible). Compiled into
// every tile's copy, the guard measurably slows the paged kernels, whose
// tiles are always full, so full tiles take the unguarded copy.
template <bool kRagged, typename T>
__device__ inline void stage_kv(const Tile& t, const T* __restrict__ k,
                                const T* __restrict__ v, size_t r0, int n,
                                int kvh, int block, int KV, int dh) {
  for (int i = threadIdx.x; i < block * dh; i += blockDim.x) {
    const int j = i / dh, d = i - j * dh;
    float kf = 0.f, vf = 0.f;
    if (!kRagged || j < n) {
      const size_t off = ((r0 + j) * KV + kvh) * dh + d;
      kf = to_f32(k[off]);
      vf = to_f32(v[off]);
    }
    t.k[j * (dh + 1) + d] = kf;
    t.v[i] = vf;
  }
}

// Stage key tile `ki` of KV head `kvh`.
template <typename T, typename Rows>
__device__ inline void load_kv(const Tile& t, const T* __restrict__ k,
                               const T* __restrict__ v, const Rows& rows,
                               int b, int ki, int kvh, int block, int KV,
                               int dh) {
  const size_t r0 = rows.first(b, ki);
  const int n = rows.count(ki);
  if (n == block)
    stage_kv<false>(t, k, v, r0, n, kvh, block, KV, dh);
  else
    stage_kv<true>(t, k, v, r0, n, kvh, block, KV, dh);
}

// One online-softmax step over the staged tile, whose first key sits at
// position key0. Ends synchronized, so the next tile may be staged.
__device__ inline void accum_block(const Tile& t, int R, int block, int dh,
                                   int key0, float scale) {
  for (int i = threadIdx.x; i < R * block; i += blockDim.x) {
    const int r = i / block, j = i - r * block;
    const float* qr = t.q + size_t(r) * dh;
    const float* kj = t.k + size_t(j) * (dh + 1);
    float dot = 0.f;
    for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kj[d], dot);
    const int key = key0 + j;
    t.s[i] = (key >= t.lo[r] && key <= t.hi[r]) ? dot * scale : kNegInf;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float* sr = t.s + size_t(r) * block;
    const float m_prev = t.m[r];
    float m_new = m_prev;
    for (int j = 0; j < block; ++j) m_new = fmaxf(m_new, sr[j]);
    float sum = 0.f;
    for (int j = 0; j < block; ++j) {
      const float p = expf(sr[j] - m_new);
      sr[j] = p;
      sum += p;
    }
    const float a = expf(m_prev - m_new);
    t.l[r] = a * t.l[r] + sum;
    t.alpha[r] = a;
    t.m[r] = m_new;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh;
    const float* pr = t.s + size_t(r) * block;
    float o = 0.f;
    for (int j = 0; j < block; ++j) o = fmaf(pr[j], t.v[j * dh + d], o);
    t.acc[i] = t.acc[i] * t.alpha[r] + o;
  }
  __syncthreads();
}

// Allow `bytes` of dynamic shared memory for `kernel` (above 48 KB only by
// opting in).
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

}  // namespace attn_tile
