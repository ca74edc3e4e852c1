// Flash attention forward for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see kernels/build.py).
//
// Replaces the Pallas TPU kernel flash_attention_with_lse of
// src/repro/kernels/flash_attention.py (:83, body _flash_kernel :26):
// full-sequence grouped-query self-attention, q (B,S,H,dh) against k, v
// (B,S,KV,dh) with query head h on KV head h // (H/KV), causal and/or a
// sliding window (row - col < window, applied with causal as in the Pallas
// body), online softmax in float32; writes out (B,S,H,dh) in q's dtype and
// the per-row log-sum-exp lse (B,S,H) in float32, the residual the
// backward pass needs.
//
// What bounds it on the card: at a prompt of 1024 tokens the operations
// (about 4 * H * dh * S^2 / 2 for causal attention, 8.6 GFLOP at
// Qwen3-8B's heads) take ~9 us at the bf16 tensor-core rate, the bytes
// (q, k, v, out) ~6 us at 3.35 TB/s, so it is bound by operations. This
// first version is the simple, right one and runs no tensor core: the
// Pallas grid's sequential key axis becomes a loop inside one thread
// block that owns a (batch, KV head, tile of query rows) and walks the key
// tiles itself through the tile loop that the decode and chunk-prefill
// kernels share (attention_tile.cuh) — contiguous self-attention is the
// chunk-prefill kernel at start 0 over contiguous rows. The query rows of
// a tile are the (position, group head) pairs flattened position-major,
// so the H/KV query heads of a KV head share each staged K/V tile. Key
// tiles wholly above the diagonal or wholly before the window are
// skipped. Any S is taken (the Pallas wrapper asserts S % 128 == 0 beyond
// one block); the ragged last key tile is masked. Known gap: scalar
// float32 FMAs from shared memory, ~100x off the bound; wgmma with TMA
// staging is later work.

#include "attention_tile.cuh"

using namespace attn_tile;

namespace {

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int dtype, int B, int S,
                               int H, int KV, int dh, int causal, int window,
                               float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_flash<float>(q, k, v, out, lse, B, S, H, KV, dh, causal,
                               window, scale, s);
  if (dtype == 1)
    return launch_flash<__nv_bfloat16>(q, k, v, out, lse, B, S, H, KV, dh,
                                       causal, window, scale, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
