// Decode and chunk-prefill attention kernels for Hopper (sm_90a), bound
// through a plain C interface (ctypes; see kernels/build.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decode_attention.py:
//   * paged_decode_attention  (:454, body _paged_decode_kernel :127 and
//     _accum_block :34) — one query token per slot over its paged KV span;
//   * decode_attention        (:85, body _decode_kernel :63 and the same
//     _accum_block) — one query token per slot over its contiguous
//     (B, S, KV, dh) cache row;
//   * chunk_prefill_attention (:240, body _chunk_prefill_kernel :177) — a
//     prompt chunk's queries over the request's paged prefix + the chunk;
//   * paged_verify_attention  (:381, body _paged_verify_kernel :316) — a
//     speculative span of L candidate tokens per slot over the slot's paged
//     KV span (the span's own K/V already scattered in), row l fenced to
//     keys <= pos + l: the chunk-prefill body batched over slots.
//
// What bounds them on the card: device memory. Every key and value of the live
// span is read once per (slot, KV head) and used by only the GQA group
// (decode) or one row tile (prefill, verify), so the arithmetic intensity is a
// few operations per byte, far below the ~295 op/byte where bf16 tensor cores
// become the limit. This first version is the simple, right one: one thread
// block per (slot, KV head) for decode, per (KV head, tile of query rows) for
// prefill and per (slot, KV head, tile of span rows) for verify (spec_len 4 at
// GQA 4:1 is one tile of 16 rows, so verify launches as many blocks as
// decode), each walking the key tiles of its span up to the horizon tile
// (tiles past it are neither loaded nor computed) through the shared tile loop
// of attention_tile.cuh. The paged and contiguous decode kernels are one
// template: they differ only in where a key tile's rows sit (a block table
// entry, or (b, s) arithmetic), as the Pallas kernels share _accum_block and
// differ only in their index maps. The contiguous cache is cut into tiles of
// kContiguousBlock positions and any S is taken (the Pallas wrapper asserts S
// % min(256, S) == 0; the ragged last tile is masked here). Known gap: at 8
// slots x 8 KV heads decode and verify fill 64 of the 132 SMs; splitting the
// span across blocks (flash-decoding) and wgmma/TMA staging are later work.

#include "attention_tile.cuh"

using namespace attn_tile;

namespace {

constexpr int kContiguousBlock = 64;   // cache positions per key tile

// grid (B, KV): the `group` query heads h = kvh * group + g of slot b
// (q.reshape(B, KV, group, dh), as the reference regroups them) attend over
// key tiles 0..last of the slot's span of s_len positions. Keys at
// position <= pos are live; with window > 0 the span is a ring and every
// key is live once pos >= s_len.
template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              Rows rows, T* __restrict__ out, int H, int KV, int dh,
              int block, int nk, int s_len, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, group = H / KV;
  const Tile t = carve(smem, group, block, dh);
  const int p = pos[b];
  const bool wrapped = window > 0 && p >= s_len;
  const size_t q0 = (size_t(b) * H + size_t(kvh) * group) * dh;
  for (int i = threadIdx.x; i < group * dh; i += blockDim.x)
    t.q[i] = to_f32(q[q0 + i]);
  for (int r = threadIdx.x; r < group; r += blockDim.x) {
    t.lo[r] = 0;
    t.hi[r] = wrapped ? s_len - 1 : min(p, s_len - 1);
  }
  init_state(t, group, dh);
  __syncthreads();
  const int last = wrapped ? nk - 1 : min(p / block, nk - 1);
  for (int ki = 0; ki <= last; ++ki) {
    load_kv(t, k, v, rows, b, ki, kvh, block, KV, dh);
    __syncthreads();
    accum_block(t, group, block, dh, ki * block, scale);
  }
  for (int i = threadIdx.x; i < group * dh; i += blockDim.x)
    out[q0 + i] = from_f32<T>(t.acc[i] / fmaxf(t.l[i / dh], 1e-30f));
}

// grid (KV, ceil(C * group / kRows)): rows are the chunk's (c, g) query
// pairs flattened c-major per KV head; row c*group + g is query head
// kvh*group + g at absolute position start + c, fenced to keys at
// positions <= start + c. Each tile stops at its own last row's block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool,
                     const int* __restrict__ table, T* __restrict__ out,
                     int start, int C, int H, int KV, int dh, int block,
                     int NB, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, group = H / KV;
  const int r0 = blockIdx.y * kRows;
  const int R = min(kRows, C * group - r0);
  const Tile t = carve(smem, R, block, dh);
  const PagedRows rows{table, NB, block};
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    t.q[i] = to_f32(q[(size_t(c) * H + h) * dh + d]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    t.lo[r] = 0;
    t.hi[r] = start + (r0 + r) / group;
  }
  init_state(t, R, dh);
  __syncthreads();
  const int last = min((start + (r0 + R - 1) / group) / block, NB - 1);
  for (int ki = 0; ki <= last; ++ki) {
    load_kv(t, k_pool, v_pool, rows, 0, ki, kvh, block, KV, dh);
    __syncthreads();
    accum_block(t, R, block, dh, ki * block, scale);
  }
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    out[(size_t(c) * H + h) * dh + d] =
        from_f32<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
}

// grid (B, KV, ceil(L * group / kRows)): rows are slot b's (l, g) query
// pairs flattened l-major per KV head; row l*group + g is query head
// kvh*group + g of span offset l, at absolute position pos[b] + l and
// fenced to keys at positions <= pos[b] + l. Each row tile stops at the
// block of its own last row, or at the table's last column: a span past
// the table horizon NB*block (its K/V went to the scratch block) sees
// exactly the NB blocks of the table. pos is read on the device.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ pos,
                    const int* __restrict__ tables, T* __restrict__ out,
                    int L, int H, int KV, int dh, int block, int NB,
                    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, group = H / KV;
  const int r0 = blockIdx.z * kRows;
  const int R = min(kRows, L * group - r0);
  const Tile t = carve(smem, R, block, dh);
  const PagedRows rows{tables, NB, block};
  const int p = pos[b];
  const size_t q0 = size_t(b) * L * H;     // row (b, 0, 0) of (B, L, H, dh)
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int l = rr / group, h = kvh * group + rr % group;
    t.q[i] = to_f32(q[(q0 + size_t(l) * H + h) * dh + d]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    t.lo[r] = 0;
    t.hi[r] = p + (r0 + r) / group;
  }
  init_state(t, R, dh);
  __syncthreads();
  const int last = min((p + (r0 + R - 1) / group) / block, NB - 1);
  for (int ki = 0; ki <= last; ++ki) {
    load_kv(t, k_pool, v_pool, rows, b, ki, kvh, block, KV, dh);
    __syncthreads();
    accum_block(t, R, block, dh, ki * block, scale);
  }
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int l = rr / group, h = kvh * group + rr % group;
    out[(q0 + size_t(l) * H + h) * dh + d] =
        from_f32<T>(t.acc[i] / fmaxf(t.l[r], 1e-30f));
  }
}

template <typename T, typename Rows>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* pos, Rows rows, void* out, int B, int H,
                  int KV, int dh, int block, int nk, int s_len, int window,
                  float scale, cudaStream_t stream) {
  const size_t bytes = tile_bytes(H / KV, block, dh);
  cudaError_t err = set_smem(decode_kernel<T, Rows>, bytes);
  if (err != cudaSuccess) return int(err);
  decode_kernel<T, Rows><<<dim3(B, KV), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos), rows,
      static_cast<T*>(out), H, KV, dh, block, nk, s_len, window, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_prefill(const void* q, const void* k, const void* v,
                   const void* table, void* out, int start, int C, int H,
                   int KV, int dh, int block, int NB, float scale,
                   cudaStream_t stream) {
  const size_t bytes = tile_bytes(kRows, block, dh);
  cudaError_t err = set_smem(chunk_prefill_kernel<T>, bytes);
  if (err != cudaSuccess) return int(err);
  const int tiles = (C * (H / KV) + kRows - 1) / kRows;
  chunk_prefill_kernel<T><<<dim3(KV, tiles), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<T*>(out), start, C, H, KV, dh, block, NB, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_verify(const void* q, const void* k, const void* v,
                  const void* pos, const void* tables, void* out, int B,
                  int L, int H, int KV, int dh, int block, int NB,
                  float scale, cudaStream_t stream) {
  const size_t bytes = tile_bytes(kRows, block, dh);
  cudaError_t err = set_smem(paged_verify_kernel<T>, bytes);
  if (err != cudaSuccess) return int(err);
  const int tiles = (L * (H / KV) + kRows - 1) / kRows;
  paged_verify_kernel<T><<<dim3(B, KV, tiles), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(tables), static_cast<T*>(out), L, H, KV, dh,
      block, NB, scale);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its
// launch.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* pos,
                                      const void* tables, void* out,
                                      int dtype, int B, int H, int KV, int dh,
                                      int block, int NB, int window,
                                      float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const PagedRows rows{static_cast<const int*>(tables), NB, block};
  if (dtype == 0)
    return launch_decode<float>(q, k_pool, v_pool, pos, rows, out, B, H, KV,
                                dh, block, NB, NB * block, window, scale, s);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k_pool, v_pool, pos, rows, out,
                                        B, H, KV, dh, block, NB, NB * block,
                                        window, scale, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, void* out, int dtype, int B,
                                int H, int KV, int dh, int S, int window,
                                float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int block = kContiguousBlock;
  const ContiguousRows rows{S, block};
  const int nk = (S + block - 1) / block;
  if (dtype == 0)
    return launch_decode<float>(q, k, v, pos, rows, out, B, H, KV, dh, block,
                                nk, S, window, scale, s);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k, v, pos, rows, out, B, H, KV,
                                        dh, block, nk, S, window, scale, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int chunk_prefill_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       void* out, int dtype, int start, int C,
                                       int H, int KV, int dh, int block,
                                       int NB, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_prefill<float>(q, k_pool, v_pool, table, out, start, C, H,
                                 KV, dh, block, NB, scale, s);
  if (dtype == 1)
    return launch_prefill<__nv_bfloat16>(q, k_pool, v_pool, table, out,
                                         start, C, H, KV, dh, block, NB,
                                         scale, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int paged_verify_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* pos,
                                      const void* tables, void* out,
                                      int dtype, int B, int L, int H, int KV,
                                      int dh, int block, int NB, float scale,
                                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_verify<float>(q, k_pool, v_pool, pos, tables, out, B, L, H,
                                KV, dh, block, NB, scale, s);
  if (dtype == 1)
    return launch_verify<__nv_bfloat16>(q, k_pool, v_pool, pos, tables, out,
                                        B, L, H, KV, dh, block, NB, scale, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
