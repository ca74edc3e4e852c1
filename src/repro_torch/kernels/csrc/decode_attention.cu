// Paged attention kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see kernels/build.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decode_attention.py:
//   * paged_decode_attention  (:454, body _paged_decode_kernel :127 and
//     _accum_block :34) — one query token per slot over its paged KV span;
//   * chunk_prefill_attention (:240, body _chunk_prefill_kernel :177) — a
//     prompt chunk's queries over the request's paged prefix + the chunk.
//
// What bounds them on the card: device memory. Every key and value of the
// live span is read once per (slot, KV head) and used by only the GQA group
// (decode) or one row tile (prefill), so the arithmetic intensity is a few
// operations per byte, far below the ~295 op/byte where bf16 tensor cores
// become the limit. This first version is the simple, right one: one thread
// block per (slot, KV head) for decode and per (KV head, tile of query
// rows) for prefill, each looping over the logical blocks of its span up to
// the horizon block (blocks past it are neither loaded nor computed), with
// the K/V block staged in shared memory as float32 and the online softmax
// (m, l, acc) kept in float32 shared memory. Known gap: at 8 slots x 8 KV
// heads decode fills 64 of the 132 SMs; splitting the span across blocks
// (flash-decoding) and wgmma/TMA staging are later work.
//
// Numerics mirror the Pallas body: scores in float32 scaled by 1/sqrt(dh),
// the masking constant -1e30, m/l/acc recurrence in ascending block order,
// and the final divide by max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kPrefillRows = 16;   // query rows per prefill thread block

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

// Shared-memory tile for R query rows against one KV block. K rows are
// padded to dh + 1 floats so that threads reading neighbouring keys at the
// same feature hit different banks.
struct Tile {
  float* q;      // R * dh
  float* k;      // block * (dh + 1)
  float* v;      // block * dh
  float* s;      // R * block   scores, then probabilities
  float* m;      // R           running max
  float* l;      // R           running denominator
  float* alpha;  // R           rescale factor of this block
  float* acc;    // R * dh      running numerator
  int* limit;    // R           largest key position the row may attend
};

__host__ __device__ inline size_t tile_floats(int R, int block, int dh) {
  return size_t(R) * dh * 2 + size_t(block) * (2 * dh + 1) +
         size_t(R) * block + 3 * size_t(R);
}

__host__ __device__ inline size_t tile_bytes(int R, int block, int dh) {
  return tile_floats(R, block, dh) * sizeof(float) + size_t(R) * sizeof(int);
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
  t.limit = reinterpret_cast<int*>(t.acc + size_t(R) * dh);
  return t;
}

__device__ inline void init_state(const Tile& t, int R, int dh) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    t.m[r] = kNegInf;
    t.l[r] = 0.f;
  }
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) t.acc[i] = 0.f;
}

// Stage physical block `phys` of KV head `kvh` from the (P, block, KV, dh)
// pools into shared memory as float32.
template <typename T>
__device__ inline void load_kv(const Tile& t, const T* __restrict__ k_pool,
                               const T* __restrict__ v_pool, int phys, int kvh,
                               int block, int KV, int dh) {
  for (int i = threadIdx.x; i < block * dh; i += blockDim.x) {
    const int j = i / dh, d = i - j * dh;
    const size_t off = ((size_t(phys) * block + j) * KV + kvh) * dh + d;
    t.k[j * (dh + 1) + d] = to_f32(k_pool[off]);
    t.v[i] = to_f32(v_pool[off]);
  }
}

// One online-softmax step over the staged block, whose first key sits at
// logical position key0: key key0 + j is visible to row r iff
// key0 + j <= limit[r]. Ends synchronized, so the next block may be staged.
__device__ inline void accum_block(const Tile& t, int R, int block, int dh,
                                   int key0, float scale) {
  for (int i = threadIdx.x; i < R * block; i += blockDim.x) {
    const int r = i / block, j = i - r * block;
    const float* qr = t.q + size_t(r) * dh;
    const float* kj = t.k + size_t(j) * (dh + 1);
    float dot = 0.f;
    for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kj[d], dot);
    t.s[i] = (key0 + j <= t.limit[r]) ? dot * scale : kNegInf;
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

// grid (B, KV): the `group` query heads h = kvh * group + g of slot b
// (q.reshape(B, KV, group, dh), as the reference regroups them) attend over
// the slot's logical blocks 0..last through its block table row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ pos,
                    const int* __restrict__ tables, T* __restrict__ out,
                    int H, int KV, int dh, int block, int NB, int window,
                    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, group = H / KV;
  const Tile t = carve(smem, group, block, dh);
  const int p = pos[b];
  const int s_log = NB * block;
  // ring rule (window > 0): once the slot wrapped, every key is live
  const bool wrapped = window > 0 && p >= s_log;
  const size_t q0 = (size_t(b) * H + size_t(kvh) * group) * dh;
  for (int i = threadIdx.x; i < group * dh; i += blockDim.x)
    t.q[i] = to_f32(q[q0 + i]);
  for (int r = threadIdx.x; r < group; r += blockDim.x)
    t.limit[r] = wrapped ? INT_MAX : p;
  init_state(t, group, dh);
  __syncthreads();
  const int last = wrapped ? NB - 1 : min(p / block, NB - 1);
  for (int ki = 0; ki <= last; ++ki) {
    const int phys = tables[size_t(b) * NB + ki];
    load_kv(t, k_pool, v_pool, phys, kvh, block, KV, dh);
    __syncthreads();
    accum_block(t, group, block, dh, ki * block, scale);
  }
  for (int i = threadIdx.x; i < group * dh; i += blockDim.x)
    out[q0 + i] = from_f32<T>(t.acc[i] / fmaxf(t.l[i / dh], 1e-30f));
}

// grid (KV, ceil(C * group / kPrefillRows)): rows are the chunk's
// (c, g) query pairs flattened c-major per KV head; row c*group + g is
// query head kvh*group + g at absolute position start + c, fenced to keys
// at positions <= start + c. Each tile stops at its own last row's block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool,
                     const int* __restrict__ table, T* __restrict__ out,
                     int start, int C, int H, int KV, int dh, int block,
                     int NB, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, group = H / KV;
  const int r0 = blockIdx.y * kPrefillRows;
  const int R = min(kPrefillRows, C * group - r0);
  const Tile t = carve(smem, R, block, dh);
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    t.q[i] = to_f32(q[(size_t(c) * H + h) * dh + d]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    t.limit[r] = start + (r0 + r) / group;
  init_state(t, R, dh);
  __syncthreads();
  const int last = min((start + (r0 + R - 1) / group) / block, NB - 1);
  for (int ki = 0; ki <= last; ++ki) {
    load_kv(t, k_pool, v_pool, table[ki], kvh, block, KV, dh);
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

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* pos, const void* tables, void* out, int B,
                  int H, int KV, int dh, int block, int NB, int window,
                  float scale, cudaStream_t stream) {
  const size_t bytes = tile_bytes(H / KV, block, dh);
  cudaError_t err = set_smem(paged_decode_kernel<T>, bytes);
  if (err != cudaSuccess) return int(err);
  paged_decode_kernel<T><<<dim3(B, KV), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(tables), static_cast<T*>(out), H, KV, dh,
      block, NB, window, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_prefill(const void* q, const void* k, const void* v,
                   const void* table, void* out, int start, int C, int H,
                   int KV, int dh, int block, int NB, float scale,
                   cudaStream_t stream) {
  const size_t bytes = tile_bytes(kPrefillRows, block, dh);
  cudaError_t err = set_smem(chunk_prefill_kernel<T>, bytes);
  if (err != cudaSuccess) return int(err);
  const int tiles = (C * (H / KV) + kPrefillRows - 1) / kPrefillRows;
  chunk_prefill_kernel<T><<<dim3(KV, tiles), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<T*>(out), start, C, H, KV, dh, block, NB, scale);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* pos,
                                      const void* tables, void* out,
                                      int dtype, int B, int H, int KV, int dh,
                                      int block, int NB, int window,
                                      float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_decode<float>(q, k_pool, v_pool, pos, tables, out, B, H,
                                KV, dh, block, NB, window, scale, s);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k_pool, v_pool, pos, tables, out,
                                        B, H, KV, dh, block, NB, window,
                                        scale, s);
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

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
