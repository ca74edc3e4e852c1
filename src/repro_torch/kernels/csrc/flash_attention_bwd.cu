// Flash attention backward for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see kernels/build.py).
//
// Replaces the Pallas TPU kernel pair of
// src/repro/kernels/flash_attention_bwd.py (flash_attention_bwd :121,
// bodies _dq_kernel :41 and _dkv_kernel :79): the gradient of full-sequence
// grouped-query self-attention (flash_attention.cu's forward) from the
// saved per-row log-sum-exp,
//
//   p  = exp(q.k^T * scale - lse)     (masked entries 0)
//   dv = p^T . do
//   ds = p * (do.v^T - delta),  delta = rowsum(do * o)
//   dk = ds^T . q * scale
//   dq = ds . k * scale
//
// with q, do, o (B,S,H,dh), k, v (B,S,KV,dh), query head h on KV head
// h // (H/KV), lse and delta (B,S,H) float32. delta is one elementwise
// product and sum outside the kernels (the wrapper's torch call), as the
// Pallas wrapper computes it in jnp (:136).
//
// Two kernels behind one entry point, as the Pallas pair:
// * dq: grid (KV, row tiles, B). A block owns kRows query rows of one KV
//   head -- (position, group head) pairs flattened position-major, as the
//   forward's tiles -- and walks the key tiles its mask reaches, staging K
//   and V in float32 shared memory and accumulating dq there.
// * dk/dv: grid (KV, key tiles, B). A block owns kKeyBlock keys of one KV
//   head with their dk and dv accumulators in float32 shared memory, and
//   walks the query rows that can see them: every group head of each
//   position, so the GQA group sum happens in float32 inside the kernel,
//   with no per-query-head temporaries and no atomics (the Pallas wrapper
//   writes per-head dk/dv and sums them in the working dtype, :183).
//   Key tiles are numbered so that the ones with the most rows to walk
//   (the first, under a causal mask) are launched first.
//
// The mask is the forward's: row position c sees key x iff x <= c (causal)
// and c - x < window (window > 0, causal only). Any S: the ragged last key
// tile is zero-filled and its missing keys lie past every row's last
// visible key; the ragged last row tile has fewer rows (R), and a padded
// row is never walked, so no lse that the forward did not write is read.
//
// What bounds it on the card: at Qwen3-8B's heads and S = 4096 the five
// causal products are ~344 GFLOP, ~0.35 ms at the bf16 tensor-core rate;
// the bytes (q, k, v, o, do, lse, dq, dk, dv) ~0.03 ms at 3.35 TB/s. So
// it is bound by operations. This first version is the simple, right one
// and runs no tensor core: scalar float32 FMAs out of shared memory, as
// the forward; wgmma with TMA staging is later work.

#include "attention_tile.cuh"

using namespace attn_tile;

namespace {

constexpr int kKeyBlock = 32;   // key positions per staged tile

// First and last key a query row at position c may see.
__device__ __forceinline__ void row_bounds(int c, int S, int causal,
                                           int window, int* lo, int* hi) {
  *lo = (causal && window > 0) ? max(0, c - window + 1) : 0;
  *hi = causal ? c : S - 1;
}

// Copy `n` rows of KV head `kvh` from position p0 of contiguous (B,S,KV,dh)
// k and v into ld-strided float32 tiles of `block` rows; rows from n on
// are zeros.
template <typename T>
__device__ inline void stage_keys(float* sk, float* sv, const T* __restrict__ k,
                                  const T* __restrict__ v, size_t p0, int n,
                                  int kvh, int block, int KV, int dh,
                                  int ld) {
  for (int i = threadIdx.x; i < block * dh; i += blockDim.x) {
    const int j = i / dh, d = i - j * dh;
    float kf = 0.f, vf = 0.f;
    if (j < n) {
      const size_t off = ((p0 + j) * KV + kvh) * dh + d;
      kf = to_f32(k[off]);
      vf = to_f32(v[off]);
    }
    sk[j * ld + d] = kf;
    sv[j * ld + d] = vf;
  }
}

// Stage R flattened query rows r0.. of KV head kvh: q and do as float32,
// lse, delta and the rows' visibility bounds.
template <typename T>
__device__ inline void stage_rows(float* sq, float* sdo, float* slse,
                                  float* sdelta, int* slo, int* shi,
                                  const T* __restrict__ q,
                                  const T* __restrict__ dO,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta, int b,
                                  int r0, int R, int kvh, int S, int H,
                                  int group, int dh, int causal, int window) {
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    const size_t off = ((size_t(b) * S + c) * H + h) * dh + d;
    sq[i] = to_f32(q[off]);
    sdo[i] = to_f32(dO[off]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    const size_t off = (size_t(b) * S + c) * H + h;
    slse[r] = lse[off];
    sdelta[r] = delta[off];
    row_bounds(c, S, causal, window, &slo[r], &shi[r]);
  }
}

// p and ds of R staged rows against a staged key tile whose first key is
// at position key0; masked entries are 0. Either output may be null.
__device__ inline void probs(float* sp, float* sds, const float* sq,
                             const float* sdo, const float* sk,
                             const float* sv, const float* slse,
                             const float* sdelta, const int* slo,
                             const int* shi, int R, int block, int dh,
                             int ld, int key0, float scale) {
  for (int i = threadIdx.x; i < R * block; i += blockDim.x) {
    const int r = i / block, j = i - r * block, key = key0 + j;
    float p = 0.f, ds = 0.f;
    if (key >= slo[r] && key <= shi[r]) {
      const float* qr = sq + size_t(r) * dh;
      const float* dor = sdo + size_t(r) * dh;
      const float* kj = sk + size_t(j) * ld;
      const float* vj = sv + size_t(j) * ld;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(qr[d], kj[d], s);
        dp = fmaf(dor[d], vj[d], dp);
      }
      p = expf(s * scale - slse[r]);
      ds = p * (dp - sdelta[r]);
    }
    if (sp) sp[i] = p;
    sds[i] = ds;
  }
}

__host__ __device__ inline size_t dq_bytes(int dh) {
  const int R = kRows, block = kKeyBlock, ld = dh + 1;
  return (size_t(3) * R * dh + size_t(2) * block * ld + size_t(R) * block +
          2 * R) * sizeof(float) + 2 * R * sizeof(int);
}

__host__ __device__ inline size_t dkv_bytes(int dh) {
  const int R = kRows, block = kKeyBlock, ld = dh + 1;
  return (size_t(2) * block * ld + size_t(2) * block * dh +
          size_t(2) * R * dh + size_t(2) * R * block + 2 * R) *
         sizeof(float) + 2 * R * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int H, int KV, int dh, int causal,
          int window, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.z, group = H / KV;
  const int r0 = blockIdx.y * kRows;
  const int R = min(kRows, S * group - r0);
  const int block = kKeyBlock, ld = dh + 1;
  float* sq = smem;                        // R * dh
  float* sdo = sq + kRows * dh;            // R * dh
  float* sacc = sdo + kRows * dh;          // R * dh   dq accumulator
  float* sk = sacc + kRows * dh;           // block * ld
  float* sv = sk + block * ld;             // block * ld
  float* sds = sv + block * ld;            // R * block
  float* slse = sds + kRows * block;       // R
  float* sdelta = slse + kRows;            // R
  int* slo = reinterpret_cast<int*>(sdelta + kRows);
  int* shi = slo + kRows;
  stage_rows(sq, sdo, slse, sdelta, slo, shi, q, dO, lse, delta, b, r0, R,
             kvh, S, H, group, dh, causal, window);
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) sacc[i] = 0.f;
  __syncthreads();
  const int c_first = r0 / group, c_last = (r0 + R - 1) / group;
  const bool windowed = causal && window > 0;
  const int first = windowed ? max(0, c_first - window + 1) / block : 0;
  const int last = causal ? c_last / block : (S - 1) / block;
  for (int ki = first; ki <= last; ++ki) {
    const int key0 = ki * block;
    stage_keys(sk, sv, k, v, size_t(b) * S + key0, min(block, S - key0),
               kvh, block, KV, dh, ld);
    __syncthreads();
    probs(nullptr, sds, sq, sdo, sk, sv, slse, sdelta, slo, shi, R, block,
          dh, ld, key0, scale);
    __syncthreads();
    for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
      const int r = i / dh, d = i - r * dh;
      const float* dsr = sds + size_t(r) * block;
      float a = 0.f;
      for (int j = 0; j < block; ++j) a = fmaf(dsr[j], sk[j * ld + d], a);
      sacc[i] += a;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    dq[((size_t(b) * S + c) * H + h) * dh + d] = from_f32<T>(sacc[i] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dO,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV,
           int dh, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.z, group = H / KV;
  const int block = kKeyBlock, ld = dh + 1;
  const int key0 = blockIdx.y * block, n = min(block, S - key0);
  float* sk = smem;                        // block * ld
  float* sv = sk + block * ld;             // block * ld
  float* sdk = sv + block * ld;            // block * dh  dk accumulator
  float* sdv = sdk + block * dh;           // block * dh  dv accumulator
  float* sq = sdv + block * dh;            // R * dh
  float* sdo = sq + kRows * dh;            // R * dh
  float* sp = sdo + kRows * dh;            // R * block
  float* sds = sp + kRows * block;         // R * block
  float* slse = sds + kRows * block;       // R
  float* sdelta = slse + kRows;            // R
  int* slo = reinterpret_cast<int*>(sdelta + kRows);
  int* shi = slo + kRows;
  stage_keys(sk, sv, k, v, size_t(b) * S + key0, n, kvh, block, KV, dh, ld);
  for (int i = threadIdx.x; i < block * dh; i += blockDim.x) {
    sdk[i] = 0.f;
    sdv[i] = 0.f;
  }
  // the positions whose rows can see a key of this tile
  const bool windowed = causal && window > 0;
  const int c_lo = causal ? key0 : 0;
  const int c_hi = windowed ? min(S - 1, key0 + n - 1 + window - 1) : S - 1;
  const int row_end = (c_hi + 1) * group;
  for (int r0 = c_lo * group; r0 < row_end; r0 += kRows) {
    const int R = min(kRows, row_end - r0);
    __syncthreads();   // the previous rows' tiles are consumed
    stage_rows(sq, sdo, slse, sdelta, slo, shi, q, dO, lse, delta, b, r0, R,
               kvh, S, H, group, dh, causal, window);
    __syncthreads();
    probs(sp, sds, sq, sdo, sk, sv, slse, sdelta, slo, shi, R, block, dh,
          ld, key0, scale);
    __syncthreads();
    for (int i = threadIdx.x; i < block * dh; i += blockDim.x) {
      const int j = i / dh, d = i - j * dh;
      float a = 0.f, c = 0.f;
      for (int r = 0; r < R; ++r) {
        a = fmaf(sp[r * block + j], sdo[r * dh + d], a);
        c = fmaf(sds[r * block + j], sq[r * dh + d], c);
      }
      sdv[i] += a;
      sdk[i] += c;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * dh; i += blockDim.x) {
    const int j = i / dh, d = i - j * dh;
    const size_t off = ((size_t(b) * S + key0 + j) * KV + kvh) * dh + d;
    dk[off] = from_f32<T>(sdk[i] * scale);
    dv[off] = from_f32<T>(sdv[i]);
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dO,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int B, int S, int H, int KV, int dh, int causal,
               int window, float scale, cudaStream_t stream) {
  const size_t q_bytes = dq_bytes(dh), kv_bytes = dkv_bytes(dh);
  cudaError_t err = set_smem(dq_kernel<T>, q_bytes);
  if (err != cudaSuccess) return int(err);
  err = set_smem(dkv_kernel<T>, kv_bytes);
  if (err != cudaSuccess) return int(err);
  const int row_tiles = (S * (H / KV) + kRows - 1) / kRows;
  const int key_tiles = (S + kKeyBlock - 1) / kKeyBlock;
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto dop = static_cast<const T*>(dO);
  auto lp = static_cast<const float*>(lse);
  auto dp = static_cast<const float*>(delta);
  dq_kernel<T><<<dim3(KV, row_tiles, B), kThreads, q_bytes, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<T*>(dq), S, H, KV, dh, causal,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dkv_kernel<T><<<dim3(KV, key_tiles, B), kThreads, kv_bytes, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<T*>(dk), static_cast<T*>(dv), S,
      H, KV, dh, causal, window, scale);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launches.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int dtype,
                                   int B, int S, int H, int KV, int dh,
                                   int causal, int window, float scale,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, dO, lse, delta, dq, dk, dv, B, S, H,
                             KV, dh, causal, window, scale, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, dO, lse, delta, dq, dk, dv, B,
                                     S, H, KV, dh, causal, window, scale, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
