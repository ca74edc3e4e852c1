// Fused centroid-router kernel (paper Eq. 28) for Hopper (sm_90a), bound
// through a plain C interface (ctypes; see kernels/build.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/router_scores.py
// (router_scores :34, body _router_kernel :21): L2-normalize the features
// x (B, D) and the centroids (K, D) with rsqrt(max(sum of squares, 1e-24)),
// take the cosine similarities, then a temperature softmax over K.
//
// What bounds it on the card: at the serving shapes (B = 1 at admission,
// D = tens, K = a handful) the latency of one launch, far above its
// 1e-7 ms of bytes; at large B the bytes of x, read once. The design:
// * a row takes `span` lanes of a warp (the fewest powers of two that hold
//   one piece of the row each, at most 32), so a warp serves 32 / span
//   rows (at D = 32 in float32, 8 lanes of 16 bytes: 4 rows a warp) and a
//   block `warps` such warps: one group of rows a block;
// * each lane reads its pieces of x with 16-byte loads where D and the
//   alignment allow (router_plan in router_scores.py); where the row is
//   one piece a lane, the load is issued before the centroids are staged
//   and the piece stays in registers;
// * the block stages the centroids, converted to float32, in shared memory,
//   each group of span lanes taking one (at B = 1 and D = 32, K = 2: two
//   groups of the one warp, so both centroids and x are loaded at once),
//   and with them their inverse norms (a shuffle sum among the group's
//   lanes); where K x D does not fit the shared-memory budget it stages
//   them in slabs along D, and the sums run over the slabs in turn;
// * the K dot products are reduced with shuffles among a row's lanes only,
//   no block barrier, and the K-way softmax runs in the same lanes: in
//   their registers where the centroids take one slab and K is at most
//   kChunkK (every lane then holds all K sums), else over the sums each
//   row keeps in shared memory.
// The only block barriers are those around each slab's staging. The
// launch configuration (warps, lanes a row, slab width, vector width) is
// fixed on the host from the shapes alone: at B = 1 one warp in one launch.
// The Pallas version padded the ragged batch edge with rows of 1.0; here
// the lanes of rows past the last stage centroids, shuffle along and store
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxWarps = 32;
constexpr size_t kMaxSmem = 48 * 1024;   // no opt-in attribute needed

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

// Butterfly sum (max) over each aligned group of `span` lanes (a power of
// two, uniform across the warp): every lane of a group gets its total.
__device__ __forceinline__ float group_sum(float v, int span) {
  for (int o = span / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v, int span) {
  for (int o = span / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// VEC elements from src (16 bytes when VEC > 1) into float32 dst; returns
// their sum of squares.
template <typename T, int VEC>
__device__ __forceinline__ float load_vec(const T* src, float* dst) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16-byte vectors");
  float sq = 0.f;
  if constexpr (VEC == 1) {
    dst[0] = to_f32(src[0]);
    sq = dst[0] * dst[0];
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      dst[i] = to_f32(e[i]);
      sq = fmaf(dst[i], dst[i], sq);
    }
  }
  return sq;
}

// A piece of VEC floats from shared memory, 16 bytes a read (pieces start
// on 16-byte boundaries: slabs and pieces are whole multiples of VEC).
template <int VEC>
__device__ __forceinline__ void read_piece(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
  }
}

// Shared memory (floats): the centroid slab cs[K][slab], the centroids'
// inverse norms [K], then each row's dot products [rows][K].
__host__ __device__ inline size_t smem_floats(int K, int rows, int slab) {
  return size_t(K) * slab + K + size_t(rows) * K;
}

// A lane holds the partial sums of this many centroids at once; past
// kChunkK centroids, its pieces of x are read again (from cache) for each
// further chunk unless they stay in registers.
constexpr int kChunkK = 8;

template <typename T, int VEC>
__global__ void router_kernel(const T* __restrict__ x,
                              const T* __restrict__ centroids,
                              T* __restrict__ out, int B, int D, int K,
                              int span, int slab, float temperature) {
  extern __shared__ __align__(16) float sm[];
  const int W = blockDim.x / 32, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32, gl = lane % span;
  const int r = warp * (32 / span) + lane / span;     // the block's row
  const int row = blockIdx.x * W * (32 / span) + r;
  const bool live = row < B;
  float* cs = sm;
  float* inv = cs + size_t(K) * slab;
  float* dots = inv + K + size_t(r) * K;
  const T* xr = x + size_t(row) * D;
  const int nslab = (D + slab - 1) / slab;
  // one piece a lane: load it now, before the staging barrier, and keep it
  const bool held = nslab == 1 && D <= span * VEC;
  // one slab and one chunk of centroids: the row's K sums end in every one
  // of its lanes' registers, and the softmax runs there
  const bool in_regs = nslab == 1 && K <= kChunkK;
  float acc[kChunkK];
  float xh[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) xh[e] = 0.f;
  float sq = 0.f;
  if (held && live && gl * VEC < D) sq = load_vec<T, VEC>(xr + gl * VEC, xh);
  for (int s = 0; s < nslab; ++s) {
    const int d0 = s * slab, n = min(slab, D - d0);
    const int np = (n + VEC - 1) / VEC;   // pieces (VEC divides D, and so n)
    if (s > 0) __syncthreads();           // the last slab's readers are done
    // each group of span lanes stages a centroid, the groups all at once;
    // every lane takes each round, so the shuffles see the whole warp
    for (int k0 = 0; k0 < K; k0 += blockDim.x / span) {
      const int k = k0 + threadIdx.x / span;
      float c2 = 0.f;
      for (int i = gl; i < np && k < K; i += span)
        c2 += load_vec<T, VEC>(centroids + size_t(k) * D + d0 + i * VEC,
                               cs + size_t(k) * slab + i * VEC);
      c2 = group_sum(c2, span);
      if (gl == 0 && k < K) {
        const float t = s > 0 ? inv[k] + c2 : c2;
        inv[k] = s + 1 < nslab ? t : rsqrtf(fmaxf(t, 1e-24f));
      }
    }
    __syncthreads();                      // the slab is staged
    // the K dot products over the slab, kChunkK centroids at a time: lane
    // gl takes the row's pieces gl, gl + span, ... (lanes past the pieces,
    // and the lanes of rows past B, hold zeros)
    for (int k0 = 0; k0 < K; k0 += kChunkK) {
      const int nk = min(kChunkK, K - k0);
#pragma unroll
      for (int a = 0; a < kChunkK; ++a) acc[a] = 0.f;
      for (int p = gl; p < np; p += span) {
        float xv[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) xv[e] = xh[e];
        if (!held && live) {
          const float q = load_vec<T, VEC>(xr + d0 + p * VEC, xv);
          if (k0 == 0) sq += q;
        }
#pragma unroll
        for (int kk = 0; kk < kChunkK; ++kk) {
          if (kk >= nk) break;
          float cv[VEC];
          read_piece<VEC>(cs + size_t(k0 + kk) * slab + p * VEC, cv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[kk] = fmaf(xv[e], cv[e], acc[kk]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kChunkK; ++kk) {
        if (kk >= nk) break;
        acc[kk] = group_sum(acc[kk], span);
      }
      if (live && gl == 0 && !in_regs)
        for (int kk = 0; kk < nk; ++kk)
          dots[k0 + kk] = (s > 0 ? dots[k0 + kk] : 0.f) + acc[kk];
    }
  }
  const float inv_x = rsqrtf(fmaxf(group_sum(sq, span), 1e-24f));
  if (in_regs) {
    float mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int k = 0; k < kChunkK; ++k) {
      if (k >= K) break;
      acc[k] = temperature * (acc[k] * inv_x * inv[k]);
      mx = fmaxf(mx, acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kChunkK; ++k) {
      if (k >= K) break;
      acc[k] = expf(acc[k] - mx);
      sum += acc[k];
    }
#pragma unroll
    for (int k = 0; k < kChunkK; ++k) {
      if (k >= K) break;
      if (live && k % span == gl)
        out[size_t(row) * K + k] = from_f32<T>(acc[k] / sum);
    }
    return;
  }
  __syncwarp();                           // the row's dot products
  auto logit = [&](int k) {
    return temperature * (dots[k] * inv_x * inv[k]);
  };
  // the softmax over K among the row's lanes: lane gl holds centroids gl,
  // gl + span, ... (the shuffles stay within a row's lanes; a row past B
  // computes on whatever its dot products hold and stores nothing)
  float mx = -INFINITY;
  for (int k = gl; k < K; k += span) mx = fmaxf(mx, logit(k));
  mx = group_max(mx, span);
  float sum = 0.f;
  for (int k = gl; k < K; k += span) sum += expf(logit(k) - mx);
  sum = group_sum(sum, span);
  for (int k = gl; k < K && live; k += span)
    out[size_t(row) * K + k] = from_f32<T>(expf(logit(k) - mx) / sum);
}

template <typename T, int VEC>
int launch(const void* x, const void* c, void* out, int B, int D, int K,
           int warps, int span, int slab, float temperature,
           cudaStream_t stream) {
  const int rows = warps * (32 / span);
  const size_t bytes = smem_floats(K, rows, slab) * sizeof(float);
  router_kernel<T, VEC><<<(B + rows - 1) / rows, 32 * warps, bytes,
                          stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<T*>(out), B, D, K, span, slab, temperature);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The launch plan (router_plan in
// router_scores.py): `warps` warps a block, `span` lanes a row (a power of
// two, at most 32), so warps x 32 / span rows a block and one group of
// rows a block; the centroids staged in slabs of `slab` columns; `vec`
// elements a load (1, or 16 bytes' worth: 4 float32, 8 bf16, with D a
// multiple and both operands 16-byte aligned). A plan this entry cannot
// run is refused, never replaced by another. Returns the cudaError_t of
// the launch.
extern "C" int router_scores(const void* x, const void* centroids, void* out,
                             int dtype, int B, int D, int K, int warps,
                             int span, int slab, int vec, float temperature,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int wide = dtype == 0 ? 4 : 8;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(centroids)) % 16 == 0;
  if (B < 1 || D < 1 || K < 1 || warps < 1 || warps > kMaxWarps ||
      span < 1 || span > 32 || (span & (span - 1)) != 0 || slab < 1 ||
      (dtype != 0 && dtype != 1) ||
      !(vec == 1 || (vec == wide && D % vec == 0 && aligned)) ||
      slab % vec != 0 ||
      smem_floats(K, warps * (32 / span), slab) * sizeof(float) > kMaxSmem)
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return vec == 1 ? launch<float, 1>(x, centroids, out, B, D, K, warps,
                                       span, slab, temperature, s)
                    : launch<float, 4>(x, centroids, out, B, D, K, warps,
                                       span, slab, temperature, s);
  return vec == 1 ? launch<__nv_bfloat16, 1>(x, centroids, out, B, D, K,
                                             warps, span, slab, temperature,
                                             s)
                  : launch<__nv_bfloat16, 8>(x, centroids, out, B, D, K,
                                             warps, span, slab, temperature,
                                             s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
