// Fused centroid-router kernel (paper Eq. 28) for Hopper (sm_90a), bound
// through a plain C interface (ctypes; see kernels/build.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/router_scores.py
// (router_scores :34, body _router_kernel :21): L2-normalize the features
// x (B, D) and the centroids (K, D) with rsqrt(max(sum of squares, 1e-24)),
// take the cosine similarities, then a temperature softmax over K.
//
// What bounds it on the card: nothing but launch latency at serving shapes
// (B = 1 at submission, D = tens to thousands, K = a handful); at large B
// it is bound by reading x once. One thread block per row of x: the block
// reduces |x|^2, then for each centroid the dot product and |c|^2 together
// (the centroid norms are recomputed per row — K * D is tiny next to the
// launch), and one thread finishes the K-way softmax. The Pallas version
// padded the ragged batch edge with rows of 1.0; here the grid is exactly
// B rows, so there is no edge to mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

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

// Sum of (a, b) over the thread block; every thread gets the totals.
__device__ inline float2 block_sum2(float a, float b, float2* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  float2 tot = make_float2(0.f, 0.f);
  for (int w = 0; w < int(blockDim.x / 32); ++w) {
    tot.x += scratch[w].x;
    tot.y += scratch[w].y;
  }
  __syncthreads();   // scratch is reused by the next reduction
  return tot;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
router_kernel(const T* __restrict__ x, const T* __restrict__ centroids,
              T* __restrict__ out, int D, int K, float temperature) {
  extern __shared__ float sims[];                 // K
  __shared__ float2 scratch[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  float sq = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = to_f32(xr[d]);
    sq = fmaf(v, v, sq);
  }
  const float inv_x = rsqrtf(fmaxf(block_sum2(sq, 0.f, scratch).x, 1e-24f));
  for (int k = 0; k < K; ++k) {
    const T* ck = centroids + size_t(k) * D;
    float dot = 0.f, cc = 0.f;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      const float c = to_f32(ck[d]);
      dot = fmaf(to_f32(xr[d]), c, dot);
      cc = fmaf(c, c, cc);
    }
    const float2 tot = block_sum2(dot, cc, scratch);
    if (threadIdx.x == 0)
      sims[k] = temperature * (tot.x * inv_x * rsqrtf(fmaxf(tot.y, 1e-24f)));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mx = sims[0];
    for (int k = 1; k < K; ++k) mx = fmaxf(mx, sims[k]);
    float sum = 0.f;
    for (int k = 0; k < K; ++k) {
      sims[k] = expf(sims[k] - mx);
      sum += sims[k];
    }
    for (int k = 0; k < K; ++k) out[row * K + k] = from_f32<T>(sims[k] / sum);
  }
}

template <typename T>
int launch(const void* x, const void* c, void* out, int B, int D, int K,
           float temperature, cudaStream_t stream) {
  router_kernel<T><<<B, kThreads, size_t(K) * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<T*>(out), D, K, temperature);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int router_scores(const void* x, const void* centroids, void* out,
                             int dtype, int B, int D, int K,
                             float temperature, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, centroids, out, B, D, K,
                                       temperature, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, centroids, out, B, D, K,
                                               temperature, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
