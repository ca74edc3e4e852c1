// Fused AdamW update for Hopper (sm_90a), bound through a plain C interface
// (ctypes; see kernels/build.py).
//
// Replaces no Pallas kernel: the reference's AdamW (src/repro/optim/
// adamw.py, apply_updates) is plain jnp, which XLA fuses into one pass
// under the jitted train step. The eager port ran it as about fifteen
// float32 passes over each leaf; this kernel is that loop body in one
// pass, in place, leaf by leaf (optim/adamw.py calls it once a leaf).
//
// Per element, in float32 and in the plain version's order (each step
// rounded as the eager passes round it):
//   g32 = f32(g) * scale
//   m   = b1 * m + (1 - b1) * g32
//   v   = b2 * v + (1 - b2) * g32^2
//   step = (m / b1c) / (sqrt(v / b2c) + eps) + wd * master
//   master -= lr * step;  p = round(master)
// With no master the parameter is float32 (or bf16, read as float32) and
// plays the master's part. lr, scale, b1c and b2c are 0-d float32 device
// tensors, read through pointers: no host readback, and the launch can be
// captured into a CUDA graph.
//
// What bounds it on the card: bytes. About 0.5 FLOP a byte, far below the
// ridge. A bf16 parameter with a float32 master moves 28 B a parameter
// (read the bf16 gradient and float32 m, v, master; write m, v, master and
// the bf16 parameter): 2.79 B parameters in 23.3 ms at 3.35 TB/s. The
// design:
// * 16-byte vector loads and stores, 8 elements a thread a step: one 16-B
//   load of a bf16 gradient, two each of m, v and the master, one 16-B
//   store of a bf16 parameter;
// * streaming cache hints (__ldcs / __stcs): each byte is touched once and
//   the leaves are far larger than the 50 MB L2;
// * a grid-stride loop over as many blocks as are resident on all SMs,
//   each thread with kUnroll vectors' loads in flight before it computes;
// * a scalar tail for the last n % 8 elements, and a scalar path for a
//   leaf whose pointers are not all 16-byte aligned.
// The instantiation follows the inputs: parameter bf16 or float32,
// gradient bf16 or float32, master present or absent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;       // elements a vector step
constexpr int kUnroll = 2;    // vector steps a thread loads before computing
constexpr int kMaxDevices = 64;

struct Coefs {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

struct Scalars {
  float lr, scale, b1c, b2c;
};

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
  return __float2bfloat16_rn(x);
}

// 8 elements at src (16-byte aligned) into float32, evict-first.
__device__ __forceinline__ void load8(const float* src, float (&d)[kVec]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(src));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(src) + 1);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&d)[kVec]) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    d[2 * i] = f.x;
    d[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&s)[kVec]) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(s[0], s[1], s[2], s[3]));
  __stcs(reinterpret_cast<float4*>(dst) + 1,
         make_float4(s[4], s[5], s[6], s[7]));
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&s)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(dst), raw);
}

// One element's update. Every product, quotient, root and sum is rounded
// where the eager passes round it (explicit _rn intrinsics, so the compiler
// neither contracts nor reorders): a multiply-add where ATen's pass is one
// (add with alpha, addcmul), a product and a sum where it is two.
__device__ __forceinline__ void update(float g, float& m, float& v, float& w,
                                       const Coefs& c, const Scalars& s) {
  const float g32 = __fmul_rn(g, s.scale);
  m = __fmaf_rn(c.one_minus_b1, g32, __fmul_rn(m, c.b1));
  v = __fmaf_rn(c.one_minus_b2, __fmul_rn(g32, g32), __fmul_rn(v, c.b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.b2c)), c.eps);
  float step = __fdiv_rn(__fdiv_rn(m, s.b1c), denom);
  step = __fmaf_rn(c.wd, w, step);
  w = __fsub_rn(w, __fmul_rn(step, s.lr));
}

// Elements [i0, n) one at a time, a grid stride apart.
template <typename P, typename G, bool MASTER>
__device__ __forceinline__ void scalar_span(
    P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
    float* __restrict__ v, float* __restrict__ master, long long i0,
    long long n, const Coefs& c, const Scalars& s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = i0 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float mi = m[i], vi = v[i], w;
    if constexpr (MASTER) w = master[i];
    else w = to_f32(p[i]);
    update(to_f32(g[i]), mi, vi, w, c, s);
    m[i] = mi;
    v[i] = vi;
    if constexpr (MASTER) master[i] = w;
    p[i] = from_f32<P>(w);
  }
}

template <typename P, typename G, bool MASTER, bool VEC>
__global__ void __launch_bounds__(kThreads) adamw_update_sm90(
    P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
    float* __restrict__ v, float* __restrict__ master,
    const float* __restrict__ lr, const float* __restrict__ scale,
    const float* __restrict__ b1c, const float* __restrict__ b2c,
    long long n, Coefs c) {
  const Scalars s{__ldg(lr), __ldg(scale), __ldg(b1c), __ldg(b2c)};
  if constexpr (!VEC) {
    scalar_span<P, G, MASTER>(p, g, m, v, master, 0, n, c, s);
    return;
  }
  const long long nvec = n / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j0 < nvec; j0 += stride * kUnroll) {
    float gv[kUnroll][kVec], mv[kUnroll][kVec], vv[kUnroll][kVec],
        wv[kUnroll][kVec];
    // every load of the kUnroll vectors first, then the arithmetic
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * stride;
      if (j >= nvec) continue;
      const long long e = j * kVec;
      load8(g + e, gv[u]);
      load8(m + e, mv[u]);
      load8(v + e, vv[u]);
      if constexpr (MASTER) load8(master + e, wv[u]);
      else load8(p + e, wv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = j0 + u * stride;
      if (j >= nvec) continue;
      const long long e = j * kVec;
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        update(gv[u][k], mv[u][k], vv[u][k], wv[u][k], c, s);
      store8(m + e, mv[u]);
      store8(v + e, vv[u]);
      if constexpr (MASTER) store8(master + e, wv[u]);
      store8(p + e, wv[u]);
    }
  }
  scalar_span<P, G, MASTER>(p, g, m, v, master, nvec * kVec, n, c, s);
}

// Blocks resident on every SM of the current device at once: the grid of
// the grid-stride loop (one wave, no tail wave), kept a device.
template <typename K>
int resident_blocks(K kernel) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
            cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <typename P, typename G, bool MASTER, bool VEC>
int launch(void* p, const void* g, void* m, void* v, void* master,
           const void* lr, const void* scale, const void* b1c,
           const void* b2c, long long n, const Coefs& c,
           cudaStream_t stream) {
  auto kernel = adamw_update_sm90<P, G, MASTER, VEC>;
  const int most = resident_blocks(kernel);
  if (most <= 0) return int(cudaErrorInvalidDevice);
  const long long work = VEC ? (n / kVec + kUnroll - 1) / kUnroll + n % kVec
                             : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = int(want < most ? want : most);
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<float*>(m),
      static_cast<float*>(v), static_cast<float*>(master),
      static_cast<const float*>(lr), static_cast<const float*>(scale),
      static_cast<const float*>(b1c), static_cast<const float*>(b2c), n, c);
  return int(cudaGetLastError());
}

template <typename P, typename G, bool MASTER>
int pick_vec(bool vec, void* p, const void* g, void* m, void* v,
             void* master, const void* lr, const void* scale,
             const void* b1c, const void* b2c, long long n, const Coefs& c,
             cudaStream_t s) {
  return vec ? launch<P, G, MASTER, true>(p, g, m, v, master, lr, scale, b1c,
                                          b2c, n, c, s)
             : launch<P, G, MASTER, false>(p, g, m, v, master, lr, scale,
                                           b1c, b2c, n, c, s);
}

template <typename P, typename G>
int pick_master(bool vec, void* p, const void* g, void* m, void* v,
                void* master, const void* lr, const void* scale,
                const void* b1c, const void* b2c, long long n,
                const Coefs& c, cudaStream_t s) {
  return master ? pick_vec<P, G, true>(vec, p, g, m, v, master, lr, scale,
                                       b1c, b2c, n, c, s)
                : pick_vec<P, G, false>(vec, p, g, m, v, master, lr, scale,
                                        b1c, b2c, n, c, s);
}

}  // namespace

// p: the parameter (p_dtype 0 = float32, 1 = bfloat16), updated in place;
// g: its gradient (g_dtype likewise); m, v: float32 moments, updated in
// place; master: the float32 master, updated in place, or NULL (the
// parameter is then its own master); lr, scale, b1c, b2c: 0-d float32
// device tensors. n elements each, contiguous. The vector path needs every
// pointer 16-byte aligned; otherwise the scalar path runs. Returns the
// cudaError_t of the launch.
extern "C" int adamw_update(void* p, const void* g, void* m, void* v,
                            void* master, const void* lr, const void* scale,
                            const void* b1c, const void* b2c, int p_dtype,
                            int g_dtype, long long n, float b1,
                            float one_minus_b1, float b2, float one_minus_b2,
                            float eps, float weight_decay, void* stream) {
  if (n < 1 || !p || !g || !m || !v || !lr || !scale || !b1c || !b2c ||
      (p_dtype != 0 && p_dtype != 1) || (g_dtype != 0 && g_dtype != 1))
    return int(cudaErrorInvalidValue);
  const bool vec = ((reinterpret_cast<uintptr_t>(p) |
                     reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(m) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(master)) % 16) == 0;
  const Coefs c{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay};
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (p_dtype == 0)
    return g_dtype == 0
               ? pick_master<float, float>(vec, p, g, m, v, master, lr, scale,
                                           b1c, b2c, n, c, s)
               : pick_master<float, bf16>(vec, p, g, m, v, master, lr, scale,
                                          b1c, b2c, n, c, s);
  return g_dtype == 0
             ? pick_master<bf16, float>(vec, p, g, m, v, master, lr, scale,
                                        b1c, b2c, n, c, s)
             : pick_master<bf16, bf16>(vec, p, g, m, v, master, lr, scale,
                                       b1c, b2c, n, c, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
