// Intra-chunk linear-attention kernel (chunkwise Mamba2-SSD / mLSTM) for
// Hopper (sm_90a), bound through a plain C interface (ctypes; see
// kernels/build.py).
//
// Replaces the Pallas TPU kernel chunk_scan of
// src/repro/kernels/chunk_scan.py (:50, body _chunk_kernel :24). For each
// (batch b, chunk c, head h) of qc, kc (B,NC,L,H,dk), vc (B,NC,L,H,dv) and
// the inclusive cumulative log-decay cum (B,NC,L,H) float32:
//
//   intra[t] = sum_{s<=t} exp(cum_t - cum_s) (q_t . k_s) v_s   (B,NC,L,H,dv)
//   chunk_kv = sum_s exp(cum_{L-1} - cum_s) k_s v_s^T          (B,NC,H,dk,dv)
//
// both written in float32. Inputs are float32 or bfloat16 and are upcast to
// float32 before every product, as the Pallas body and
// repro/kernels/ref.py chunk_scan_ref do. The carry between chunks stays
// in the caller (models/ssm.py chunked_linear_attention).
//
// What bounds it on the card: at Zamba2's chunked-prefill shape (B = NC =
// 1, L = 256, H = 32, dk = 64, dv = 160, bf16) the bytes (4.7 MB in, 6.6 MB
// out) take 3.4 us at 3.35 TB/s; the causal half of the products (0.64
// GFLOP, float32 arithmetic) takes 9.5 us at the 67 TFLOP/s float32 rate,
// so it is bound by operations.
//
// Design. The Pallas kernel holds a whole (L x dk), (L x dv) head in VMEM;
// at L = 256, dv = 160 that is 160 KB of float32 for V alone, which does
// not fit in a Hopper block's 227 KB beside Q, K and the output. So the
// work is split in two kernels behind one entry point:
//
// * intra: grid (B*NC*H, ceil(L/16)). A block owns 16 query rows of one
//   (b, c, h) and walks key tiles of 32 positions, staged as float32 in
//   shared memory, up to the tile that holds its last row (the causal half
//   only). Each score q_t . k_s is weighted by exp(cum_t - cum_s), formed
//   from the difference and only where s <= t: a masked pair takes weight
//   0 and never reaches the exp (cum falls by hundreds over a chunk, so
//   exp(cum_t) * exp(-cum_s) would overflow). The 16 x dv rows accumulate
//   in float32 shared memory.
// * kv: grid (B*NC*H, ceil(dk/16)). A block owns 16 rows of one head's
//   dk x dv summary and reduces over the L positions in tiles of 32, each
//   k row scaled by exp(cum_{L-1} - cum_s) as it is staged.
//
// Any L, dk and dv whose tiles fit in shared memory are taken (odd dv
// included; mLSTM's H = 4, dk = 384, dv = 385 needs 150 KB):
// chunk_scan_smem_bytes says how much a shape needs, and the launcher
// refuses a shape above 227 KB. Ragged last row and key tiles are masked.
// Known gap: scalar float32 FMAs out of shared memory, no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;    // query rows (intra) or dk rows (kv) per block
constexpr int kKeys = 32;    // key positions per staged tile
constexpr size_t kMaxSmem = 232448;   // 227 KB, a Hopper block's limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t intra_bytes(int dk, int dv) {
  return sizeof(float) * (size_t(kRows) * dk         // q rows
                          + size_t(kKeys) * (dk + 1)  // k tile, padded
                          + size_t(kKeys) * dv        // v tile
                          + size_t(kRows) * kKeys     // weighted scores
                          + size_t(kRows) * dv        // accumulator
                          + kRows + kKeys);           // cum of rows, keys
}

size_t kv_bytes(int dv) {
  return sizeof(float) * (size_t(kKeys) * kRows       // decayed k tile
                          + size_t(kKeys) * dv        // v tile
                          + size_t(kRows) * dv);      // accumulator
}

// Row t of head h in chunk bc = b * NC + c sits at ((bc * L + t) * H + h)
// times the row width in every (B,NC,L,H,...) operand.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_scan_intra_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ cum,
                        float* __restrict__ intra, int L, int H, int dk,
                        int dv) {
  extern __shared__ float smem[];
  const int h = blockIdx.x % H;
  const size_t bc = blockIdx.x / H;
  const int t0 = blockIdx.y * kRows;
  const int R = min(kRows, L - t0);
  float* sq = smem;
  float* sk = sq + size_t(kRows) * dk;
  float* sv = sk + size_t(kKeys) * (dk + 1);
  float* ss = sv + size_t(kKeys) * dv;
  float* acc = ss + kRows * kKeys;
  float* cr = acc + size_t(kRows) * dv;
  float* ck = cr + kRows;
  for (int i = threadIdx.x; i < R * dk; i += blockDim.x) {
    const int r = i / dk, d = i - r * dk;
    sq[i] = to_f32(q[((bc * L + t0 + r) * H + h) * dk + d]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    cr[r] = cum[(bc * L + t0 + r) * H + h];
  for (int i = threadIdx.x; i < R * dv; i += blockDim.x) acc[i] = 0.f;
  const int last = (t0 + R - 1) / kKeys;
  for (int kt = 0; kt <= last; ++kt) {
    const int s0 = kt * kKeys;
    const int n = min(kKeys, L - s0);
    __syncthreads();   // the previous tile is consumed; q, cr, acc are set
    for (int i = threadIdx.x; i < kKeys * dk; i += blockDim.x) {
      const int j = i / dk, d = i - j * dk;
      sk[j * (dk + 1) + d] =
          j < n ? to_f32(k[((bc * L + s0 + j) * H + h) * dk + d]) : 0.f;
    }
    for (int i = threadIdx.x; i < kKeys * dv; i += blockDim.x) {
      const int j = i / dv, e = i - j * dv;
      sv[i] = j < n ? to_f32(v[((bc * L + s0 + j) * H + h) * dv + e]) : 0.f;
    }
    for (int j = threadIdx.x; j < kKeys; j += blockDim.x)
      ck[j] = j < n ? cum[(bc * L + s0 + j) * H + h] : 0.f;
    __syncthreads();
    for (int i = threadIdx.x; i < R * kKeys; i += blockDim.x) {
      const int r = i / kKeys, j = i - r * kKeys;
      float w = 0.f;
      if (s0 + j <= t0 + r) {          // causal; implies j < n
        const float* qr = sq + size_t(r) * dk;
        const float* kj = sk + size_t(j) * (dk + 1);
        float dot = 0.f;
        for (int d = 0; d < dk; ++d) dot = fmaf(qr[d], kj[d], dot);
        w = dot * expf(cr[r] - ck[j]);
      }
      ss[i] = w;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * dv; i += blockDim.x) {
      const int r = i / dv, e = i - r * dv;
      const float* sr = ss + r * kKeys;
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(sr[j], sv[j * dv + e], o);
      acc[i] += o;
    }
  }
  // each thread writes back the accumulator elements it summed
  for (int i = threadIdx.x; i < R * dv; i += blockDim.x) {
    const int r = i / dv, e = i - r * dv;
    intra[((bc * L + t0 + r) * H + h) * dv + e] = acc[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_scan_kv_kernel(const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ cum, float* __restrict__ kv,
                     int L, int H, int dk, int dv) {
  extern __shared__ float smem[];
  const int h = blockIdx.x % H;
  const size_t bc = blockIdx.x / H;
  const int d0 = blockIdx.y * kRows;
  const int R = min(kRows, dk - d0);
  float* skd = smem;                          // [j * kRows + r]
  float* sv = skd + kKeys * kRows;            // [j * dv + e]
  float* acc = sv + size_t(kKeys) * dv;       // [r * dv + e]
  const float total = cum[(bc * L + L - 1) * H + h];
  for (int i = threadIdx.x; i < R * dv; i += blockDim.x) acc[i] = 0.f;
  for (int s0 = 0; s0 < L; s0 += kKeys) {
    const int n = min(kKeys, L - s0);
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < kKeys * kRows; i += blockDim.x) {
      const int j = i / kRows, r = i - j * kRows;
      float val = 0.f;
      if (j < n && r < R) {
        const size_t row = (bc * L + s0 + j) * H + h;
        val = to_f32(k[row * dk + d0 + r]) * expf(total - cum[row]);
      }
      skd[i] = val;
    }
    for (int i = threadIdx.x; i < kKeys * dv; i += blockDim.x) {
      const int j = i / dv, e = i - j * dv;
      sv[i] = j < n ? to_f32(v[((bc * L + s0 + j) * H + h) * dv + e]) : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * dv; i += blockDim.x) {
      const int r = i / dv, e = i - r * dv;
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(skd[j * kRows + r], sv[j * dv + e],
                                           o);
      acc[i] += o;
    }
  }
  for (int i = threadIdx.x; i < R * dv; i += blockDim.x) {
    const int r = i / dv, e = i - r * dv;
    kv[(size_t(blockIdx.x) * dk + d0 + r) * dv + e] = acc[i];
  }
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cum,
           void* intra, void* kv, int BNC, int L, int H, int dk, int dv,
           cudaStream_t stream) {
  const size_t bi = intra_bytes(dk, dv), bk = kv_bytes(dv);
  if (bi > kMaxSmem || bk > kMaxSmem) return int(cudaErrorInvalidValue);
  cudaError_t err = set_smem(chunk_scan_intra_kernel<T>, bi);
  if (err == cudaSuccess) err = set_smem(chunk_scan_kv_kernel<T>, bk);
  if (err != cudaSuccess) return int(err);
  const unsigned heads = unsigned(BNC) * unsigned(H);
  chunk_scan_intra_kernel<T>
      <<<dim3(heads, (L + kRows - 1) / kRows), kThreads, bi, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(cum),
          static_cast<float*>(intra), L, H, dk, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  chunk_scan_kv_kernel<T>
      <<<dim3(heads, (dk + kRows - 1) / kRows), kThreads, bk, stream>>>(
          static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const float*>(cum), static_cast<float*>(kv), L, H, dk,
          dv);
  return int(cudaGetLastError());
}

}  // namespace

// Shared memory the larger of the two kernels needs per block at (dk, dv).
extern "C" long long chunk_scan_smem_bytes(int dk, int dv) {
  const size_t bi = intra_bytes(dk, dv), bk = kv_bytes(dv);
  return static_cast<long long>(bi > bk ? bi : bk);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v; cum, intra and kv are always
// float32). BNC = B * NC. Returns the cudaError_t of the launches.
extern "C" int chunk_scan(const void* q, const void* k, const void* v,
                          const void* cum, void* intra, void* kv, int dtype,
                          int BNC, int L, int H, int dk, int dv,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, cum, intra, kv, BNC, L, H, dk, dv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, cum, intra, kv, BNC, L, H, dk, dv,
                                 s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
