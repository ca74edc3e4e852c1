// Intra-chunk linear-attention kernels (chunkwise Mamba2-SSD / mLSTM) for
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
// both written in float32, held to the float32 result of the Pallas body
// and of repro/kernels/ref.py chunk_scan_ref (inputs upcast before every
// product). The carry between chunks stays in the caller (models/ssm.py
// chunked_linear_attention).
//
// What bounds it on the card: at Zamba2's chunked-prefill shape (B = NC =
// 1, L = 256, H = 32, dk = 64, dv = 160, bf16) the bytes (4.7 MB in, 6.6 MB
// out) take 3.4 us at 3.35 TB/s; the causal half of the products (0.64
// GFLOP) takes 0.65 us at the bf16 tensor-core rate, 1.7 us with the
// second products run once for each of three bf16 parts (below). At
// mLSTM's (xLSTM-125M: L = 256, H = 4, dk = 384, dv = 385 with the ones
// channel) the bytes (2.4 MB in, 3.9 MB out) take 1.9 us; the products
// (0.51 GFLOP; 1.3 GFLOP with three parts of the second products) 1.3 us.
// So on the tensor cores it is bound by bytes, most of them the float32
// outputs. On the float32 FMA units the same products take 9.5 us
// (Zamba2) and 7.5 us (mLSTM): the scalar design is bound by operations.
//
// Three designs behind two entry points. The wrapper picks the route from
// dtype and widths alone, before the launch (kernels/chunk_scan.py,
// tensor_core_route), and chunk_scan_sm90 picks its kernel from the
// widths; none ever stands in for another after a failure.
//
// * tc::chunk_scan_sm90 -- bf16 with dk and dv multiples of 8 (the tensor
//   maps' row strides are whole 16 bytes) and dk up to 128: the tensor
//   cores, one launch a call. Every full-width Mamba2 shape of the repo
//   (Zamba2's dk = 64, dv = 160) and the smoke config's L = 16 take it.
//   Grid (B*NC*H, summary tiles + row tiles, dv slices), 256 threads: a
//   consumer warpgroup, and a producer warpgroup that gives its registers
//   away (setmaxnreg), two blocks an SM. At Zamba2's shape that is 32
//   heads x (1 summary + 4 row tiles of 64) = 160 blocks, all resident on
//   132 SMs; summary blocks and the row tiles with the most key tiles run
//   first.
//   - intra, one 64-row query tile a block. TMA stages the Q tile once
//     (4-D maps (d, H, L, B*NC), flash_sm90.cuh) and a producer warp keeps
//     a 2-stage ring of 64-key K and V tiles, each key's cum beside them
//     (plain loads: a column of cum is 4 bytes wide, too narrow for a TMA
//     box), over the key tiles up to the diagonal only. S = Q.K^T is
//     wgmma_ss (bf16 products are exact in the float32 accumulator). The
//     weight is applied on the accumulator fragment in registers: P[t,s] =
//     S[t,s] exp(cum_t - cum_s) where s <= t < L, else 0 -- a masked pair
//     never reaches the exp (cum falls by hundreds over a chunk, so
//     exp(cum_t) exp(-cum_s), or an unmasked difference, would overflow).
//     O += P.V is wgmma_rs, P from registers, V MN-major.
//   - chunk_kv, one 64-row tile of dk a block (M = dk, K = L, N = dv). The
//     A operand (w K)^T, w_s = exp(cum_{L-1} - cum_s), is built in
//     registers: each thread reads the 16 keys x 2 rows of K its A
//     fragments hold through the 128-byte swizzle of the K tile, scales
//     them in float32 and splits them, and the product with V MN-major is
//     the intra half's P.V. The other way (K^T MN-major from shared memory,
//     w folded into V) would write a split, swizzled copy of each V tile
//     back to shared memory for every part.
//   - Precision. P and w K are float32, and one bf16 rounding keeps 8 bits
//     (about 4e-3 relative), far past the 5e-5 the card's checks hold the
//     scan to in both dtypes. So each is split into kParts bf16 parts,
//     part p = bf16(x - parts 0 .. p-1) (each remainder exact in float32),
//     and the product runs once a part: two parts carry about 16 bits,
//     three all 24. kParts is a template constant, 2 or 3: the wrapper's
//     SCAN_PARTS (PERF.md states the errors measured with each).
//   - dv past 192 columns is cut into column slices (grid z), at most three
//     64-column slabs a block (a 64 x 192 float32 O is 96 registers a
//     thread); each slice recomputes S. Edges need no masking code: rows,
//     keys and columns past L, dk and dv read zeros from TMA (L < 64, ragged
//     L, d past a slab, dk != dv), B > 1 and NC > 1 are the maps' fourth
//     dimension, and rows past L and columns past dv are not written.
// * wide::chunk_scan_wide_sm90 -- bf16 with dk a multiple of 8 up to 1408
//   and any dv: mLSTM's dk = 384, dv = 385, and every odd dv. The same
//   products, weights, parts and precision as above; what differs:
//   - Q and K keep TMA (rows of 2 dk bytes, multiples of 16), but dk = 384
//     is six 64-column slabs, and a 2-stage ring of whole K tiles beside Q
//     (48 KB a tile) would leave one block an SM. So K streams through a
//     4-stage ring one slab at a time: S accumulates over the slabs, one
//     wgmma group (4 k-steps) a slab, and a stage goes back to the
//     producer when the group after it is issued and its own has
//     completed. A summary block loads only the one slab of K it reduces.
//   - V cannot be staged by TMA, nor by cp.async: at dv = 385 a (position,
//     head) row starts at byte 770 (l H + h), on a 2-byte boundary on
//     every odd row, and the position stride (3080 bytes) is no multiple
//     of 16. Three producer warps load it through registers, a lane a
//     column pair of a key row (coalesced bf16 loads), and store it as one
//     word into the 128-byte swizzle of a 2-stage V ring, keys past L and
//     columns past dv as zeros; then fence.proxy.async, so that wgmma
//     reads what they wrote. The same warps stage each key tile's cum.
//   - One 64-column slab of dv a block: dv = 385 is seven slabs of equal
//     width (448 columns), where slices of up to three slabs would be
//     192 + 192 + 1. Outputs are plain float stores: intra rows of 1540
//     bytes and chunk_kv rows of dv floats are not 8-byte aligned.
//   - Shared memory: Q 6 x 8 KB + K ring 4 x 8 KB + V ring 2 x 8 KB + cum
//     0.75 KB + barriers = 97.9 KB at dk = 384 (8 KB x (slabs + 6) + 1.9
//     KB in general), so two blocks an SM up to dk = 448 and one beyond;
//     dk = 1408 (22 slabs) is the most that fits 227 KB. At mLSTM's
//     chunked-prefill shape the grid is 4 heads x (6 summary + 4 row
//     tiles) x 7 slabs = 280 blocks against 264 resident: about one wave.
// * chunk_scan -- float32, and bf16 dk that is no multiple of 8 or is past
//   1408: the first, scalar design, two kernels behind one entry point.
//   Tensor cores take no float32, and TF32 keeps about three digits, which
//   would break the float32 tolerance.
//   - intra: grid (B*NC*H, ceil(L/16)). A block owns 16 query rows of one
//     (b, c, h) and walks key tiles of 32 positions, staged as float32 in
//     shared memory, up to the tile that holds its last row; the weight is
//     masked before the exp as above. The 16 x dv rows accumulate in
//     float32 shared memory.
//   - kv: grid (B*NC*H, ceil(dk/16)). A block owns 16 rows of one head's
//     dk x dv summary and reduces over the L positions in tiles of 32, each
//     k row scaled by exp(cum_{L-1} - cum_s) as it is staged.
//   Any L, dk and dv whose tiles fit in shared memory are taken (mLSTM's
//   H = 4, dk = 384, dv = 385 needs 150 KB): chunk_scan_smem_bytes says how
//   much a shape needs, and the wrapper refuses a shape above 227 KB.
//   Scalar float32 FMAs out of shared memory, no tensor cores.
//
// Build: one nvcc, no extra include path, about 14 s on the H100 machine's
// host for twelve instantiations of tc::chunk_scan_sm90 (1-2 slabs of dk x
// 1-3 of dv x 2 or 3 parts; each at 128 registers a thread, no spills) and
// two of wide::chunk_scan_wide_sm90 (2 or 3 parts).
// <cuda.h> is read for the CUtensorMap type only; cuTensorMapEncodeTiled
// is looked up in the libcuda that the CUDA runtime has loaded, so nothing
// links it.

#include "flash_sm90.cuh"

#include <cstddef>

namespace {

// ---------------------------------------------------------------- scalar

namespace scalar {


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

}  // namespace scalar

// ---------------------------------------------------------------- bf16

namespace tc {

using namespace sm90;

constexpr int kStages = 2;         // K/V ring depth
constexpr int kTcThreads = 256;    // consumer warpgroup + producer warpgroup
constexpr int kMaxDk = 128;        // Q and K tiles of at most two slabs
constexpr int kMaxSlabsV = 3;      // dv columns a block: 3 x 64

// Shared memory, from a 1024-byte boundary: Q (NSK slabs of 64 rows), then
// kStages K tiles (NSK slabs) and kStages V tiles (NSV slabs), then cum of
// the Q tile's rows and of each stage's keys, then the barriers.
template <int NSK, int NSV>
struct Smem {
  static constexpr int kKTile = NSK * kSlabBytes;
  static constexpr int kVTile = NSV * kSlabBytes;
  static constexpr int kK = NSK * kSlabBytes;
  static constexpr int kV = kK + kStages * kKTile;
  static constexpr int kCum = kV + kStages * kVTile;
  static constexpr int kBar = kCum + 4 * kTile * (1 + kStages);
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// x0, x1 (two A-fragment elements) as kParts bf16 pairs whose sum is x:
// part p is bf16 of what parts 0 .. p - 1 leave (each remainder is exact
// in float32).
template <int kParts>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&a)[kParts][4][4],
                                           int kk, int e) {
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    a[p][kk][e] = *reinterpret_cast<uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    x0 -= f.x;
    x1 -= f.y;
  }
}

// O += A.V over one 64-key tile: A as kParts bf16 fragments of its four
// k-steps, V MN-major (NSV slabs of 64 columns), one wgmma a part.
template <int NSV, int kParts>
__device__ __forceinline__ void issue_av(float (&o)[NSV][32],
                                         uint32_t (&a)[kParts][4][4],
                                         const uint8_t* vt) {
#pragma unroll
  for (int p = 0; p < kParts; ++p) fence_regs(a[p]);
  fence_regs(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int s = 0; s < NSV; ++s) {
      const uint64_t vd = desc_mn(vt + s * kSlabBytes + kk * 2048);
#pragma unroll
      for (int p = 0; p < kParts; ++p) wgmma_rs<1>(o[s], a[p][kk], vd);
    }
  wg_commit();
  wg_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int p = 0; p < kParts; ++p) fence_regs(a[p]);
}

// The A fragments of (w K)^T over one 64-key tile, w_j = exp(total - cum_j)
// (cum of the tile's keys at ck), split into kParts bf16 parts: register e
// of k-step kk holds rows r0 + 8 (e & 1), keys 16 kk + 8 (e >> 1) + 2 quad +
// {0, 1}, read through the 128-byte swizzle of the K slab at ks; keys past
// L are zeros.
template <int kParts>
__device__ __forceinline__ void decayed_k_frags(
    const uint8_t* ks, const float* ck, float total, int key0, int L,
    int r0, int quad, uint32_t (&a)[kParts][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = r0 + 8 * (e & 1);
      float x[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int j = 16 * kk + 8 * (e >> 1) + 2 * quad + b;
        const __nv_bfloat16 kj = *reinterpret_cast<const __nv_bfloat16*>(
            ks + j * 128 + ((((d >> 3) ^ (j & 7)) << 4) | ((d & 7) * 2)));
        x[b] = key0 + j < L ? __bfloat162float(kj) * expf(total - ck[j])
                            : 0.f;
      }
      split_pair(x[0], x[1], a, kk, e);
    }
}

// P[t, s] = S[t, s] exp(cum_t - cum_s) where s <= t < L, else 0, on a
// 64 x 64 score fragment (keys key0.., their cum at ck; the thread's rows
// row[] with cum cr[]), split into the kParts A fragments of P.V. A masked
// pair never reaches the exp.
template <int kParts>
__device__ __forceinline__ void weighted_p_frags(
    float (&sc)[32], const float* ck, const int (&row)[2],
    const float (&cr)[2], int key0, int L, int quad,
    uint32_t (&a)[kParts][4][4]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int hh = (e >> 1) & 1;
    const int j = 8 * (e >> 2) + 2 * quad + (e & 1);
    sc[e] = key0 + j <= row[hh] && row[hh] < L
                ? sc[e] * expf(cr[hh] - ck[j])
                : 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_pair(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], a, kk, e);
}

// grid (B*NC*H, kv_tiles + row tiles, dv slices), kTcThreads threads:
// warpgroup 0 consumes, warp 0 of warpgroup 1 loads. blockIdx.y below
// kv_tiles: the summary's dk rows 64 y .. 64 y + 63; above: a row tile,
// the last ones (most key tiles) first.
template <int NSK, int NSV, int kParts>
__global__ void __launch_bounds__(kTcThreads, 2)
chunk_scan_sm90(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const float* __restrict__ cum, float* __restrict__ intra,
                float* __restrict__ kv, int L, int H, int dk, int dv,
                int kv_tiles) {
  using S = Smem<NSK, NSV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  float* cum_rows = reinterpret_cast<float*>(sm + S::kCum);
  float* cum_keys = cum_rows + kTile;                    // [kStages][kTile]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int row_tiles = gridDim.y - kv_tiles;
  const bool summary = int(blockIdx.y) < kv_tiles;
  const int t0 = summary ? 0 : (gridDim.y - 1 - blockIdx.y) * kTile;
  const int n_kt = summary ? row_tiles : t0 / kTile + 1;
  const int col0 = blockIdx.z * NSV * kSlab;   // the block's first dv column
  const float* cum_h = cum + size_t(bc) * L * H + h;   // position t at t H
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    bar_init(q_full, 32);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);
      bar_init(&empty[s], 128);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (wg == 1) {                                         // producer warp
    reg_dealloc<40>();
    if (threadIdx.x >= 128 + 32) return;
    const int lane = threadIdx.x % 32;
    if (!summary) {
      for (int r = lane; r < kTile; r += 32)
        cum_rows[r] = t0 + r < L ? cum_h[size_t(t0 + r) * H] : 0.f;
      if (lane == 0) {
        bar_expect_tx(q_full, NSK * kSlabBytes);
        for (int s = 0; s < NSK; ++s)
          tma_load(sm + s * kSlabBytes, &mq, q_full, s * kSlab, h, t0, bc);
      } else {
        bar_arrive(q_full);
      }
    }
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % kStages, key0 = i * kTile;
      bar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      float* ck = cum_keys + st * kTile;
      for (int j = lane; j < kTile; j += 32)
        ck[j] = key0 + j < L ? cum_h[size_t(key0 + j) * H] : 0.f;
      if (lane == 0) {
        bar_expect_tx(&full[st], S::kKTile + S::kVTile);
        for (int s = 0; s < NSK; ++s)
          tma_load(sm + S::kK + st * S::kKTile + s * kSlabBytes, &mk,
                   &full[st], s * kSlab, h, key0, bc);
        for (int s = 0; s < NSV; ++s)
          tma_load(sm + S::kV + st * S::kVTile + s * kSlabBytes, &mv,
                   &full[st], col0 + s * kSlab, h, key0, bc);
      } else {
        bar_arrive(&full[st]);
      }
    }
    return;
  }

  reg_alloc<216>();                                      // consumers
  const int t = threadIdx.x, lane = t % 32, quad = lane % 4;
  const int r0 = (t / 32) * 16 + lane / 4;   // rows r0 and r0 + 8
  float o[NSV][32];
#pragma unroll
  for (int s = 0; s < NSV; ++s)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[s][e] = 0.f;
  uint32_t a[kParts][4][4];

  if (summary) {
    // A[d, j] = w_j K[j, 64 y + d] over the keys j of each tile, from slab
    // y of K
    const float total = cum_h[size_t(L - 1) * H];
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % kStages, key0 = i * kTile;
      bar_wait(&full[st], (i / kStages) & 1);
      decayed_k_frags(
          sm + S::kK + st * S::kKTile + blockIdx.y * kSlabBytes,
          cum_keys + st * kTile, total, key0, L, r0, quad, a);
      issue_av(o, a, sm + S::kV + st * S::kVTile);
      bar_arrive(&empty[st]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = blockIdx.y * kTile + r0 + 8 * hh;
      if (d >= dk) continue;
      float* dst = kv + ((size_t(bc) * H + h) * dk + d) * dv;
#pragma unroll
      for (int s = 0; s < NSV; ++s)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + s * kSlab + 8 * j + 2 * quad;
          if (col < dv)
            *reinterpret_cast<float2*>(dst + col) =
                make_float2(o[s][4 * j + 2 * hh], o[s][4 * j + 2 * hh + 1]);
        }
    }
    return;
  }

  bar_wait(q_full, 0);
  const int row[2] = {t0 + r0, t0 + r0 + 8};
  const float cr[2] = {cum_rows[r0], cum_rows[r0 + 8]};
  const int ksteps = (dk + 15) / 16;
  for (int i = 0; i < n_kt; ++i) {
    const int st = i % kStages, key0 = i * kTile;
    bar_wait(&full[st], (i / kStages) & 1);
    const uint8_t* kt = sm + S::kK + st * S::kKTile;
    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NSK; ++kk) {
      if (kk >= ksteps) break;
      const int off = (kk >> 2) * kSlabBytes + (kk & 3) * 32;
      wgmma_ss(sc, desc_k(sm + off), desc_k(kt + off), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    weighted_p_frags(sc, cum_keys + st * kTile, row, cr, key0, L, quad, a);
    issue_av(o, a, sm + S::kV + st * S::kVTile);
    bar_arrive(&empty[st]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row[hh] >= L) continue;
    float* dst = intra + ((size_t(bc) * L + row[hh]) * H + h) * dv;
#pragma unroll
    for (int s = 0; s < NSV; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + s * kSlab + 8 * j + 2 * quad;
        if (col < dv)
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[s][4 * j + 2 * hh], o[s][4 * j + 2 * hh + 1]);
      }
  }
}

template <int NSK, int NSV, int kParts>
int launch(const void* q, const void* k, const void* v, const void* cum,
           void* intra, void* kv, int BNC, int L, int H, int dk, int dv,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, BNC, L, H, dk, 1, kTile);
  if (!err) err = make_map(&mk, k, BNC, L, H, dk, 1, kTile);
  if (!err) err = make_map(&mv, v, BNC, L, H, dv, 1, kTile);
  if (err) return err;
  const size_t bytes = Smem<NSK, NSV>::kBytes;
  cudaError_t e = allow_smem(chunk_scan_sm90<NSK, NSV, kParts>, bytes);
  if (e != cudaSuccess) return int(e);
  const int row_tiles = (L + kTile - 1) / kTile;
  const int slices = (dv + NSV * kSlab - 1) / (NSV * kSlab);
  chunk_scan_sm90<NSK, NSV, kParts>
      <<<dim3(unsigned(BNC) * unsigned(H), NSK + row_tiles, slices),
         kTcThreads, bytes, stream>>>(
          mq, mk, mv, static_cast<const float*>(cum),
          static_cast<float*>(intra), static_cast<float*>(kv), L, H, dk, dv,
          NSK);
  return int(cudaGetLastError());
}

template <int NSK, int NSV>
int by_parts(int parts, const void* q, const void* k, const void* v,
             const void* cum, void* intra, void* kv, int BNC, int L, int H,
             int dk, int dv, cudaStream_t s) {
  if (parts == 2)
    return launch<NSK, NSV, 2>(q, k, v, cum, intra, kv, BNC, L, H, dk, dv,
                               s);
  return launch<NSK, NSV, 3>(q, k, v, cum, intra, kv, BNC, L, H, dk, dv, s);
}

template <int NSK>
int by_slabs(int nsv, int parts, const void* q, const void* k,
             const void* v, const void* cum, void* intra, void* kv, int BNC,
             int L, int H, int dk, int dv, cudaStream_t s) {
  if (nsv == 1)
    return by_parts<NSK, 1>(parts, q, k, v, cum, intra, kv, BNC, L, H, dk,
                            dv, s);
  if (nsv == 2)
    return by_parts<NSK, 2>(parts, q, k, v, cum, intra, kv, BNC, L, H, dk,
                            dv, s);
  return by_parts<NSK, 3>(parts, q, k, v, cum, intra, kv, BNC, L, H, dk, dv,
                          s);
}

}  // namespace tc

// ------------------------------------------------------- bf16, wide rows

namespace wide {

using namespace sm90;

constexpr int kThreads = 256;    // consumer warpgroup + producer warpgroup
constexpr int kKStages = 4;      // K ring: one 64-key x 64-column slab each
constexpr int kVStages = 2;      // V ring: one 64-key x 64-column slab each
constexpr int kLoaders = 96;     // producer warps 1-3 stage V and cum
constexpr size_t kMaxSmem = 232448;

// Shared memory from a 1024-byte boundary: the Q tile (nsk slabs), the K
// ring, the V ring, cum of the Q tile's rows and of each V stage's keys,
// then the barriers (q_full, k_full, k_empty, v_full, v_empty).
struct Smem {
  int k, v, cum, bar, bytes;
  __host__ __device__ explicit Smem(int nsk)
      : k(nsk * kSlabBytes),
        v(k + kKStages * kSlabBytes),
        cum(v + kVStages * kSlabBytes),
        bar(cum + 4 * kTile * (1 + kVStages)),
        bytes(bar + 8 * (1 + 2 * kKStages + 2 * kVStages) + 1024) {}
};

// grid (B*NC*H, nsk + row tiles, ceil(dv / 64)), kThreads threads:
// warpgroup 0 consumes; lane 0 of warp 4 loads Q and K by TMA, warps 5-7
// load V and cum through registers. blockIdx.y below nsk: the summary's dk
// rows 64 y .. 64 y + 63; above: a row tile, the last ones first.
// blockIdx.z: the block's 64 dv columns.
template <int kParts>
__global__ void __launch_bounds__(kThreads, 2)
chunk_scan_wide_sm90(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const uint16_t* __restrict__ v,
                     const float* __restrict__ cum,
                     float* __restrict__ intra, float* __restrict__ kv,
                     int L, int H, int dk, int dv, int nsk) {
  const Smem S(nsk);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  float* cum_rows = reinterpret_cast<float*>(sm + S.cum);
  float* cum_keys = cum_rows + kTile;                   // [kVStages][kTile]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S.bar);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kKStages;
  uint64_t* v_full = k_empty + kKStages;
  uint64_t* v_empty = v_full + kVStages;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int row_tiles = gridDim.y - nsk;
  const bool summary = int(blockIdx.y) < nsk;
  const int t0 = summary ? 0 : (gridDim.y - 1 - blockIdx.y) * kTile;
  const int n_kt = summary ? row_tiles : t0 / kTile + 1;
  const int k_units = summary ? 1 : nsk;      // K slabs a key tile
  const int col0 = blockIdx.z * kSlab;
  const float* cum_h = cum + size_t(bc) * L * H + h;   // position t at t H
  if (threadIdx.x == 0) {
    bar_init(q_full, 32);
    for (int s = 0; s < kKStages; ++s) {
      bar_init(&k_full[s], 1);
      bar_init(&k_empty[s], 128);
    }
    for (int s = 0; s < kVStages; ++s) {
      bar_init(&v_full[s], kLoaders);
      bar_init(&v_empty[s], 128);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {                              // producers
    reg_dealloc<56>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 160) {                             // Q and K: TMA
      if (!summary) {
        for (int r = lane; r < kTile; r += 32)
          cum_rows[r] = t0 + r < L ? cum_h[size_t(t0 + r) * H] : 0.f;
        if (lane == 0) {
          bar_expect_tx(q_full, nsk * kSlabBytes);
          for (int s = 0; s < nsk; ++s)
            tma_load(sm + s * kSlabBytes, &mq, q_full, s * kSlab, h, t0, bc);
        } else {
          bar_arrive(q_full);
        }
      }
      if (lane != 0) return;
      int u = 0;
      for (int i = 0; i < n_kt; ++i)
        for (int s = 0; s < k_units; ++s, ++u) {
          const int st = u % kKStages;
          bar_wait(&k_empty[st], ((u / kKStages) & 1) ^ 1);
          bar_expect_tx(&k_full[st], kSlabBytes);
          tma_load(sm + S.k + st * kSlabBytes, &mk, &k_full[st],
                   (summary ? int(blockIdx.y) : s) * kSlab, h, i * kTile, bc);
        }
      return;
    }
    // V rows start on any 2-byte boundary (dv = 385: 770-byte rows), so
    // neither TMA nor cp.async can stage them: each lane loads a column
    // pair of a key row as two bf16 and stores it as one word into the
    // 128-byte swizzle (chunk c of row r at chunk c ^ (r % 8)). Keys past
    // L and columns past dv are zeros.
    const int p = threadIdx.x - 160, w = p / 32;
    const int c = 2 * lane;
    const bool c0_in = col0 + c < dv, c1_in = col0 + c + 1 < dv;
    const uint32_t swz = ((c >> 3) << 4) | ((c & 7) * 2);
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % kVStages, key0 = i * kTile;
      bar_wait(&v_empty[st], ((i / kVStages) & 1) ^ 1);
      for (int j = p; j < kTile; j += kLoaders)
        cum_keys[st * kTile + j] =
            key0 + j < L ? cum_h[size_t(key0 + j) * H] : 0.f;
      uint8_t* vt = sm + S.v + st * kSlabBytes;
#pragma unroll 4
      for (int r = w; r < kTile; r += kLoaders / 32) {
        uint32_t lo = 0, hi = 0;
        if (key0 + r < L) {
          const uint16_t* src =
              v + ((size_t(bc) * L + key0 + r) * H + h) * dv + col0 + c;
          if (c0_in) lo = src[0];
          if (c1_in) hi = src[1];
        }
        *reinterpret_cast<uint32_t*>(vt + r * 128 + (swz ^ ((r & 7) << 4))) =
            lo | (hi << 16);
      }
      fence_async_smem();      // the V tile is read by wgmma (async proxy)
      bar_arrive(&v_full[st]);
    }
    return;
  }

  reg_alloc<200>();                                      // consumers
  const int t = threadIdx.x, lane = t % 32, quad = lane % 4;
  const int r0 = (t / 32) * 16 + lane / 4;   // rows r0 and r0 + 8
  float o[1][32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[0][e] = 0.f;
  uint32_t a[kParts][4][4];

  if (summary) {
    // A[d, j] = w_j K[j, 64 y + d], from the one K slab (slab y) each key
    // tile brings
    const float total = cum_h[size_t(L - 1) * H];
    for (int i = 0; i < n_kt; ++i) {
      const int ks_st = i % kKStages, vs = i % kVStages, key0 = i * kTile;
      bar_wait(&k_full[ks_st], (i / kKStages) & 1);
      bar_wait(&v_full[vs], (i / kVStages) & 1);
      tc::decayed_k_frags(sm + S.k + ks_st * kSlabBytes,
                          cum_keys + vs * kTile, total, key0, L, r0, quad, a);
      bar_arrive(&k_empty[ks_st]);
      tc::issue_av(o, a, sm + S.v + vs * kSlabBytes);
      bar_arrive(&v_empty[vs]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = blockIdx.y * kTile + r0 + 8 * hh;
      if (d >= dk) continue;
      float* dst = kv + ((size_t(bc) * H + h) * dk + d) * dv;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int col = col0 + 8 * j + 2 * quad + b;
          if (col < dv) dst[col] = o[0][4 * j + 2 * hh + b];
        }
    }
    return;
  }

  bar_wait(q_full, 0);
  const int row[2] = {t0 + r0, t0 + r0 + 8};
  const float cr[2] = {cum_rows[r0], cum_rows[r0 + 8]};
  int u = 0;
  for (int i = 0; i < n_kt; ++i) {
    const int vs = i % kVStages, key0 = i * kTile;
    // S = Q.K^T over the dk slabs, one K slab a ring stage; a stage is
    // given back once the wgmma group that reads it has completed
    float sc[32];
    for (int s = 0; s < nsk; ++s, ++u) {
      const int st = u % kKStages;
      bar_wait(&k_full[st], (u / kKStages) & 1);
      const uint8_t* qs = sm + s * kSlabBytes;
      const uint8_t* ks = sm + S.k + st * kSlabBytes;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(sc, desc_k(qs + kk * 32), desc_k(ks + kk * 32),
                 s > 0 || kk > 0);
      wg_commit();
      if (s > 0) {
        wg_wait<1>();
        bar_arrive(&k_empty[(u - 1) % kKStages]);
      }
    }
    wg_wait<0>();
    fence_regs(sc);
    bar_arrive(&k_empty[(u - 1) % kKStages]);
    bar_wait(&v_full[vs], (i / kVStages) & 1);
    tc::weighted_p_frags(sc, cum_keys + vs * kTile, row, cr, key0, L, quad,
                         a);
    tc::issue_av(o, a, sm + S.v + vs * kSlabBytes);
    bar_arrive(&v_empty[vs]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row[hh] >= L) continue;
    float* dst = intra + ((size_t(bc) * L + row[hh]) * H + h) * dv;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int col = col0 + 8 * j + 2 * quad + b;
        if (col < dv) dst[col] = o[0][4 * j + 2 * hh + b];
      }
  }
}

template <int kParts>
int launch(const void* q, const void* k, const void* v, const void* cum,
           void* intra, void* kv, int BNC, int L, int H, int dk, int dv,
           cudaStream_t stream) {
  const int nsk = (dk + kSlab - 1) / kSlab;
  const size_t bytes = Smem(nsk).bytes;
  if (bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  CUtensorMap mq, mk;
  int err = make_map(&mq, q, BNC, L, H, dk, 1, kTile);
  if (!err) err = make_map(&mk, k, BNC, L, H, dk, 1, kTile);
  if (err) return err;
  cudaError_t e = allow_smem(chunk_scan_wide_sm90<kParts>, bytes);
  if (e != cudaSuccess) return int(e);
  const int row_tiles = (L + kTile - 1) / kTile;
  const int slabs = (dv + kSlab - 1) / kSlab;
  chunk_scan_wide_sm90<kParts>
      <<<dim3(unsigned(BNC) * unsigned(H), nsk + row_tiles, slabs), kThreads,
         bytes, stream>>>(mq, mk, static_cast<const uint16_t*>(v),
                          static_cast<const float*>(cum),
                          static_cast<float*>(intra), static_cast<float*>(kv),
                          L, H, dk, dv, nsk);
  return int(cudaGetLastError());
}

}  // namespace wide

}  // namespace

// Shared memory the larger of the two scalar kernels needs per block at
// (dk, dv).
extern "C" long long chunk_scan_smem_bytes(int dk, int dv) {
  const size_t bi = scalar::intra_bytes(dk, dv), bk = scalar::kv_bytes(dv);
  return static_cast<long long>(bi > bk ? bi : bk);
}

// The scalar kernels. dtype: 0 = float32, 1 = bfloat16 (q, k, v; cum,
// intra and kv are always float32). BNC = B * NC. Returns the cudaError_t
// of the launches.
extern "C" int chunk_scan(const void* q, const void* k, const void* v,
                          const void* cum, void* intra, void* kv, int dtype,
                          int BNC, int L, int H, int dk, int dv,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return scalar::launch<float>(q, k, v, cum, intra, kv, BNC, L, H, dk, dv,
                                 s);
  if (dtype == 1)
    return scalar::launch<__nv_bfloat16>(q, k, v, cum, intra, kv, BNC, L, H,
                                         dk, dv, s);
  return int(cudaErrorInvalidValue);
}

// Shared memory chunk_scan_wide_sm90 needs per block at dk.
extern "C" long long chunk_scan_wide_smem_bytes(int dk) {
  return wide::Smem((dk + sm90::kSlab - 1) / sm90::kSlab).bytes;
}

// bf16 on the tensor cores: dk a multiple of 8 whose Q tile and rings fit
// in shared memory (chunk_scan_wide_smem_bytes), any dv >= 1, parts 2 or
// 3, q and k on 16-byte boundaries, and v too where it goes by TMA (the
// wrapper checks). dk <= 128 with dv a multiple of 8 takes tc::
// chunk_scan_sm90, whose dv is cut into as few column slices of at most
// three slabs as there can be, of near-equal width; every other width
// wide::chunk_scan_wide_sm90, one 64-column slab a block. Returns the
// cudaError_t of the launch, or sm90::kEncodeError + the CUresult of a
// failed tensor-map encoding.
extern "C" int chunk_scan_sm90(const void* q, const void* k, const void* v,
                               const void* cum, void* intra, void* kv,
                               int BNC, int L, int H, int dk, int dv,
                               int parts, void* stream) {
  if (dk % 8 || dk < 8 || dv < 1 || L < 1 || (parts != 2 && parts != 3))
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dv % 8 || dk > tc::kMaxDk) {
    if (parts == 2)
      return wide::launch<2>(q, k, v, cum, intra, kv, BNC, L, H, dk, dv, s);
    return wide::launch<3>(q, k, v, cum, intra, kv, BNC, L, H, dk, dv, s);
  }
  const int slabs = (dv + sm90::kSlab - 1) / sm90::kSlab;
  const int slices = (slabs + tc::kMaxSlabsV - 1) / tc::kMaxSlabsV;
  const int nsv = (slabs + slices - 1) / slices;
  if (dk <= sm90::kSlab)
    return tc::by_slabs<1>(nsv, parts, q, k, v, cum, intra, kv, BNC, L, H,
                           dk, dv, s);
  return tc::by_slabs<2>(nsv, parts, q, k, v, cum, intra, kv, BNC, L, H, dk,
                         dv, s);
}

extern "C" const char* kernel_error_string(int err) {
  return sm90::error_string(err);
}
