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
// Both designs below are a pair of kernels, as the Pallas pair. The
// scalar pair (the float32 path):
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
// it is bound by operations, and only the tensor cores come near the
// bound.
//
// Two designs behind the entry point, chosen by dtype:
//
// * bfloat16: dq_sm90 and dkv_sm90, on the tensor cores (flash_sm90.cuh),
//   the same pair without atomics, deterministic.
//   - dkv_sm90: grid (KV, key tiles of 128, B). A block owns 128 keys of
//     one KV head, K and V resident in shared memory (one TMA load), 64
//     keys a consumer warpgroup. A producer warp streams the flattened
//     query rows that can see them -- tiles of 64 // group positions x
//     every group head, so the GQA sum stays in float32 in the kernel --
//     through a two-stage TMA ring of Q and dO tiles; the same warp
//     stages each row's lse (times log2 e) and delta beside them with
//     plain loads (a (group, positions) box of float32 is not a whole 16
//     bytes wide when group < 4, so TMA cannot take it). With keys as the
//     products' M, wgmma computes S^T = K.Q^T and dP^T = V.dO^T; then
//     P^T = exp2(S^T * scale * log2 e - lse * log2 e) and
//     dS^T = P^T * (dP^T - delta) on the accumulator fragments, which turn
//     into bf16 A fragments in registers for dV += P^T.dO and
//     dK += dS^T.Q (Q and dO read MN-major). dK and dV stay in float32
//     registers until the end. Key tiles with the most rows (the first,
//     under a causal mask) are launched first.
//   - dq_sm90: grid (KV, row tiles of 2 x 64 rows, B), the forward's
//     tiling (flash_attention.cu): Q and dO resident, a two-stage TMA
//     ring of 64-key K and V tiles over the key tiles the rows' mask
//     reaches; S = Q.K^T and dP = dO.V^T, P and dS in registers,
//     dQ += dS.K. Row tiles with the most key tiles are launched first.
//   Masks: tiles wholly outside a warpgroup's mask are skipped by it, and
//   only tiles that cross the diagonal, the window's start or S are
//   masked. dh is any multiple of 8 up to 128, zero-filled to 64-column
//   slabs (score products run ceil(dh / 16) k-steps); above 128 a thread's
//   float32 dK and dV accumulators alone, 2 x 4 x 32 registers at
//   dh = 256, would pass its 255. P and dS go to the
//   tensor cores as bf16 (the reference keeps them in float32), split in
//   two: hi = bf16(x) and lo = bf16(x - hi), and the products that take
//   them (dV, dK, dQ) run once for each. One bf16 each, the usual flash
//   design, left gradients that cancel to near 0 with the rounding of
//   their large terms, beyond the bf16 tolerance of the card's checks at
//   the training shape; the split costs about a quarter of the time.
//   Cost of the design: without atomics the pair runs seven products
//   (S and dP in both kernels, then dQ, dK, dV) against the bound's five;
//   with the split dQ, dK and dV run twice, ten products in all.
// * float32: dq_kernel and dkv_kernel, the first, scalar design: float32
//   FMAs out of float32 shared memory, 16 query rows / 32 keys a block.
//   Tensor cores take no float32 inputs, and TF32 keeps about three
//   digits, which would break the float32 tolerance (5e-5) that the
//   card's checks and the full-width float32 gradient phase hold it to,
//   so this path stays scalar.
//
// Build: one nvcc, no extra include path, about 6 s (nvcc 12.9 on the
// H100 machine's host). <cuda.h> is read for the CUtensorMap type only;
// cuTensorMapEncodeTiled is looked up in the libcuda that the CUDA
// runtime has loaded (cudaGetDriverEntryPoint), so nothing links it.

#include "attention_tile.cuh"
#include "flash_sm90.cuh"

namespace {

// ---------------------------------------------------------------- float32

namespace scalar {

using namespace attn_tile;

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

}  // namespace scalar

// ---------------------------------------------------------------- bf16

namespace bwd {

using namespace sm90;

// dq_sm90's shared memory, from a 1024-byte boundary: Q and dO (NS slabs
// of 2 x 64 rows each), kStages K and kStages V tiles (NS slabs of 64
// keys), barriers.
template <int NS>
struct DqSmem {
  static constexpr int kStages = 2;
  static constexpr int kRowSlab = kConsumers * kSlabBytes;
  static constexpr int kKV = NS * kSlabBytes;
  static constexpr int kDO = NS * kRowSlab;
  static constexpr int kK = 2 * NS * kRowSlab;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBar = kV + kStages * kKV;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// dkv_sm90's: K and V (NS slabs of 2 x 64 keys each), kStages Q and
// kStages dO tiles (NS slabs of 64 rows), kStages x (lse * log2 e, delta,
// position) of 64 rows, barriers.
template <int NS>
struct DkvSmem {
  static constexpr int kStages = 2;
  static constexpr int kKeySlab = kConsumers * kSlabBytes;
  static constexpr int kV = NS * kKeySlab;
  static constexpr int kRows = NS * kSlabBytes;
  static constexpr int kQ = 2 * NS * kKeySlab;
  static constexpr int kDO = kQ + kStages * kRows;
  static constexpr int kStat = kDO + kStages * kRows;
  static constexpr int kBar = kStat + kStages * 3 * kTile * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
dq_sm90(const __grid_constant__ CUtensorMap mq,
        const __grid_constant__ CUtensorMap mdo,
        const __grid_constant__ CUtensorMap mk,
        const __grid_constant__ CUtensorMap mv,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dq, int S, int H, int KV, int dh,
        int causal, int window, float scale, float scale_log2) {
  using L = DqSmem<NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;
  const int group = H / KV, P = kTile / group, rows = P * group;
  const int kvh = blockIdx.x, b = blockIdx.z;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int c_first = tile * kConsumers * P;
  const int c_last = min(S - 1, c_first + kConsumers * P - 1);
  const bool windowed = causal && window > 0;
  const int kt_first = windowed ? max(0, c_first - window + 1) / kTile : 0;
  const int kt_last = causal ? c_last / kTile : (S - 1) / kTile;
  const int n_kt = kt_last - kt_first + 1;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers * 128);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {                               // producer
    reg_dealloc<40>();
    if (threadIdx.x != kConsumers * 128) return;
    bar_expect_tx(q_full, 2 * NS * kConsumers * rows * 128);
    for (int w = 0; w < kConsumers; ++w)
      for (int s = 0; s < NS; ++s) {
        const int off = s * L::kRowSlab + w * kSlabBytes;
        tma_load(sm + off, &mq, q_full, s * kSlab, kvh * group,
                 c_first + w * P, b);
        tma_load(sm + L::kDO + off, &mdo, q_full, s * kSlab, kvh * group,
                 c_first + w * P, b);
      }
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % L::kStages;
      bar_wait(&empty[st], ((i / L::kStages) & 1) ^ 1);
      bar_expect_tx(&full[st], 2 * L::kKV);
      const int key0 = (kt_first + i) * kTile;
      for (int s = 0; s < NS; ++s) {
        tma_load(sm + L::kK + st * L::kKV + s * kSlabBytes, &mk, &full[st],
                 s * kSlab, kvh, key0, b);
        tma_load(sm + L::kV + st * L::kKV + s * kSlabBytes, &mv, &full[st],
                 s * kSlab, kvh, key0, b);
      }
    }
    return;
  }

  reg_alloc<232>();                                     // consumers
  const int t = threadIdx.x % 128, lane = t % 32, quad = lane % 4;
  const int r0 = (t / 32) * 16 + lane / 4;   // rows r0 and r0 + 8
  const int cw = c_first + wg * P;
  const int cw_last = min(S - 1, cw + P - 1);
  int lo[2], hi[2];
  float lse2[2], dl[2];
  size_t row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = r0 + 8 * h, c = cw + rl / group;
    lo[h] = windowed ? max(0, c - window + 1) : 0;
    hi[h] = causal ? c : S - 1;
    row[h] = (size_t(b) * S + c) * H + kvh * group + rl % group;
    const bool valid = rl < rows && c < S;
    lse2[h] = valid ? lse[row[h]] * kLog2e : inf_f();
    dl[h] = valid ? delta[row[h]] : 0.f;
  }
  float acc[NS][32];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[s][i] = 0.f;
  const int ksteps = (dh + 15) / 16;
  const uint8_t* qw = sm + wg * kSlabBytes;
  const uint8_t* dow = sm + L::kDO + wg * kSlabBytes;
  bar_wait(q_full, 0);

  for (int i = 0; i < n_kt; ++i) {
    const int st = i % L::kStages;
    const int key0 = (kt_first + i) * kTile, key_end = key0 + kTile - 1;
    bar_wait(&full[st], (i / L::kStages) & 1);
    const bool skip = cw > S - 1 || (causal && cw_last < key0) ||
                      (windowed && cw - key_end >= window);
    if (!skip) {
      const uint8_t* kt = sm + L::kK + st * L::kKV;
      const uint8_t* vt = sm + L::kV + st * L::kKV;
      float sc[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NS; ++kk) {
        if (kk >= ksteps) break;
        const int off = (kk >> 2), col = (kk & 3) * 32;
        wgmma_ss(sc, desc_k(qw + off * L::kRowSlab + col),
                 desc_k(kt + off * kSlabBytes + col), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4 * NS; ++kk) {
        if (kk >= ksteps) break;
        const int off = (kk >> 2), col = (kk & 3) * 32;
        wgmma_ss(dp, desc_k(dow + off * L::kRowSlab + col),
                 desc_k(vt + off * kSlabBytes + col), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool whole = key_end <= S - 1 && (!causal || key_end <= cw) &&
                         (!windowed || cw_last - key0 < window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h = (e >> 1) & 1;
        const int key = key0 + 8 * (e >> 2) + 2 * quad + (e & 1);
        const bool vis = whole || (key >= lo[h] && key <= hi[h]);
        const float p = vis ? exp2f(sc[e] * scale_log2 - lse2[h]) : 0.f;
        sc[e] = p * (dp[e] - dl[h]);
      }
      uint32_t da[4][4], dlo[4][4];
      to_a_frags_split(sc, da, dlo);
      fence_regs(da);
      fence_regs(dlo);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const uint64_t kd = desc_mn(kt + s * kSlabBytes + kk * 2048);
          wgmma_rs<1>(acc[s], da[kk], kd);
          wgmma_rs<1>(acc[s], dlo[kk], kd);
        }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int s = 0; s < NS; ++s) fence_regs(acc[s]);
    }
    bar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rl = r0 + 8 * h, c = cw + rl / group;
    if (rl >= rows || c > S - 1) continue;
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = s * kSlab + 8 * j + 2 * quad;
        if (col < dh)
          *reinterpret_cast<__nv_bfloat162*>(dq + row[h] * dh + col) =
              __floats2bfloat162_rn(acc[s][4 * j + 2 * h] * scale,
                                    acc[s][4 * j + 2 * h + 1] * scale);
      }
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
dkv_sm90(const __grid_constant__ CUtensorMap mq,
         const __grid_constant__ CUtensorMap mdo,
         const __grid_constant__ CUtensorMap mk,
         const __grid_constant__ CUtensorMap mv,
         const float* __restrict__ lse, const float* __restrict__ delta,
         __nv_bfloat16* __restrict__ dk_out,
         __nv_bfloat16* __restrict__ dv_out, int S, int H, int KV, int dh,
         int causal, int window, float scale, float scale_log2) {
  using L = DkvSmem<NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;
  const int group = H / KV, P = kTile / group, rows = P * group;
  const int kvh = blockIdx.x, b = blockIdx.z;
  const int key0 = blockIdx.y * kConsumers * kTile;
  const int n = min(kConsumers * kTile, S - key0);
  const bool windowed = causal && window > 0;
  // the positions whose rows can see a key of this block
  const int c_lo = causal ? key0 : 0;
  const int c_hi = windowed ? min(S - 1, key0 + n - 1 + window - 1) : S - 1;
  const int n_rt = (c_hi - c_lo + P) / P;
  const int wg = threadIdx.x / 128;
  // Rows past P * group of a row tile are never written by TMA: zeros, so
  // that they add nothing to the products over rows.
  for (int i = threadIdx.x; i < 2 * L::kStages * L::kRows / 16;
       i += blockDim.x)
    reinterpret_cast<uint4*>(sm + L::kQ)[i] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      bar_init(&full[s], 32);
      bar_init(&empty[s], kConsumers * 128);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {                               // producer warp
    reg_dealloc<40>();
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      bar_expect_tx(kv_full, 2 * NS * L::kKeySlab);
      for (int s = 0; s < NS; ++s) {
        tma_load(sm + s * L::kKeySlab, &mk, kv_full, s * kSlab, kvh, key0,
                 b);
        tma_load(sm + L::kV + s * L::kKeySlab, &mv, kv_full, s * kSlab,
                 kvh, key0, b);
      }
    }
    for (int i = 0; i < n_rt; ++i) {
      const int st = i % L::kStages, c0 = c_lo + i * P;
      bar_wait(&empty[st], ((i / L::kStages) & 1) ^ 1);
      float* sl = reinterpret_cast<float*>(sm + L::kStat) + st * 3 * kTile;
      float* sd = sl + kTile;
      int* sp = reinterpret_cast<int*>(sd + kTile);
      for (int rl = lane; rl < kTile; rl += 32) {
        const int c = c0 + rl / group;
        const bool valid = rl < rows && c < S;
        const size_t idx = (size_t(b) * S + c) * H + kvh * group + rl % group;
        sl[rl] = valid ? lse[idx] * kLog2e : inf_f();
        sd[rl] = valid ? delta[idx] : 0.f;
        sp[rl] = c;
      }
      if (lane == 0) {
        bar_expect_tx(&full[st], 2 * NS * rows * 128);
        for (int s = 0; s < NS; ++s) {
          const int off = st * L::kRows + s * kSlabBytes;
          tma_load(sm + L::kQ + off, &mq, &full[st], s * kSlab, kvh * group,
                   c0, b);
          tma_load(sm + L::kDO + off, &mdo, &full[st], s * kSlab,
                   kvh * group, c0, b);
        }
      } else {
        bar_arrive(&full[st]);
      }
    }
    return;
  }

  reg_alloc<232>();                                     // consumers
  const int t = threadIdx.x % 128, lane = t % 32, quad = lane % 4;
  const int kw = key0 + wg * kTile;          // the warpgroup's first key
  const int kr0 = kw + (t / 32) * 16 + lane / 4;   // keys kr0, kr0 + 8
  float dk[NS][32], dv[NS][32];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[s][i] = dv[s][i] = 0.f;
  const int ksteps = (dh + 15) / 16;
  const uint8_t* kwp = sm + wg * kSlabBytes;
  const uint8_t* vwp = sm + L::kV + wg * kSlabBytes;
  bar_wait(kv_full, 0);

  for (int i = 0; i < n_rt; ++i) {
    const int st = i % L::kStages, c0 = c_lo + i * P;
    const int c_end = min(c0 + P - 1, S - 1);
    bar_wait(&full[st], (i / L::kStages) & 1);
    const bool skip = kw > S - 1 || (causal && c_end < kw) ||
                      (windowed && c0 - (kw + kTile - 1) >= window);
    if (!skip) {
      const uint8_t* qt = sm + L::kQ + st * L::kRows;
      const uint8_t* dot = sm + L::kDO + st * L::kRows;
      const float* sl = reinterpret_cast<const float*>(sm + L::kStat) +
                        st * 3 * kTile;
      const float* sd = sl + kTile;
      const int* sp = reinterpret_cast<const int*>(sd + kTile);
      float sc[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NS; ++kk) {
        if (kk >= ksteps) break;
        const int off = (kk >> 2), col = (kk & 3) * 32;
        wgmma_ss(sc, desc_k(kwp + off * L::kKeySlab + col),
                 desc_k(qt + off * kSlabBytes + col), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4 * NS; ++kk) {
        if (kk >= ksteps) break;
        const int off = (kk >> 2), col = (kk & 3) * 32;
        wgmma_ss(dp, desc_k(vwp + off * L::kKeySlab + col),
                 desc_k(dot + off * kSlabBytes + col), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const bool whole = kw + kTile - 1 <= S - 1 &&
                         (!causal || kw + kTile - 1 <= c0) &&
                         (!windowed || c_end - kw < window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = kr0 + 8 * ((e >> 1) & 1);
        const int col = 8 * (e >> 2) + 2 * quad + (e & 1);
        const int c = sp[col];
        const bool vis = whole || ((!causal || key <= c) &&
                                   (!windowed || c - key < window) &&
                                   key <= S - 1);
        const float p = vis ? exp2f(sc[e] * scale_log2 - sl[col]) : 0.f;
        dp[e] = p * (dp[e] - sd[col]);
        sc[e] = p;
      }
      uint32_t hi[4][4], lo[4][4];
      to_a_frags_split(sc, hi, lo);
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(dv);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const uint64_t od = desc_mn(dot + s * kSlabBytes + kk * 2048);
          wgmma_rs<1>(dv[s], hi[kk], od);
          wgmma_rs<1>(dv[s], lo[kk], od);
        }
      wg_commit();
      wg_wait<0>();
      to_a_frags_split(dp, hi, lo);
      fence_regs(hi);
      fence_regs(lo);
      fence_regs(dk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const uint64_t qd = desc_mn(qt + s * kSlabBytes + kk * 2048);
          wgmma_rs<1>(dk[s], hi[kk], qd);
          wgmma_rs<1>(dk[s], lo[kk], qd);
        }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        fence_regs(dv[s]);
        fence_regs(dk[s]);
      }
    }
    bar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kr0 + 8 * h;
    if (key > S - 1) continue;
    const size_t off = ((size_t(b) * S + key) * KV + kvh) * dh;
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = s * kSlab + 8 * j + 2 * quad;
        if (col >= dh) continue;
        *reinterpret_cast<__nv_bfloat162*>(dk_out + off + col) =
            __floats2bfloat162_rn(dk[s][4 * j + 2 * h] * scale,
                                  dk[s][4 * j + 2 * h + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + off + col) =
            __floats2bfloat162_rn(dv[s][4 * j + 2 * h],
                                  dv[s][4 * j + 2 * h + 1]);
      }
  }
}

template <int NS>
int launch(const void* q, const void* k, const void* v, const void* dO,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int B, int S, int H, int KV, int dh, int causal, int window,
           float scale, cudaStream_t stream) {
  const int group = H / KV, P = kTile / group;
  CUtensorMap mq, mdo, mk, mv, mk2, mv2;
  int err = make_map(&mq, q, B, S, H, dh, group, P);
  if (!err) err = make_map(&mdo, dO, B, S, H, dh, group, P);
  if (!err) err = make_map(&mk, k, B, S, KV, dh, 1, kTile);
  if (!err) err = make_map(&mv, v, B, S, KV, dh, 1, kTile);
  if (!err) err = make_map(&mk2, k, B, S, KV, dh, 1, kConsumers * kTile);
  if (!err) err = make_map(&mv2, v, B, S, KV, dh, 1, kConsumers * kTile);
  if (err) return err;
  cudaError_t e = allow_smem(dq_sm90<NS>, DqSmem<NS>::kBytes);
  if (e == cudaSuccess) e = allow_smem(dkv_sm90<NS>, DkvSmem<NS>::kBytes);
  if (e != cudaSuccess) return int(e);
  auto lp = static_cast<const float*>(lse);
  auto dp = static_cast<const float*>(delta);
  const float scale_log2 = scale * kLog2e;
  const int row_tiles = (S + kConsumers * P - 1) / (kConsumers * P);
  dq_sm90<NS><<<dim3(KV, row_tiles, B), kThreads, DqSmem<NS>::kBytes,
                stream>>>(mq, mdo, mk, mv, lp, dp,
                          static_cast<__nv_bfloat16*>(dq), S, H, KV, dh,
                          causal, window, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int key_tiles = (S + kConsumers * kTile - 1) / (kConsumers * kTile);
  dkv_sm90<NS><<<dim3(KV, key_tiles, B), kThreads, DkvSmem<NS>::kBytes,
                 stream>>>(mq, mdo, mk2, mv2, lp, dp,
                           static_cast<__nv_bfloat16*>(dk),
                           static_cast<__nv_bfloat16*>(dv), S, H, KV, dh,
                           causal, window, scale, scale_log2);
  return int(cudaGetLastError());
}

}  // namespace bwd

}  // namespace

// dtype: 0 = float32 (scalar kernels), 1 = bfloat16 (tensor cores; dh a
// multiple of 8 up to 128, H / KV <= 64, 16-byte aligned operands: the
// wrapper checks). Returns the cudaError_t of the launches, or
// sm90::kEncodeError + the CUresult of a failed tensor-map encoding.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int dtype,
                                   int B, int S, int H, int KV, int dh,
                                   int causal, int window, float scale,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return scalar::launch_bwd<float>(q, k, v, dO, lse, delta, dq, dk, dv, B,
                                     S, H, KV, dh, causal, window, scale, s);
  if (dtype != 1 || dh % 8 || dh > 128 || H % KV || H / KV > 64)
    return int(cudaErrorInvalidValue);
  auto run = dh <= 64 ? bwd::launch<1> : bwd::launch<2>;
  return run(q, k, v, dO, lse, delta, dq, dk, dv, B, S, H, KV, dh, causal,
             window, scale, s);
}

extern "C" const char* kernel_error_string(int err) {
  return sm90::error_string(err);
}
