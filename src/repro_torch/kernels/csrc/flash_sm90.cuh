// Hopper building blocks of the bf16 attention kernels (flash_attention.cu,
// flash_attention_bwd.cu, and through paged_sm90.cuh the paged kernels of
// decode_attention.cu): mbarriers, TMA tile loads, wgmma on bf16 tiles in
// 128-byte-swizzled shared memory, the online-softmax step on a score
// fragment, and the tensor maps that describe the (B, S, heads, dh)
// operands to the TMA unit.
//
// Layout. A tile of rows x dh bf16 is kept as ceil(dh / 64) slabs; a slab
// holds 64 columns of every row, 128 bytes a row, in the 128-byte swizzle
// that TMA writes (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma reads (layout type
// 1 of the matrix descriptor). Slabs and tiles start on 1024-byte
// boundaries, so the swizzle phase is that of the row index. Columns past
// dh are zero-filled by the TMA unit (they lie outside the tensor map).
//
// Products. Every product is one wgmma shape, m64n64k16 with float32
// accumulators, in two forms:
// * wgmma_ss: A and B from shared memory, both K-major (dh contiguous):
//   the backward's score products (Q.K^T, dO.V^T, and K.Q^T, V.dO^T with
//   keys as M);
// * wgmma_rs: A from registers (a bf16 fragment converted in place from an
//   accumulator: P or dS; or the forward's Q tile, read once from shared
//   memory), B from shared memory MN-major (the tile's dh columns are the
//   product's N): P.V, dS.K, P^T.dO, dS^T.Q; or K-major: the forward's
//   Q.K^T.
//   An output wider than 64 columns takes one instruction per slab.
//
// The accumulator fragment of m64nN (thread t of warp w of the
// warpgroup, lane = t % 32): element 4j + e sits at row 16w + lane/4
// (+8 for e >= 2), column 8j + 2(lane % 4) + e % 2. Its pairs at
// 8kk..8kk+7 are the A fragment of k-step kk of a product over those
// columns, so P and dS never leave the registers.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

constexpr int kSlab = 64;          // bf16 columns of a 128-byte row
constexpr int kTile = 64;          // rows of a wgmma, keys of a key tile
constexpr int kConsumers = 2;      // consumer warpgroups of a block
constexpr int kThreads = 128 * (kConsumers + 1);   // + producer warpgroup
constexpr int kSlabBytes = kTile * 128;           // one 64-row slab
constexpr float kNegInf = -1e30f;  // the masking constant of the reference
// -inf: the log-sum-exp of a row that sees no key
__device__ __forceinline__ float neg_infinity() {
  return __int_as_float(0xff800000);
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// cuTensorMapEncodeTiled's failures are returned as kEncodeError + CUresult
constexpr int kEncodeError = 100000;

// ---------------------------------------------------------------- device

__device__ __forceinline__ float inf_f() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::
               "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::
               "r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
               "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait of more
// than ~2^34 clocks (seconds) is a fault -- a transfer that never lands --
// and traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Generic-proxy writes to shared memory become visible to the async
// proxy (TMA, wgmma) of this block.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One TMA box of a 4-D tensor map into shared memory; completion is
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::
      "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar)) : "memory");
}

template <int R> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(R));
}
template <int R> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(R));
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major operands
// (lbo unused, sbo = 1024: eight 128-byte rows) advance a k-step of 16
// columns by 32 bytes of start address; MN-major operands (sbo = 1024:
// eight rows of K, lbo: the next 64 columns of N) advance 16 rows of K by
// 2048 bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return desc(p, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return desc(p, kSlabBytes, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most kPending of this thread's committed wgmma groups are
// still running (groups complete in order).
template <int kPending = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(kPending)
               : "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous window (issue .. wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&d)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(d[i]);
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

#define SM90_ACC32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define SM90_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A.B^T over one k-step of 16: A (64 x 16) and B (64 x 16) K-major
// in shared memory. accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : SM90_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A.B over one k-step of 16: A (64 x 16) a bf16 register fragment,
// B in shared memory, MN-major (kTransB = 1: B is 16 x 64 with its 64
// columns contiguous) or K-major (kTransB = 0: B^T is 64 x 16 with its 16
// columns contiguous). accumulate == 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n\t}"
      : SM90_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(kTransB));
}

#undef SM90_ACC32
#undef SM90_D32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of the four k-steps of a product over an accumulator's
// 64 columns.
__device__ __forceinline__ void to_a_frags(const float (&d)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

// The same fragments split in two: hi = bf16(x), lo = bf16(x - hi), so
// that hi.B + lo.B carries x to about 16 bits where one bf16 keeps 8.
__device__ __forceinline__ void to_a_frags_split(const float (&d)[32],
                                                 uint32_t (&hi)[4][4],
                                                 uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = d[8 * kk + 2 * e], x1 = d[8 * kk + 2 * e + 1];
      __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][e] = *reinterpret_cast<uint32_t*>(&h);
      lo[kk][e] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
}

// Sum over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

// The A fragments of a warpgroup's 64-row tile in shared memory (NS
// slabs `slab` bytes apart, the tile's row 0 at `tile`): k-step kk covers
// columns 16kk..16kk+15. Each thread reads its rows r0 = 16 warp + lane/4
// and r0 + 8 through the 128-byte swizzle (16-byte chunk c of row r sits
// at chunk c ^ (r % 8)).
template <int NS>
__device__ __forceinline__ void load_a_frags(const uint8_t* tile, int slab,
                                             uint32_t (&a)[4 * NS][4]) {
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x % 128) / 32 * 16 +
                                          lane / 4;
#pragma unroll
  for (int kk = 0; kk < 4 * NS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1);
      const int col = (kk & 3) * 16 + 8 * (e >> 1) + 2 * (lane % 4);
      a[kk][e] = *reinterpret_cast<const uint32_t*>(
          tile + (kk >> 2) * slab + row * 128 +
          ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2)));
    }
}

// One online-softmax step on a warpgroup's 64 x 64 score fragment sc
// (keys key0..key0+63; rows r0, r0 + 8 of the thread see keys lo..hi):
// scores scaled into log2 units and masked unless the whole tile is
// visible, the rows' maxima m and sums l updated, sc turned into
// P = exp2(s - m), and the rescale factor of the rows' earlier output
// returned in alpha.
__device__ __forceinline__ void softmax_step(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool whole, int key0, int quad,
                                             const int (&lo)[2],
                                             const int (&hi)[2],
                                             float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int h = (e >> 1) & 1;
    const int key = key0 + 8 * (e >> 2) + 2 * quad + (e & 1);
    float x = sc[e] * scale_log2;
    if (!whole && (key < lo[h] || key > hi[h])) x = kNegInf;
    sc[e] = x;
    mx[h] = fmaxf(mx[h], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    alpha[h] = exp2f(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int h = (e >> 1) & 1;
    sc[e] = exp2f(sc[e] - m[h]);
    l[h] += sc[e];
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the CUDA runtime already
// loaded, so the library links against no libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a contiguous (B, S, heads, dh) bf16 tensor whose box is
// 64 columns of `box_heads` consecutive heads at `box_rows` consecutive
// positions: `box_rows * box_heads` rows of 128 bytes in shared memory,
// position-major. Coordinates past any dimension read as zeros.
inline int make_map(CUtensorMap* map, const void* base, int B, int S,
                    int heads, int dh, int box_heads, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return kEncodeError + int(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(heads),
                              cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(dh) * 2,
                                 cuuint64_t(heads) * dh * 2,
                                 cuuint64_t(S) * heads * dh * 2};
  const cuuint32_t box[4] = {cuuint32_t(kSlab), cuuint32_t(box_heads),
                             cuuint32_t(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + int(r);
}

inline const char* error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled failed (CUresult "
                                  "= error - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace sm90
