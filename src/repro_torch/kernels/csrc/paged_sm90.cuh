// Paged attention on Hopper's tensor cores (bf16): the tile loop of the
// chunk-prefill, span-verify and decode kernels of decode_attention.cu,
// built on flash_sm90.cuh (mbarrier rings, TMA, wgmma, softmax_step).
//
// Work of a block. A block owns 64 flattened rows of one (slot, KV head):
// (offset, group head) pairs, offset-major, P = 64 / group offsets of the
// chunk (prefill), of the slot's span (verify) or the slot's one query
// token (decode: n_off = 1, so `group` rows are live and the rest read
// zeros), as flash_fwd_sm90 holds (position, group head) pairs. Row r sees
// the keys 0 .. p + offset(r), p the host int `start` (prefill) or pos[b],
// read on the device (verify, decode), and never a key past the slot's
// `keys` positions (NB * block paged, S contiguous): a span past them sees
// exactly those keys. That clamp is also decode's ring rule: with a window
// every key is live once pos >= keys, which is the same set. The block
// walks the 64-key tiles [kt_begin, kt_end) of its split of the key range;
// tiles past its last row's visible keys are neither loaded nor computed.
// kCons consumer warpgroups hold the same 64 rows and take key tiles in
// turn: with two (prefill, verify; a block an SM), one runs its softmax
// while the other's products use the tensor cores (a grid of one row tile
// a block fills 128 of the 132 SMs at the main path's chunk); with one
// (decode; two blocks an SM), the SM's two blocks interleave. Each runs
// S = Q.K^T and O += P.V on wgmma with float32 accumulators, the online
// softmax on the accumulator fragment (softmax_step, the reference's
// masking rule), P converted to a bf16 A fragment in registers, S of its
// tile i issued with P.V of its previous tile behind it as in
// flash_fwd_sm90. With two consumers, consumer 1 hands its (m, l, O) to
// consumer 0 through shared memory at the end, which rescales both to the
// larger m. One split writes the output in bf16; several write float32
// partials (m in log2 units, l, the unnormalised O) that merge_rows
// combines (verify_merge and the decode merges of decode_attention.cu).
//
// The loaders, a template parameter of the body. A producer warp keeps a
// ring of kStages K and V tiles full.
// * PagedLoader. A 64-key tile is 64 / block pages (block <= 64) or 64
//   rows of one page (block >= 64), each found through the block table:
//   TMA over a 4-D map of the pool (dh, KV, block, P), one box (64
//   columns, 1 head, min(block, 64) rows, 1 page) per page and 64-column
//   slab, page j of the tile at row j * block of the slab. For a
//   power-of-two block from 8 up every destination lies on a 1024-byte
//   boundary, so the 128-byte swizzle that TMA writes and wgmma reads
//   keeps the phase of the tile's row index; other blocks are refused by
//   the wrapper (and by the C entry). Lane j of the warp issues box j of a
//   tile (2 x NS x pages <= 32 boxes) and loads its table entry one tile
//   ahead. Pages of a tile past the table's last column (a horizon that is
//   not a multiple of 64 keys) load that column's page again, so every row
//   of the ring holds finite values; the fence hides them.
// * ContiguousLoader. A 64-key tile is one box a slab, rows kt * 64 ..
//   kt * 64 + 63 of slot b, from a 4-D map of the (B, S, KV, dh) cache
//   (dh, KV, S, B) with box (64 columns, 1 head, 64 rows, 1 slot); lane j
//   < 2 x NS issues box j. Rows past S read zeros and the fence hides
//   them, so any S is taken (ragged, under 64, a ring shorter than a
//   tile).
// Q comes by TMA as in flash, from a map over (dh, H, offsets, B): offsets
// past C, L or 1 read zeros and are never written.
#pragma once

#include "flash_sm90.cuh"

namespace paged {

using namespace sm90;


// Shared memory, from a 1024-byte boundary: Q (NS slabs of 64 rows), then
// kStages K tiles and kStages V tiles (NS slabs of 64 keys each), then the
// barriers. With two consumers the drained K tiles carry consumer 1's (m,
// l, O) to consumer 0 (128 x (32 NS + 4) floats).
template <int NS, int kStages>
struct Smem {
  static constexpr int kKV = NS * kSlabBytes;   // one K or V tile
  static constexpr int kK = NS * kSlabBytes;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBar = kV + kStages * kKV;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// What a launch computes. Rows of slot b at offset o are query heads
// kvh * group + g at absolute position p + o; out is (B, n_off, H, dh).
struct Work {
  __nv_bfloat16* out;     // the output (splits == 1)
  float* part_acc;        // partials (B, KV, splits, n_off * group, dh)
  float* part_m;          // (B, KV, splits, n_off * group), log2 units
  float* part_l;
  const int* pos;         // (B,) on the device, or nullptr: p = start
  const int* tables;      // (B, NB), the paged loader's
  float* lse;             // (B, n_off, H) natural-log lse, or nullptr
  int start, n_off, H, KV, dh, block, NB;
  int keys;               // key positions of a slot: NB * block, or S
  int splits, tps;        // key tiles [s * tps, s * tps + tps) per split
  float scale_log2;
};

// A power-of-two page block from 8 up (see the header).
__host__ __device__ inline bool block_ok(int block) {
  return block >= 8 && (block & (block - 1)) == 0;
}

// The paged loader (see the header): lane j of the producer warp issues
// box j of a tile, (page, slab, K or V), its page read from the block
// table one tile ahead.
template <int NS>
struct PagedLoader {
  const CUtensorMap *mk, *mv;
  const int* table;
  int NB, block, kt_begin, kvh, lane, page, slab, is_v, n_box, box_rows;
  int phys, next;   // this lane's page of the current and the next tile

  __device__ PagedLoader(const CUtensorMap& k, const CUtensorMap& v,
                         const Work& w, int b, int kvh_, int kt_begin_,
                         int lane_)
      : mk(&k), mv(&v), table(w.tables + size_t(b) * w.NB), NB(w.NB),
        block(w.block), kt_begin(kt_begin_), kvh(kvh_), lane(lane_) {
    const int ppt = block >= kTile ? 1 : kTile / block;
    n_box = 2 * NS * ppt;
    page = lane / (2 * NS);
    slab = (lane / 2) % NS;
    is_v = lane % 2;
    box_rows = min(block, kTile);
    phys = lane < n_box ? page_of(0) : 0;
  }
  __device__ int page_of(int i) const {
    const int key0 = (kt_begin + i) * kTile;
    return table[min(key0 / block + page, NB - 1)];
  }
  // before the wait for a free stage: the table entry of tile i + 1
  __device__ void prefetch(int i, int n_kt) {
    next = lane < n_box && i + 1 < n_kt ? page_of(i + 1) : 0;
  }
  __device__ void issue(int i, uint8_t* k_tile, uint8_t* v_tile,
                        uint64_t* bar) {
    if (lane < n_box) {
      const int row0 = block >= kTile ? (kt_begin + i) * kTile % block : 0;
      tma_load((is_v ? v_tile : k_tile) + slab * kSlabBytes +
                   page * box_rows * 128,
               is_v ? mv : mk, bar, slab * kSlab, kvh, row0, phys);
    }
    phys = next;
  }
};

// The contiguous loader (see the header): lane j < 2 x NS issues the box
// (slab j / 2, K or V) of a 64-row slab of slot b's cache row.
template <int NS>
struct ContiguousLoader {
  const CUtensorMap *mk, *mv;
  int b, kt_begin, kvh, lane;

  __device__ ContiguousLoader(const CUtensorMap& k, const CUtensorMap& v,
                              const Work&, int b_, int kvh_, int kt_begin_,
                              int lane_)
      : mk(&k), mv(&v), b(b_), kt_begin(kt_begin_), kvh(kvh_),
        lane(lane_) {}
  __device__ void prefetch(int, int) {}
  __device__ void issue(int i, uint8_t* k_tile, uint8_t* v_tile,
                        uint64_t* bar) {
    if (lane < 2 * NS) {
      const int slab = lane / 2;
      tma_load((lane % 2 ? v_tile : k_tile) + slab * kSlabBytes,
               lane % 2 ? mv : mk, bar, slab * kSlab, kvh,
               (kt_begin + i) * kTile, b);
    }
  }
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(2 * 128) : "memory");
}

// Threads of a block with kCons consumer warpgroups, and the registers a
// consumer thread takes once the producer warpgroup has given its own
// away: two consumers fill an SM with one block, one consumer with two.
template <int kCons> __host__ __device__ constexpr int threads() {
  return 128 * (kCons + 1);
}
template <int kCons> __host__ __device__ constexpr int consumer_regs() {
  return kCons == 2 ? 232 : 216;
}

// grid (KV, row tiles, B * splits), threads<kCons>() threads: warpgroups
// 0 .. kCons - 1 consume, warp 4 kCons loads (the producer warpgroup gives
// its registers to the consumers). Row tiles with the most key tiles (the
// last offsets) are launched first.
template <int NS, int kStages, int kCons, typename Loader>
__device__ __forceinline__ void paged_body(const CUtensorMap& mq,
                                           const CUtensorMap& mk,
                                           const CUtensorMap& mv,
                                           const Work& w) {
  static_assert(kCons == 1 || kCons == 2, "one or two consumers");
  static_assert(kStages % kCons == 0, "stage s feeds consumer s % kCons");
  using L = Smem<NS, kStages>;
  static_assert(kCons == 1 || 128 * (32 * NS + 4) * 4 <= kStages * L::kKV,
                "the hand-over fits in the K ring");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  const int group = w.H / w.KV, P = kTile / group, rows = P * group;
  const int kvh = blockIdx.x, tile = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.z / w.splits, split = blockIdx.z % w.splits;
  const int off0 = tile * P, off_last = min(off0 + P - 1, w.n_off - 1);
  const int p = w.pos ? w.pos[b] : w.start;
  const int s_log = w.keys;
  // a split wholly past the slot's last visible key exits (merge_rows
  // counts the same live splits); split 0 stays where no key is visible
  // (decode's empty fence, pos < 0) and, walking no tile, writes a 0 row
  // and lse -inf, or partials of l = 0
  const int kt_begin = split * w.tps;
  if (split > 0 && kt_begin * kTile > min(p + w.n_off - 1, s_log - 1))
    return;
  const int last_key = min(p + off_last, s_log - 1);
  const int kt_end = last_key < 0 ? kt_begin
                                  : min(kt_begin + w.tps,
                                        last_key / kTile + 1);
  const int n_kt = max(0, kt_end - kt_begin);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 128);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (wg == kCons) {                                     // producer warp
    reg_dealloc<40>();
    const int lane = threadIdx.x % 32;
    if (n_kt == 0 || threadIdx.x >= kCons * 128 + 32) return;
    if (lane == 0) {
      bar_expect_tx(q_full, NS * rows * 128);
      for (int s = 0; s < NS; ++s)
        tma_load(sm + s * kSlabBytes, &mq, q_full, s * kSlab,
                 kvh * group, off0, b);
    }
    Loader loader(mk, mv, w, b, kvh, kt_begin, lane);
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % kStages;
      loader.prefetch(i, n_kt);
      if (lane == 0) {
        bar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        bar_expect_tx(&full[st], 2 * L::kKV);
      }
      __syncwarp();
      loader.issue(i, sm + L::kK + st * L::kKV, sm + L::kV + st * L::kKV,
                   &full[st]);
    }
    return;
  }

  // consumer wg takes the block's key tiles wg, wg + kCons, ...
  reg_alloc<consumer_regs<kCons>()>();
  const int t = threadIdx.x % 128, lane = t % 32, quad = lane % 4;
  const int r0 = (t / 32) * 16 + lane / 4;   // rows r0 and r0 + 8
  int lo[2] = {0, 0}, hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    hi[h] = min(p + off0 + (r0 + 8 * h) / group, s_log - 1);
  const int min_hi = min(p + off0, s_log - 1);   // the tile's first row
  const int ksteps = (w.dh + 15) / 16;
  const int mine = n_kt > wg ? (n_kt - wg + kCons - 1) / kCons : 0;
  auto wait_tile = [&](int i) {
    bar_wait(&full[i % kStages], (i / kStages) & 1);
  };
  auto release = [&](int i) { bar_arrive(&empty[i % kStages]); };
  float o[NS][32];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[s][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  if (mine > 0) {
    uint32_t qf[4 * NS][4];
    bar_wait(q_full, 0);
    load_a_frags<NS>(sm, kSlabBytes, qf);
    float sc[32], alpha[2];
    uint32_t pa[4][4];
    auto issue_s = [&](int i) {
      const uint8_t* kt = sm + L::kK + (i % kStages) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < 4 * NS; ++kk) {
        if (kk >= ksteps) break;
        wgmma_rs<0>(sc, qf[kk],
                    desc_k(kt + (kk >> 2) * kSlabBytes + (kk & 3) * 32),
                    kk > 0);
      }
      wg_commit();
    };
    auto issue_pv = [&](int i) {
      const uint8_t* vt = sm + L::kV + (i % kStages) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int s = 0; s < NS; ++s)
          wgmma_rs<1>(o[s], pa[kk], desc_mn(vt + s * kSlabBytes +
                                             kk * 2048));
      wg_commit();
    };
    auto softmax = [&](int i) {
      const int key0 = (kt_begin + i) * kTile;
      softmax_step(sc, m, l, alpha, key0 + kTile - 1 <= min_hi, key0, quad,
                   lo, hi, w.scale_log2);
    };
    wait_tile(wg);
    fence_regs(qf);
    wg_fence();
    issue_s(wg);
    wg_wait<0>();
    fence_regs(qf);
    fence_regs(sc);
    softmax(wg);
    to_a_frags(sc, pa);
    // S of tile i on the tensor cores with P.V of the previous one behind
    // it; the softmax of tile i waits for the first only
    for (int j = 1; j < mine; ++j) {
      const int i = wg + kCons * j, prev = i - kCons;
      wait_tile(i);
      fence_regs(pa);
      fence_regs(o);
      wg_fence();
      issue_s(i);
      issue_pv(prev);
      wg_wait<1>();
      fence_regs(sc);
      softmax(i);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(prev);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[s][e] *= alpha[(e >> 1) & 1];
      to_a_frags(sc, pa);
    }
    const int last = wg + kCons * (mine - 1);
    fence_regs(pa);
    fence_regs(o);
    wg_fence();
    issue_pv(last);
    wg_wait<0>();
    fence_regs(o);
    release(last);
  }

  if constexpr (kCons == 2) {
    // consumer 1 hands (m, l, O) to consumer 0 through the drained ring,
    // element e of thread t at e * 128 + t; consumer 0 rescales both to the
    // larger m (a consumer without tiles has m = -1e30: weight 0)
    float* xch = reinterpret_cast<float*>(sm + L::kK);
    constexpr int kO = NS * 32;
    consumers_sync();
    if (wg == 1) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int e = 0; e < 32; ++e) xch[(s * 32 + e) * 128 + t] = o[s][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xch[(kO + h) * 128 + t] = m[h];
        xch[(kO + 2 + h) * 128 + t] = l[h];
      }
    }
    consumers_sync();
    if (wg == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = xch[(kO + h) * 128 + t];
      const float mx = fmaxf(m[h], m1);
      a0[h] = exp2f(m[h] - mx);
      a1[h] = exp2f(m1 - mx);
      m[h] = mx;
      l[h] = l[h] * a0[h] + xch[(kO + 2 + h) * 128 + t] * a1[h];
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h = (e >> 1) & 1;
        o[s][e] = o[s][e] * a0[h] + xch[(s * 32 + e) * 128 + t] * a1[h];
      }
  }

  // epilogue: rows r0 and r0 + 8 of the block's tile
  const int n_rows = w.n_off * group;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lh = quad_sum(l[h]);
    const int rl = r0 + 8 * h, off = off0 + rl / group;
    if (rl >= rows || off >= w.n_off) continue;
    const int g = rl % group;
    if (w.splits == 1) {
      const size_t row = (size_t(b) * w.n_off + off) * w.H + kvh * group + g;
      const float inv = 1.f / fmaxf(lh, 1e-30f);
      if (w.lse && quad == 0)
        w.lse[row] = lh > 0.f ? (m[h] + log2f(lh)) * kLn2 : neg_infinity();
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = s * kSlab + 8 * j + 2 * quad;
          if (col < w.dh)
            *reinterpret_cast<__nv_bfloat162*>(w.out + row * w.dh + col) =
                __floats2bfloat162_rn(o[s][4 * j + 2 * h] * inv,
                                      o[s][4 * j + 2 * h + 1] * inv);
        }
      continue;
    }
    const size_t pr =
        ((size_t(b) * w.KV + kvh) * w.splits + split) * n_rows +
        off * group + g;
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = s * kSlab + 8 * j + 2 * quad;
        if (col < w.dh)
          *reinterpret_cast<float2*>(w.part_acc + pr * w.dh + col) =
              make_float2(o[s][4 * j + 2 * h], o[s][4 * j + 2 * h + 1]);
      }
    if (quad == 0) {
      w.part_m[pr] = m[h];
      w.part_l[pr] = lh;
    }
  }
}

// The merge of several splits' partials: warp i of block x combines row
// 4x + i = (b, l, h) of the (B, L, H, dh) output (L = w.n_off) from the
// float32 partials of its live splits (those that start at or before the
// slot's horizon, as paged_body decides), lane s holding split s (splits
// <= 32): one round of loads for every m and l, then each lane sums four
// columns over the splits. M = max m_s, out = sum 2^(m_s - M) O_s /
// max(sum 2^(m_s - M) l_s, 1e-30), in bf16, and with w.lse the row's
// natural-log lse (M + log2 of that sum) * ln 2. A split in which a row
// sees no key has m_s = -1e30 and weight 0; key 0 is visible whenever pos
// >= 0, so every row has a live split. With pos < 0 (decode's empty
// fence) split 0 is the live one and its l = 0 gives a 0 row and lse
// -inf. Launched with ceil(B * L * H / 4) blocks of 128.
__device__ __forceinline__ void merge_rows(const Work& w, int B) {
  const int L = w.n_off, lane = threadIdx.x % 32;
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= B * L * w.H) return;
  const int h = row % w.H, l = row / w.H % L, b = row / (w.H * L);
  const int group = w.H / w.KV, n_rows = L * group;
  const int horizon = min(w.pos[b] + L - 1, w.keys - 1);
  const int live = min(w.splits, horizon / (w.tps * kTile) + 1);
  const size_t first =
      size_t(b * w.KV + h / group) * w.splits * n_rows + l * group +
      h % group;                       // split s at first + s * n_rows
  const size_t mine = first + size_t(lane) * n_rows;
  const float m = lane < live ? w.part_m[mine] : kNegInf;
  float M = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffff, M, o));
  const float wt = lane < live ? exp2f(m - M) : 0.f;
  float den = lane < live ? wt * w.part_l[mine] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    den += __shfl_xor_sync(0xffffffff, den, o);
  const float inv = 1.f / fmaxf(den, 1e-30f);
  if (w.lse && lane == 0)
    w.lse[row] = den > 0.f ? (M + log2f(den)) * kLn2 : neg_infinity();
  for (int c0 = 0; c0 < w.dh; c0 += 128) {
    const int c = c0 + 4 * lane;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < live; ++s) {
      const float ws = __shfl_sync(0xffffffff, wt, s);
      if (c < w.dh) {
        const float4 a = *reinterpret_cast<const float4*>(
            w.part_acc + (first + size_t(s) * n_rows) * w.dh + c);
        num.x += ws * a.x;
        num.y += ws * a.y;
        num.z += ws * a.z;
        num.w += ws * a.w;
      }
    }
    if (c < w.dh) {
      __nv_bfloat162* o =
          reinterpret_cast<__nv_bfloat162*>(w.out + size_t(row) * w.dh + c);
      o[0] = __floats2bfloat162_rn(num.x * inv, num.y * inv);
      o[1] = __floats2bfloat162_rn(num.z * inv, num.w * inv);
    }
  }
}

// Tensor map of a (P, block, KV, dh) bf16 pool whose box is 64 columns of
// one head at min(block, 64) consecutive rows of one page.
inline int make_pool_map(CUtensorMap* map, const void* base, int P,
                         int block, int KV, int dh) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return kEncodeError + int(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(KV),
                              cuuint64_t(block), cuuint64_t(P)};
  const cuuint64_t strides[3] = {cuuint64_t(dh) * 2,
                                 cuuint64_t(KV) * dh * 2,
                                 cuuint64_t(block) * KV * dh * 2};
  const cuuint32_t box[4] = {cuuint32_t(kSlab), 1,
                             cuuint32_t(block < kTile ? block : kTile), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + int(r);
}

}  // namespace paged
