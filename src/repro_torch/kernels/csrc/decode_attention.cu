// Decode and chunk-prefill attention kernels for Hopper (sm_90a), bound
// through a plain C interface (ctypes; see kernels/build.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decode_attention.py:
//   * paged_decode_attention  (:454, body _paged_decode_kernel :127 and
//     _accum_block :34) — one query token per slot over its paged KV span;
//   * decode_attention        (:85, body _decode_kernel :63 and the same
//     _accum_block) — one query token per slot over its contiguous
//     (B, S, KV, dh) cache row;
//   * chunk_prefill_attention (:240, body _chunk_prefill_kernel :177) — a
//     prompt chunk's queries over the request's paged prefix + the chunk,
//     for B requests at one shared start, each through its own table row
//     (the reference vmaps the Pallas kernel over an expert stack,
//     src/repro/core/ensemble.py:196-206; here the batch is a grid axis);
//   * paged_verify_attention  (:381, body _paged_verify_kernel :316) — a
//     speculative span of L candidate tokens per slot over the slot's paged
//     KV span (the span's own K/V already scattered in), row l fenced to
//     keys <= pos + l: the chunk-prefill body batched over slots.
//
// Two designs, chosen by dtype (a dispatch, not a fallback: each entry
// point takes what its wrapper checked, or returns an error).
//
// * float32, all four kernels: the first, scalar design. Tensor cores take
//   no float32, and TF32 keeps about three digits, which would break the
//   5e-5 tolerance of the card's float32 checks. One thread block per
//   (slot, KV head) for decode, per (KV head, tile of 16 query rows) for
//   prefill and per (slot, KV head, tile of span rows) for verify, each
//   walking the key tiles of its span up to the horizon tile (tiles past
//   it are neither loaded nor computed) with float32 FMAs out of shared
//   memory through the tile loop of attention_tile.cuh. The paged and
//   contiguous decode kernels are one template: they differ only in where
//   a key tile's rows sit (a block table entry, or (b, s) arithmetic), as
//   the Pallas kernels share _accum_block and differ only in their index
//   maps. The contiguous cache is cut into tiles of kContiguousBlock
//   positions and any S is taken (the Pallas wrapper asserts S % min(256,
//   S) == 0; the ragged last tile is masked here).
// * bf16, all four kernels: the tensor-core design of paged_sm90.cuh
//   (wgmma over 64-key tiles that a producer warp stages by TMA, page by
//   page through the block table or as whole slabs of a contiguous cache
//   row; the header has the layout). Page blocks: a power of two from 8
//   up (8, 16, 32, 64, 128, ...); dh a multiple of 8 up to 128; at most 64
//   query heads a KV head; operands on 16-byte boundaries. The wrapper
//   raises on anything else, with the shape named.
//   - chunk_prefill_sm90: bound by operations (C = 256 at start 512 of
//     Qwen3-8B's heads: 2.7 us of bf16 tensor-core work against 2.2 us of
//     bytes). The products run on wgmma. Its grid is one row tile a block,
//     (KV, row tiles, 1): at C = 256, H = 32, KV = 8 that is 16 row tiles
//     x 8 heads = 128 blocks on 132 SMs, where two row tiles a block
//     (flash's layout) would fill 64. Each block's two consumer
//     warpgroups take alternate key tiles of the same rows, so an SM
//     still holds two warpgroups; the row tiles with the most key tiles
//     run first, and every block walks only its own rows' keys (9 to 12
//     tiles there). One split: it writes its output directly. A batch of
//     B chunks (an expert stack's K copies of one request's chunk, each
//     over its own part of the pool) is the grid's third axis, as verify's
//     slots are: (KV, row tiles, B).
//   - paged_verify_sm90: bound by bytes (8 slots x 4 span rows of
//     Qwen3-8B's heads over spans ending by 1023: 19 MB of K/V, 5.6 us).
//     A slot has L x group = 16 rows a KV head, so a 64-row wgmma tile
//     carries 48 zero rows, which costs nothing against 32 KB of K/V per
//     64-key tile; what the kernel needs is bytes in flight on every SM.
//     So each slot's key range is split across blocks (flash-decoding):
//     grid (KV, row tiles, B x splits), splits fixed on the host from NB
//     x block alone (pos is never read on the host). Blocks whose key
//     range starts past their slot's horizon exit at once (idle slots,
//     short spans). Each live block writes float32 partials (m, l, O)
//     into a workspace the wrapper allocates; verify_merge (merge_rows of
//     paged_sm90.cuh) combines a row's live partials.
//   - paged_decode_sm90 and contiguous_decode_sm90: the verify design at
//     one row a slot (n_off = 1), over the paged or the contiguous loader.
//     Bound by bytes (8 slots of Qwen3-8B's heads over positions up to
//     1023: 16 MB of K/V, 4.9 us), and one block a (slot, KV head) pair
//     is 64 blocks, half the SMs: so each slot's key range is split across
//     blocks, the number of splits fixed on the host from the key count
//     and the (B, KV) count (decode_splits in decode_attention.py), and
//     paged_decode_merge / contiguous_decode_merge (merge_rows again)
//     combine the partials. Of a 64-row wgmma tile only `group` rows are
//     live (4 at Qwen3-8B's heads): its two m64n64 products per 64-key
//     tile take about 0.28 us of one SM's tensor-core share against 1.3
//     us of its share of the bandwidth for the tile's 32 KB, and they
//     overlap the ring's loads. One consumer warpgroup a block and a ring
//     small enough for two blocks an SM: at the main path's shapes it
//     took 0.0143 ms where verify's layout (two consumers, one block an
//     SM) took 0.0168 at its best split (PERF.md). The ring rule of a
//     windowed decode is the clamp of every row to the slot's keys
//     (paged_sm90.cuh), so the window needs no code here.

#include "attention_tile.cuh"
#include "paged_sm90.cuh"

using namespace attn_tile;

namespace {

constexpr int kContiguousBlock = 64;   // cache positions per key tile

// grid (B, KV): the `group` query heads h = kvh * group + g of slot b
// (q.reshape(B, KV, group, dh), as the reference regroups them) attend over
// key tiles 0..last of the slot's span of s_len positions. Keys at
// position <= pos are live; with window > 0 the span is a ring and every
// key is live once pos >= s_len.
template <typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ pos,
              Rows rows, float* __restrict__ out, int H, int KV, int dh,
              int block, int nk, int s_len, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, group = H / KV;
  const Tile t = carve(smem, group, block, dh);
  const int p = pos[b];
  const bool wrapped = window > 0 && p >= s_len;
  const size_t q0 = (size_t(b) * H + size_t(kvh) * group) * dh;
  for (int i = threadIdx.x; i < group * dh; i += blockDim.x)
    t.q[i] = q[q0 + i];
  for (int r = threadIdx.x; r < group; r += blockDim.x) {
    t.lo[r] = 0;
    t.hi[r] = wrapped ? s_len - 1 : min(p, s_len - 1);
  }
  init_state(t, group, dh);
  __syncthreads();
  const int last = wrapped ? nk - 1 : min(p / block, nk - 1);
  for (int ki = 0; ki <= last; ++ki) {
    load_kv(t, k, v, rows, b, ki, kvh, block, KV, dh);
    __syncthreads();
    accum_block(t, group, block, dh, ki * block, scale);
  }
  for (int i = threadIdx.x; i < group * dh; i += blockDim.x)
    out[q0 + i] = t.acc[i] / fmaxf(t.l[i / dh], 1e-30f);
}

// grid (KV, ceil(C * group / kRows), B): rows are chunk b's (c, g) query
// pairs flattened c-major per KV head; row c*group + g is query head
// kvh*group + g at absolute position start + c, fenced to keys at
// positions <= start + c, through table row b. Each tile stops at its own
// last row's block.
__global__ void __launch_bounds__(kThreads)
chunk_prefill_kernel(const float* __restrict__ q,
                     const float* __restrict__ k_pool,
                     const float* __restrict__ v_pool,
                     const int* __restrict__ tables, float* __restrict__ out,
                     int start, int C, int H, int KV, int dh, int block,
                     int NB, float scale) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, group = H / KV, b = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const int R = min(kRows, C * group - r0);
  const Tile t = carve(smem, R, block, dh);
  const PagedRows rows{tables, NB, block};
  q += size_t(b) * C * H * dh;
  out += size_t(b) * C * H * dh;
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    t.q[i] = to_f32(q[(size_t(c) * H + h) * dh + d]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    t.lo[r] = 0;
    t.hi[r] = start + (r0 + r) / group;
  }
  init_state(t, R, dh);
  __syncthreads();
  const int last = min((start + (r0 + R - 1) / group) / block, NB - 1);
  for (int ki = 0; ki <= last; ++ki) {
    load_kv(t, k_pool, v_pool, rows, b, ki, kvh, block, KV, dh);
    __syncthreads();
    accum_block(t, R, block, dh, ki * block, scale);
  }
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int c = rr / group, h = kvh * group + rr % group;
    out[(size_t(c) * H + h) * dh + d] =
        t.acc[i] / fmaxf(t.l[r], 1e-30f);
  }
}

// grid (B, KV, ceil(L * group / kRows)): rows are slot b's (l, g) query
// pairs flattened l-major per KV head; row l*group + g is query head
// kvh*group + g of span offset l, at absolute position pos[b] + l and
// fenced to keys at positions <= pos[b] + l. Each row tile stops at the
// block of its own last row, or at the table's last column: a span past
// the table horizon NB*block (its K/V went to the scratch block) sees
// exactly the NB blocks of the table. pos is read on the device.
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int* __restrict__ pos,
                    const int* __restrict__ tables, float* __restrict__ out,
                    int L, int H, int KV, int dh, int block, int NB,
                    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, group = H / KV;
  const int r0 = blockIdx.z * kRows;
  const int R = min(kRows, L * group - r0);
  const Tile t = carve(smem, R, block, dh);
  const PagedRows rows{tables, NB, block};
  const int p = pos[b];
  const size_t q0 = size_t(b) * L * H;     // row (b, 0, 0) of (B, L, H, dh)
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int l = rr / group, h = kvh * group + rr % group;
    t.q[i] = to_f32(q[(q0 + size_t(l) * H + h) * dh + d]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    t.lo[r] = 0;
    t.hi[r] = p + (r0 + r) / group;
  }
  init_state(t, R, dh);
  __syncthreads();
  const int last = min((p + (r0 + R - 1) / group) / block, NB - 1);
  for (int ki = 0; ki <= last; ++ki) {
    load_kv(t, k_pool, v_pool, rows, b, ki, kvh, block, KV, dh);
    __syncthreads();
    accum_block(t, R, block, dh, ki * block, scale);
  }
  for (int i = threadIdx.x; i < R * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh, rr = r0 + r;
    const int l = rr / group, h = kvh * group + rr % group;
    out[(q0 + size_t(l) * H + h) * dh + d] =
        t.acc[i] / fmaxf(t.l[r], 1e-30f);
  }
}

template <typename Rows>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* pos, Rows rows, void* out, int B, int H,
                  int KV, int dh, int block, int nk, int s_len, int window,
                  float scale, cudaStream_t stream) {
  const size_t bytes = tile_bytes(H / KV, block, dh);
  cudaError_t err = set_smem(decode_kernel<Rows>, bytes);
  if (err != cudaSuccess) return int(err);
  decode_kernel<Rows><<<dim3(B, KV), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(pos), rows,
      static_cast<float*>(out), H, KV, dh, block, nk, s_len, window, scale);
  return int(cudaGetLastError());
}

int launch_prefill(const void* q, const void* k, const void* v,
                   const void* table, void* out, int start, int B, int C,
                   int H, int KV, int dh, int block, int NB, float scale,
                   cudaStream_t stream) {
  const size_t bytes = tile_bytes(kRows, block, dh);
  cudaError_t err = set_smem(chunk_prefill_kernel, bytes);
  if (err != cudaSuccess) return int(err);
  const int tiles = (C * (H / KV) + kRows - 1) / kRows;
  chunk_prefill_kernel<<<dim3(KV, tiles, B), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(table),
      static_cast<float*>(out), start, C, H, KV, dh, block, NB, scale);
  return int(cudaGetLastError());
}

int launch_verify(const void* q, const void* k, const void* v,
                  const void* pos, const void* tables, void* out, int B,
                  int L, int H, int KV, int dh, int block, int NB,
                  float scale, cudaStream_t stream) {
  const size_t bytes = tile_bytes(kRows, block, dh);
  cudaError_t err = set_smem(paged_verify_kernel, bytes);
  if (err != cudaSuccess) return int(err);
  const int tiles = (L * (H / KV) + kRows - 1) / kRows;
  paged_verify_kernel<<<dim3(B, KV, tiles), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(tables), static_cast<float*>(out), L, H, KV,
      dh, block, NB, scale);
  return int(cudaGetLastError());
}

// ------------------------------------------------- bf16, tensor cores

// ring stages: a consumer holds two tiles at once (S of one, P.V of the
// other); prefill's long walks keep two more in flight. Decode's one
// consumer keeps its block small enough for two an SM (Q, the ring and
// the barriers of two blocks within the SM's 228 KB).
constexpr int kPrefillStages = 6;
constexpr int kVerifyStages = 4;
template <int NS>
__host__ __device__ constexpr int decode_stages() {
  return NS == 1 ? 6 : 2;
}
constexpr int kDecodeThreads = paged::threads<1>();

template <int NS>
__global__ void __launch_bounds__(sm90::kThreads, 1)
chunk_prefill_sm90(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const paged::Work w) {
  paged::paged_body<NS, kPrefillStages, 2, paged::PagedLoader<NS>>(
      mq, mk, mv, w);
}

template <int NS>
__global__ void __launch_bounds__(sm90::kThreads, 1)
paged_verify_sm90(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const paged::Work w) {
  paged::paged_body<NS, kVerifyStages, 2, paged::PagedLoader<NS>>(
      mq, mk, mv, w);
}

template <int NS>
__global__ void __launch_bounds__(kDecodeThreads, 2)
paged_decode_sm90(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const paged::Work w) {
  paged::paged_body<NS, decode_stages<NS>(), 1, paged::PagedLoader<NS>>(
      mq, mk, mv, w);
}

template <int NS>
__global__ void __launch_bounds__(kDecodeThreads, 2)
contiguous_decode_sm90(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const paged::Work w) {
  paged::paged_body<NS, decode_stages<NS>(), 1,
                    paged::ContiguousLoader<NS>>(mq, mk, mv, w);
}

// The merges of several splits (paged_sm90.cuh's merge_rows), one name
// each so that a profile tells them apart.
__global__ void __launch_bounds__(128)
verify_merge(const paged::Work w, int B) {
  paged::merge_rows(w, B);
}

__global__ void __launch_bounds__(128)
paged_decode_merge(const paged::Work w, int B) {
  paged::merge_rows(w, B);
}

__global__ void __launch_bounds__(128)
contiguous_decode_merge(const paged::Work w, int B) {
  paged::merge_rows(w, B);
}

// What a bf16 launch computes (paged_sm90.cuh's Work), with the
// workspace cut into acc, then m, then l.
paged::Work make_work(void* out, void* workspace, const void* pos,
                      const void* tables, int start, int B, int n_off,
                      int H, int KV, int dh, int block, int NB, int keys,
                      int splits, int tps, float scale) {
  paged::Work w{};
  w.out = static_cast<__nv_bfloat16*>(out);
  const size_t n_part = size_t(B) * KV * splits * n_off * (H / KV);
  w.part_acc = static_cast<float*>(workspace);
  w.part_m = w.part_acc ? w.part_acc + n_part * dh : nullptr;
  w.part_l = w.part_m ? w.part_m + n_part : nullptr;
  w.pos = static_cast<const int*>(pos);
  w.tables = static_cast<const int*>(tables);
  w.start = start;
  w.n_off = n_off;
  w.H = H;
  w.KV = KV;
  w.dh = dh;
  w.block = block;
  w.NB = NB;
  w.keys = keys;
  w.splits = splits;
  w.tps = tps;
  w.scale_log2 = scale * sm90::kLog2e;
  return w;
}

// A split plan takes every key tile in exactly one split (at most 32: the
// merge's lanes), and a workspace when there are several.
bool splits_ok(int keys, int splits, int tps, const void* workspace) {
  const int tiles = (keys + sm90::kTile - 1) / sm90::kTile;
  return splits >= 1 && splits <= 32 && tps >= 1 &&
         (splits - 1) * tps < tiles && splits * tps >= tiles &&
         (splits == 1 || workspace != nullptr);
}

// The Q map of a launch: (dh, H, n_off, B), a box of 64 / group offsets.
int make_q_map(CUtensorMap* mq, const void* q, int B, const paged::Work& w) {
  const int group = w.H / w.KV;
  return sm90::make_map(mq, q, B, w.n_off, w.H, w.dh, group,
                        sm90::kTile / group);
}

// One launch of a paged tensor-core kernel over B slots of w.n_off
// offsets, and with several splits one of `merge` over their partials.
template <typename K, typename M>
int launch_sm90(K kernel, M merge, int threads, size_t smem,
                const CUtensorMap& mq, const CUtensorMap& mk,
                const CUtensorMap& mv, const paged::Work& w, int B,
                cudaStream_t stream) {
  cudaError_t e = sm90::allow_smem(kernel, smem);
  if (e != cudaSuccess) return int(e);
  const int rows_off = sm90::kTile / (w.H / w.KV);
  const int tiles = (w.n_off + rows_off - 1) / rows_off;
  kernel<<<dim3(w.KV, tiles, B * w.splits), threads, smem, stream>>>(
      mq, mk, mv, w);
  e = cudaGetLastError();
  if (e != cudaSuccess || w.splits == 1) return int(e);
  merge<<<(B * w.n_off * w.H + 3) / 4, 128, 0, stream>>>(w, B);
  return int(cudaGetLastError());
}

// The limits of the tensor-core kernels (the wrappers check them first);
// block 0 stands for the contiguous cache, which has none.
bool sm90_shape_ok(int H, int KV, int dh, int block) {
  return H % KV == 0 && H / KV <= sm90::kTile && dh % 8 == 0 && dh > 0 &&
         dh <= 2 * sm90::kSlab && (block == 0 || paged::block_ok(block));
}

// B chunks at one start: slot b of the paged body is chunk b, its table
// row b, its queries and output rows (b, c) of (B, C, H, dh).
int launch_prefill_sm90(const void* q, const void* k, const void* v,
                        const void* table, void* out, int start, int B,
                        int C, int H, int KV, int dh, int block, int NB,
                        int P, float scale, cudaStream_t stream) {
  const int keys = NB * block;
  const paged::Work w =
      make_work(out, nullptr, nullptr, table, start, B, C, H, KV, dh, block,
                NB, keys, 1, (keys + sm90::kTile - 1) / sm90::kTile, scale);
  CUtensorMap mq, mk, mv;
  int err = make_q_map(&mq, q, B, w);
  if (!err) err = paged::make_pool_map(&mk, k, P, block, KV, dh);
  if (!err) err = paged::make_pool_map(&mv, v, P, block, KV, dh);
  if (err) return err;
  if (dh <= sm90::kSlab)
    return launch_sm90(chunk_prefill_sm90<1>, verify_merge, sm90::kThreads,
                       paged::Smem<1, kPrefillStages>::kBytes, mq, mk, mv, w,
                       B, stream);
  return launch_sm90(chunk_prefill_sm90<2>, verify_merge, sm90::kThreads,
                     paged::Smem<2, kPrefillStages>::kBytes, mq, mk, mv, w,
                     B, stream);
}

int launch_verify_sm90(const void* q, const void* k, const void* v,
                       const void* pos, const void* tables, void* out,
                       void* workspace, int B, int L, int H, int KV, int dh,
                       int block, int NB, int P, int splits, int tps,
                       float scale, cudaStream_t stream) {
  if (!splits_ok(NB * block, splits, tps, workspace))
    return int(cudaErrorInvalidValue);
  const paged::Work w =
      make_work(out, workspace, pos, tables, 0, B, L, H, KV, dh, block, NB,
                NB * block, splits, tps, scale);
  CUtensorMap mq, mk, mv;
  int err = make_q_map(&mq, q, B, w);
  if (!err) err = paged::make_pool_map(&mk, k, P, block, KV, dh);
  if (!err) err = paged::make_pool_map(&mv, v, P, block, KV, dh);
  if (err) return err;
  if (dh <= sm90::kSlab)
    return launch_sm90(paged_verify_sm90<1>, verify_merge, sm90::kThreads,
                       paged::Smem<1, kVerifyStages>::kBytes, mq, mk, mv, w,
                       B, stream);
  return launch_sm90(paged_verify_sm90<2>, verify_merge, sm90::kThreads,
                     paged::Smem<2, kVerifyStages>::kBytes, mq, mk, mv, w,
                     B, stream);
}

// A decode launch at NS slabs, paged or contiguous.
template <int NS>
int launch_decode_slabs(bool paged_kv, const CUtensorMap& mq,
                        const CUtensorMap& mk, const CUtensorMap& mv,
                        const paged::Work& w, int B, cudaStream_t stream) {
  constexpr size_t smem = paged::Smem<NS, decode_stages<NS>()>::kBytes;
  if (paged_kv)
    return launch_sm90(paged_decode_sm90<NS>, paged_decode_merge,
                       kDecodeThreads, smem, mq, mk, mv, w, B, stream);
  return launch_sm90(contiguous_decode_sm90<NS>, contiguous_decode_merge,
                     kDecodeThreads, smem, mq, mk, mv, w, B, stream);
}

// bf16 decode over the maps of either cache: one query row a slot.
int launch_decode_sm90(bool paged_kv, const CUtensorMap& mk,
                       const CUtensorMap& mv, const void* q, const void* pos,
                       const void* tables, void* out, void* workspace, int B,
                       int H, int KV, int dh, int block, int NB, int keys,
                       int splits, int tps, float scale,
                       cudaStream_t stream) {
  const paged::Work w =
      make_work(out, workspace, pos, tables, 0, B, 1, H, KV, dh, block, NB,
                keys, splits, tps, scale);
  CUtensorMap mq;
  const int err = make_q_map(&mq, q, B, w);
  if (err) return err;
  if (dh <= sm90::kSlab)
    return launch_decode_slabs<1>(paged_kv, mq, mk, mv, w, B, stream);
  return launch_decode_slabs<2>(paged_kv, mq, mk, mv, w, B, stream);
}

}  // namespace

// dtype: 0 = float32 (scalar kernels), 1 = bfloat16 (tensor cores, within
// sm90_shape_ok). The entries return the cudaError_t of their launch, or
// sm90::kEncodeError + the CUresult of a failed tensor-map encoding.
//
// The decode entries: bf16 splits each slot's key tiles into `splits` (at
// most 32) ranges of `tps` tiles (decode_splits in decode_attention.py)
// and, with more than one, needs a float32 workspace of B x KV x splits x
// group x (dh + 2) elements. float32 reads neither. P: the pool's pages.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* pos,
                                      const void* tables, void* out,
                                      void* workspace, int dtype, int B,
                                      int H, int KV, int dh, int block,
                                      int NB, int P, int window, int splits,
                                      int tps, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const PagedRows rows{static_cast<const int*>(tables), NB, block};
    return launch_decode(q, k_pool, v_pool, pos, rows, out, B, H, KV, dh,
                         block, NB, NB * block, window, scale, s);
  }
  if (dtype != 1 || !sm90_shape_ok(H, KV, dh, block) ||
      !splits_ok(NB * block, splits, tps, workspace))
    return int(cudaErrorInvalidValue);
  CUtensorMap mk, mv;
  int err = paged::make_pool_map(&mk, k_pool, P, block, KV, dh);
  if (!err) err = paged::make_pool_map(&mv, v_pool, P, block, KV, dh);
  if (err) return err;
  return launch_decode_sm90(true, mk, mv, q, pos, tables, out, workspace, B,
                            H, KV, dh, block, NB, NB * block, splits, tps,
                            scale, s);
}

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, void* out, void* workspace,
                                int dtype, int B, int H, int KV, int dh,
                                int S, int window, int splits, int tps,
                                float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int block = kContiguousBlock;
    const ContiguousRows rows{S, block};
    return launch_decode(q, k, v, pos, rows, out, B, H, KV, dh, block,
                         (S + block - 1) / block, S, window, scale, s);
  }
  if (dtype != 1 || !sm90_shape_ok(H, KV, dh, 0) ||
      !splits_ok(S, splits, tps, workspace))
    return int(cudaErrorInvalidValue);
  CUtensorMap mk, mv;
  int err = sm90::make_map(&mk, k, B, S, KV, dh, 1, sm90::kTile);
  if (!err) err = sm90::make_map(&mv, v, B, S, KV, dh, 1, sm90::kTile);
  if (err) return err;
  return launch_decode_sm90(false, mk, mv, q, pos, nullptr, out, workspace,
                            B, H, KV, dh, 0, 0, S, splits, tps, scale, s);
}

// Chunk prefill of B chunks at one start, table (B, NB): one split, so no
// workspace.
extern "C" int chunk_prefill_attention(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       void* out, int dtype, int start, int B,
                                       int C, int H, int KV, int dh,
                                       int block, int NB, int P, float scale,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B < 1) return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_prefill(q, k_pool, v_pool, table, out, start, B, C, H, KV,
                          dh, block, NB, scale, s);
  if (dtype != 1 || !sm90_shape_ok(H, KV, dh, block))
    return int(cudaErrorInvalidValue);
  return launch_prefill_sm90(q, k_pool, v_pool, table, out, start, B, C, H,
                             KV, dh, block, NB, P, scale, s);
}

// As the decode entries; bf16 splits by verify_splits (decode_attention.py)
// and needs a workspace of B x KV x splits x L x group x (dh + 2) floats
// with more than one split.
extern "C" int paged_verify_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* pos,
                                      const void* tables, void* out,
                                      void* workspace, int dtype, int B,
                                      int L, int H, int KV, int dh,
                                      int block, int NB, int P, int splits,
                                      int tps, float scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_verify(q, k_pool, v_pool, pos, tables, out, B, L, H, KV,
                         dh, block, NB, scale, s);
  if (dtype != 1 || !sm90_shape_ok(H, KV, dh, block))
    return int(cudaErrorInvalidValue);
  return launch_verify_sm90(q, k_pool, v_pool, pos, tables, out, workspace,
                            B, L, H, KV, dh, block, NB, P, splits, tps,
                            scale, s);
}

extern "C" const char* kernel_error_string(int err) {
  return sm90::error_string(err);
}
