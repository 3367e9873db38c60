// K7: block-sparse flash attention, for Hopper (sm_90a).
//
// Replaces the four Pallas kernels of
// deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py, one
// __global__ entry point each (the band forward and the backward two,
// one per body: bf16 at head dims 64 and 128 on the Hopper body, fp32 on
// the WMMA body):
//   bs_fwd_kernel           <- _bs_fwd_kernel (:160), the table forward
//   band_fwd_kernel_sm90,   <- _band_fwd_kernel (:552), the band + global
//   band_fwd_kernel            forward
//   bs_bwd_dkv_kernel_sm90, <- _bs_bwd_dkv_kernel (:229), dK and dV
//   bs_bwd_dkv_kernel
//   bs_bwd_dq_kernel_sm90,  <- _bs_bwd_dq_kernel (:279), dQ
//   bs_bwd_dq_kernel
// They compute attention over [B, T, H, D] restricted to a block layout
// [H, T/block, T/block] (and the causal triangle, element by element,
// when causal), with the online softmax in log2 space as K1/K2 do, and
// write out [B, T, H, D] in the input dtype and lse [B*H, T] (fp32, log2
// space; +inf for a row that sees nothing, so the backward's P is 0).
//
// Bound on the H100: the work scales with the visible score entries, not
// T^2. At the bench shapes (T 16384, H16, D64, bf16, block 256) a
// 64 x 64 tile does 64 flops per byte of K/V it loads, far under the
// card's ~295 balance point: a tile walk that reloads K/V per q tile is
// bound by L2 and latency first, and a fast kernel keeps several q tiles
// on one K/V tile and its loads in flight.
//
// The band forward in bf16 at head dims 64 and 128, the sparse path's,
// runs attention_hopper.cuh's forward body (K1's) over `BandWalk90`:
// 128-row q tiles, two warpgroups of 64 rows sharing each 64-row K/V
// tile, which arrives by TMA in a ring of 4 (D 64) or 2 (D 128) stages;
// wgmma products with the scores and O in registers; masks only on the
// (64-row half, k tile) pairs that hold a hidden score; a half that sees
// nothing of a tile skips its products; two CTAs per SM. Each half's
// visibility is a bit mask of its sub-blocks against the tile's, from
// the closed-form band test and the tile's global bits, computed per
// step on the card. The backward in bf16 at head dims 64 and 128 runs
// K2's two Hopper sweeps (`dkv_body`, `dq_body`) over `TableWalk90`: a
// resident 128-row tile (k tile for dK/dV, q tile for dQ) streams the
// 64-row tiles that either of its halves sees, from the pair tables the
// host builds out of the 64 x 64 tables (`_pair_tables`), one sub-block
// mask per half and step; a half that sees nothing of a step's tile
// skips its products (its warpgroup still waits for the tile). The CTAs
// run longest walk first, in an order the host sorts (the global
// columns' transpose rows list every later q tile: up to T/64 steps). The
// table forward and the fp32 kernels are the first, simple ones: the
// tile bodies of attention_tiles.cuh (WMMA 16x16x16 bf16 with fp32
// accumulation, a CUDA-core fp32 path, no TMA, no wgmma, no pipelining)
// over walks that visit only the visible 64 x 64 tiles.
//
// What the design does about the TPU kernel's shape:
// - The Pallas grid's super-rows (qt layout rows) and head groups (g)
//   amortised grid-step overhead; here every CTA is one (q tile, b*h)
//   and loops over its own visible list, so neither is carried over.
// - Layout blocks of 16 and 32 put several blocks in one 64-row tile: the
//   host tables are built per tile with a bit mask of visible sub-blocks,
//   bit (i * rr + j) for q sub-row i and k sub-column j of the tile (rr =
//   64 / sub-block size; blocks >= 64 give rr = 1 and one bit), the
//   generalisation of the TPU kernel's per-member-row `kmask` bits. The
//   Hopper band walk computes the same bits per 64-row half.
// - The band kernel's host-side gather of the global K/V columns (:703)
//   existed for regular Pallas tiles; here the kernel reads those tiles
//   in place from an index list, in ascending position order with the
//   closed-form band span: globals before the span, the span, globals
//   after it. A global tile inside the span is visited once, as part of
//   the span, so no score is counted twice; causally dead global tiles
//   (first key after the tile's last query) are not visited at all. A
//   128-row q tile walks the union of its halves' spans.
// - The backward is K2's atomic-free two sweeps over the tables: dK/dV
//   per k tile over the transpose table, dQ per q tile over the forward
//   table, after K2's delta pre-pass (rowsum(dO * O)). Every output row
//   has one writer, so a run repeats bit for bit.
#include "attention_hopper.cuh"

namespace {

using namespace attn;

// score (row, col) of a tile pair is visible when its sub-block's bit
// is set and, if causal, the key does not follow the query
struct MaskVis {
  int bits, sub_shift, rr, q0, k0, causal;
  __device__ __forceinline__ bool operator()(int row, int col) const {
    return ((bits >> ((row >> sub_shift) * rr + (col >> sub_shift))) & 1) &&
           (!causal || k0 + col <= q0 + row);
  }
};

// one row of a visible-tile table: tiles idx[0 .. n) with their masks
struct TableWalk {
  const int* idx;
  const int* mask;
  int n, sub_shift, rr, causal;
  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int tile(int s) const { return idx[s]; }
  __device__ __forceinline__ MaskVis vis(int s, int q0, int k0) const {
    return MaskVis{mask[s], sub_shift, rr, q0, k0, causal};
  }
};

// the table row of (head h of unique layout head_map[h], tile)
__device__ __forceinline__ TableWalk table_row(const int* head_map,
                                               const int* idx,
                                               const int* cnt,
                                               const int* mask, int maxn,
                                               int heads, int bh, int tile,
                                               int nt, int sub_shift, int rr,
                                               int causal) {
  const long long row =
      static_cast<long long>(head_map[bh % heads]) * nt + tile;
  return TableWalk{idx + row * maxn, mask + row * maxn, cnt[row], sub_shift,
                   rr, causal};
}

// The band + global layout of `_band_decompose`: key block kb is visible
// from query block qb when it lies in the band (sliding: |kb - qb| < w,
// only kb <= qb when causal; aligned: the same w-block window) or is a
// global column; causal masks element by element.
struct BandVis {
  int q0, k0, bshift, w, aligned, causal, in_band, gbits, sub_shift;
  __device__ __forceinline__ bool operator()(int row, int col) const {
    const int qp = q0 + row, kp = k0 + col;
    if (causal && kp > qp) return false;
    if ((gbits >> (col >> sub_shift)) & 1) return true;
    if (!in_band) return false;
    const int qb = qp >> bshift, kb = kp >> bshift;
    if (aligned) return kb / w == qb / w;
    return kb >= qb - (w - 1) && kb <= qb + (w - 1);
  }
};

// The walk of q tile qt in the band kernel, ascending in position:
// global tiles before the band span [lo, hi], the span, global tiles
// after it (causal: only those at or before the diagonal). gtiles lists
// the tiles holding a global column, ascending; gbits[kt] marks the
// global sub-blocks of tile kt.
struct BandWalk {
  const int* gtiles;
  const int* gbits;
  int lo, nband, a, b, bshift, w, aligned, causal, sub_shift, n;

  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int tile(int s) const {
    if (s < a) return gtiles[s];
    if (s < a + nband) return lo + (s - a);
    return gtiles[b + (s - a - nband)];
  }
  __device__ __forceinline__ BandVis vis(int s, int q0, int k0) const {
    const int in_band = s >= a && s < a + nband;
    return BandVis{q0, k0, bshift, w, aligned, causal, in_band,
                   gbits[k0 / kB], sub_shift};
  }
};

__device__ __forceinline__ BandWalk band_walk(int qt, int nb, int bshift,
                                              int w, int aligned, int causal,
                                              const int* gtiles, int ng,
                                              const int* gbits,
                                              int sub_shift) {
  // the band span in layout blocks, then in tiles (as _band_walks)
  const int qb_lo = (qt * kB) >> bshift;
  const int qb_hi = (qt * kB + kB - 1) >> bshift;
  int kb_lo, kb_hi;
  if (aligned) {
    kb_lo = qb_lo / w * w;
    kb_hi = qb_hi / w * w + w - 1;
  } else {
    kb_lo = qb_lo - (w - 1);
    kb_hi = qb_hi + (w - 1);
  }
  if (causal) kb_hi = min(kb_hi, qb_hi);
  kb_lo = max(kb_lo, 0);
  kb_hi = min(kb_hi, nb - 1);
  const int lo = (kb_lo << bshift) / kB;
  int hi = (((kb_hi + 1) << bshift) - 1) / kB;
  if (causal) hi = min(hi, qt);
  int a = 0, b = 0, c = 0;
  for (int i = 0; i < ng; ++i) {
    const int g = gtiles[i];
    a += g < lo;
    b += g <= hi;
    c += !causal || g <= qt;
  }
  const int nband = hi - lo + 1;
  return BandWalk{gtiles, gbits, lo, nband, a, b, bshift, w, aligned,
                  causal, sub_shift, a + nband + (c - b)};
}

// The band walk of the Hopper body: 128-row q tile qt over 64-row k
// tiles, in BandWalk's order over the union of the two 64-row halves'
// spans. The CTA lays the walk out in shared memory before it starts
// (`band_walk90`), so the loop holds only a pointer and reads one word
// per step and half: steps[s] the k tile of step s, steps[nmax + s] and
// steps[2 nmax + s] the sub-block bits of the two halves against it, bit
// (i * rr + j) set when sub-block row i of the half sees sub-block column
// j of the tile (a global column or the band) and does not lie wholly
// after it (causal). `partial`, `empty` and `vis` of a half come from its
// bits; a half past the sequence's end (the last tile of a T that is no
// multiple of 128) has none.
struct BandWalk90 {
  const int* steps;
  int n, nmax, q_first, sub_shift, causal;

  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int tile(int s) const { return steps[s]; }
  __device__ __forceinline__ int bits(int s, int q0) const {
    return steps[(q0 == q_first ? 1 : 2) * nmax + s];
  }
  __device__ __forceinline__ MaskVis vis(int s, int q0, int k0) const {
    return MaskVis{bits(s, q0), sub_shift, sm90::kStep >> sub_shift, q0, k0,
                   causal};
  }
  __device__ __forceinline__ bool partial(int s, int q0, int, int k0,
                                          int nk) const {
    const int rr = sm90::kStep >> sub_shift;
    return bits(s, q0) != (1 << (rr * rr)) - 1 ||
           (causal && k0 + nk - 1 > q0);
  }
  __device__ __forceinline__ bool empty(int s, int q0, int, int) const {
    return bits(s, q0) == 0;
  }
};

// the sub-block bits of the 64-row half at q0 against the k tile at k0
__device__ __forceinline__ int band_bits(int q0, int k0, int g, int bshift,
                                         int w, int aligned, int causal,
                                         int sub_shift) {
  const int sub = 1 << sub_shift, rr = sm90::kStep >> sub_shift;
  int out = 0;
  for (int i = 0; i < rr; ++i)
    for (int j = 0; j < rr; ++j) {
      const int qb = (q0 + i * sub) >> bshift, kb = (k0 + j * sub) >> bshift;
      const bool band = aligned ? kb / w == qb / w
                                : kb >= qb - (w - 1) && kb <= qb + (w - 1);
      const bool v = (((g >> j) & 1) || band) &&
                     !(causal && k0 + j * sub > q0 + i * sub + sub - 1);
      out |= static_cast<int>(v) << (i * rr + j);
    }
  return out;
}

// Lays out the walk of q tile qt in `steps` ([3][nmax] in shared memory,
// each thread a share of the steps; the forward body's first barrier
// publishes them) and returns it. The span and the global tiles before
// and after it are BandWalk's, over the rows of both halves; a walk
// longer than the host's nmax (the longest `_band_walks` row) traps.
__device__ __forceinline__ BandWalk90 band_walk90(
    int* steps, int nmax, int qt, int seq, int bshift, int w, int aligned,
    int causal, const int* gtiles, int ng, const int* gbits, int sub_shift) {
  constexpr int kQ = sm90::kRows, kK = sm90::kStep;
  const int nb = seq >> bshift;
  const int qb_lo = (qt * kQ) >> bshift;
  const int qb_hi = (qt * kQ + kQ - 1) >> bshift;
  int kb_lo, kb_hi;
  if (aligned) {
    kb_lo = qb_lo / w * w;
    kb_hi = qb_hi / w * w + w - 1;
  } else {
    kb_lo = qb_lo - (w - 1);
    kb_hi = qb_hi + (w - 1);
  }
  if (causal) kb_hi = min(kb_hi, qb_hi);
  kb_lo = max(kb_lo, 0);
  kb_hi = min(kb_hi, nb - 1);
  const int lo = (kb_lo << bshift) / kK;
  int hi = (((kb_hi + 1) << bshift) - 1) / kK;
  const int last = (qt * kQ + kQ - 1) / kK;  // the k tile of the last row
  if (causal) hi = min(hi, last);
  int a = 0, b = 0, c = 0;
  for (int i = 0; i < ng; ++i) {
    const int g = gtiles[i];
    a += g < lo;
    b += g <= hi;
    c += !causal || g <= last;
  }
  const int nband = hi - lo + 1, n = a + nband + (c - b);
  if (n > nmax) __trap();
  const int q0 = qt * kQ;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int t = s < a           ? gtiles[s]
                  : s < a + nband ? lo + (s - a)
                                  : gtiles[b + (s - a - nband)];
    steps[s] = t;
    steps[nmax + s] = band_bits(q0, t * kK, gbits[t], bshift, w, aligned,
                                causal, sub_shift);
    steps[2 * nmax + s] =
        q0 + kK < seq ? band_bits(q0 + kK, t * kK, gbits[t], bshift, w,
                                  aligned, causal, sub_shift)
                      : 0;
  }
  return BandWalk90{steps, n, nmax, q0, sub_shift, causal};
}

// The visibility of one (64-row half, 64-row tile) pair of a table walk
// to one thread: bit e for element e of its 32-score accumulator (rows
// 16 warp + lane / 4 + 8 ((e / 2) % 2), columns 8 (e / 4) + 2 (lane % 4)
// + e % 2; attention_hopper.cuh's layout). The sweeps take it before
// their products, so one register of it lives across them instead of the
// pair's bits, sub-block size and positions: the D 64 dQ sweep runs at
// 128 registers, which the dense sweep's scores and accumulators fill.
struct HalfMask {
  unsigned m;
};

// sm90::hide and sm90::hide_t for a HalfMask: hidden scores to -inf
template <int R>
__device__ __forceinline__ void hide(float (&s)[R], HalfMask v, int, int) {
  static_assert(R == 32, "one mask bit per accumulator element");
#pragma unroll
  for (int e = 0; e < R; ++e)
    if (!((v.m >> e) & 1)) s[e] = sm90::neg_inf();
}
template <int R>
__device__ __forceinline__ void hide_t(float (&s)[R], HalfMask v, int w,
                                       int l) {
  hide(s, v, w, l);
}

// The mask of the pair whose word is w (`TableWalk90`) at positions (q0,
// k0): sub-block bit (i * rr + j) for q sub-row i and k sub-column j,
// and, causally, keys at or before the query. kKeys: the accumulator's
// rows are keys and its columns queries (dK/dV), else the reverse (dQ).
template <bool kKeys>
__device__ __forceinline__ unsigned half_mask(int w, int q0, int k0) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int bits = w & 0xffff, sub_shift = (w >> 16) & 15;
  const int rr = sm90::kStep >> sub_shift, causal = (w >> 21) & 1;
  unsigned m = 0;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int a = warp * 16 + lane / 4 + 8 * ((e / 2) % 2);
    const int c = 8 * (e / 4) + 2 * (lane % 4) + e % 2;
    const int row = kKeys ? c : a, col = kKeys ? a : c;  // query, key
    const bool v =
        ((bits >> ((row >> sub_shift) * rr + (col >> sub_shift))) & 1) &&
        (!causal || k0 + col <= q0 + row);
    m |= static_cast<unsigned>(v) << e;
  }
  return m;
}

// The walk of the Hopper backward sweeps: one row of a pair table
// (`_pair_tables`), 64-row streamed tiles past a 128-row resident one.
// The CTA copies its row into shared memory at byte kAt before it starts
// (`table_walk90`), three words per step s: the streamed tile, then one
// word per 64-row half of the resident tile, which packs the half's
// sub-block bits against the tile (bits 0-15, MaskVis's meaning: bit
// (i * rr + j) for q sub-row i and k sub-column j), sub_shift (bits
// 16-19), whether the pair holds a hidden score (bit 20: a bit unset, or
// the causal diagonal crosses it) and causal (bit 21). In registers the
// walk keeps only its count: the sweeps at D 64 run two CTAs per SM, 128
// registers a thread, and the dense sweeps use them all, so everything
// else is read from shared memory where it is used. `partial`, `empty`
// and `vis` key on the resident half: the k half k0 when the resident
// tile holds keys (kKeys: dK/dV over the transpose table), the q half q0
// when it holds queries (dQ over the forward table); the resident tile
// starts at a multiple of 128 rows, so bit 6 of the half's first row
// names it. A half with bits 0 (its 64-row table row does not list the
// tile, or it lies past T) skips the step.
template <bool kKeys, size_t kAt>
struct TableWalk90 {
  int n;

  static __device__ __forceinline__ const int* at() {
    return reinterpret_cast<const int*>(hopper::smem_base() + kAt);
  }
  // the resident half's word of step s
  __device__ __forceinline__ int word(int s, int q0, int k0) const {
    return at()[1 + 3 * s + (((kKeys ? k0 : q0) >> 6) & 1)];
  }
  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int tile(int s) const { return at()[3 * s]; }
  // the thread's mask of the pair, worked out only where it hides a
  // score; the empty asm pins the work before the sweep's products
  __device__ __forceinline__ HalfMask vis(int s, int q0, int k0) const {
    const int w = word(s, q0, k0);
    unsigned m = ~0u;
    if ((w >> 20) & 1) m = half_mask<kKeys>(w, q0, k0);
    asm volatile("" : "+r"(m));
    return HalfMask{m};
  }
  __device__ __forceinline__ bool partial(int s, int q0, int, int k0,
                                          int) const {
    return (word(s, q0, k0) >> 20) & 1;
  }
  __device__ __forceinline__ bool empty(int s, int q0, int, int k0) const {
    return (word(s, q0, k0) & 0xffff) == 0;
  }
};

// Copies pair-table row `row` (table [rows][3][nmax], count [rows]) into
// shared memory at kAt ([nmax][3] words, each thread a share; the
// sweep's first barrier publishes them), packing each half's word, and
// returns its walk; `first` is the resident tile's first row.
template <bool kKeys, size_t kAt>
__device__ __forceinline__ TableWalk90<kKeys, kAt> table_walk90(
    const int* __restrict__ table, const int* __restrict__ count,
    long long row, int nmax, int first, int sub_shift, int causal) {
  int* steps = reinterpret_cast<int*>(hopper::smem_base() + kAt);
  const int n = count[row];
  const int* src = table + row * 3 * nmax;
  const int rr = sm90::kStep >> sub_shift, full = (1 << (rr * rr)) - 1;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int t = src[s];
    steps[3 * s] = t;
    for (int half = 0; half < 2; ++half) {
      const int bits = src[(1 + half) * nmax + s];
      const int r0 = first + half * sm90::kStep, o0 = t * sm90::kStep;
      const int q0 = kKeys ? o0 : r0, k0 = kKeys ? r0 : o0;
      const bool hidden =
          bits != full || (causal && k0 + sm90::kStep - 1 > q0);
      steps[3 * s + 1 + half] = bits | sub_shift << 16 |
                                static_cast<int>(hidden) << 20 |
                                (causal != 0) << 21;
    }
  }
  return TableWalk90<kKeys, kAt>{n};
}

// The CTA's head h, b*h and resident tile in the host's order of (head,
// tile) pairs, longest walk first (`_longest_first`), the batch element
// fastest: CTA i takes pair order[i / batch] of batch element i % batch.
__device__ __forceinline__ void table_order(const int* __restrict__ order,
                                            int nt, int heads, int& h,
                                            int& bh, int& tile) {
  const int batch = gridDim.x / (nt * heads);
  const int pair = order[blockIdx.x / batch];
  h = pair / nt;
  tile = pair % nt;
  bh = (blockIdx.x % batch) * heads + h;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bs_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int seq, int heads, Strides st,
              float scale_log2, int causal, const int* __restrict__ head_map,
              const int* __restrict__ kidx, const int* __restrict__ kcnt,
              const int* __restrict__ kmask, int kmax, int sub_shift,
              int rr) {
  const int qt = blockIdx.x, bh = blockIdx.y;
  const TableWalk walk = table_row(head_map, kidx, kcnt, kmask, kmax, heads,
                                   bh, qt, seq / kB, sub_shift, rr, causal);
  fwd_body<T, D>(q, k, v, out, lse, seq, heads, st, scale_log2, qt, bh,
                 walk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
band_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out,
                float* __restrict__ lse, int seq, int heads, Strides st,
                float scale_log2, int causal, int bshift, int w, int aligned,
                const int* __restrict__ gtiles, int ng,
                const int* __restrict__ gbits, int sub_shift) {
  const int qt = blockIdx.x, bh = blockIdx.y;
  const BandWalk walk = band_walk(qt, seq >> bshift, bshift, w, aligned,
                                  causal, gtiles, ng, gbits, sub_shift);
  fwd_body<T, D>(q, k, v, out, lse, seq, heads, st, scale_log2, qt, bh,
                 walk);
}

// The Hopper band kernel's shared memory: the forward body's, then the
// walk's [3][nmax] words. Two CTAs per SM at D 64; one at D 128, where
// the walk's pointer and counts would push the body's registers past the
// 128 of two CTAs
template <int D>
struct BandCfg90 {
  using F = sm90::FwdCfg<D>;
  static constexpr size_t walk = (F::bar + 8 + F::R::bytes + 15) / 16 * 16;
  static constexpr int kBlocks = D == 64 ? 2 : 1;
  static size_t bytes(int nmax) { return walk + 12 * size_t(nmax) + 1024; }
};

// bf16 at D 64 and 128: one CTA per (b*h, 128-row q tile), in
// `GridOrder`'s order (longest causal walks first)
template <int D>
__global__ void __launch_bounds__(sm90::kThreads, BandCfg90<D>::kBlocks)
band_fwd_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     bf16* __restrict__ out, float* __restrict__ lse,
                     int seq, int heads, float scale_log2, int causal,
                     int bshift, int w, int aligned,
                     const int* __restrict__ gtiles, int ng,
                     const int* __restrict__ gbits, int sub_shift, int nmax,
                     sm90::GridOrder order) {
  const int nt = (seq + sm90::kRows - 1) / sm90::kRows;
  int bh, rank;
  order.at(nt, bh, rank);
  const int qt = nt - 1 - rank;
  int* steps =
      reinterpret_cast<int*>(hopper::smem_base() + BandCfg90<D>::walk);
  const BandWalk90 walk =
      band_walk90(steps, nmax, qt, seq, bshift, w, aligned, causal, gtiles,
                  ng, gbits, sub_shift);
  sm90::fwd_body<D, false>(mq, mk, mv, out, lse, seq, heads, scale_log2, qt,
                           bh, walk, MergeIn{});
}

// The Hopper table forward's shared memory: the forward body's, then the
// walk's 3 nmax words (TableWalk90's layout; nmax <= 512, the host's
// bound). Two CTAs per SM at D 64; one at D 128, where the 128 registers
// of two spill the scores and O (`kernel_variants.py sparse_fwd` times
// two there)
template <int D>
struct FwdTableCfg90 {
  using F = sm90::FwdCfg<D>;
  static constexpr size_t walk = (F::bar + 8 + F::R::bytes + 15) / 16 * 16;
  static constexpr int kBlocks = D == 64 ? 2 : 1;
  static size_t bytes(int nmax) { return walk + 12 * size_t(nmax) + 1024; }
};

// bf16 at D 64 and 128: one CTA per (b*h, 128-row q tile) over the
// forward pair table, in `table_order`'s order (longest walk first)
template <int D>
__global__ void __launch_bounds__(sm90::kThreads, FwdTableCfg90<D>::kBlocks)
bs_fwd_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   bf16* __restrict__ out, float* __restrict__ lse, int seq,
                   int heads, float scale_log2, int causal,
                   const int* __restrict__ head_map,
                   const int* __restrict__ table,
                   const int* __restrict__ count,
                   const int* __restrict__ order, int nmax, int sub_shift) {
  const int nt = (seq + sm90::kRows - 1) / sm90::kRows;
  int h, bh, qt;
  table_order(order, nt, heads, h, bh, qt);
  const auto walk = table_walk90<false, FwdTableCfg90<D>::walk>(
      table, count, static_cast<long long>(head_map[h]) * nt + qt, nmax,
      qt * sm90::kRows, sub_shift, causal);
  sm90::fwd_body<D, false>(mq, mk, mv, out, lse, seq, heads, scale_log2, qt,
                           bh, walk, MergeIn{});
}

// The Hopper backward kernels' shared memory: the sweep's, then the
// walk's 3 nmax words (nmax <= 512, the host's bound: 6 KB)
template <int D>
struct TableCfg90 {
  using C = sm90::BwdCfg<D>;
  static constexpr size_t walk = (C::bar + 8 + C::R::bytes + 15) / 16 * 16;
  static size_t bytes(int nmax) { return walk + 12 * size_t(nmax) + 1024; }
};

// bf16 at D 64 and 128: one CTA per (b*h, 128-row k tile) over the
// transpose pair table (`table_order`'s order)
template <int D>
__global__ void __launch_bounds__(sm90::kThreads,
                                  sm90::BwdCfg<D>::kDkvBlocks)
bs_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       int seq, int heads, float scale_log2, float sm_scale,
                       int causal, const int* __restrict__ head_map,
                       const int* __restrict__ table,
                       const int* __restrict__ count,
                       const int* __restrict__ order, int nmax,
                       int sub_shift) {
  const int nt = (seq + sm90::kRows - 1) / sm90::kRows;
  int h, bh, kt;
  table_order(order, nt, heads, h, bh, kt);
  const auto walk = table_walk90<true, TableCfg90<D>::walk>(
      table, count, static_cast<long long>(head_map[h]) * nt + kt, nmax,
      kt * sm90::kRows, sub_shift, causal);
  sm90::dkv_body<D>(mq, mk, mv, mdo, lse, delta, dk, dv, seq, heads,
                    scale_log2, sm_scale, kt, bh, walk);
}

// one CTA per (b*h, 128-row q tile) over the forward pair table
template <int D>
__global__ void __launch_bounds__(sm90::kThreads, sm90::BwdCfg<D>::kDqBlocks)
bs_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      int seq, int heads, float scale_log2, float sm_scale,
                      int causal, const int* __restrict__ head_map,
                      const int* __restrict__ table,
                      const int* __restrict__ count,
                      const int* __restrict__ order, int nmax,
                      int sub_shift) {
  const int nt = (seq + sm90::kRows - 1) / sm90::kRows;
  int h, bh, qt;
  table_order(order, nt, heads, h, bh, qt);
  const auto walk = table_walk90<false, TableCfg90<D>::walk>(
      table, count, static_cast<long long>(head_map[h]) * nt + qt, nmax,
      qt * sm90::kRows, sub_shift, causal);
  sm90::dq_body<D>(mq, mk, mv, mdo, lse, delta, dq, seq, heads, scale_log2,
                   sm_scale, qt, bh, walk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bs_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int seq, int heads, Strides st,
                  float scale_log2, float sm_scale, int causal,
                  const int* __restrict__ head_map,
                  const int* __restrict__ qidx, const int* __restrict__ qcnt,
                  const int* __restrict__ qmask, int qmax, int sub_shift,
                  int rr) {
  const int kt = blockIdx.x, bh = blockIdx.y;
  const TableWalk walk = table_row(head_map, qidx, qcnt, qmask, qmax, heads,
                                   bh, kt, seq / kB, sub_shift, rr, causal);
  dkv_body<T, D>(q, k, v, dout, lse, delta, dk, dv, seq, heads, st,
                 scale_log2, sm_scale, kt, bh, walk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bs_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq,
                 int seq, int heads, Strides st, float scale_log2,
                 float sm_scale, int causal, const int* __restrict__ head_map,
                 const int* __restrict__ kidx, const int* __restrict__ kcnt,
                 const int* __restrict__ kmask, int kmax, int sub_shift,
                 int rr) {
  const int qt = blockIdx.x, bh = blockIdx.y;
  const TableWalk walk = table_row(head_map, kidx, kcnt, kmask, kmax, heads,
                                   bh, qt, seq / kB, sub_shift, rr, causal);
  dq_body<T, D>(q, k, v, dout, lse, delta, dq, seq, heads, st, scale_log2,
                sm_scale, qt, bh, walk);
}

Strides strides_of(const long long* s, bool with_dout) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                 with_dout ? s[12] : 0, with_dout ? s[13] : 0,
                 with_dout ? s[14] : 0};
}

// a table: head_map [H], idx/mask [U * nt * maxn], cnt [U * nt]
struct Table {
  const int* head_map;
  const int* idx;
  const int* cnt;
  const int* mask;
  int maxn;
};

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int batch, int seq, int heads,
               const long long* s, float scale_log2, int causal, Table tab,
               int sub_shift, int rr, cudaStream_t stream) {
  auto kern = bs_fwd_kernel<T, D>;
  allow_smem(kern, FwdLayout<T, D>::bytes);
  dim3 grid(seq / kB, batch * heads);
  kern<<<grid, kThreads, FwdLayout<T, D>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, seq, heads,
      strides_of(s, false), scale_log2, causal, tab.head_map, tab.idx,
      tab.cnt, tab.mask, tab.maxn, sub_shift, rr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_band(const void* q, const void* k, const void* v, void* out,
                float* lse, int batch, int seq, int heads,
                const long long* s, float scale_log2, int causal, int bshift,
                int w, int aligned, const int* gtiles, int ng,
                const int* gbits, int sub_shift, cudaStream_t stream) {
  auto kern = band_fwd_kernel<T, D>;
  allow_smem(kern, FwdLayout<T, D>::bytes);
  dim3 grid(seq / kB, batch * heads);
  kern<<<grid, kThreads, FwdLayout<T, D>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, seq, heads,
      strides_of(s, false), scale_log2, causal, bshift, w, aligned, gtiles,
      ng, gbits, sub_shift);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_band_sm90(const void* q, const void* k, const void* v, void* out,
                     float* lse, int batch, int seq, int heads,
                     const long long* s, float scale_log2, int causal,
                     int bshift, int w, int aligned, const int* gtiles,
                     int ng, const int* gbits, int sub_shift, int nmax,
                     cudaStream_t stream) {
  using L = sm90::FwdCfg<D>;
  CUtensorMap mq, mk, mv;
  if (sm90::make_map(&mq, q, batch, seq, heads, D, s[0], s[1], s[2],
                     sm90::kRows) ||
      sm90::make_map(&mk, k, batch, seq, heads, D, s[3], s[4], s[5],
                     L::kN) ||
      sm90::make_map(&mv, v, batch, seq, heads, D, s[6], s[7], s[8], L::kN))
    return sm90::kMapError;
  auto kern = band_fwd_kernel_sm90<D>;
  const size_t bytes = BandCfg90<D>::bytes(nmax);
  allow_smem(kern, bytes);
  const long long nt = (seq + sm90::kRows - 1) / sm90::kRows;
  kern<<<static_cast<unsigned>(nt * batch * heads), sm90::kThreads, bytes,
         stream>>>(mq, mk, mv, static_cast<bf16*>(out), lse, seq, heads,
                   scale_log2, causal, bshift, w, aligned, gtiles, ng, gbits,
                   sub_shift, nmax,
                   sm90::grid_order(static_cast<long long>(batch) * heads,
                                    seq, D));
  return static_cast<int>(cudaGetLastError());
}

// a pair table: head_map [H], steps [U * nt * 3 * nmax], count [U * nt],
// order [H * nt] (nt the 128-row tiles)
struct PairTable {
  const int* head_map;
  const int* steps;
  const int* count;
  const int* order;
  int nmax;
};

unsigned pair_grid(int batch, int seq, int heads) {
  return static_cast<unsigned>(static_cast<long long>(seq + sm90::kRows - 1) /
                               sm90::kRows * batch * heads);
}

template <int D>
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                    float* lse, int batch, int seq, int heads,
                    const long long* s, float scale_log2, int causal,
                    PairTable tab, int sub_shift, cudaStream_t stream) {
  using L = sm90::FwdCfg<D>;
  CUtensorMap mq, mk, mv;
  if (sm90::make_map(&mq, q, batch, seq, heads, D, s[0], s[1], s[2],
                     sm90::kRows) ||
      sm90::make_map(&mk, k, batch, seq, heads, D, s[3], s[4], s[5],
                     L::kN) ||
      sm90::make_map(&mv, v, batch, seq, heads, D, s[6], s[7], s[8], L::kN))
    return sm90::kMapError;
  auto kern = bs_fwd_kernel_sm90<D>;
  const size_t bytes = FwdTableCfg90<D>::bytes(tab.nmax);
  allow_smem(kern, bytes);
  kern<<<pair_grid(batch, seq, heads), sm90::kThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), lse, seq, heads, scale_log2,
      causal, tab.head_map, tab.steps, tab.count, tab.order, tab.nmax,
      sub_shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dk,
               void* dv, int batch, int seq, int heads, const long long* s,
               float scale_log2, float sm_scale, int causal, Table tab,
               int sub_shift, int rr, cudaStream_t stream) {
  launch_delta<T, D>(out, dout, nullptr, delta, batch, seq, heads, s + 9,
                     s + 12, stream);
  auto kern = bs_bwd_dkv_kernel<T, D>;
  allow_smem(kern, BwdLayout<T, D>::bytes);
  dim3 grid(seq / kB, batch * heads);
  kern<<<grid, kThreads, BwdLayout<T, D>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), seq, heads,
      strides_of(s, true), scale_log2, sm_scale, causal, tab.head_map,
      tab.idx, tab.cnt, tab.mask, tab.maxn, sub_shift, rr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int batch,
              int seq, int heads, const long long* s, float scale_log2,
              float sm_scale, int causal, Table tab, int sub_shift, int rr,
              cudaStream_t stream) {
  auto kern = bs_bwd_dq_kernel<T, D>;
  allow_smem(kern, BwdLayout<T, D>::bytes);
  dim3 grid(seq / kB, batch * heads);
  kern<<<grid, kThreads, BwdLayout<T, D>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), seq, heads, strides_of(s, true), scale_log2,
      sm_scale, causal, tab.head_map, tab.idx, tab.cnt, tab.mask, tab.maxn,
      sub_shift, rr);
  return static_cast<int>(cudaGetLastError());
}

// resident (kRows) and streamed (kStep) maps of q, k, v and dO, through
// the caller's strides (s: q, k, v, out, dout)
template <int D>
int bwd_maps(CUtensorMap (&res)[4], CUtensorMap (&str)[4], const void* q,
             const void* k, const void* v, const void* dout, int batch,
             int seq, int heads, const long long* s) {
  const void* ptr[4] = {q, k, v, dout};
  const long long* st[4] = {s, s + 3, s + 6, s + 12};
  for (int i = 0; i < 4; ++i)
    if (sm90::make_map(&res[i], ptr[i], batch, seq, heads, D, st[i][0],
                       st[i][1], st[i][2], sm90::kRows) ||
        sm90::make_map(&str[i], ptr[i], batch, seq, heads, D, st[i][0],
                       st[i][1], st[i][2], sm90::kStep))
      return sm90::kMapError;
  return 0;
}

template <int D>
int launch_dkv_sm90(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const float* lse,
                    float* delta, void* dk, void* dv, int batch, int seq,
                    int heads, const long long* s, float scale_log2,
                    float sm_scale, int causal, PairTable tab, int sub_shift,
                    cudaStream_t stream) {
  CUtensorMap res[4], str[4];
  if (bwd_maps<D>(res, str, q, k, v, dout, batch, seq, heads, s))
    return sm90::kMapError;
  launch_delta<bf16, D>(out, dout, nullptr, delta, batch, seq, heads, s + 9,
                        s + 12, stream);
  auto kern = bs_bwd_dkv_kernel_sm90<D>;
  const size_t bytes = TableCfg90<D>::bytes(tab.nmax);
  allow_smem(kern, bytes);
  kern<<<pair_grid(batch, seq, heads), sm90::kThreads, bytes, stream>>>(
      str[0], res[1], res[2], str[3], lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), seq, heads, scale_log2, sm_scale, causal,
      tab.head_map, tab.steps, tab.count, tab.order, tab.nmax, sub_shift);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int batch, int seq, int heads,
                   const long long* s, float scale_log2, float sm_scale,
                   int causal, PairTable tab, int sub_shift,
                   cudaStream_t stream) {
  CUtensorMap res[4], str[4];
  if (bwd_maps<D>(res, str, q, k, v, dout, batch, seq, heads, s))
    return sm90::kMapError;
  auto kern = bs_bwd_dq_kernel_sm90<D>;
  const size_t bytes = TableCfg90<D>::bytes(tab.nmax);
  allow_smem(kern, bytes);
  kern<<<pair_grid(batch, seq, heads), sm90::kThreads, bytes, stream>>>(
      res[0], str[1], str[2], res[3], lse, delta, static_cast<bf16*>(dq),
      seq, heads, scale_log2, sm_scale, causal, tab.head_map, tab.steps,
      tab.count, tab.order, tab.nmax, sub_shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point instantiates its launcher for (T, D) from dtype (0 =
// float32, 1 = bfloat16) and head_dim (64 or 128), and returns
// cudaGetLastError(), or -1 for an unsupported pair.
#define DS_DISPATCH(dtype, head_dim, LAUNCH, ...)                       \
  if ((dtype) == 1 && (head_dim) == 64) return LAUNCH<bf16, 64>(__VA_ARGS__); \
  if ((dtype) == 1 && (head_dim) == 128)                                \
    return LAUNCH<bf16, 128>(__VA_ARGS__);                              \
  if ((dtype) == 0 && (head_dim) == 64)                                 \
    return LAUNCH<float, 64>(__VA_ARGS__);                              \
  if ((dtype) == 0 && (head_dim) == 128)                                \
    return LAUNCH<float, 128>(__VA_ARGS__);                             \
  return -1

// Strides are in elements, (b, t, h) of q, k, v (9 values) for the
// forwards, of q, k, v, out, dout (15 values) for the backwards; every
// head dim is contiguous. out, dq, dk, dv are contiguous [B, T, H, D];
// lse and delta [B*H, T] fp32. Tables (int32, on the device): head_map
// [H] -> unique layout u; idx/mask [U, T/64, maxn] and cnt [U, T/64],
// the forward table (visible k tiles per q tile) for the forward and dQ,
// the transpose table (visible q tiles per k tile) for dK/dV; mask bit
// (i * rr + j) for q sub-row i and k sub-column j of 2^sub_shift rows.
extern "C" int ds_bs_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, float* lse, int batch, int seq,
                              int heads, int head_dim,
                              const long long* strides, float scale_log2,
                              int causal, const int* head_map,
                              const int* kidx, const int* kcnt,
                              const int* kmask, int kmax, int sub_shift,
                              int rr, int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (batch * seq == 0) return 0;
  const Table tab{head_map, kidx, kcnt, kmask, kmax};
  DS_DISPATCH(dtype, head_dim, launch_fwd, q, k, v, out, lse, batch, seq,
              heads, strides, scale_log2, causal, tab, sub_shift, rr,
              static_cast<cudaStream_t>(stream));
}

// K7-fwd on the Hopper body (bf16 at head dims 64 and 128; -1 for any
// other pair): the arguments of ds_bs_attn_fwd with the forward pair
// table in place of the 64-row one (as ds_bs_attn_bwd_dq_sm90 takes it):
// steps [U, nt, 3, nmax], count [U, nt] and order [H * nt].
extern "C" int ds_bs_attn_fwd_sm90(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int batch, int seq, int heads,
                                   int head_dim, const long long* strides,
                                   float scale_log2, int causal,
                                   const int* head_map, const int* steps,
                                   const int* count, const int* order,
                                   int nmax, int sub_shift, int dtype,
                                   int device, void* stream) {
  cudaSetDevice(device);
  if (batch * seq == 0) return 0;
  const PairTable tab{head_map, steps, count, order, nmax};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 64)
    return launch_fwd_sm90<64>(q, k, v, out, lse, batch, seq, heads, strides,
                               scale_log2, causal, tab, sub_shift, s);
  if (dtype == 1 && head_dim == 128)
    return launch_fwd_sm90<128>(q, k, v, out, lse, batch, seq, heads,
                                strides, scale_log2, causal, tab, sub_shift,
                                s);
  return -1;
}

// The band + global forward on the WMMA body: layout blocks of 2^bshift
// rows, band width w blocks (aligned windows when `aligned`), gtiles [ng]
// the ascending tiles that hold a global column, gbits [T/64] their
// global sub-blocks (of 2^sub_shift rows).
extern "C" int ds_bs_attn_band_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int batch, int seq, int heads,
                                   int head_dim, const long long* strides,
                                   float scale_log2, int causal, int bshift,
                                   int w, int aligned, const int* gtiles,
                                   int ng, const int* gbits, int sub_shift,
                                   int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (batch * seq == 0) return 0;
  DS_DISPATCH(dtype, head_dim, launch_band, q, k, v, out, lse, batch, seq,
              heads, strides, scale_log2, causal, bshift, w, aligned, gtiles,
              ng, gbits, sub_shift, static_cast<cudaStream_t>(stream));
}

// K7-band on the Hopper body (bf16 at head dims 64 and 128; -1 for any
// other pair): the arguments of ds_bs_attn_band_fwd (gbits per 64-row k
// tile) and nmax, the longest walk of a 128-row q tile.
extern "C" int ds_bs_attn_band_fwd_sm90(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int batch, int seq, int heads, int head_dim, const long long* strides,
    float scale_log2, int causal, int bshift, int w, int aligned,
    const int* gtiles, int ng, const int* gbits, int sub_shift, int nmax,
    int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (batch * seq == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 64)
    return launch_band_sm90<64>(q, k, v, out, lse, batch, seq, heads,
                                strides, scale_log2, causal, bshift, w,
                                aligned, gtiles, ng, gbits, sub_shift, nmax,
                                s);
  if (dtype == 1 && head_dim == 128)
    return launch_band_sm90<128>(q, k, v, out, lse, batch, seq, heads,
                                 strides, scale_log2, causal, bshift, w,
                                 aligned, gtiles, ng, gbits, sub_shift, nmax,
                                 s);
  return -1;
}

// dK, dV, after writing delta = rowsum(dO * O) (which dQ then reads)
extern "C" int ds_bs_attn_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* out,
                                  const void* dout, const float* lse,
                                  float* delta, void* dk, void* dv, int batch,
                                  int seq, int heads, int head_dim,
                                  const long long* strides, float scale_log2,
                                  float sm_scale, int causal,
                                  const int* head_map, const int* qidx,
                                  const int* qcnt, const int* qmask,
                                  int qmax, int sub_shift, int rr, int dtype,
                                  int device, void* stream) {
  cudaSetDevice(device);
  if (batch * seq == 0) return 0;
  const Table tab{head_map, qidx, qcnt, qmask, qmax};
  DS_DISPATCH(dtype, head_dim, launch_dkv, q, k, v, out, dout, lse, delta,
              dk, dv, batch, seq, heads, strides, scale_log2, sm_scale,
              causal, tab, sub_shift, rr,
              static_cast<cudaStream_t>(stream));
}

extern "C" int ds_bs_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int batch,
                                 int seq, int heads, int head_dim,
                                 const long long* strides, float scale_log2,
                                 float sm_scale, int causal,
                                 const int* head_map, const int* kidx,
                                 const int* kcnt, const int* kmask, int kmax,
                                 int sub_shift, int rr, int dtype, int device,
                                 void* stream) {
  cudaSetDevice(device);
  if (batch * seq == 0) return 0;
  const Table tab{head_map, kidx, kcnt, kmask, kmax};
  DS_DISPATCH(dtype, head_dim, launch_dq, q, k, v, dout, lse, delta, dq,
              batch, seq, heads, strides, scale_log2, sm_scale, causal, tab,
              sub_shift, rr, static_cast<cudaStream_t>(stream));
}

// K7-dkv and K7-dq on the Hopper sweeps (bf16 at head dims 64 and 128; -1
// for any other pair): the arguments of ds_bs_attn_bwd_dkv /
// ds_bs_attn_bwd_dq with a pair table in place of the 64-row one: steps
// [U, nt, 3, nmax] (nt = ceil(T / 128); per row the streamed 64-row tiles,
// then the two halves' sub-block bits), count [U, nt] and order [H * nt],
// the (head, tile) pairs longest walk first.
extern "C" int ds_bs_attn_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dk, void* dv,
    int batch, int seq, int heads, int head_dim, const long long* strides,
    float scale_log2, float sm_scale, int causal, const int* head_map,
    const int* steps, const int* count, const int* order, int nmax,
    int sub_shift, int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (batch * seq == 0) return 0;
  const PairTable tab{head_map, steps, count, order, nmax};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 64)
    return launch_dkv_sm90<64>(q, k, v, out, dout, lse, delta, dk, dv, batch,
                               seq, heads, strides, scale_log2, sm_scale,
                               causal, tab, sub_shift, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dkv_sm90<128>(q, k, v, out, dout, lse, delta, dk, dv,
                                batch, seq, heads, strides, scale_log2,
                                sm_scale, causal, tab, sub_shift, s);
  return -1;
}

extern "C" int ds_bs_attn_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int batch, int seq,
    int heads, int head_dim, const long long* strides, float scale_log2,
    float sm_scale, int causal, const int* head_map, const int* steps,
    const int* count, const int* order, int nmax, int sub_shift, int dtype,
    int device, void* stream) {
  cudaSetDevice(device);
  if (batch * seq == 0) return 0;
  const PairTable tab{head_map, steps, count, order, nmax};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 64)
    return launch_dq_sm90<64>(q, k, v, dout, lse, delta, dq, batch, seq,
                              heads, strides, scale_log2, sm_scale, causal,
                              tab, sub_shift, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dq_sm90<128>(q, k, v, dout, lse, delta, dq, batch, seq,
                               heads, strides, scale_log2, sm_scale, causal,
                               tab, sub_shift, s);
  return -1;
}
