// K2-fused: the one-pass flash attention backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_bwd_fused_kernel` and its packed twin
// `_bwd_fused_kernel_packed` in deepspeed_tpu/ops/transformer/
// flash_attention.py (:606, :738; launched by `_bwd` at :825 whenever the
// whole sequence is one tile, which the JAX package's 1024-row default
// block makes every T <= 1024). From q, k, v, dO, the forward's
// log2-space lse and delta, with scores scaled by sm_scale * log2(e) and
// masked entries hidden as the forward hides them:
//   P = exp2(S - lse);   dP = dO V^T;   dS = P (dP - delta) sm_scale
//   dV = P^T dO;   dK = dS^T Q;   dQ = dS K
// with P cast to dO's dtype and dS to q's before their products, fp32
// sums, dQ/dK/dV written in the input dtype as [B, T, H, D]. S, P, dP and
// dS are formed once per visible tile pair: 5 products a pair, where K2's
// two sweeps (flash_attention_bwd.cu) form S and dP twice, 7 products.
//
// delta is folded in: without a given delta the kernel computes
// delta = rowsum(dO * O) - log2(e) * dlse for its rows before its first
// product (no pre-pass launch); with one (`_flash_merge_bwd`'s, K5's
// backward) it reads delta_in - log2(e) * dlse and leaves delta_in as it
// was.
//
// Layout: a thread-block cluster per (b, h) over the nk = ceil(T / 128)
// <= 8 key blocks of 128 rows, one CTA per SM, following a plan built on
// the host (flash_attention.py `_fused_plan`, which the plain twin walks
// too): each CTA takes its (key block, q block) pairs in order, with its
// key blocks' K and V resident (both loaded at the start, so the switch
// to the second waits on nothing) and its dK, dV in registers, as the
// dK/dV sweep keeps them. Causal at head dim 64, CTA c pairs key blocks
// c and nk - 1 - c: nk + 1 pairs for each of ceil(nk / 2) CTAs. The rest
// (not causal; head dim 128, where a second K/V block does not fit)
// rotate: CTA i holds key block i and takes q block (i + r) mod nk as its
// r-th pair, causal while i + r < nk. The head's lse rows are resident
// from the start, and its delta rows too: each CTA computes those of its
// own q blocks, and after one cluster barrier gathers the rest from their
// CTAs through distributed shared memory, once.
//
// A pair streams the q block's two 64-row steps (Q, dO) by TMA through a
// ring that runs ahead across pairs. Each warpgroup forms the transposed
// scores S^T = K Q^T and dP^T = V dO^T of its 64 keys, so that P^T and
// dS^T sit in registers as the A operands of dV += P^T dO and
// dK += dS^T Q, and writes dS^T, in dS's 16-bit type, into the pair's
// [128 keys x 128 q] tile in shared memory. After the pair's steps one
// barrier of the two warpgroups hands the tile over (two tiles alternate
// by pair, so no second barrier guards the next pair's writes), and each
// warpgroup multiplies 64 q rows of dS (the tile read transposed) by the
// resident K, a 64 x D x 128 product.
//
// dQ: each q step's partials are summed in the plan's order (by pair
// index: a q block's partials come from distinct pairs of distinct CTAs),
// in fp32, in a device-memory workspace: the first partial is stored and
// the others are added by `red.global.add` from registers; the CTA that
// added a q step's last partial reads the sum back once, at its end, and
// writes dq in the input dtype (a q step with one partial writes dq
// straight away). Order without a barrier a round: each partial's
// warpgroup waits on a baton, an mbarrier in its own shared memory, that
// the previous partial's warpgroup arrives on through the cluster (its
// threads' adds ordered before the one arrival by the warpgroup's barrier,
// the arrival a release at cluster scope), and then passes it on. A CTA
// waits only for the partials before its own, never for the cluster; a q
// step's predecessors sit at lower pair indices, so every wait is met by
// CTAs of the same cluster, which the cluster co-schedules: no deadlock
// (the CPU tests simulate the plan's waits). Every dQ element is summed in
// one fixed order with no float atomics whose order can change, so a
// second launch repeats the first bit for bit. The workspace is
// [B*H, T, D] fp32 from the wrapper's torch.empty; nothing needs zeroing.
//
// Bound on the H100: at the flagship shape (bf16, causal, [11, 1024, 25,
// 64]) the 5 products of the visible pairs, 0.0934 ms at 989 TFLOP/s; at
// BERT's [16, 128, 16, 64] (non-causal, one CTA a head, one partial a q
// step) the same 5 products, 0.0087 ms, under its bytes (0.0101 ms at
// 3.35 TB/s). One CTA per SM: two resident K/V blocks, the ring, two dS
// tiles and the head's rows take ~187 KB at head dim 64 (~208 registers);
// one K/V block and ~204 KB at 128, where the loop re-derives the pair's
// and the head's indices where it uses them (C::kLean) to stay within 255
// registers. Measured on the H100 (PERF.md §6, `kernel_variants.py
// fused_bwd`): at T 1024 ~1.2x K2's sweeps. What holds it there, in that
// order: the 64-row steps at the dK/dV sweep's pace, but on 120 of the 132
// SMs (a 4-CTA cluster at one CTA per SM fits 30 at a time: 10 waves at
// the flagship's 275 heads); the dQ product and the tile's hand-off; the
// partials' adds; their order. At BERT's shape it beats the sweeps (one
// launch, no delta pre-pass).
//
// Sequences that are not one tile (T > 1024) keep the sweeps, as the
// JAX package keeps its two kernels there; so do fp32 inputs and the
// head dims 192 and 256 (attention_tiles.cuh's bodies).
#include "attention_hopper.cuh"

// inside attn::sm90, so that its names (kThreads, Ring) hide the WMMA
// bodies' and hopper.cuh's of the same name
namespace attn {
namespace sm90 {
namespace {

constexpr int kMaxCluster = 8;   // the portable cluster size: T <= 1024
constexpr int kMaxT = kMaxCluster * kRows;

// d[64 x 64] = A[64 x 16] B[16 x 64] summed over the K dim, both
// operands MN-major in shared memory (A read transposed: stored K rows x
// M columns, as dS^T is)
#define FUSED_WGMMA_SS_TT_N64(TY)                                          \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %34, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
      "{"                                                                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31"                             \
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                \
      : "l"(da), "l"(db), "r"(scale_d))

template <typename E>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (kHalf<E>)
    FUSED_WGMMA_SS_TT_N64("f16");
  else
    FUSED_WGMMA_SS_TT_N64("bf16");
}

// ---------------------------------------------------------------------
// Cluster: rank, barriers, distributed shared memory; the batons
// ---------------------------------------------------------------------
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; orders the shared-memory
// accesses (local and remote) before the arrive before those after the
// wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// `threads` threads (whole warps) at named barrier `id`
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the cluster address of local shared address `p` in CTA `rank`
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

// a baton's one phase completed: the q step's previous partial performed
// (acquire at cluster scope; a wait that never ends traps, as mbar_wait)
__device__ __forceinline__ void baton_wait(uint64_t* bar) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(0u)
        : "memory");
  }
}

// arrive on baton `bar`'s copy in CTA `rank` (release at cluster scope)
__device__ __forceinline__ void baton_pass(uint64_t* bar, int rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote(bar, rank))
      : "memory");
}

// dQ partials in the fp32 workspace: an add performed at L2, and the
// sum read back from L2
__device__ __forceinline__ void red_add2(float* p, float x, float y) {
  asm volatile("red.relaxed.gpu.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(p),
               "f"(x), "f"(y)
               : "memory");
}
__device__ __forceinline__ float2 ld_sum2(const float* p) {
  float2 v;
  asm volatile("ld.relaxed.gpu.global.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p)
               : "memory");
  return v;
}

// ---------------------------------------------------------------------
// The plan: the (key block, q block) pairs each CTA of a cluster takes,
// in order, and each q step's partials in their order (a q block's
// partials come from pairs of distinct indices). Built on the host
// (flash_attention.py `_fused_plan` / `_FusedPlan`, which the plain twin
// walks too).
// ---------------------------------------------------------------------
constexpr int kMaxPairs = kMaxCluster + 1;
constexpr int kMaxSteps = 2 * kMaxPairs;
struct FusedPlan {
  int ctas, pairs;                           // CTAs a cluster; most pairs
  signed char n[kMaxCluster];                // pairs of CTA c
  signed char kb[kMaxCluster][kMaxPairs];    // key block of pair p
  signed char qb[kMaxCluster][kMaxPairs];    // q block of pair p
  signed char first[kMaxCluster][kMaxPairs];     // 1: the q block's first
  signed char next_cta[kMaxCluster][kMaxPairs];  // -1: its last partial
  signed char next_pair[kMaxCluster][kMaxPairs];
  signed char kv[kMaxCluster][2];   // CTA c's key blocks in order (-1)
  signed char own[kMaxCluster][2];  // q blocks whose delta CTA c computes
  signed char owner[kMaxCluster];   // the CTA of q block j's delta
  signed char slot[kMaxCluster];    // and its slot there
};

// ---------------------------------------------------------------------
// Shared memory
// ---------------------------------------------------------------------
template <int D>
struct FusedCfg {
  static constexpr int kS = D == 64 ? 3 : 2;   // ring stages (Q, dO)
  // resident K/V blocks: a causal CTA's two key blocks at head dim 64
  // (at 128 the plan gives each CTA one)
  static constexpr int kKV = D == 64 ? 2 : 1;
  // the second key block's K/V loaded at the start (else at the switch)
  static constexpr bool kPrefetchKV = true;
  // each q step's partials added in the plan's order (the batons)
  static constexpr bool kOrdered = true;
  // values re-derived where the loop uses them (see the kernel)
  static constexpr bool kLean = D == 128;
  using R = Ring<kS, 1>;
  static constexpr size_t kv_bytes = size_t(kRows) * D * 2;
  static constexpr size_t k = 0;                        // K blocks
  static constexpr size_t v = k + kKV * kv_bytes;       // V blocks
  static constexpr size_t q = v + kKV * kv_bytes;       // Q steps
  static constexpr size_t dout = q + size_t(kS) * kStep * D * 2;
  // dS^T of a pair: 128 key rows x 128 q columns, two 64-column blocks;
  // two tiles, alternating by pair
  static constexpr size_t ds = dout + size_t(kS) * kStep * D * 2;
  static constexpr size_t ds_block = size_t(kRows) * 128;
  static constexpr size_t ds_tile = 2 * ds_block;
  static constexpr size_t lse = ds + 2 * ds_tile;        // the head's rows
  static constexpr size_t delta = lse + kMaxT * 4;
  static constexpr size_t own = delta + kMaxT * 4;       // own q blocks'
  static constexpr size_t steps = own + 2 * kRows * 4;
  static constexpr size_t bar = steps + (kMaxSteps + 1 + 3) / 4 * 16;
  // K/V full [kKV], batons [kMaxPairs][2], then the ring
  static constexpr size_t ring = bar + 8 * (kKV + 2 * kMaxPairs);
  static constexpr size_t bytes = ring + R::bytes + 1024;
};
static_assert(FusedCfg<64>::bytes <= 232448 && FusedCfg<128>::bytes <= 232448,
              "K2-fused: shared memory");

// The dynamic shared memory, 1024-byte aligned as smem_base() aligns it,
// but by pointer arithmetic on the __shared__ array: pointers derived
// from it stay in the shared state space, so their loads and stores are
// 32-bit shared accesses (smem_base()'s integer round trip makes them
// generic, 64-bit address registers each)
__device__ __forceinline__ unsigned char* fused_smem() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
}

// the thread's index, read where it is used: lane- and warp-dependent
// offsets computed from it in a loop are not hoisted out of the loop to
// stay live across it (at head dim 128 they spilled)
__device__ __forceinline__ int thread_id() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// ---------------------------------------------------------------------
// The kernel: one CTA per (b*h, plan row), clusters of plan.ctas along x
// ---------------------------------------------------------------------
template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_fused_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                            const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv,
                            const __grid_constant__ CUtensorMap mdo,
                            const E* __restrict__ out,
                            const E* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dlse,
                            const float* __restrict__ delta_in,
                            E* __restrict__ dq, E* __restrict__ dk,
                            E* __restrict__ dv, float* __restrict__ ws,
                            int seq, int heads, long long sob, long long sot,
                            long long soh, long long sdb, long long sdt,
                            long long sdh, float scale_log2, float sm_scale,
                            int causal,
                            const __grid_constant__ FusedPlan plan) {
  using C = FusedCfg<D>;
  using R = typename C::R;
  constexpr int kS = C::kS;
  const int c = cluster_rank();           // the plan's row
  const int bh = blockIdx.x / plan.ctas;
  const int b = bh / heads, h = bh % heads;
  unsigned char* sm = fused_smem();
  E* sK = reinterpret_cast<E*>(sm + C::k);
  E* sV = reinterpret_cast<E*>(sm + C::v);
  E* sQ = reinterpret_cast<E*>(sm + C::q);
  E* sdO = reinterpret_cast<E*>(sm + C::dout);
  unsigned char* sDS = sm + C::ds;
  float* sLse = reinterpret_cast<float*>(sm + C::lse);
  float* sDelta = reinterpret_cast<float*>(sm + C::delta);
  float* sOwn = reinterpret_cast<float*>(sm + C::own);
  int* sSteps = reinterpret_cast<int*>(sm + C::steps);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sm + C::bar);
  uint64_t* baton = full_kv + C::kKV;     // [pair][warpgroup]
  const R ring{reinterpret_cast<uint64_t*>(sm + C::ring),
               reinterpret_cast<unsigned*>(sm + C::ring + R::bar_bytes)};
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(bh) * seq;
  const int np = plan.n[c];

  // the walk: the 64-row q steps of the CTA's pairs in order (a q block
  // that T stops halfway through has one)
  if (tid == 0) {
    int n = 0;
    for (int p = 0; p < np; ++p) {
      const int j = plan.qb[c][p];
      for (int s = 0; s < 2; ++s)
        if (j * kRows + s * kStep < seq) sSteps[n++] = j * kRows + s * kStep;
    }
    sSteps[kMaxSteps] = n;
    for (int x = 0; x < C::kKV + 2 * kMaxPairs; ++x) mbar_init(full_kv + x, 1);
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n = sSteps[kMaxSteps];
  // At head dim 128 (C::kLean) the loop derives these again where it uses
  // them, from shared memory and the special registers, rather than hold
  // them across the steps (held, each one spilled there; at 64 the
  // re-derivation only costs time): the walk's length, the head (b*h),
  // its first row in lse, delta and the workspace, a [B, T, H, D] row's
  // offset, a pair's key and q blocks, and the thread's lane and warp.
  auto steps_n = [&]() {
    if constexpr (C::kLean)
      return *static_cast<volatile int*>(sSteps + kMaxSteps);
    else
      return n;
  };
  auto head_bh = [&]() {
    if constexpr (C::kLean) {
      int x;
      asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(x));
      return x / plan.ctas;
    } else {
      return bh;
    }
  };
  auto head_row0 = [&]() {
    return static_cast<long long>(head_bh()) * seq;
  };
  auto row_at = [&](int t) {
    const int x = head_bh();
    return ((static_cast<long long>(x / heads) * seq + t) * heads +
            x % heads) * D;
  };
  auto row_c = [&]() { return C::kLean ? cluster_rank() : c; };
  auto pair_kb = [&](int p) { return int(plan.kb[row_c()][p]); };
  auto pair_qb = [&](int p) { return int(plan.qb[row_c()][p]); };
  auto lane_warp = [&](int& lane, int& warp) {
    const int t = C::kLean ? thread_id() : tid;
    lane = t % 32;
    warp = t % 128 / 32;
  };
  auto load = [&](int it) {
    const int st = it % kS, x = head_bh();
    const int hh = C::kLean ? x % heads : h, bb = C::kLean ? x / heads : b;
    uint64_t* bar = ring.full(it, 0);
    mbar_expect_tx(bar, 2 * kStep * D * 2);
    tma_tile<kStep, D>(sQ + st * kStep * D, mq, bar, hh, sSteps[it], bb);
    tma_tile<kStep, D>(sdO + st * kStep * D, mdo, bar, hh, sSteps[it], bb);
  };
  // K and V of the CTA's x-th key block into resident slot x
  auto load_kv = [&](int x) {
    mbar_expect_tx(full_kv + x, 2 * kRows * D * 2);
    tma_tile<kRows, D>(sK + x * kRows * D, mk, full_kv + x, h,
                       plan.kv[c][x] * kRows, b);
    tma_tile<kRows, D>(sV + x * kRows * D, mv, full_kv + x, h,
                       plan.kv[c][x] * kRows, b);
  };
  if (tid == 0) {
    load_kv(0);
    if constexpr (C::kKV > 1 && C::kPrefetchKV)
      if (plan.kv[c][1] >= 0) load_kv(1);
    for (int it = 0; it < n && it < kS; ++it) load(it);
  }

  // while the tiles land: the head's lse rows (zeros past T), and delta
  // of the rows of the CTA's own q blocks (two threads a row):
  // rowsum(dO * O) in fp32, or the given delta; minus log2(e) dlse
  const int rows_pad = (seq + kRows - 1) / kRows * kRows;
  for (int x = tid; x < rows_pad; x += kThreads)
    sLse[x] = x < seq ? lse[row0 + x] : 0.f;
  {
    // the rows' loads first (both own q blocks at once at head dim 64),
    // then the sums
    constexpr int kV = D / 16;   // 16-byte vectors of half a row
    constexpr int kAtOnce = D == 64 ? 2 : 1;
    const int row = tid >> 1, half = tid & 1;
#pragma unroll
    for (int s0 = 0; s0 < 2; s0 += kAtOnce) {
      uint4 ov[kAtOnce][kV], gv[kAtOnce][kV];
      float given[kAtOnce], shift[kAtOnce];
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u) {
        const int j = plan.own[c][s0 + u], t = j * kRows + row;
        const bool live = j >= 0 && t < seq;
        given[u] = live && half == 0 && delta_in != nullptr
                       ? delta_in[row0 + t] : 0.f;
        shift[u] = live && half == 0 && dlse != nullptr ? dlse[row0 + t]
                                                         : 0.f;
        const bool rows = live && delta_in == nullptr;
        const E* o = out + b * sob + t * sot + h * soh + half * (D / 2);
        const E* g = dout + b * sdb + t * sdt + h * sdh + half * (D / 2);
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          ov[u][v] = rows ? *reinterpret_cast<const uint4*>(o + 8 * v)
                          : make_uint4(0u, 0u, 0u, 0u);
          gv[u][v] = rows ? *reinterpret_cast<const uint4*>(g + 8 * v)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u) {
        const int j = plan.own[c][s0 + u], t = j * kRows + row;
        float acc = given[u];
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const E* oe = reinterpret_cast<const E*>(&ov[u][v]);
          const E* ge = reinterpret_cast<const E*>(&gv[u][v]);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc += to_float(ge[e]) * to_float(oe[e]);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (half == 0) {
          acc -= kLog2e * shift[u];
          sOwn[(s0 + u) * kRows + row] = acc;
          if (j >= 0) sDelta[t] = acc;
        }
      }
    }
  }
  // the CTA's barriers initialised and its delta rows written, for the
  // cluster; then the other CTAs' rows gathered, once
  cluster_arrive();
  __syncthreads();
  cluster_wait();
  {
    float dl[kMaxT / kThreads];
#pragma unroll
    for (int u = 0; u < kMaxT / kThreads; ++u) {
      const int x = tid + u * kThreads, j = x / kRows;
      dl[u] = x < seq && plan.owner[j] != c
                  ? ld_cluster(remote(sOwn + plan.slot[j] * kRows + x % kRows,
                                      plan.owner[j]))
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kMaxT / kThreads; ++u) {
      const int x = tid + u * kThreads;
      if (x < rows_pad && (x >= seq || plan.owner[x / kRows] != c))
        sDelta[x] = dl[u];
    }
  }
  // the gathers done: a CTA leaves (after the matching wait, at its end)
  // only once every CTA has read its delta rows
  cluster_arrive();
  __syncthreads();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_dk[e] = acc_dv[e] = 0.f;
  // dK and dV of key block kb leave from registers
  auto store_dkv = [&](int kb) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int t = kb * kRows + wg * 64 + warp * 16 + lane / 4 + 8 * x;
      if (t >= seq) continue;
      const long long at = row_at(t);
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * (lane % 4);
        store2<E>(dk + at + col, acc_dk[4 * jj + 2 * x],
                  acc_dk[4 * jj + 2 * x + 1]);
        store2<E>(dv + at + col, acc_dv[4 * jj + 2 * x],
                  acc_dv[4 * jj + 2 * x + 1]);
      }
    }
  };

  // dQ of pair p for the warpgroup's q step (wg) of its q block: whether
  // the step holds rows (T may stop before it)
  auto dq_rows = [&](int p) {
    return pair_qb(p) * kRows + wg * kStep < seq;
  };
  // dS [64 q x 128 keys] K [128 keys x 64 columns cb] (started, not
  // waited for), after both warpgroups' dS^T of the pair are written
  auto dq_start = [&](int p, int cb, float (&acc)[32]) {
    if (cb == 0) named_sync(1, kThreads);
    if (!dq_rows(p)) return;
    const int x = C::kKV > 1 && pair_kb(p) != plan.kv[c][0];
    const uint32_t a0 =
        smem_u32(sDS + (p % 2) * C::ds_tile + wg * C::ds_block);
    const uint32_t b0 = smem_u32(sK + x * kRows * D + cb * kRows * 64);
    wg_fence();
    auto product = [&](int kk) {
      wgmma_ss_tt<E>(acc, desc_sw128(a0 + kk * 16 * 128, kRows * 128, 1024),
                     desc_sw128(b0 + kk * 16 * 128, kRows * 128, 1024),
                     kk > 0);
    };
    if constexpr (C::kLean) {
      // (not unrolled: its 16 descriptors computed ahead spilled)
#pragma unroll 1
      for (int kk = 0; kk < kRows / 16; ++kk) product(kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) product(kk);
    }
    wg_commit();
  };
  // the partial into the q step's sum, after the partials before it: a
  // q step's only partial is dq, its first stored, the rest added
  auto dq_put = [&](int p, int cb, const float (&acc)[32]) {
    const bool first = plan.first[c][p], last = plan.next_cta[c][p] < 0;
    if (C::kOrdered && cb == 0 && !first) baton_wait(baton + 2 * p + wg);
    int lane, warp;
    lane_warp(lane, warp);
    const int t0 =
        pair_qb(p) * kRows + wg * kStep + warp * 16 + lane / 4;
    const int col0 = cb * 64 + 2 * (lane % 4);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int t = t0 + 8 * x;
      if (t >= seq) continue;
      if (first && last) {
        E* q_ = dq + row_at(t) + col0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          store2<E>(q_ + 8 * jj, acc[4 * jj + 2 * x], acc[4 * jj + 2 * x + 1]);
      } else {
        float* w_ = ws + (head_row0() + t) * D + col0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          if (first)
            *reinterpret_cast<float2*>(w_ + 8 * jj) =
                make_float2(acc[4 * jj + 2 * x], acc[4 * jj + 2 * x + 1]);
          else
            red_add2(w_ + 8 * jj, acc[4 * jj + 2 * x], acc[4 * jj + 2 * x + 1]);
        }
      }
    }
  };
  // dq of the q steps whose last partial the warpgroup added, from the
  // workspace once at the CTA's end (each thread reads back the elements
  // it added last, after every partial before them)
  auto dq_finish = [&]() {
    for (int p = 0; p < np; ++p) {
      if (plan.first[c][p] || plan.next_cta[c][p] >= 0 || !dq_rows(p))
        continue;
      const int t0 =
          pair_qb(p) * kRows + wg * kStep + warp * 16 + lane / 4;
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        float2 sum[2][8];
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            sum[x][jj] = t0 + 8 * x < seq
                             ? ld_sum2(ws + (head_row0() + t0 + 8 * x) * D +
                                       cb * 64 + 8 * jj + 2 * (lane % 4))
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int t = t0 + 8 * x;
          if (t >= seq) continue;
          E* qrow =
              dq + row_at(t);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            store2<E>(qrow + cb * 64 + 8 * jj + 2 * (lane % 4),
                      sum[x][jj].x, sum[x][jj].y);
        }
      }
    }
  };
  // the next partial of the q step may go: the warpgroup's barrier
  // orders every thread's adds before one thread's arrival, whose
  // release (cumulative) makes them visible to the acquiring waiter
  auto dq_pass = [&](int p) {
    if (!C::kOrdered || !dq_rows(p) || plan.next_cta[c][p] < 0) return;
    named_sync(2 + wg, 128);
    if (tid % 128 == 0)
      baton_pass(baton + 2 * plan.next_pair[c][p] + wg,
                 plan.next_cta[c][p]);
  };

  int slot = 0;   // the resident K/V block of the current pair
  mbar_wait(full_kv, 0);
  int it = 0;
  for (int p = 0; p < np; ++p) {
    const int kb = pair_kb(p);
    if constexpr (C::kKV > 1) {
      if (kb != plan.kv[c][slot]) {
        // the CTA's second key block, loaded at the start
        store_dkv(plan.kv[c][slot]);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc_dk[e] = acc_dv[e] = 0.f;
        if (!C::kPrefetchKV && tid == 0) load_kv(1);
        slot = 1;
        mbar_wait(full_kv + 1, 0);
      }
    }
    const E* k_blk = sK + slot * kRows * D;
    const E* v_blk = sV + slot * kRows * D;
    unsigned char* ds_t = sDS + (p % 2) * C::ds_tile;
    for (int s = 0; s < 2; ++s) {
      const int q0 = pair_qb(p) * kRows + s * kStep;
      if (q0 >= seq) break;
      // the warpgroup's first key
      const int k0 = pair_kb(p) * kRows + wg * 64;
      const int st = it % kS;
      ring.wait(it, 0);
      // this step's lane and warp (see thread_id)
      int lane, warp;
      lane_warp(lane, warp);
      unsigned char* ds_s = ds_t + s * C::ds_block;
      const DenseWalk90 walk{0, 1, causal, seq};
      const bool vis = k0 < seq && !walk.empty(it, q0, kStep, k0);
      const E* q_s = sQ + st * kStep * D;
      const E* do_s = sdO + st * kStep * D;
      const float* lse_s = sLse + q0;
      const float* delta_s = sDelta + q0;
      float st_[kStep / 2], dpt[kStep / 2];
      uint32_t pa[kStep / 16][4], da[kStep / 16][4];
      if (vis) {
        wg_fence();
        gemm_abt<D, kRows, kStep>(st_, k_blk, wg * 64, q_s, 0);
        gemm_abt<D, kRows, kStep>(dpt, v_blk, wg * 64, do_s, 0);
        wg_commit();
        wg_wait();
        reg_fence(st_);
        reg_fence(dpt);
        // element e: key row 16 warp + lane / 4 + 8 ((e / 2) % 2) of the
        // warpgroup's 64, query column 8 (e / 4) + 2 (lane % 4) + e % 2
        if (walk.partial(it, q0, kStep, k0, 64))
          hide_t(st_, walk.vis(it, q0, k0), warp, lane);
#pragma unroll
        for (int jj = 0; jj < kStep / 8; ++jj) {
          const int col = 8 * jj + 2 * (lane % 4);
          const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 dl2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 4 * jj + 2 * x;
            const float p0 = ex2(fmaf(st_[e], scale_log2, -lse2.x));
            const float p1 = ex2(fmaf(st_[e + 1], scale_log2, -lse2.y));
            st_[e] = p0;
            st_[e + 1] = p1;
            dpt[e] = p0 * (dpt[e] - dl2.x) * sm_scale;
            dpt[e + 1] = p1 * (dpt[e + 1] - dl2.y) * sm_scale;
          }
        }
        pack_a<kStep, E>(st_, pa);
        pack_a<kStep, E>(dpt, da);
        wg_fence();
        gemm_pb<D, kStep, kStep>(acc_dv, pa, do_s, 0);
        gemm_pb<D, kStep, kStep>(acc_dk, da, q_s, 0);
        wg_commit();
      }
      // dS^T into the step's column block: da[kk][x] holds q columns
      // 16 kk + 8 (x / 2) + 2 (lane % 4) + {0, 1} of key row
      // 16 warp + lane / 4 + 8 (x % 2). Under the 128-byte swizzle (TMA's
      // and wgmma's layout) 16-bit element (row, col) of a 64-column block
      // sits at row * 128 + ((((col * 2) >> 4) ^ (row & 7)) << 4) +
      // ((col * 2) & 15): here the row's 128 bytes, 16-byte chunk
      // 2 kk + x / 2 swizzled by lane / 4, 4 (lane % 4) bytes in. A
      // warpgroup that sees none of the step adds nothing to dQ.
      {
        unsigned char* row =
            ds_s + (wg * 64 + warp * 16 + lane / 4) * 128 + 4 * (lane % 4);
#pragma unroll
        for (int kk = 0; kk < kStep / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            *reinterpret_cast<uint32_t*>(
                row + 1024 * (x % 2) +
                (((2 * kk + x / 2) ^ (lane / 4)) << 4)) = vis ? da[kk][x] : 0u;
      }
      if (vis) {
        wg_wait();
        reg_fence(acc_dv);
        reg_fence(acc_dk);
        reg_fence(pa);
        reg_fence(da);
      }
      // (the walk's length read again: a register across the loop spilled
      // at head dim 128)
      if (lane == 0 && ring.release(it) && it + kS < steps_n())
        load(it + kS);
      __syncwarp();
      ++it;
    }
    // the dS^T tile, written by the generic proxy, is read by wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // dQ of the pair: each warpgroup's q step, 64 columns at a time
#pragma unroll 1
    for (int cb = 0; cb < D / 64; ++cb) {
      float acc_q[32];
      dq_start(p, cb, acc_q);
      if (dq_rows(p)) {
        wg_wait();
        reg_fence(acc_q);
        dq_put(p, cb, acc_q);
      }
    }
    dq_pass(p);
  }
  store_dkv(plan.kv[c][slot]);
  dq_finish();
  cluster_wait();
}

// clusters of `ctas` CTAs the card runs at once (the occupancy API on the
// kernel's own launch configuration), or -1
template <typename E, int D>
int clusters_at_once(int ctas) {
  using C = FusedCfg<D>;
  auto kern = flash_bwd_fused_kernel_sm90<E, D>;
  allow_smem(kern, C::bytes);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess ? n
                                                                      : -1;
}

template <typename E, int D>
int launch_fused(const void* q, const void* k, const void* v,
                 const void* out, const void* dout, const float* lse,
                 const float* dlse, const float* delta_in, void* dq,
                 void* dk, void* dv, float* ws, int batch, int seq,
                 int heads, const long long* s, float scale_log2,
                 float sm_scale, int causal, const FusedPlan& plan,
                 cudaStream_t stream) {
  using C = FusedCfg<D>;
  const int nk = (seq + kRows - 1) / kRows;
  if (plan.ctas < 1 || plan.ctas > kMaxCluster || nk > kMaxCluster ||
      (nk > 1 && ws == nullptr))
    return -1;
  // every CTA takes 1 .. kMaxPairs pairs, on its resident key blocks
  for (int c = 0; c < plan.ctas; ++c) {
    if (plan.n[c] < 1 || plan.n[c] > kMaxPairs || plan.kv[c][0] < 0 ||
        (C::kKV == 1 && plan.kv[c][1] >= 0))
      return -1;
    for (int p = 0; p < plan.n[c]; ++p)
      if (plan.kb[c][p] != plan.kv[c][0] && plan.kb[c][p] != plan.kv[c][1])
        return -1;
  }
  // resident K, V (128 rows) and streamed Q, dO (64 rows)
  CUtensorMap mq, mk, mv, mdo;
  constexpr auto dt = map_type<E>();
  if (make_map(&mq, q, batch, seq, heads, D, s[0], s[1], s[2], kStep, dt) ||
      make_map(&mk, k, batch, seq, heads, D, s[3], s[4], s[5], kRows, dt) ||
      make_map(&mv, v, batch, seq, heads, D, s[6], s[7], s[8], kRows, dt) ||
      make_map(&mdo, dout, batch, seq, heads, D, s[12], s[13], s[14], kStep,
               dt))
    return kMapError;
  auto kern = flash_bwd_fused_kernel_sm90<E, D>;
  allow_smem(kern, C::bytes);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(plan.ctas) *
                                           batch * heads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(plan.ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, mq, mk, mv, mdo, static_cast<const E*>(out),
      static_cast<const E*>(dout), lse, dlse, delta_in, static_cast<E*>(dq),
      static_cast<E*>(dk), static_cast<E*>(dv), ws, seq, heads, s[9], s[10],
      s[11], s[12], s[13], s[14], scale_log2, sm_scale, causal, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace sm90
}  // namespace attn

// Element strides (b, t, h), in this order, of q, k, v, out, dout (15
// values); the head dim of each is contiguous, the base and strides
// 16-byte aligned. dq/dk/dv are contiguous [B, T, H, D]; lse, dlse (may
// be null) and delta_in (null: delta from out and dout; else out is not
// read) are [B*H, T] fp32. dtype: 1 = bfloat16, 2 = float16; head_dim 64
// or 128; T <= 1024. `plan` is a FusedPlan of `plan_bytes` bytes (the
// host's `_FusedPlan` for ceil(T / 128) key blocks); `ws` a [B*H, T, D]
// fp32 workspace (null allowed at T <= 128). Returns the launch's CUDA
// error, or -1 for an unsupported (dtype, head_dim, T) or plan.
extern "C" int ds_flash_attn_bwd_fused(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const float* dlse,
    const float* delta_in, void* dq, void* dk, void* dv, int batch, int seq,
    int heads, int head_dim, const long long* strides, float scale_log2,
    float sm_scale, int causal, int dtype, int device, void* stream,
    const void* plan, int plan_bytes, void* ws) {
  cudaSetDevice(device);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch * seq == 0) return 0;
  if (plan_bytes != static_cast<int>(sizeof(attn::sm90::FusedPlan)))
    return -1;
  const auto& p = *static_cast<const attn::sm90::FusedPlan*>(plan);
  float* w = static_cast<float*>(ws);
#define DS_FUSED(E, D)                                                   \
  return attn::sm90::launch_fused<E, D>(q, k, v, out, dout, lse, dlse,   \
                                        delta_in, dq, dk, dv, w, batch,  \
                                        seq, heads, strides, scale_log2, \
                                        sm_scale, causal, p, st)
  if (dtype == 1 && head_dim == 64) DS_FUSED(attn::bf16, 64);
  if (dtype == 1 && head_dim == 128) DS_FUSED(attn::bf16, 128);
  if (dtype == 2 && head_dim == 64) DS_FUSED(__half, 64);
  if (dtype == 2 && head_dim == 128) DS_FUSED(__half, 128);
#undef DS_FUSED
  return -1;
}

// How many clusters of `ctas` CTAs (1-8) of the (dtype, head_dim) kernel
// run at once on `device`: what bounds a wave (PERF.md §6). -1 on error.
extern "C" int ds_flash_attn_bwd_fused_clusters(int ctas, int head_dim,
                                                int dtype, int device) {
  cudaSetDevice(device);
  if (ctas < 1 || ctas > attn::sm90::kMaxCluster) return -1;
  if (dtype == 1 && head_dim == 64)
    return attn::sm90::clusters_at_once<attn::bf16, 64>(ctas);
  if (dtype == 1 && head_dim == 128)
    return attn::sm90::clusters_at_once<attn::bf16, 128>(ctas);
  if (dtype == 2 && head_dim == 64)
    return attn::sm90::clusters_at_once<__half, 64>(ctas);
  if (dtype == 2 && head_dim == 128)
    return attn::sm90::clusters_at_once<__half, 128>(ctas);
  return -1;
}
