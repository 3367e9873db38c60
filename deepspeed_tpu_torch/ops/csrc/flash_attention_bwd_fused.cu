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
// delta = rowsum(dO * O) - log2(e) * dlse for its own rows before its
// first product (no pre-pass launch); with one (`_flash_merge_bwd`'s, K5's
// backward) it reads delta_in - log2(e) * dlse and leaves delta_in as it
// was.
//
// Layout: a thread-block cluster per (b, h) over the nk = ceil(T / 128)
// <= 8 key blocks of 128 rows, following a plan built on the host
// (flash_attention.py `_fused_plan`, which the plain twin walks too): in
// each round (at most 9) a CTA works on one (key block, q block) pair,
// with its key block's K and V resident (loaded again by TMA when its
// plan moves to its second key block) and its dK, dV in registers, as
// the dK/dV sweep keeps them. Causal at head dim 64, CTA c pairs key
// blocks c and nk - 1 - c: nk + 1 rounds for ceil(nk / 2) CTAs, none of
// them idle (key block 0 sees nk q blocks, key block nk - 1 one). The
// rest (not causal; head dim 128, where two dQ slabs do not fit) rotate:
// CTA i holds key block i and takes q block (i + r) mod nk in round r,
// causal while i + r < nk. Each q block's dQ lives in one CTA's shared
// memory as an fp32 slab (that of its key block's CTA).
//
// A round streams the q block's two 64-row steps (Q, dO) by TMA through
// a ring that runs ahead across rounds. Each warpgroup forms the
// transposed scores S^T = K Q^T and dP^T = V dO^T of its 64 keys, so that
// P^T and dS^T sit in registers as the A operands of dV += P^T dO and
// dK += dS^T Q, and writes dS^T, in dS's 16-bit type, into a [128 keys x
// 128 q] tile in shared memory. Then each warpgroup multiplies 64 q rows
// of dS (the tile read transposed) by the resident K, a 64 x D x 128
// product (64 columns at a time), and adds the result into the q block's
// slab, wherever it lives, through distributed shared memory: each
// thread's 16 pieces read at once (one round trip), then the sums
// written back. The plan gives a slab at most one partial
// a round, and a cluster barrier ends each round: every dQ element is
// summed in one fixed order, with no float atomics, and a second launch
// repeats the first bit for bit. delta is computed first by each slab's
// CTA for its q block's rows; the others read it from there.
//
// Bound on the H100: at the flagship shape (bf16, causal, [11, 1024, 25,
// 64]) the 5 products of the visible pairs, 0.0934 ms at 989 TFLOP/s; at
// BERT's [16, 128, 16, 64] (non-causal, one CTA a head) the same 5
// products, 0.0087 ms, under its bytes (0.0101 ms at 3.35 TB/s). One CTA
// per SM: resident K and V, the ring, the dS tile and the slabs take
// 179 KB at head dim 64 and 227 KB, all a CTA may use, at 128. Measured
// on the H100 (PERF.md §6): at BERT's shape it beats the sweeps (one
// launch, no delta pre-pass); at the flagship's it takes ~1.6x their
// time, of which the rounds' lock step and the dQ partials' exchange
// through distributed shared memory are ~0.4 ms (`kernel_variants.py
// fused_bwd` switches them off).
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
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
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
// Cluster: rank, barrier, distributed shared memory
// ---------------------------------------------------------------------
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; orders the shared-memory
// accesses (local and remote) before it before those after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the cluster address of local shared address `p` in CTA `rank`
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float2 ld_cluster2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster2(uint32_t a, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
               "f"(x), "f"(y)
               : "memory");
}


// ---------------------------------------------------------------------
// The plan: which (key block, q block) pair each CTA of a cluster works
// on in each round, and where each q block's dQ slab lives. Built on the
// host (flash_attention.py `_fused_plan`, which the plain twin walks
// too): rounds of the rotation, or, causal at head dim 64, key blocks c
// and nk - 1 - c paired in CTA c. Each round gives every slab at most one
// partial.
// ---------------------------------------------------------------------
constexpr int kMaxRounds = kMaxCluster + 1;
constexpr int kMaxSteps = 2 * kMaxRounds;
struct FusedPlan {
  int ctas, rounds;
  signed char kb[kMaxCluster][kMaxRounds];  // key block; -1: idle round
  signed char qb[kMaxCluster][kMaxRounds];  // q block
  signed char own[kMaxCluster][2];          // q blocks of CTA c's slabs
  signed char owner[kMaxCluster];           // the CTA of q block j's slab
  signed char slot[kMaxCluster];            // and the slab's slot there
};

// ---------------------------------------------------------------------
// Shared memory
// ---------------------------------------------------------------------
template <int D>
struct FusedCfg {
  static constexpr int kS = D == 64 ? 3 : 2;   // ring stages (Q, dO)
  // dQ slabs a CTA holds: two where a causal CTA pairs key blocks (head
  // dim 64; at 128 two would not fit)
  static constexpr int kSlabs = D == 64 ? 2 : 1;
  using R = Ring<kS, 1>;
  static constexpr size_t k = 0;                              // K block
  static constexpr size_t v = k + size_t(kRows) * D * 2;      // V block
  static constexpr size_t q = v + size_t(kRows) * D * 2;      // Q steps
  static constexpr size_t dout = q + size_t(kS) * kStep * D * 2;
  // dS^T of a q block: 128 key rows x 128 q columns, two 64-column blocks
  static constexpr size_t ds = dout + size_t(kS) * kStep * D * 2;
  static constexpr size_t ds_block = size_t(kRows) * 128;
  static constexpr size_t slab = ds + 2 * ds_block;           // fp32 dQ
  static constexpr size_t slab_floats = size_t(kRows) * D;
  static constexpr size_t lse = slab + kSlabs * slab_floats * 4;
  static constexpr size_t delta = lse + kRows * 4;   // the round's rows
  static constexpr size_t own = delta + kRows * 4;   // the slabs' delta
  static constexpr size_t steps = own + kSlabs * kRows * 4;
  static constexpr size_t bar = steps + (kMaxSteps + 1 + 3) / 4 * 16;
  static constexpr size_t bytes = bar + 8 + R::bytes + 1024;
};
static_assert(FusedCfg<64>::bytes <= 232448 && FusedCfg<128>::bytes <= 232448,
              "K2-fused: shared memory");

// byte offset of 16-bit element (row, col) of a 64-column block of
// 128-byte rows under the 128-byte swizzle (TMA's and wgmma's layout)
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return row * 128 + ((((col * 2) >> 4) ^ (row & 7)) << 4) + ((col * 2) & 15);
}

// float offset of (row, col) of an fp32 [128, D] dQ slab: 8-float chunks
// of a row swizzled by the row, so a warp's 8-byte accesses of 8 rows
// hit distinct chunks
template <int D>
__device__ __forceinline__ int slab_at(int row, int col) {
  return row * D + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
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
                            E* __restrict__ dv, int seq, int heads,
                            long long sob, long long sot, long long soh,
                            long long sdb, long long sdt, long long sdh,
                            float scale_log2, float sm_scale, int causal,
                            const __grid_constant__ FusedPlan plan) {
  using C = FusedCfg<D>;
  constexpr int kS = C::kS;
  const int c = cluster_rank();           // the plan's row
  const int bh = blockIdx.x / plan.ctas;
  const int b = bh / heads, h = bh % heads;
  unsigned char* sm = smem_base();
  E* sK = reinterpret_cast<E*>(sm + C::k);
  E* sV = reinterpret_cast<E*>(sm + C::v);
  E* sQ = reinterpret_cast<E*>(sm + C::q);
  E* sdO = reinterpret_cast<E*>(sm + C::dout);
  unsigned char* sDS = sm + C::ds;
  float* slab = reinterpret_cast<float*>(sm + C::slab);
  float* sLse = reinterpret_cast<float*>(sm + C::lse);
  float* sDelta = reinterpret_cast<float*>(sm + C::delta);
  float* sOwn = reinterpret_cast<float*>(sm + C::own);
  int* sSteps = reinterpret_cast<int*>(sm + C::steps);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sm + C::bar);
  const auto ring = ring_at<typename C::R>(sm + C::bar);
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(bh) * seq;

  // the walk: the 64-row q steps of the CTA's rounds in order (a q block
  // that T stops halfway through has one)
  if (tid == 0) {
    int n = 0;
    for (int r = 0; r < plan.rounds; ++r) {
      const int j = plan.qb[c][r];
      for (int s = 0; j >= 0 && s < 2; ++s)
        if (j * kRows + s * kStep < seq) sSteps[n++] = j * kRows + s * kStep;
    }
    sSteps[kMaxSteps] = n;
    mbar_init(full_kv, 1);
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n = sSteps[kMaxSteps];
  auto load = [&](int it) {
    const int st = it % kS;
    uint64_t* bar = ring.full(it, 0);
    mbar_expect_tx(bar, 2 * kStep * D * 2);
    tma_tile<kStep, D>(sQ + st * kStep * D, mq, bar, h, sSteps[it], b);
    tma_tile<kStep, D>(sdO + st * kStep * D, mdo, bar, h, sSteps[it], b);
  };
  auto load_kv = [&](int kb) {
    mbar_expect_tx(full_kv, 2 * kRows * D * 2);
    tma_tile<kRows, D>(sK, mk, full_kv, h, kb * kRows, b);
    tma_tile<kRows, D>(sV, mv, full_kv, h, kb * kRows, b);
  };
  int cur = plan.kb[c][0];   // the resident key block (round 0 is busy)
  if (tid == 0) {
    load_kv(cur);
    for (int it = 0; it < n && it < kS; ++it) load(it);
  }

  // while the tiles land: delta of the rows of the CTA's slabs (two
  // threads a row): rowsum(dO * O) in fp32, or the given delta; minus
  // log2(e) dlse. The slabs start at zero.
#pragma unroll
  for (int sl = 0; sl < C::kSlabs; ++sl) {
    const int j = plan.own[c][sl];
    const int row = tid >> 1, half = tid & 1;
    const int t = j * kRows + row;
    float acc = 0.f;
    if (j >= 0 && t < seq) {
      if (delta_in != nullptr) {
        acc = half == 0 ? delta_in[row0 + t] : 0.f;
      } else {
        const E* o = out + b * sob + t * sot + h * soh + half * (D / 2);
        const E* g = dout + b * sdb + t * sdt + h * sdh + half * (D / 2);
#pragma unroll
        for (int x = 0; x < D / 2; x += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(o + x);
          const uint4 gv = *reinterpret_cast<const uint4*>(g + x);
          const E* oe = reinterpret_cast<const E*>(&ov);
          const E* ge = reinterpret_cast<const E*>(&gv);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc += to_float(ge[e]) * to_float(oe[e]);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      if (j >= 0 && t < seq && dlse != nullptr) acc -= kLog2e * dlse[row0 + t];
      sOwn[sl * kRows + row] = acc;
    }
  }
  for (int x = tid; x < int(C::kSlabs * C::slab_floats / 4); x += kThreads)
    reinterpret_cast<float4*>(slab)[x] = make_float4(0.f, 0.f, 0.f, 0.f);
  // every CTA of the cluster running, its delta and zeroed slabs visible
  cluster_sync();

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
      const long long at =
          ((static_cast<long long>(b) * seq + t) * heads + h) * D;
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
  uint32_t kv_phase = 0;
  mbar_wait(full_kv, kv_phase);

  int it = 0;
  for (int r = 0; r < plan.rounds; ++r) {
    const int kb = plan.kb[c][r], j = plan.qb[c][r];
    if (j >= 0) {
      if (kb != cur) {
        // the CTA's next key block
        store_dkv(cur);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc_dk[e] = acc_dv[e] = 0.f;
        if (tid == 0) load_kv(kb);
        cur = kb;
        kv_phase ^= 1;
        mbar_wait(full_kv, kv_phase);
      }
      // the round's lse rows, and its delta rows from the slab's CTA
      const int t = j * kRows + (tid & 127);
      if (tid < 128)
        sDelta[tid] = t < seq ? ld_cluster(remote(
                                    sOwn + plan.slot[j] * kRows + tid,
                                    plan.owner[j]))
                              : 0.f;
      else
        sLse[tid - 128] = t < seq ? lse[row0 + t] : 0.f;
      __syncthreads();
      const int k0 = cur * kRows + wg * 64;   // the warpgroup's first key
      for (int s = 0; s < 2; ++s) {
        const int q0 = j * kRows + s * kStep;
        if (q0 >= seq) break;
        const int st = it % kS;
        ring.wait(it, 0);
        unsigned char* ds_s = sDS + s * C::ds_block;
        const DenseWalk90 walk{0, 1, causal, seq};
        if (k0 < seq && !walk.empty(it, q0, kStep, k0)) {
          const E* q_s = sQ + st * kStep * D;
          const E* do_s = sdO + st * kStep * D;
          const float* lse_s = sLse + s * kStep;
          const float* delta_s = sDelta + s * kStep;
          float st_[kStep / 2], dpt[kStep / 2];
          wg_fence();
          gemm_abt<D, kRows, kStep>(st_, sK, wg * 64, q_s, 0);
          gemm_abt<D, kRows, kStep>(dpt, sV, wg * 64, do_s, 0);
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
          uint32_t pa[kStep / 16][4], da[kStep / 16][4];
          pack_a<kStep, E>(st_, pa);
          pack_a<kStep, E>(dpt, da);
          wg_fence();
          gemm_pb<D, kStep, kStep>(acc_dv, pa, do_s, 0);
          gemm_pb<D, kStep, kStep>(acc_dk, da, q_s, 0);
          wg_commit();
          // dS^T into the step's column block: da[kk][x] holds q columns
          // 16 kk + 8 (x / 2) + 2 (lane % 4) + {0, 1} of key row
          // 16 warp + lane / 4 + 8 (x % 2)
#pragma unroll
          for (int kk = 0; kk < kStep / 16; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int kr = wg * 64 + warp * 16 + lane / 4 + 8 * (x % 2);
              const int qc = 16 * kk + 8 * (x / 2) + 2 * (lane % 4);
              *reinterpret_cast<uint32_t*>(ds_s + sw128(kr, qc)) = da[kk][x];
            }
          wg_wait();
          reg_fence(acc_dv);
          reg_fence(acc_dk);
          reg_fence(pa);
          reg_fence(da);
        } else {
          // a warpgroup that sees none of the step adds nothing to dQ
#pragma unroll
          for (int kk = 0; kk < kStep / 16; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int kr = wg * 64 + warp * 16 + lane / 4 + 8 * (x % 2);
              const int qc = 16 * kk + 8 * (x / 2) + 2 * (lane % 4);
              *reinterpret_cast<uint32_t*>(ds_s + sw128(kr, qc)) = 0u;
            }
        }
        if (lane == 0 && ring.release(it) && it + kS < n) load(it + kS);
        __syncwarp();
        ++it;
      }
      // the dS^T tile, written by the generic proxy, is read by wgmma
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      // dQ partial of q step wg: dS [64 q x 128 keys] K [128 keys x D],
      // 64 columns at a time, each added into q block j's slab, wherever
      // it lives (one CTA a round a slab): the thread's 16 pieces read
      // (one round trip), then the sums written back
      if (j * kRows + wg * kStep < seq) {
        float* dst = slab + plan.slot[j] * C::slab_floats;
        const int to = plan.owner[j];
        const uint32_t a0 = smem_u32(sDS + wg * C::ds_block);
#pragma unroll 1
        for (int cb = 0; cb < D / 64; ++cb) {
          float acc[32];
          const uint32_t b0 = smem_u32(sK + cb * kRows * 64);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < kRows / 16; ++kk)
            wgmma_ss_tt<E>(
                acc, desc_sw128(a0 + kk * 16 * 128, kRows * 128, 1024),
                desc_sw128(b0 + kk * 16 * 128, kRows * 128, 1024), kk > 0);
          wg_commit();
          wg_wait();
          reg_fence(acc);
          float2 old[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            const int row = wg * 64 + warp * 16 + lane / 4 + 8 * (u % 2);
            const int col = cb * 64 + 8 * (u / 2) + 2 * (lane % 4);
            old[u] = ld_cluster2(remote(dst + slab_at<D>(row, col), to));
          }
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            const int row = wg * 64 + warp * 16 + lane / 4 + 8 * (u % 2);
            const int col = cb * 64 + 8 * (u / 2) + 2 * (lane % 4);
            const int e = 4 * (u / 2) + 2 * (u % 2);
            st_cluster2(remote(dst + slab_at<D>(row, col), to),
                        old[u].x + acc[e], old[u].y + acc[e + 1]);
          }
        }
      }
    }
    // the round's adds done in every CTA before the next round's
    cluster_sync();
  }

  // the last key block's dK and dV; dQ of the CTA's slabs, complete
  // after the last round
  store_dkv(cur);
#pragma unroll
  for (int sl = 0; sl < C::kSlabs; ++sl) {
    const int j = plan.own[c][sl];
    if (j < 0) continue;
    const float* src = slab + sl * C::slab_floats;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int tq = j * kRows + wg * 64 + warp * 16 + lane / 4 + 8 * x;
      if (tq >= seq) continue;
      E* row = dq + ((static_cast<long long>(b) * seq + tq) * heads + h) * D;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * (lane % 4);
        const float2 v2 = *reinterpret_cast<const float2*>(
            src + slab_at<D>(wg * 64 + warp * 16 + lane / 4 + 8 * x, col));
        store2<E>(row + col, v2.x, v2.y);
      }
    }
  }
}

template <typename E, int D>
int launch_fused(const void* q, const void* k, const void* v,
                 const void* out, const void* dout, const float* lse,
                 const float* dlse, const float* delta_in, void* dq,
                 void* dk, void* dv, int batch, int seq, int heads,
                 const long long* s, float scale_log2, float sm_scale,
                 int causal, const FusedPlan& plan, cudaStream_t stream) {
  using C = FusedCfg<D>;
  if (plan.ctas < 1 || plan.ctas > kMaxCluster || plan.rounds < 1 ||
      plan.rounds > kMaxRounds || (seq + kRows - 1) / kRows > kMaxCluster)
    return -1;
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
      static_cast<E*>(dk), static_cast<E*>(dv), seq, heads, s[9], s[10],
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
// host's `_fused_plan` for ceil(T / 128) key blocks). Returns the
// launch's CUDA error, or -1 for an unsupported (dtype, head_dim, T) or
// plan.
extern "C" int ds_flash_attn_bwd_fused(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const float* dlse,
    const float* delta_in, void* dq, void* dk, void* dv, int batch, int seq,
    int heads, int head_dim, const long long* strides, float scale_log2,
    float sm_scale, int causal, int dtype, int device, void* stream,
    const void* plan, int plan_bytes) {
  cudaSetDevice(device);
  auto st = static_cast<cudaStream_t>(stream);
  if (batch * seq == 0) return 0;
  if (plan_bytes != static_cast<int>(sizeof(attn::sm90::FusedPlan)))
    return -1;
  const auto& p = *static_cast<const attn::sm90::FusedPlan*>(plan);
#define DS_FUSED(E, D)                                                   \
  return attn::sm90::launch_fused<E, D>(q, k, v, out, dout, lse, dlse,   \
                                        delta_in, dq, dk, dv, batch, seq, \
                                        heads, strides, scale_log2,      \
                                        sm_scale, causal, p, st)
  if (dtype == 1 && head_dim == 64) DS_FUSED(attn::bf16, 64);
  if (dtype == 1 && head_dim == 128) DS_FUSED(attn::bf16, 128);
  if (dtype == 2 && head_dim == 64) DS_FUSED(__half, 64);
  if (dtype == 2 && head_dim == 128) DS_FUSED(__half, 128);
#undef DS_FUSED
  return -1;
}
