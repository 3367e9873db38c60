// Hopper (sm_90a) bodies of the bf16 and fp16 flash-attention kernels at
// head dims 64 and 128: K1-fwd and its K5 merge mode (flash_attention_fwd.cu),
// K2's two sweeps (flash_attention_bwd.cu), the wgmma, TMA and ring pieces
// of K2-fused (flash_attention_bwd_fused.cu) and, over their band and table
// walks, the block-sparse band forward K7-band and backward K7-dkv and
// K7-dq (block_sparse_attention.cu). fp32 inputs, head dims 192/256 and
// K7's table forward keep attention_tiles.cuh's WMMA bodies.
//
// Replaces, in deepspeed_tpu/ops/transformer/flash_attention.py, the
// forward Pallas kernels `_fwd_kernel` :262 and `_fwd_kernel_packed`
// :337 (launcher `_fwd` :431, `pallas_call` :491), in their merge mode
// too (`flash_attention_merge` :1068), and the backward kernels
// `_bwd_dkv_kernel` :513, `_bwd_dq_kernel` :564 and their packed twins
// :662, :704 (launcher `_bwd` :765, `pallas_call` :845, :884); the
// one-tile `_bwd_fused_kernel` :606 / :738 (`pallas_call` :825) is
// K2-fused's (flash_attention_bwd_fused.cu, over this header's pieces).
//
// Bound on the H100 at the flagship shape (bf16, causal, [11, 1024, 25,
// 64]): the forward's bytes, 0.0434 ms at 3.35 TB/s, with its products
// (0.0373 ms at 989 TFLOP/s) close behind; the backward's products,
// 0.0934 ms. At D 64 a score's exp2 (one MUFU op, 16 a clock per SM)
// takes as long as its two forward products on the tensor cores, so
// the CUDA-core work per score sets the pace as much as the products
// do: the softmax here is one FFMA, one MUFU, a max and an add per
// score, and the products overlap it across the SM's four warpgroups.
//
// One CTA is two warpgroups of 64 rows each (a resident tile of 128 rows)
// and no producer warp: every tile arrives by TMA
// (`cp.async.bulk.tensor.4d`, 128-byte swizzle) through 4-D tensor maps
// (D, H, T, B) built on the host with the caller's strides, so the qkv
// column slices load in place and rows past T arrive as zeros. Thread 0
// starts the loads of the resident tile and of the first stages of a ring
// of streamed 64-row tiles; "full" mbarriers count the bytes in, "empty"
// ones the 8 warps out, and the last warp to release a stage refills it.
// Without a producer warp (which costs a whole warpgroup's registers:
// ptxas sizes these kernels in warpgroups) the forward fits two CTAs per
// SM, so one CTA's softmax overlaps the other's products. The warpgroups
// multiply with `wgmma.mma_async` straight from the swizzled tiles: score
// products take both operands K-major from shared memory, and the
// products with P or dS take them as the register A operand (the fp32
// accumulator of one product is, element for element, the A fragment of
// the next once packed to bf16) against a B tile read MN-major through
// the descriptor's transpose bit. Scores, the online softmax (each
// accumulator row lives in 4 threads: two quad shuffles per reduction)
// and every output accumulator stay in registers; only tiles that cross
// the causal diagonal or the sequence's end are masked, and a warpgroup
// skips the products of a tile it cannot see.
//
// The element type E (bf16, or __half for the fp16 forms) picks the
// wgmma operand type (`.bf16` / `.f16`), the tensor maps' data type and
// the packing of P, dS and the outputs; everything else (the tiles'
// layout, the fp32 accumulators and softmax) is the same for both.
//
// A tile of R rows x D 16-bit columns sits in shared memory as D / 64
// column blocks of R x 128 bytes, each 1024-byte aligned, which is the
// layout TMA writes for a 64-column box under CU_TENSOR_MAP_SWIZZLE_128B
// and the canonical 128-byte-swizzle layout of a wgmma descriptor.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace attn {
namespace sm90 {

constexpr int kConsumers = 2;              // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128;
constexpr int kRows = 64 * kConsumers;     // rows of a resident tile
constexpr int kStep = 64;                  // rows of a streamed tile

// bf16 and fp16 at head dims 64 and 128 run here; `dispatch_dense` sends
// the rest to attention_tiles.cuh
template <typename T, int D>
constexpr bool kOnSm90 =
    (std::is_same<T, bf16>::value || std::is_same<T, __half>::value) &&
    (D == 64 || D == 128);

template <typename E>
constexpr bool kHalf = std::is_same<E, __half>::value;

// ---------------------------------------------------------------------
// PTX: TMA boxes of the (D, H, T, B) maps, 16-bit wgmma (mbarriers, the
// ring, descriptors and fences come from hopper.cuh)
// ---------------------------------------------------------------------
using namespace hopper;

// one 64-column box of a (D, H, T, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         uint64_t* bar, int col, int h,
                                         int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(col),
      "r"(h), "r"(t), "r"(b)
      : "memory");
}

// a whole R x D tile: D / 64 boxes, one per column block
template <int R, int D, typename E>
__device__ __forceinline__ void tma_tile(E* dst, const CUtensorMap& map,
                                         uint64_t* bar, int h, int t0,
                                         int b) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    tma_load(dst + cb * R * 64, map, bar, cb * 64, h, t0, b);
}

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, A and B K-major in shared
// memory (128-byte swizzle), fp32 accumulate; scale_d 0 overwrites d. TY
// is the operands' PTX type.
#define ATTN_WGMMA_SS_N64(TY)                                              \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %34, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
      "{"                                                                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                   \
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
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (kHalf<E>)
    ATTN_WGMMA_SS_N64("f16");
  else
    ATTN_WGMMA_SS_N64("bf16");
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the accumulator
// layout of a product, `pack_a`), B MN-major in shared memory
#define ATTN_WGMMA_RS_N64(TY)                                              \
  asm volatile(                                                            \
      "{\n.reg .pred p;\n"                                                 \
      "setp.ne.b32 p, %37, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
      "{"                                                                  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                   \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                   \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                 \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),               \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),               \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),               \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),             \
        "r"(scale_d))

template <typename E>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (kHalf<E>)
    ATTN_WGMMA_RS_N64("f16");
  else
    ATTN_WGMMA_RS_N64("bf16");
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (the accumulator
// layout of a product, `pack_a`), B MN-major in shared memory
#define ATTN_WGMMA_RS_N128(TY)                                      \
  asm volatile(                                                     \
      "{\n.reg .pred p;\n"                                          \
      "setp.ne.b32 p, %69, 0;\n"                                    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
      "{"                                                           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                            \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                    \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                    \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                    \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                    \
      "%56, %57, %58, %59, %60, %61, %62, %63"                      \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),        \
        "r"(scale_d))

template <typename E>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (kHalf<E>)
    ATTN_WGMMA_RS_N128("f16");
  else
    ATTN_WGMMA_RS_N128("bf16");
}

// (lo, hi) rounded to E and packed in one register
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf<E>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// p[0], p[1] = lo, hi rounded to E (p 4-byte aligned)
template <typename E>
__device__ __forceinline__ void store2(E* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<E>(lo, hi);
}

// ---------------------------------------------------------------------
// Warpgroup products. The fp32 accumulator of an m64nN product holds, in
// thread t of the warpgroup (warp w = t / 32, lane l), element e at row
// 16 w + l / 4 + 8 ((e / 2) % 2) and column 8 (e / 4) + 2 (l % 4) + e % 2.
// ---------------------------------------------------------------------
template <int N, typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64<E>(d, a, db, 1);
  else
    wgmma_rs_n128<E>(d, a, db, 1);
}

// d[64 x 64] = A B^T over D: A rows ra .. ra + 63 of an RA-row tile, B
// rows rb .. rb + 63 of an RB-row tile, both K-major (started, not
// waited for)
template <int D, int RA, int RB, typename E>
__device__ __forceinline__ void gemm_abt(float (&d)[32], const E* a,
                                         int ra, const E* b, int rb) {
  const uint32_t a0 = smem_u32(a) + ra * 128;
  const uint32_t b0 = smem_u32(b) + rb * 128;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64<E>(d, desc_sw128(a0 + (kk / 4) * RA * 128 + off, 16, 1024),
                 desc_sw128(b0 + (kk / 4) * RB * 128 + off, 16, 1024),
                 kk > 0);
  }
}

// d[64 x D] += P B over K rows: P as K / 16 A fragments (`pack_a`),
// B rows kb .. kb + K - 1 of an RB-row tile read MN-major (started, not
// waited for)
template <int D, int K, int RB, typename E>
__device__ __forceinline__ void gemm_pb(float (&d)[D / 2],
                                        const uint32_t (&p)[K / 16][4],
                                        const E* b, int kb) {
  const uint32_t b0 = smem_u32(b) + kb * 128;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<D, E>(d, p[kk],
                   desc_sw128(b0 + kk * 16 * 128, RB * 128, 1024));
}

// the accumulator of an m64nN product, rounded to E, as the A fragments
// of a product over its N columns
template <int N, typename E>
__device__ __forceinline__ void pack_a(const float (&s)[N / 2],
                                       uint32_t (&p)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack2<E>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------
// The walk (attention_tiles.cuh's interface: count, tile, vis) of dense
// attention, plus which tile pairs need a mask and which a warpgroup can
// skip (`partial` and `empty`, given the step too).
// ---------------------------------------------------------------------
// visibility of score (row, col) of the tile pair at positions (q0, k0):
// the causal triangle and keys before the sequence's end
struct DenseVis {
  int q0, k0, causal, seq;
  __device__ __forceinline__ bool operator()(int row, int col) const {
    const int k = k0 + col;
    return k < seq && (!causal || k <= q0 + row);
  }
};

// tiles first .. first + n - 1 along the walked axis
struct DenseWalk90 {
  int first, n, causal, seq;
  __device__ __forceinline__ int count() const { return n; }
  __device__ __forceinline__ int tile(int s) const { return first + s; }
  __device__ __forceinline__ DenseVis vis(int, int q0, int k0) const {
    return DenseVis{q0, k0, causal, seq};
  }
  // whether the nq x nk pair at (q0, k0), step s of the walk, holds a
  // hidden score
  __device__ __forceinline__ bool partial(int, int q0, int nq, int k0,
                                          int nk) const {
    return k0 + nk > seq || (causal && k0 + nk - 1 > q0);
  }
  // whether it holds nothing visible
  __device__ __forceinline__ bool empty(int, int q0, int nq, int k0) const {
    return causal && k0 > q0 + nq - 1;
  }
};

// The ring of streamed tiles (hopper.cuh) over the 8 consumer warps
constexpr int kWarps = kConsumers * 4;
template <int kS, int kF>
using Ring = hopper::Ring<kS, kF, kWarps>;

// __expf's log2 counterpart: ex2.approx with denormals flushed (the
// exponents here are <= 0 and p below 2^-126 is 0 to the products)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// Hidden scores of an m64nN accumulator (`vis(row, col)` false) set to
// -inf before the scale: exp2 of them is 0 as of the -1e30 the twins
// use, and a row max they would set never reaches past -1e30. hide_t
// is the transposed tile's (rows keys, columns queries).
template <int R, typename Vis>
__device__ __forceinline__ void hide(float (&s)[R], const Vis& vis, int warp,
                                     int lane) {
#pragma unroll
  for (int e = 0; e < R; ++e)
    if (!vis(warp * 16 + lane / 4 + 8 * ((e / 2) % 2),
             8 * (e / 4) + 2 * (lane % 4) + e % 2))
      s[e] = neg_inf();
}
template <int R, typename Vis>
__device__ __forceinline__ void hide_t(float (&s)[R], const Vis& vis,
                                       int warp, int lane) {
#pragma unroll
  for (int e = 0; e < R; ++e)
    if (!vis(8 * (e / 4) + 2 * (lane % 4) + e % 2,
             warp * 16 + lane / 4 + 8 * ((e / 2) % 2)))
      s[e] = neg_inf();
}

// ---------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------
// 64-row K/V tiles in a ring of 4 (D 64) or 2 (D 128) stages; two CTAs
// per SM, so one CTA's softmax runs beside the other's products
template <int D>
struct FwdCfg {
  static constexpr int kN = kStep;
  static constexpr int kS = D == 64 ? 4 : 2;
  static constexpr int kBlocks = 2;
  using R = Ring<kS, 2>;  // barriers: K, V
  static constexpr size_t q = 0;
  static constexpr size_t k = q + size_t(kRows) * D * 2;
  static constexpr size_t v = k + size_t(kS) * kN * D * 2;
  static constexpr size_t bar = v + size_t(kS) * kN * D * 2;
  static constexpr size_t bytes = bar + 8 + R::bytes + 1024;
};

// One 128-row q tile `qt` of head bh (b, h) over the walk's K/V tiles:
// S = Q K^T, the online softmax in log2 space (the running max m and sum
// l of each row, the exponents of a row that has seen nothing visible
// yet taken against -5e29 so masked p are 0, l and O rescaled once per
// K/V tile), O = O alpha + P V with P rounded to E (v's type), then
// `fwd_store_row`'s epilogue: K1 writes out = O / l and lse = m +
// log2(l) (+inf for a row that saw nothing); K5 folds in the carry
// (prev_out, prev_lse) and writes out (fp32), the merged lse and lse_n.
template <int D, bool Merge, typename Walk, typename E = bf16>
__device__ __forceinline__ void fwd_body(
    const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
    FwdOut<Merge, E>* __restrict__ out, float* __restrict__ lse,
    int seq, int heads, float scale_log2, int qt, int bh, const Walk& walk,
    const MergeIn& mg) {
  using C = FwdCfg<D>;
  constexpr int kN = C::kN, kS = C::kS;
  unsigned char* sm = smem_base();
  E* sQ = reinterpret_cast<E*>(sm + C::q);
  E* sK = reinterpret_cast<E*>(sm + C::k);
  E* sV = reinterpret_cast<E*>(sm + C::v);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sm + C::bar);
  const auto ring = ring_at<typename C::R>(sm + C::bar);
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, n = walk.count();
  auto load = [&](int it) {
    const int k0 = walk.tile(it) * kN, st = it % kS;
    mbar_expect_tx(ring.full(it, 0), kN * D * 2);
    tma_tile<kN, D>(sK + st * kN * D, mk, ring.full(it, 0), h, k0, b);
    mbar_expect_tx(ring.full(it, 1), kN * D * 2);
    tma_tile<kN, D>(sV + st * kN * D, mv, ring.full(it, 1), h, k0, b);
  };
  if (tid == 0) {
    mbar_init(full_q, 1);
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(full_q, kRows * D * 2);
    tma_tile<kRows, D>(sQ, mq, full_q, h, qt * kRows, b);
    for (int it = 0; it < n && it < kS; ++it) load(it);
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q0 = qt * kRows + wg * 64;  // the warpgroup's first row
  float o[D / 2], s[kN / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(full_q, 0);

  for (int it = 0; it < n; ++it) {
    const int st = it % kS;
    const int k0 = walk.tile(it) * kN;
    ring.wait(it, 0);
    if (!walk.empty(it, q0, 64, k0)) {
      wg_fence();
      gemm_abt<D, kRows, kN>(s, sQ, wg * 64, sK + st * kN * D, 0);
      wg_commit();
      wg_wait();
      reg_fence(s);

      if (walk.partial(it, q0, 64, k0, kN))
        hide(s, walk.vis(it, q0, k0), warp, lane);
      // the row max of the raw scores scaled is that of the scaled
      // scores (scale_log2 > 0); the scale then folds into one FFMA
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = neg_inf();
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        const float m_new = fmaxf(m[i], quad_max(mx) * scale_log2);
        const float m_safe = fmaxf(m_new, 0.5f * kNegInf);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            s[e] = ex2(fmaf(s[e], scale_log2, -m_safe));
            sum += s[e];
          }
        alpha[i] = ex2(fminf(m[i] - m_safe, 0.f));
        l[i] = alpha[i] * l[i] + quad_sum(sum);
        m[i] = m_new;
      }
      // alpha = 1 leaves O as it is: skip the rescale where no row of
      // the warp raised its max
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e / 2) % 2];
      }
      uint32_t p[kN / 16][4];
      pack_a<kN, E>(s, p);

      ring.wait(it, 1);
      wg_fence();
      gemm_pb<D, kN, kN>(o, p, sV + st * kN * D, 0);
      wg_commit();
      wg_wait();
      reg_fence(o);
      reg_fence(p);
    }
    if (lane == 0 && ring.release(it) && it + kS < n) load(it + kS);
    __syncwarp();
  }

  // epilogue: the thread's two rows, columns 8 j + 2 (lane % 4) + {0, 1}
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + warp * 16 + lane / 4 + 8 * i;
    if (t >= seq) continue;
    const long long row = static_cast<long long>(bh) * seq + t;
    FwdOut<Merge, E>* orow =
        out + ((static_cast<long long>(b) * seq + t) * heads + h) * D;
    // one reciprocal per row where the twins divide each element: the
    // products differ from the quotients by at most one fp32 ulp
    if constexpr (!Merge) {
      const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        store2<E>(orow + col, o[4 * j + 2 * i] * inv_l,
                  o[4 * j + 2 * i + 1] * inv_l);
      }
      if (lane % 4 == 0) lse[row] = l[i] > 0.f ? m[i] + log2f(l[i]) : inf;
    } else {
      const float lse_n = l[i] > 0.f ? m[i] + log2f(l[i]) : -inf;
      const float plse = mg.prev_lse[row];
      const float mm = fmaxf(lse_n, plse);
      const float w_p = exp2f(plse - mm);
      const float w_sum = w_p + exp2f(lse_n - mm);
      const float inv = 1.f / w_sum;
      const float w_acc = exp2f(m[i] - mm) * inv;
      const float w_prev = w_p * inv;
      // the wrapper hands prev_out with 8-byte aligned rows
      const float* prow = mg.prev_out + b * mg.pb + t * mg.pt + h * mg.ph;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float2 pv = *reinterpret_cast<const float2*>(prow + col);
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(pv.x * w_prev + o[4 * j + 2 * i] * w_acc,
                        pv.y * w_prev + o[4 * j + 2 * i + 1] * w_acc);
      }
      if (lane % 4 == 0) {
        lse[row] = mm + log2f(w_sum);
        mg.lse_n[row] = l[i] > 0.f ? lse_n : inf;
      }
    }
  }
}

// ---------------------------------------------------------------------
// Backward: the two deterministic sweeps of K2. Each recomputes
// S = Q K^T and dP = dO V^T for its pairs, P = exp2(S - lse) and
// dS = P (dP - delta) sm_scale, with P rounded to dO's dtype and dS to
// q's before their products; every output row is owned by one CTA.
// Both stream 64-row tiles (kStep) past a resident 128-row pair in a
// ring of 3 stages.
// ---------------------------------------------------------------------
template <int D>
struct BwdCfg {
  static constexpr int kS = 3;
  using R = Ring<kS, 1>;
  // resident pair (K, V or Q, dO), streamed pair, the streamed lse and
  // delta rows (dK/dV sweep)
  static constexpr size_t a = 0;
  static constexpr size_t b = a + size_t(kRows) * D * 2;
  static constexpr size_t c = b + size_t(kRows) * D * 2;
  static constexpr size_t d = c + size_t(kS) * kStep * D * 2;
  static constexpr size_t rows = d + size_t(kS) * kStep * D * 2;
  static constexpr size_t bar = rows + size_t(kS) * 2 * kStep * 4;
  static constexpr size_t bytes = bar + 8 + R::bytes + 1024;
  // CTAs per SM: the dK/dV sweep holds two accumulators
  static constexpr int kDkvBlocks = 1;
  static constexpr int kDqBlocks = D == 64 ? 2 : 1;
};

// dK, dV of the 128-row k tile `kt` of head bh over the walk's 64-row q
// steps. K and V stay resident; the ring streams Q, dO and the step's
// lse and delta rows. Each warpgroup computes the transposed scores
// S^T = K Q^T and dP^T = V dO^T of its 64 keys, so that P^T and dS^T
// land in registers as the A operands of dV += P^T dO and dK += dS^T Q
// (dO and Q read MN-major).
template <int D, typename Walk, typename E>
__device__ __forceinline__ void dkv_body(
    const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
    const CUtensorMap& mdo, const float* __restrict__ lse,
    const float* __restrict__ delta, E* __restrict__ dk,
    E* __restrict__ dv, int seq, int heads, float scale_log2,
    float sm_scale, int kt, int bh, const Walk& walk) {
  using C = BwdCfg<D>;
  constexpr int kS = C::kS;
  unsigned char* sm = smem_base();
  E* sK = reinterpret_cast<E*>(sm + C::a);
  E* sV = reinterpret_cast<E*>(sm + C::b);
  E* sQ = reinterpret_cast<E*>(sm + C::c);
  E* sdO = reinterpret_cast<E*>(sm + C::d);
  float* sRows = reinterpret_cast<float*>(sm + C::rows);  // [S][lse, delta]
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sm + C::bar);
  const auto ring = ring_at<typename C::R>(sm + C::bar);
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, n = walk.count();
  const float* lse_h = lse + static_cast<long long>(bh) * seq;
  const float* delta_h = delta + static_cast<long long>(bh) * seq;
  auto load = [&](int it) {
    const int q0 = walk.tile(it) * kStep, st = it % kS;
    uint64_t* bar = ring.full(it, 0);
    mbar_expect_tx(bar, 2 * kStep * D * 2 + 2 * kStep * 4);
    tma_tile<kStep, D>(sQ + st * kStep * D, mq, bar, h, q0, b);
    tma_tile<kStep, D>(sdO + st * kStep * D, mdo, bar, h, q0, b);
    bulk_load(sRows + st * 2 * kStep, lse_h + q0, kStep * 4, bar);
    bulk_load(sRows + st * 2 * kStep + kStep, delta_h + q0, kStep * 4, bar);
  };
  if (tid == 0) {
    mbar_init(full_kv, 1);
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(full_kv, 2 * kRows * D * 2);
    tma_tile<kRows, D>(sK, mk, full_kv, h, kt * kRows, b);
    tma_tile<kRows, D>(sV, mv, full_kv, h, kt * kRows, b);
    for (int it = 0; it < n && it < kS; ++it) load(it);
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int k0 = kt * kRows + wg * 64;  // the warpgroup's first key
  float acc_dk[D / 2], acc_dv[D / 2], st_[kStep / 2], dpt[kStep / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_dk[e] = acc_dv[e] = 0.f;
  mbar_wait(full_kv, 0);

  for (int it = 0; it < n; ++it) {
    const int st = it % kS;
    const int q0 = walk.tile(it) * kStep;
    ring.wait(it, 0);
    if (!walk.empty(it, q0, kStep, k0)) {
      const E* q_s = sQ + st * kStep * D;
      const E* do_s = sdO + st * kStep * D;
      const float* lse_s = sRows + st * 2 * kStep;
      const float* delta_s = lse_s + kStep;
      // the pair's visibility, taken before the products (a table walk
      // works out its mask here, so one register of it lives across them;
      // taken after they start and before their wait, it spilled at D 64)
      const auto vis = walk.vis(it, q0, k0);
      wg_fence();
      gemm_abt<D, kRows, kStep>(st_, sK, wg * 64, q_s, 0);
      gemm_abt<D, kRows, kStep>(dpt, sV, wg * 64, do_s, 0);
      wg_commit();
      wg_wait();
      reg_fence(st_);
      reg_fence(dpt);
      // element e: key row 16 warp + lane / 4 + 8 ((e / 2) % 2) of the
      // warpgroup's 64, query column c = 8 (e / 4) + 2 (lane % 4) + e % 2
      if (walk.partial(it, q0, kStep, k0, 64))
        hide_t(st_, vis, warp, lane);
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dl2 = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i;
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
      wg_wait();
      reg_fence(acc_dv);
      reg_fence(acc_dk);
      reg_fence(pa);
      reg_fence(da);
    }
    if (lane == 0 && ring.release(it) && it + kS < n) load(it + kS);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + warp * 16 + lane / 4 + 8 * i;
    if (t >= seq) continue;
    const long long at =
        ((static_cast<long long>(b) * seq + t) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      store2<E>(dk + at + col, acc_dk[4 * j + 2 * i],
                acc_dk[4 * j + 2 * i + 1]);
      store2<E>(dv + at + col, acc_dv[4 * j + 2 * i],
                acc_dv[4 * j + 2 * i + 1]);
    }
  }
}

// dQ of the 128-row q tile `qt` of head bh over the walk's 64-row k
// steps. Q and dO stay resident, the ring streams K and V; each
// warpgroup computes S and dP of its 64 queries, forms dS in registers
// and accumulates dQ += dS K (K read MN-major).
template <int D, typename Walk, typename E>
__device__ __forceinline__ void dq_body(
    const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
    const CUtensorMap& mdo, const float* __restrict__ lse,
    const float* __restrict__ delta, E* __restrict__ dq, int seq,
    int heads, float scale_log2, float sm_scale, int qt, int bh,
    const Walk& walk) {
  using C = BwdCfg<D>;
  constexpr int kS = C::kS;
  unsigned char* sm = smem_base();
  E* sQ = reinterpret_cast<E*>(sm + C::a);
  E* sdO = reinterpret_cast<E*>(sm + C::b);
  E* sK = reinterpret_cast<E*>(sm + C::c);
  E* sV = reinterpret_cast<E*>(sm + C::d);
  uint64_t* full_qdo = reinterpret_cast<uint64_t*>(sm + C::bar);
  const auto ring = ring_at<typename C::R>(sm + C::bar);
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, n = walk.count();
  auto load = [&](int it) {
    const int k0 = walk.tile(it) * kStep, st = it % kS;
    uint64_t* bar = ring.full(it, 0);
    mbar_expect_tx(bar, 2 * kStep * D * 2);
    tma_tile<kStep, D>(sK + st * kStep * D, mk, bar, h, k0, b);
    tma_tile<kStep, D>(sV + st * kStep * D, mv, bar, h, k0, b);
  };
  if (tid == 0) {
    mbar_init(full_qdo, 1);
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(full_qdo, 2 * kRows * D * 2);
    tma_tile<kRows, D>(sQ, mq, full_qdo, h, qt * kRows, b);
    tma_tile<kRows, D>(sdO, mdo, full_qdo, h, qt * kRows, b);
    for (int it = 0; it < n && it < kS; ++it) load(it);
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q0 = qt * kRows + wg * 64;  // the warpgroup's first query
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + warp * 16 + lane / 4 + 8 * i;
    const long long row = static_cast<long long>(bh) * seq + t;
    lse_r[i] = t < seq ? lse[row] : 0.f;
    delta_r[i] = t < seq ? delta[row] : 0.f;
  }
  float acc[D / 2], s[kStep / 2], dp[kStep / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  mbar_wait(full_qdo, 0);

  for (int it = 0; it < n; ++it) {
    const int st = it % kS;
    const int k0 = walk.tile(it) * kStep;
    ring.wait(it, 0);
    if (!walk.empty(it, q0, 64, k0)) {
      const E* k_s = sK + st * kStep * D;
      const auto vis = walk.vis(it, q0, k0);  // as in dkv_body
      wg_fence();
      gemm_abt<D, kRows, kStep>(s, sQ, wg * 64, k_s, 0);
      gemm_abt<D, kRows, kStep>(dp, sdO, wg * 64, sV + st * kStep * D, 0);
      wg_commit();
      wg_wait();
      reg_fence(s);
      reg_fence(dp);
      if (walk.partial(it, q0, 64, k0, kStep))
        hide(s, vis, warp, lane);
#pragma unroll
      for (int e = 0; e < kStep / 2; ++e) {
        const int i = (e / 2) % 2;
        const float p = ex2(fmaf(s[e], scale_log2, -lse_r[i]));
        dp[e] = p * (dp[e] - delta_r[i]) * sm_scale;
      }
      uint32_t da[kStep / 16][4];
      pack_a<kStep, E>(dp, da);
      wg_fence();
      gemm_pb<D, kStep, kStep>(acc, da, k_s, 0);
      wg_commit();
      wg_wait();
      reg_fence(acc);
      reg_fence(da);
    }
    if (lane == 0 && ring.release(it) && it + kS < n) load(it + kS);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + warp * 16 + lane / 4 + 8 * i;
    if (t >= seq) continue;
    E* row = dq + ((static_cast<long long>(b) * seq + t) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<E>(row + 8 * j + 2 * (lane % 4), acc[4 * j + 2 * i],
                acc[4 * j + 2 * i + 1]);
  }
}

// ---------------------------------------------------------------------
// Grid order. A 1-D grid of nt tiles for each of the B*H heads (so B*H
// is not bounded by grid.y), in groups of `group` heads: within a group
// tile-major, every head's longest causal tile before any shorter one,
// so the group's last wave holds short work; the groups one after the
// other, each sized so that the operands its tiles stream (K and V, or
// Q and dO) stay in L2 while its tiles run.
// ---------------------------------------------------------------------
struct GridOrder {
  int group;
  // (b*h, position along its head's longest-first order) of this CTA
  __device__ __forceinline__ void at(int nt, int& bh, int& rank) const {
    const int heads_total = gridDim.x / nt;
    const int g = blockIdx.x / (group * nt);
    const int first = g * group;
    const int size = min(group, heads_total - first);
    const int i = blockIdx.x - first * nt;
    rank = i / size;
    bh = first + i % size;
  }
};

// the heads whose two streamed 16-bit operands fill kL2Budget bytes
constexpr long long kL2Budget = 32ll << 20;
inline GridOrder grid_order(long long heads_total, int seq, int d) {
  const long long per_head = static_cast<long long>(seq) * d * 2 * 2;
  long long g = kL2Budget / per_head;
  g = g < 1 ? 1 : g > heads_total ? heads_total : g;
  return GridOrder{static_cast<int>(g)};
}

// ---------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------
// The map of a 16-bit [B, T, H, D] tensor (`dt`: bf16 unless the caller
// passes fp16's `map_type<__half>()`) read through its element strides
// (b, t, h), D contiguous: dims (D, H, T, B), boxes of 64 columns x
// `rows` rows of one head, 128-byte swizzle, rows past T read as zeros.
// The wrapper guarantees a 16-byte aligned base and 16-byte strides; a
// dimension of extent 1 takes a stride of 16 bytes (never stepped).
template <typename E>
constexpr CUtensorMapDataType map_type() {
  return kHalf<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

inline int make_map(CUtensorMap* map, const void* base, int batch, int seq,
                    int heads, int d, long long sb, long long st,
                    long long sh, int rows,
                    CUtensorMapDataType dt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  auto stride = [](long long elems, int extent) -> cuuint64_t {
    return extent == 1 ? 16 : static_cast<cuuint64_t>(elems) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {stride(sh, heads), stride(st, seq),
                                 stride(sb, batch)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return encode(map, dt, 4, base, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace sm90
}  // namespace attn
