// K6: int8 x int8 GEMM with a per-block dequant epilogue, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `_qmm_kernel` of
// deepspeed_tpu/ops/transformer/quantized_matmul.py (launcher
// `_qmm_pallas`). For each group g (G = 1 for a projection, G = E for
// the experts), with Kp = nb * block:
//
//   out[g, m, n] = cast( (sum_b float(P[g, b, m, n]) * sw[g, b, n])
//                        * sx[g, m] )
//   P[g, b, m, n] = sum over k in block b of xq[g, m, k] * wqt[g, n, k]
//
// int8 products summed in int32 within each quantization block (exact:
// |P| <= block * 128 * 128 <= 2^24 for block <= 1024), each block's
// partial converted to fp32, scaled by its column scale and added into
// an fp32 accumulator in ascending b, then the row scale once and the
// cast. Products and sums use __fmul_rn/__fadd_rn, so no FMA is
// contracted and the result equals the plain twin's (the same steps as
// separate torch ops) bit for bit.
//
// Bound on the H100: operations. At the flagship shapes (M = 11,264,
// Kp = 1664 or 6400, N = 1600..6400) 2*M*Kp*N int8 operations at 1,979
// TOPS take 0.03-0.12 ms, while the bytes (int8 operands, bf16 output)
// take a fraction of that at 3.35 TB/s. The TPU kernel walked a
// sequential K grid axis with the accumulator in VMEM scratch; here a
// CTA owns a 128 x 128 output tile at a time and loops over K itself,
// with each warpgroup's 64 x 128 int32 partial and fp32 sum in registers
// (128 of them per thread: a larger tile would spill, and they keep the
// CTA to one per SM). A stage of the tile carries 4.2 M operations for
// 32.5 KB read from L2, so at the int8 peak the tile would draw ~15 TB/s
// from L2, more than L2 gives; and the per-block epilogue costs the
// CUDA cores about as much time as the block's products cost the tensor
// cores. On the H100 the loads alone, the products alone and the
// epilogue alone each take a like share of the kernel's time, and they
// overlap only in part (`kernel_variants.py qmm`).
//
// The design:
// - Loads: 3-D TMA tensor maps (Kp, M, G) of xq and (Kp, N, G) of wqt
//   with 128-byte swizzle, and a 2-D map of sw; a stage is 128 bytes of
//   K (a quantization block at block 128) of 128 rows of each operand
//   plus the block's 128 column scales, in a ring of kS stages. A
//   producer warpgroup (one thread of it) loads each stage once the 8
//   consumer warps have released it, so no consumer warp stops to
//   refill. ptxas sizes the 384-thread CTA at 168 registers a thread,
//   which the consumers' 128 accumulator registers and the rest fit
//   without a spill. Rows past M and N arrive as zeros and are not
//   written: no padded copies.
// - Persistent CTAs, one per SM, walk the output tiles (M fastest) and
//   run the ring on across them, so the next tile's loads fly during a
//   tile's last products and its stores, and no CTA starts cold.
// - Products: wgmma m64n128k32 s32.s8.s8, both operands K-major from
//   the swizzled tiles (8-bit wgmma has no transpose, so the weights
//   come transposed, [G, N, Kp]); scale-d 0 on a block's first k-step
//   restarts the int32 partial.
// - The per-block epilogue (convert, scale, add: three fp32 operations
//   per element, about as many cycles as the block's products) reads
//   the partial once its products are done and the column scales from a
//   ring of 2 kS slots, so a stage's operand tiles go back to the loads
//   before the epilogue runs: the epilogue holds up no load.
// - int32 -> fp32 by cvt (exact for |P| <= 2^24). The magic-number form
//   (an integer add of 0x4B400000 and an exact fp32 subtract, exact for
//   |P| <= 2^22) gives the same bits but puts a third instruction on the
//   fp32 pipe, which the epilogue fills: it is the slower of the two on
//   the H100 at the flagship shapes (`kernel_variants.py qmm`, "magic").
//
// Layouts. xq [G, M, Kp] int8, wqt [G, N, Kp] int8 (K contiguous), sx
// [G, M] fp32, sw [G, nb, sw_cols] fp32 (sw_cols >= N, a multiple of 4:
// TMA's 16-byte row stride), out [G, M, N] fp32 (dt 0), bf16 (dt 1) or
// fp16 (dt 2: the fp32 result rounded once, inf past 65504 as JAX's
// `astype` gives it).
// The wrapper checks Kp % block == 0, block % 128 == 0 and 16-byte
// aligned bases.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;           // output rows per CTA: 2 warpgroups
constexpr int kBN = 128;           // output columns per CTA
constexpr int kBK = 128;           // bytes of K per stage (the swizzle row)
constexpr int kS = 4;              // stages in the ring
constexpr int kThreads = 384;      // a producer and 2 consumer warpgroups
using R = Ring<kS, 1, 8>;          // released by the 8 consumer warps

// shared memory: the A and B tiles of every stage (1024-byte aligned),
// the column scales' 2 kS slots, the ring's barriers
struct Cfg {
  static constexpr size_t a = 0;
  static constexpr size_t b = a + size_t(kS) * kBM * kBK;
  static constexpr size_t sw = b + size_t(kS) * kBN * kBK;
  static constexpr size_t bar = sw + size_t(2 * kS) * kBN * 4;
  static constexpr size_t bytes = bar + 8 + R::bytes + 1024;
  static constexpr uint32_t stage_bytes = kBM * kBK + kBN * kBK + kBN * 4;
};

// d[64 x 128] (+)= A[64 x 32] B[128 x 32]^T over int8, A and B K-major
// in shared memory (128-byte swizzle), int32 accumulate; scale_d 0
// overwrites d. Element e of d, in thread t of the warpgroup (warp w =
// t / 32, lane l), is row 16 w + l / 4 + 8 ((e / 2) % 2), column
// 8 (e / 4) + 2 (l % 4) + e % 2.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// two adjacent outputs in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 a,
                                       __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}
__device__ __forceinline__ void store2(__half* p, __half a, __half b) {
  *reinterpret_cast<__half2*>(p) = __halves2half2(a, b);
}

template <typename Out>
__device__ __forceinline__ Out cast(float v);
template <>
__device__ __forceinline__ float cast<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half cast<__half>(float v) {
  return __float2half_rn(v);
}

// The output tiles (g, m0, n0), M fastest, are dealt round-robin to the
// CTAs; a CTA's steps are its tiles' K stages in order, step `it` in
// ring stage it % kS and column-scale slot it % (2 kS). Warpgroup wg
// owns rows m0 + 64 wg .. + 63 of a tile (wg -1 is the producer). Each
// step: wait for its bytes, issue its 4 k-steps, wait for the products,
// hand the stage back to the producer; at a block's last stage fold the
// block into the fp32 sum; at a tile's last, the row scale, the cast and
// the store.
template <typename Out>
__global__ void __launch_bounds__(kThreads, 1)
qmm_kernel(const __grid_constant__ CUtensorMap ma,
           const __grid_constant__ CUtensorMap mb,
           const __grid_constant__ CUtensorMap ms,
           const float* __restrict__ sx, Out* __restrict__ out, int m,
           int n, int kp, int block, int groups) {
  unsigned char* sm = smem_base();
  int8_t* sA = reinterpret_cast<int8_t*>(sm + Cfg::a);
  int8_t* sB = reinterpret_cast<int8_t*>(sm + Cfg::b);
  float* sS = reinterpret_cast<float*>(sm + Cfg::sw);
  const R ring = ring_at<R>(sm + Cfg::bar);
  const int tid = threadIdx.x, wg = tid / 128 - 1, warp = (tid % 128) / 32,
            lane = tid % 32;
  const int nb = kp / block, spb = block / kBK, nk = kp / kBK;
  const int tn = (n + kBN - 1) / kBN, tm = (m + kBM - 1) / kBM;
  const int mine = (groups * tm * tn - blockIdx.x + gridDim.x - 1) /
                   gridDim.x;  // tiles of this CTA
  const int steps = mine * nk;
  // group, first row and first column of the tile of step it
  auto origin = [&](int it, int& g, int& m0, int& n0) {
    const int tile = blockIdx.x + (it / nk) * gridDim.x;
    g = tile / (tm * tn);
    m0 = tile % tm * kBM;
    n0 = tile / tm % tn * kBN;
  };
  auto load = [&](int it) {
    int g, m0, n0;
    origin(it, g, m0, n0);
    const int k = it % nk, st = it % kS;
    uint64_t* bar = ring.full(it, 0);
    mbar_expect_tx(bar, Cfg::stage_bytes);
    tma_load_3d(sA + st * kBM * kBK, ma, bar, k * kBK, m0, g);
    tma_load_3d(sB + st * kBN * kBK, mb, bar, k * kBK, n0, g);
    tma_load_2d(sS + it % (2 * kS) * kBN, ms, bar, n0, g * nb + k / spb);
  };
  if (tid == 0) {
    ring.init();
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg < 0) {
    // the producer: one thread loads each step once the consumers have
    // released its stage
    if (tid == 0)
      for (int it = 0; it < steps; ++it) {
        if (it >= kS) mbar_wait(ring.empty(it), (it / kS - 1) & 1);
        load(it);
      }
    return;
  }

  int part[64];
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) part[e] = 0;
  for (int it = 0; it < steps;) {
    int g, m0, n0;
    origin(it, g, m0, n0);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    for (int k = 0; k < nk; ++k, ++it) {
      const int st = it % kS;
      ring.wait(it, 0);
      const uint32_t a0 = smem_u32(sA + st * kBM * kBK) + wg * 64 * kBK;
      const uint32_t b0 = smem_u32(sB + st * kBN * kBK);
      const bool first = k % spb == 0;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8_n128(part, desc_sw128(a0 + kk * 32, 16, 1024),
                      desc_sw128(b0 + kk * 32, 16, 1024),
                      !(first && kk == 0));
      wg_commit();
      wg_wait();
      reg_fence(part);
      if (lane == 0) mbar_arrive(ring.empty(it));
      __syncwarp();
      if (k % spb == spb - 1) {
        const float* sws = sS + it % (2 * kS) * kBN;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const float2 s2 = *reinterpret_cast<const float2*>(
              sws + 8 * j + 2 * (lane % 4));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i;
            acc[e] = __fadd_rn(acc[e], __fmul_rn(__int2float_rn(part[e]),
                                                 s2.x));
            acc[e + 1] = __fadd_rn(
                acc[e + 1], __fmul_rn(__int2float_rn(part[e + 1]), s2.y));
          }
        }
      }
    }

    // the row scale once, the cast, the masked store
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * i;
      if (row >= m) continue;
      const float rs = sx[static_cast<long long>(g) * m + row];
      Out* orow = out + (static_cast<long long>(g) * m + row) * n;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        const Out v0 = cast<Out>(__fmul_rn(acc[4 * j + 2 * i], rs));
        const Out v1 = cast<Out>(__fmul_rn(acc[4 * j + 2 * i + 1], rs));
        if (n % 2 == 0 && col + 1 < n) {
          store2(orow + col, v0, v1);  // an even N keeps the pair aligned
        } else {
          if (col < n) orow[col] = v0;
          if (col + 1 < n) orow[col + 1] = v1;
        }
      }
    }
  }
}

template <typename Out>
int launch(const CUtensorMap& ma, const CUtensorMap& mb,
           const CUtensorMap& ms, const float* sx, void* out, int groups,
           int m, int n, int kp, int block, int device,
           cudaStream_t stream) {
  auto kern = qmm_kernel<Out>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(Cfg::bytes));
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long tiles = static_cast<long long>(groups) *
                          ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kern<<<grid, kThreads, Cfg::bytes, stream>>>(
      ma, mb, ms, sx, static_cast<Out*>(out), m, n, kp, block, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [groups, m, n] = per-block dequantized xq [groups, m, kp] @
// wqt[groups, n, kp]^T; sw [groups, kp / block, sw_cols]. dt: 0 =
// float32, 1 = bfloat16, 2 = float16 output. Returns
// cudaGetLastError(), or kMapError when a tensor map cannot be encoded.
extern "C" int ds_quantized_matmul(const void* xq, const void* wqt,
                                   const void* sx, const void* sw, void* out,
                                   int groups, int m, int n, int kp,
                                   int block, int sw_cols, int dt,
                                   int device, void* stream) {
  cudaSetDevice(device);
  if (groups <= 0 || m <= 0 || n <= 0) return 0;
  const int nb = kp / block;
  CUtensorMap ma, mb, ms;
  const cuuint64_t da[3] = {static_cast<cuuint64_t>(kp),
                            static_cast<cuuint64_t>(m),
                            static_cast<cuuint64_t>(groups)};
  const cuuint64_t sa[2] = {static_cast<cuuint64_t>(kp),
                            static_cast<cuuint64_t>(kp) * m};
  const cuuint64_t db[3] = {static_cast<cuuint64_t>(kp),
                            static_cast<cuuint64_t>(n),
                            static_cast<cuuint64_t>(groups)};
  const cuuint64_t sb[2] = {static_cast<cuuint64_t>(kp),
                            static_cast<cuuint64_t>(kp) * n};
  const cuuint32_t abox[3] = {kBK, kBM, 1}, bbox[3] = {kBK, kBN, 1};
  const cuuint64_t ds[2] = {static_cast<cuuint64_t>(sw_cols),
                            static_cast<cuuint64_t>(groups) * nb};
  const cuuint64_t ss[1] = {static_cast<cuuint64_t>(sw_cols) * 4};
  const cuuint32_t sbox[2] = {kBN, 1};
  if (hopper::encode(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, xq, da, sa, abox,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      hopper::encode(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, wqt, db, sb,
                     bbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      hopper::encode(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, sw, ds, ss,
                     sbox, CU_TENSOR_MAP_SWIZZLE_NONE))
    return hopper::kMapError;
  const auto* rs = static_cast<const float*>(sx);
  auto s = static_cast<cudaStream_t>(stream);
  if (dt == 1)
    return launch<__nv_bfloat16>(ma, mb, ms, rs, out, groups, m, n, kp,
                                 block, device, s);
  if (dt == 2)
    return launch<__half>(ma, mb, ms, rs, out, groups, m, n, kp, block,
                          device, s);
  return launch<float>(ma, mb, ms, rs, out, groups, m, n, kp, block, device,
                       s);
}
