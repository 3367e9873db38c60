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
// |P| <= block * 127 * 127 < 2^24 for block <= 1024), each block's
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
// sequential K grid axis with the accumulator in VMEM scratch; here one
// CTA owns a 128 x 128 output tile and loops over the K axis itself,
// with the int32 partial and the fp32 accumulator in registers. The
// design is the simple correct one, not the fast one: mma.sync
// m16n8k32 s8 (about half of what wgmma reaches), a two-stage cp.async
// pipeline of 64-byte K slices, 8 warps of 64 x 32. The wgmma + TMA
// form is ROADMAP work.
//
// Layouts. xq [G, M, Kp] int8 (K contiguous: mma's row-major A). The
// weights come TRANSPOSED, wqt [G, N, Kp] (K contiguous per output
// column: mma's "col" B), because ldmatrix.trans exists only for 16-bit
// elements and a transpose in shared memory costs a pass per tile,
// while the wrapper's transpose of the int8 weight costs one
// weight-sized copy per call (<= 10 MB at gpt2-1.5b, against >= 18 MB
// of int8 activations). sx [G, M] and sw [G, nb, N] fp32. out [G, M, N]
// fp32 (dt 0) or bf16 (dt 1). Rows of M and N past the edge load as
// zeros (cp.async's zero fill) and are not written: no padded copies.
// The wrapper checks Kp % block == 0, block % 64 == 0 and 16-byte
// aligned rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;            // output rows per CTA
constexpr int kBN = 128;            // output columns per CTA
constexpr int kBK = 64;             // bytes of K per pipeline stage
constexpr int kLds = kBK + 16;      // smem row stride: conflict-free frags
constexpr int kThreads = 256;       // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMi = kWarpM / 16;    // m16 tiles per warp
constexpr int kNi = kWarpN / 8;     // n8 tiles per warp

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage: kBM rows of xq and kBN rows of wqt, kBK bytes each, as
// 16-byte chunks (4 per row, 2 per thread per operand). Rows past the
// edge read 0 bytes (zero fill) from a valid address.
__device__ __forceinline__ void load_stage(
    int8_t* as, int8_t* bs, const int8_t* xq, const int8_t* wqt, int m0,
    int n0, int m, int n, long long kp, long long k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = tid + i * kThreads;
    const int r = chunk >> 2;
    const int c = (chunk & 3) * 16;
    const int row_a = m0 + r;
    const int8_t* ga = xq + (row_a < m ? row_a : 0) * kp + k0 + c;
    cp_async16(as + r * kLds + c, ga, row_a < m ? 16 : 0);
    const int row_b = n0 + r;
    const int8_t* gb = wqt + (row_b < n ? row_b : 0) * kp + k0 + c;
    cp_async16(bs + r * kLds + c, gb, row_b < n ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    qmm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wqt,
               const float* __restrict__ sx, const float* __restrict__ sw,
               void* __restrict__ out, int m, int n, int kp, int block,
               int dt) {
  __shared__ __align__(16) int8_t smem_a[2][kBM * kLds];
  __shared__ __align__(16) int8_t smem_b[2][kBN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;   // 0..1
  const int wn = warp & 3;    // 0..3
  const int gid = lane >> 2;  // mma groupID
  const int tig = lane & 3;   // mma threadID_in_group
  const int g = blockIdx.z;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int nb = kp / block;
  const int steps_per_block = block / kBK;
  const int nk = kp / kBK;

  xq += static_cast<long long>(g) * m * kp;
  wqt += static_cast<long long>(g) * n * kp;
  sx += static_cast<long long>(g) * m;
  sw += static_cast<long long>(g) * nb * n;

  int part[kMi][kNi][4];
  float acc[kMi][kNi][4];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNi; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[i][j][e] = 0;
        acc[i][j][e] = 0.0f;
      }

  load_stage(smem_a[0], smem_b[0], xq, wqt, m0, n0, m, n, kp, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_stage(smem_a[st ^ 1], smem_b[st ^ 1], xq, wqt, m0, n0, m, n, kp,
                 static_cast<long long>(kt + 1) * kBK, tid);
    }
    cp_async_commit();
    cp_async_wait_1();  // every group but the newest: stage kt is in
    __syncthreads();

    const int8_t* as = smem_a[st] + (wm * kWarpM) * kLds;
    const int8_t* bs = smem_b[st] + (wn * kWarpN) * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[kMi][4];
      unsigned bf[kNi][2];
#pragma unroll
      for (int i = 0; i < kMi; ++i) {
        const int8_t* p = as + (i * 16 + gid) * kLds + kk + tig * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kLds);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
        const int8_t* p = bs + (j * 8 + gid) * kLds + kk + tig * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMi; ++i)
#pragma unroll
        for (int j = 0; j < kNi; ++j) mma_s8(part[i][j], af[i], bf[j]);
    }

    if ((kt + 1) % steps_per_block == 0) {
      // the end of quantization block b: acc += float(part) * sw[b, col]
      const float* swb = sw + static_cast<long long>(kt / steps_per_block) * n;
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
        const int col = n0 + wn * kWarpN + j * 8 + tig * 2;
        const float s0 = col < n ? swb[col] : 0.0f;
        const float s1 = col + 1 < n ? swb[col + 1] : 0.0f;
#pragma unroll
        for (int i = 0; i < kMi; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float s = (e & 1) ? s1 : s0;
            acc[i][j][e] = __fadd_rn(
                acc[i][j][e], __fmul_rn(__int2float_rn(part[i][j][e]), s));
            part[i][j][e] = 0;
          }
        }
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration's load
  }

  // epilogue: the row scale once, the cast, the masked store
  const long long obase = static_cast<long long>(g) * m * n;
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * kWarpM + i * 16 + gid + half * 8;
      if (row >= m) continue;
      const float rs = sx[row];
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + wn * kWarpN + j * 8 + tig * 2 + c;
          if (col >= n) continue;
          const float v = __fmul_rn(acc[i][j][half * 2 + c], rs);
          const long long o = obase + static_cast<long long>(row) * n + col;
          if (dt == 1) {
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
          } else {
            static_cast<float*>(out)[o] = v;
          }
        }
      }
    }
  }
}

}  // namespace

// out [groups, m, n] = per-block dequantized xq [groups, m, kp] @
// wqt[groups, n, kp]^T. dt: 0 = float32, 1 = bfloat16 output. Returns
// cudaGetLastError().
extern "C" int ds_quantized_matmul(const void* xq, const void* wqt,
                                   const void* sx, const void* sw, void* out,
                                   int groups, int m, int n, int kp,
                                   int block, int dt, int device,
                                   void* stream) {
  cudaSetDevice(device);
  if (groups > 0 && m > 0 && n > 0) {
    const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, groups);
    qmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wqt),
        static_cast<const float*>(sx), static_cast<const float*>(sw), out, m,
        n, kp, block, dt);
  }
  return static_cast<int>(cudaGetLastError());
}
