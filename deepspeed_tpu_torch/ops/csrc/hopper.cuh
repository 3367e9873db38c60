// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma
// kernels: the attention bodies of attention_hopper.cuh (K1-fwd, K5, K2,
// K7-band) and the int8 GEMM K6 (quantized_matmul.cu). mbarriers, TMA
// loads, the wgmma fence / commit / wait, shared-memory descriptors of
// 128-byte-swizzled operands, the ring of streamed stages and
// tensor-map encoding on the host.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// never ends (a broken pipeline) traps, failing the launch, instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, 16-byte aligned) of global memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one box of a 2-D or 3-D tensor map into shared memory at coordinates
// (c0 innermost, c1, c2)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap& map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap& map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or reuse of registers that an
// asynchronous wgmma writes (its accumulator) or reads (its A operand)
// across the wait that ends it.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void reg_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets, layout type 1 (SWIZZLE_128B)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// ---------------------------------------------------------------------
// The ring of streamed tiles. Step `it` of a walk lands in stage
// it % kS: full(it, f) counts the TMA bytes of its f-th barrier in,
// empty(it) the kWarps consumer warps out. Thread 0 fills the first kS
// stages; after that the last warp to release a stage (by a counter in
// shared memory) refills it with the step kS ahead, so no warp waits to
// load and no warp is spent on loading alone.
// ---------------------------------------------------------------------
template <int kS, int kF, int kWarps>
struct Ring {
  uint64_t* bar;    // full[kS][kF], then empty[kS]
  unsigned* count;  // [kS]
  static constexpr size_t bar_bytes = 8 * (kS * kF + kS);
  static constexpr size_t bytes = bar_bytes + 4 * kS;

  __device__ __forceinline__ uint64_t* full(int it, int f) const {
    return bar + (it % kS) * kF + f;
  }
  __device__ __forceinline__ uint64_t* empty(int it) const {
    return bar + kS * kF + it % kS;
  }
  // by one thread, before the CTA's barrier
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kS; ++s) {
      for (int f = 0; f < kF; ++f) mbar_init(bar + s * kF + f, 1);
      mbar_init(bar + kS * kF + s, kWarps);
      count[s] = 0;
    }
  }
  __device__ __forceinline__ void wait(int it, int f) const {
    mbar_wait(full(it, f), (it / kS) & 1);
  }
  // lane 0 of each consumer warp, done with step it: true for the last
  // of the kWarps, which then owns the stage
  __device__ __forceinline__ bool release(int it) const {
    mbar_arrive(empty(it));
    if (atomicAdd(count + it % kS, 1u) % kWarps != kWarps - 1) return false;
    mbar_wait(empty(it), (it / kS) & 1);
    return true;
  }
};

// Shared memory: 1024-byte aligned tiles first (the 128-byte swizzle's
// atom), then the barriers
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
}

// the ring whose barriers start 8 bytes into `bars` (after one barrier
// of the kernel's own), its counters after them
template <typename R>
__device__ __forceinline__ R ring_at(unsigned char* bars) {
  return R{reinterpret_cast<uint64_t*>(bars + 8),
           reinterpret_cast<unsigned*>(bars + 8 + R::bar_bytes)};
}

// ---------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA
// runtime (no link against libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the C entries' error code when a tensor map cannot be encoded
constexpr int kMapError = -2;

// A tiled map of `rank` dims (dims[0] contiguous; strides in bytes of
// dims 1 .. rank - 1), boxes of `box`, elements past the edges read as
// zeros; 0 or kMapError.
inline int encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
                  const void* base, const cuuint64_t* dims,
                  const cuuint64_t* strides, const cuuint32_t* box,
                  CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kMapError;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError;
}

}  // namespace hopper
