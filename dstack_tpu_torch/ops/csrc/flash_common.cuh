// Shared pieces of the causal flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu) for Hopper (sm_90a): TMA tile loads, mbarrier rings,
// wgmma products and the shared-memory layout they agree on.
//
// Layout at the C boundary is the JAX package's [B, S, H, D] (contiguous,
// bf16): the row of position s of head h is D contiguous values.  lse and
// delta are f32 [B, Hq, S].  Query head h reads kv head h / (Hq / Hkv).
//
// Tiles in shared memory.  A [R, D] bf16 tile is D / 64 column blocks, each
// [R, 64] with its 128-byte rows in the 128-byte swizzle (16-byte chunk c of
// row r stored at chunk c ^ (r % 8)), each block 1024-byte aligned.  TMA
// writes that layout (CU_TENSOR_MAP_SWIZZLE_128B, a 64-value box width);
// wgmma reads it through descriptors of layout type B128:
//   * K-major operand (the reduction dimension contiguous, as Q and K in
//     S = Q K^T): 8-row groups 1024 bytes apart (SBO); a 16-wide k step
//     moves the start 32 bytes inside the row, a 64-wide one to the next
//     column block.
//   * MN-major operand (the output dimension contiguous, as V in O = P V):
//     the 8 k-rows of one swizzle atom are 128 bytes apart, atoms along k
//     1024 bytes apart (SBO), 64-wide column blocks LBO bytes apart; a
//     16-deep k step moves the start by 16 rows (2048 bytes).
// The f32 accumulator of m64nNk16 gives each thread of a warpgroup rows
// 16 * warp + lane / 4 and that + 8, and columns 8 * i + 2 * (lane % 4) and
// that + 1 for i < N / 8: acc[4i], acc[4i+1] on the first row, acc[4i+2],
// acc[4i+3] on the second.  Packed to bf16 pairs in that order, chunks 2kk
// and 2kk+1 are exactly the register A operand of the k step kk, which is
// how a score tile becomes the left operand of the next product without
// leaving the registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kColBlock = 64;  // values in one 128-byte swizzled row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// counts as having completed a phase of parity 1, so a producer's first
// wait on an empty ring slot (parity 1) passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier over `threads` threads (whole warps) under id `id` (0 is
// __syncthreads's)
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- TMA ----------------------------------------------------------------------

// One [rows, 64] box of the 4-D [B, S, H, D] tensor map at (d0, h, s0, b)
// into shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int d0, int h, int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(d0), "r"(h), "r"(s0), "r"(b)
      : "memory");
}

// Every column block of a [rows, D] tile at (h, s0, b).
template <int D>
__device__ __forceinline__ void tma_load_tile(bf16* dst, int rows, const CUtensorMap* map,
                                              uint64_t* bar, int h, int s0, int b) {
#pragma unroll
  for (int cb = 0; cb < D / kColBlock; ++cb)
    tma_load_4d(dst + cb * rows * kColBlock, map, bar, cb * kColBlock, h, s0, b);
}

// `bytes` contiguous bytes (16-byte aligned) from global into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// dst[box at (d0, h, s0, b)] += the f32 box in shared memory at `src`
// (an asynchronous bulk reduce-add, tracked by the issuing thread's bulk
// groups)
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, const void* src,
                                                  int d0, int h, int s0, int b) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(d0), "r"(h), "r"(s0), "r"(b)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until the issuing thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// wait until the issuing thread's bulk groups are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// -- wgmma ----------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// B128 descriptor of a tile starting at `p` (1024-byte aligned atoms);
// `lbo` is the byte stride between 64-wide column blocks of an MN-major
// operand (unused for K-major ones)
__device__ __forceinline__ uint64_t desc_b128(const void* p, uint32_t lbo = 16) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The asm operand lists of an m64nNk16 f32 accumulator (N / 2 registers).
#define FLASH_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FLASH_F16(i) FLASH_F4(i), FLASH_F4(i + 4), FLASH_F4(i + 8), FLASH_F4(i + 12)
#define FLASH_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define FLASH_R32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FLASH_R64                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B, A and B both from shared memory (descriptors); kTransA /
// kTransB = 1 for an MN-major operand.  `accumulate` = 0 overwrites d.
// (The operand numbers after the accumulator's are spelled out: A, B,
// accumulate, kTransA, kTransB.)
template <int N, int kTransA, int kTransB>
struct WgmmaSS;

#define FLASH_WGMMA_SS(N, REGS, LIST, A, B, P, TA, TB)                                    \
  template <int kTransA, int kTransB>                                                     \
  struct WgmmaSS<N, kTransA, kTransB> {                                                   \
    __device__ __forceinline__ static void run(float (&d)[REGS], uint64_t a, uint64_t b,  \
                                               int accumulate) {                          \
      asm volatile(                                                                       \
          "{\n .reg .pred p;\n setp.ne.b32 p, %" #P ", 0;\n"                               \
          " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " LIST ", %" #A       \
          ", %" #B ", p, 1, 1, %" #TA ", %" #TB ";\n}\n"                                   \
          : FLASH_OPERANDS_##REGS                                                         \
          : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));                 \
    }                                                                                     \
  };

// d += A B with A from registers (four bf16 pairs a thread per k step);
// operands after the accumulator's: a0-a3, B, kTransB
template <int N, int kTransB>
struct WgmmaRS;

#define FLASH_WGMMA_RS(N, REGS, LIST, A0, A1, A2, A3, B, P, TB)                           \
  template <int kTransB>                                                                  \
  struct WgmmaRS<N, kTransB> {                                                            \
    __device__ __forceinline__ static void run(float (&d)[REGS], const uint32_t (&a)[4],  \
                                               uint64_t b) {                              \
      asm volatile(                                                                       \
          "{\n .reg .pred p;\n setp.ne.b32 p, %" #P ", 0;\n"                               \
          " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " LIST ", {%" #A0    \
          ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, %" #TB ";\n}\n"               \
          : FLASH_OPERANDS_##REGS                                                         \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTransB));    \
    }                                                                                     \
  };

#define FLASH_OPERANDS_16 FLASH_F16(0)
#define FLASH_OPERANDS_32 FLASH_F16(0), FLASH_F16(16)
#define FLASH_OPERANDS_64 FLASH_F16(0), FLASH_F16(16), FLASH_F16(32), FLASH_F16(48)

FLASH_WGMMA_SS(32, 16, FLASH_R16, 16, 17, 18, 19, 20)
FLASH_WGMMA_SS(64, 32, FLASH_R32, 32, 33, 34, 35, 36)
FLASH_WGMMA_SS(128, 64, FLASH_R64, 64, 65, 66, 67, 68)
FLASH_WGMMA_RS(64, 32, FLASH_R32, 32, 33, 34, 35, 36, 37, 38)
FLASH_WGMMA_RS(128, 64, FLASH_R64, 64, 65, 66, 67, 68, 69, 70)

// 2^x in one MUFU instruction (results below 2^-126 flush to 0); exp2f
// wraps the same instruction in denormal handling
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bf16 pair (lo in the low half, as the A fragment wants it)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The register A operand of k step kk from an f32 accumulator: chunks 2kk
// and 2kk+1 (8 values), rounded to bf16.
template <int REGS>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const float (&acc)[REGS], int kk) {
  a[0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
}

// Byte offset of value (r, c) of a [rows, 128 bytes] 128-byte-swizzled
// block of bf16 (64 a row) or f32 (32 a row) values.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}
__device__ __forceinline__ uint32_t swizzled_f32(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

// Registers a thread of the warp-specialised kernels (two consumer
// warpgroups, one producer warpgroup, launched at 168 a thread): the
// producer gives up what the consumers take.  The sum must not pass
// 3 * 168, or setmaxnreg.inc waits forever.
constexpr uint32_t kConsumerRegs = 240, kProducerRegs = 24;
static_assert(2 * kConsumerRegs + kProducerRegs <= 3 * 168, "register split over the launch's");

template <uint32_t kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <uint32_t kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Round a dynamic shared-memory base up to 1024 bytes (the launch asks for
// 1 KB more than the layout needs).
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// -- host side ------------------------------------------------------------------

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime (no
// -lcuda at link time)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map over a [B, S, H, D] tensor of bf16 (or f32) whose boxes are
// [rows, 128 bytes] (one position range of one head of one sequence: a box
// never crosses into the next sequence; rows past S read as zero, stores
// and reduce-adds there are dropped), 128-byte swizzled.
inline bool make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int d,
                     int rows, bool f32 = false) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elem = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * elem, (cuuint64_t)heads * d * elem,
                                 (cuuint64_t)seq * heads * d * elem};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem), 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace flash
