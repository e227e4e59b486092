// Shared pieces of the causal flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu) for Hopper (sm_90a).
//
// Layout at the C boundary is the JAX package's [B, S, H, D] (contiguous,
// bf16): the row of position s of head h is D contiguous values, rows of one
// head are H * D apart.  lse and delta are f32 [B, Hq, S].  Query head h
// reads kv head h / (Hq / Hkv).
//
// Tiles are 64 x D bf16 in shared memory with rows padded by 8 values
// (16 bytes), so the 16 x 16 fragment loads of a warp fall on different
// banks; f32 score tiles are padded by 4.  Every tile base is 128-byte
// aligned and every fragment pointer 32-byte aligned, as WMMA requires.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBlock = 64;  // query and key rows per tile (BQ = BK)
constexpr int kWarps = 4;   // each warp owns 16 rows of the CTA's tile
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int D>
struct Tile {
  static constexpr int kLdh = D + 8;       // bf16 [64, D] tile row stride
  static constexpr int kLdf = D + 4;       // f32 [64, D] tile row stride
  static constexpr int kLds = kBlock + 4;  // f32 [64, 64] score tile stride
  static constexpr int kLdp = kBlock + 8;  // bf16 [64, 64] tile stride
  static constexpr size_t kHalfBytes = sizeof(bf16) * kBlock * kLdh;
  static constexpr size_t kF32Bytes = sizeof(float) * kBlock * kLdf;
  static constexpr size_t kScoreBytes = sizeof(float) * kBlock * kLds;
  static constexpr size_t kProbBytes = sizeof(bf16) * kBlock * kLdp;
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static_assert(kHalfBytes % 128 == 0 && kF32Bytes % 128 == 0 &&
                    kScoreBytes % 128 == 0 && kProbBytes % 128 == 0,
                "tile sizes keep every region 128-byte aligned");
};

// Cooperative copy of a [64, D] bf16 tile from global rows `row_stride`
// values apart into shared memory (row stride D + 8), 16 bytes a thread.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < kBlock * kVec; i += kThreads) {
    const int r = i / kVec, c = (i - r * kVec) * 8;
    *reinterpret_cast<uint4*>(dst + r * Tile<D>::kLdh + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

// n f32 values (n a multiple of 8) to bf16 in global memory, 16 bytes at a
// time: each value divided by `div` (kDivide) or multiplied by `mul`.
template <bool kDivide>
__device__ __forceinline__ void store_row(bf16* dst, const float* src, float f, int n) {
  for (int c = 0; c < n; c += 8) {
    __align__(16) __nv_bfloat162 t[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = src[c + 2 * e], b = src[c + 2 * e + 1];
      t[e] = kDivide ? __floats2bfloat162_rn(a / f, b / f) : __floats2bfloat162_rn(a * f, b * f);
    }
    *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(t);
  }
}

// acc[n] (16 x 16 each, n over 64 columns) = A_w [16, D] . B^T where B is a
// [64, D] tile: A_w row-major (stride lda), B read column-major (stride D+8).
template <int D>
__device__ __forceinline__ void rows_times_tile_t(FragC (&acc)[4], const bf16* a, int lda,
                                                  const bf16* b) {
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, lda);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + n * 16 * Tile<D>::kLdh + kk * 16, Tile<D>::kLdh);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// acc[dn] += A_w [16, 64] (bf16, stride Tile::kLdp) . B [64, D] (stride D+8)
template <int D>
__device__ __forceinline__ void accumulate_rows_times_tile(FragC (&acc)[D / 16], const bf16* a,
                                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, Tile<D>::kLdp);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * Tile<D>::kLdh + dn * 16, Tile<D>::kLdh);
      wmma::mma_sync(acc[dn], fa, fb, acc[dn]);
    }
  }
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace flash
