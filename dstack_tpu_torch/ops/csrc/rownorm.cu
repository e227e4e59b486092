// Row RMSNorm and its optional rotation epilogue (split-halves RoPE), forward
// and backward, for Hopper (sm_90a): y = rotate(x * rsqrt(mean(x^2) + eps) * w)
// over rows of length n, either step alone or both.
//
// Replaces no Pallas kernel: the JAX package leaves RMSNorm and RoPE to XLA,
// which fuses each chain into one pass on the TPU.  In eager PyTorch the same
// chains ran as a dozen f32 kernels each (forward, remat's recompute and
// backward), every one as large as the rows in f32.  This file is that one
// pass: the training layers' D-wide norms, and q and k's per-head norm and
// rotation in one launch.
//
// What bounds it: bytes.  A forward reads a row and writes it once (bf16: 4
// bytes an element, plus 4 a row for the saved 1 / rms), a backward reads the
// row and its output gradient and writes the input gradient (6 bytes an
// element); a handful of flops an element, nowhere near the card's rate.
//
// What the design does about it:
//   * A row lives in registers, held by TPR threads (a power of two: 4-16 for
//     head rows, 64-256 for model-width rows), each owning PPT pairs of
//     16-byte chunks: chunk c of the row's first half and chunk c of its
//     second, so each element's rotation partner is in the same thread.
//     Loads and stores are 16 bytes a thread, neighbouring threads on
//     neighbouring chunks; nothing f32 goes through device memory but the
//     1 / rms a row and the backward's weight-gradient partials.
//   * The sum of squares (the backward's dot product too) is an f32 sum over
//     the thread's elements, xor shuffles within the row's lanes, then, for
//     rows wider than a warp, the warps' sums through shared memory in a fixed
//     order: no atomics, the same bits on every run.
//   * The arithmetic repeats the plain PyTorch chain step by step with
//     round-to-nearest intrinsics (nothing contracted into an FMA) and rounds
//     to the input's type where the chain does: the normed row before its
//     rotation, the gradient between the rotation and the norm.
//   * Two tensors (q and k) go in one launch: the grid's first blocks take the
//     first tensor's rows, the rest the second's.  cos and sin come from one
//     f32 table [2, P, S, n / 2] by the row's position (row / heads % S, batch
//     row / heads / S when P > 1), shared by every head of a token (L1).
//   * Backward: a grid of as many blocks as fit the SMs walks the row groups;
//     each thread sums its columns' weight gradient over its rows in
//     registers, a block adds its row slots in order into its own f32 partial
//     row, and a second kernel sums the partials column by column in a fixed
//     order and rounds to the weight's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace rownorm {

using bf16 = __nv_bfloat16;

constexpr int kBlock = 256;    // threads a block: kBlock / TPR rows at a time
constexpr int kMaxTpr = 256;   // threads a row at most (one block)

// one tensor's rows: [rows, n], a row's position from ``heads`` rows a token
struct Rows {
  const void* x;    // input rows
  const void* dy;   // backward: output gradient
  void* out;        // forward: y; backward: dx
  const void* w;    // norm weight [n] (unused without the norm)
  float* rstd;      // 1 / rms a row (forward writes it when not null)
  void* dw;         // backward: weight gradient [n] (null: not wanted)
  long long rows;
  int heads;
};

struct Args {
  Rows t[2];
  const float* table;  // [2, P, S, n / 2] cos then sin (rotation only)
  float* part;         // backward: [blocks, n] f32 weight-gradient partials
  int n, seq, table_batch, tpr;
  float eps;
  int blocks0;         // the grid's blocks that take the first tensor
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// v as the type T holds it (the chain's cast to the input's type and back)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// E consecutive values of p as f32 (16-byte loads when they fill them)
template <typename T, int E>
__device__ __forceinline__ void load(const T* p, float (&f)[E]) {
  constexpr int kBytes = E * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) f[i * kPer + j] = to_f(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] = to_f(p[j]);
  }
}

// one 16-byte chunk of T from E = 16 / sizeof(T) values
template <typename T, int E>
__device__ __forceinline__ void store(T* p, const float (&f)[E]) {
  static_assert(E * sizeof(T) == 16, "a chunk is 16 bytes");
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < E; ++j) e[j] = from_f<T>(f[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

// the sum of v over the tpr threads of each row (tpr a power of two); every
// thread of the block calls it, and every thread of a row gets the same bits
__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
  const int lanes = tpr < 32 ? tpr : 32;
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5, per_row = tpr >> 5;
    const int first = (warp / per_row) * per_row;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    v = 0.f;
    for (int i = 0; i < per_row; ++i) v += red[first + i];
    __syncthreads();
  }
  return v;
}

// the row's cos and sin rows in the table
__device__ __forceinline__ const float* table_row(const Args& a, const Rows& r,
                                                  long long row) {
  const long long tok = row / r.heads;
  const long long b = a.table_batch == 1 ? 0 : tok / a.seq;
  return a.table + (b * a.seq + tok % a.seq) * (a.n / 2);
}

template <typename T, typename W, int PPT, bool NORM, bool ROPE>
__global__ void __launch_bounds__(kBlock) fwd_kernel(Args a) {
  constexpr int E = 16 / (int)sizeof(T);
  __shared__ float red[kBlock / 32];
  const int tpr = a.tpr, rpb = kBlock / tpr;
  const int slot = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  const int which = blockIdx.x < (unsigned)a.blocks0 ? 0 : 1;
  const Rows r = which ? a.t[1] : a.t[0];  // no dynamic index into the parameters
  const long long row =
      (long long)(blockIdx.x - (which ? a.blocks0 : 0)) * rpb + slot;
  const bool live = row < r.rows;
  const int half = a.n / 2, hc = half / E;
  const T* x = static_cast<const T*>(r.x) + row * a.n;

  // the row, and cos and sin with it, so their latencies overlap
  float v[PPT][2][E], co[PPT][E], si[PPT][E];
  const float* cs = nullptr;
  const float* sn = nullptr;
  if (ROPE && live) {
    cs = table_row(a, r, row);
    sn = cs + (long long)a.table_batch * a.seq * half;
  }
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int c = p * tpr + lane;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (live && c < hc) {
        load<T, E>(x + h * half + c * E, v[p][h]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[p][h][e] = 0.f;
      }
    }
    if constexpr (ROPE) {
      if (live && c < hc) {
        load<float, E>(cs + c * E, co[p]);
        load<float, E>(sn + c * E, si[p]);
      }
    }
  }
  if constexpr (NORM) {
    float ss = 0.f;
#pragma unroll
    for (int p = 0; p < PPT; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < E; ++e) ss = __fadd_rn(ss, __fmul_rn(v[p][h][e], v[p][h][e]));
    ss = row_sum(ss, tpr, red);
    const float rstd = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / (float)a.n), a.eps));
    if (live && lane == 0 && r.rstd != nullptr) r.rstd[row] = rstd;
    const W* w = static_cast<const W*>(r.w);
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int c = p * tpr + lane;
      if (c >= hc) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float wv[E];
        load<W, E>(w + h * half + c * E, wv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float y = __fmul_rn(__fmul_rn(v[p][h][e], rstd), wv[e]);
          v[p][h][e] = ROPE ? round_to<T>(y) : y;
        }
      }
    }
  }
  if (!live) return;
  if constexpr (ROPE) {
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      if (p * tpr + lane >= hc) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x1 = v[p][0][e], x2 = v[p][1][e];
        v[p][0][e] = __fsub_rn(__fmul_rn(x1, co[p][e]), __fmul_rn(x2, si[p][e]));
        v[p][1][e] = __fadd_rn(__fmul_rn(x2, co[p][e]), __fmul_rn(x1, si[p][e]));
      }
    }
  }
  T* y = static_cast<T*>(r.out) + row * a.n;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int c = p * tpr + lane;
    if (c >= hc) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) store<T, E>(y + h * half + c * E, v[p][h]);
  }
}

template <typename T, typename W, int PPT, bool NORM, bool ROPE>
__global__ void __launch_bounds__(kBlock) bwd_kernel(Args a) {
  constexpr int E = 16 / (int)sizeof(T);
  __shared__ float red[kBlock / 32];
  const int tpr = a.tpr, rpb = kBlock / tpr;
  const int slot = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  const int which = blockIdx.x < (unsigned)a.blocks0 ? 0 : 1;
  const Rows r = which ? a.t[1] : a.t[0];  // no dynamic index into the parameters
  const int blocks = which ? gridDim.x - a.blocks0 : a.blocks0;
  const int block = which ? blockIdx.x - a.blocks0 : blockIdx.x;
  const long long groups = (r.rows + rpb - 1) / rpb;
  const int half = a.n / 2, hc = half / E;
  const bool want_dw = NORM && r.dw != nullptr;
  const W* w = static_cast<const W*>(r.w);

  float acc[PPT][2][E];
#pragma unroll
  for (int p = 0; p < PPT; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[p][h][e] = 0.f;

  for (long long gi = block; gi < groups; gi += blocks) {
    const long long row = gi * rpb + slot;
    const bool live = row < r.rows;
    const T* dy = static_cast<const T*>(r.dy) + row * a.n;
    const T* x = static_cast<const T*>(r.x) + row * a.n;
    // every load of the row group first, so their latencies overlap: the
    // output gradient, the input (with the norm), 1 / rms, cos and sin
    float g[PPT][2][E], v[PPT][2][E], co[PPT][E], si[PPT][E];
    const float* cs = nullptr;
    const float* sn = nullptr;
    if (ROPE && live) {
      cs = table_row(a, r, row);
      sn = cs + (long long)a.table_batch * a.seq * half;
    }
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int c = p * tpr + lane;
      const bool ok = live && c < hc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ok) {
          load<T, E>(dy + h * half + c * E, g[p][h]);
          if constexpr (NORM) load<T, E>(x + h * half + c * E, v[p][h]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) g[p][h][e] = v[p][h][e] = 0.f;
        }
      }
      if constexpr (ROPE) {
        if (ok) {
          load<float, E>(cs + c * E, co[p]);
          load<float, E>(sn + c * E, si[p]);
        }
      }
    }
    const float rstd = NORM && live ? r.rstd[row] : 0.f;
    if constexpr (ROPE) {
      // the rotation's transpose: autograd's sum of the two products each
      // half took part in, rounded to T where the chain's cast sits
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        if (!live || p * tpr + lane >= hc) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float g1 = g[p][0][e], g2 = g[p][1][e];
          g[p][0][e] = round_to<T>(__fadd_rn(__fmul_rn(g1, co[p][e]), __fmul_rn(g2, si[p][e])));
          g[p][1][e] = round_to<T>(__fsub_rn(__fmul_rn(g2, co[p][e]), __fmul_rn(g1, si[p][e])));
        }
      }
    }
    if constexpr (NORM) {
      float dot = 0.f;
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        const int c = p * tpr + lane;
        if (!live || c >= hc) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float wv[E];
          load<W, E>(w + h * half + c * E, wv);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float gv = g[p][h][e];
            if (want_dw) {
              acc[p][h][e] = __fadd_rn(acc[p][h][e], __fmul_rn(gv, __fmul_rn(v[p][h][e], rstd)));
            }
            const float dn = __fmul_rn(gv, wv[e]);
            dot = __fadd_rn(dot, __fmul_rn(dn, v[p][h][e]));
            g[p][h][e] = dn;
          }
        }
      }
      dot = row_sum(dot, tpr, red);
      // autograd's chain: rsqrt's -0.5 * grad * r^3, mean's / n, square's 2x
      const float r3 = __fmul_rn(__fmul_rn(rstd, rstd), rstd);
      const float coef = __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, dot), r3), 1.0f / (float)a.n);
#pragma unroll
      for (int p = 0; p < PPT; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < E; ++e)
            g[p][h][e] = __fadd_rn(__fmul_rn(g[p][h][e], rstd),
                                   __fmul_rn(coef, __fmul_rn(2.0f, v[p][h][e])));
    }
    if (live) {
      T* dx = static_cast<T*>(r.out) + row * a.n;
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        const int c = p * tpr + lane;
        if (c >= hc) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) store<T, E>(dx + h * half + c * E, g[p][h]);
      }
    }
  }
  if (!want_dw) return;
  // the block's row slots added in order into its partial row
  float* part = a.part + (long long)blockIdx.x * a.n;
  for (int k = 0; k < rpb; ++k) {
    if (slot == k) {
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        const int c = p * tpr + lane;
        if (c >= hc) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float* q = part + h * half + c * E + e;
            *q = k == 0 ? acc[p][h][e] : __fadd_rn(*q, acc[p][h][e]);
          }
      }
    }
    __syncthreads();
  }
}

// dw[col] = the sum of the tensor's partial rows, in order of 32 strided
// runs; blockIdx.y picks the tensor, a block 32 columns
template <typename W>
__global__ void __launch_bounds__(1024) dw_kernel(const float* part, int blocks0, int blocks1,
                                                  void* dw0, void* dw1, int n) {
  __shared__ float s[32][33];
  const int which = blockIdx.y;
  W* dw = static_cast<W*>(which ? dw1 : dw0);
  if (dw == nullptr) return;
  const int rows = which ? blocks1 : blocks0;
  const float* base = part + (long long)(which ? blocks0 : 0) * n;
  const int col = blockIdx.x * 32 + threadIdx.x;
  float v = 0.f;
  if (col < n) {
    for (int i = threadIdx.y; i < rows; i += 32) v = __fadd_rn(v, base[(long long)i * n + col]);
  }
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && col < n) {
    float t = 0.f;
    for (int i = 0; i < 32; ++i) t = __fadd_rn(t, s[i][threadIdx.x]);
    dw[col] = from_f<W>(t);
  }
}

inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return count[dev];
}

template <typename T, typename W, int PPT, bool NORM, bool ROPE>
int launch(Args a, bool backward, int part_rows, cudaStream_t stream) {
  constexpr int E = 16 / (int)sizeof(T);
  const int hc = a.n / 2 / E;
  int tpr = 1;
  while (tpr * PPT < hc) tpr <<= 1;
  if (tpr > kMaxTpr) return (int)cudaErrorInvalidValue;
  a.tpr = tpr;
  const int rpb = kBlock / tpr;
  const long long g0 = (a.t[0].rows + rpb - 1) / rpb;
  const long long g1 = (a.t[1].rows + rpb - 1) / rpb;
  if (g0 + g1 == 0) return 0;
  if (!backward) {
    if (g0 + g1 > INT_MAX) return (int)cudaErrorInvalidValue;
    a.blocks0 = (int)g0;
    fwd_kernel<T, W, PPT, NORM, ROPE><<<(unsigned)(g0 + g1), kBlock, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_kernel<T, W, PPT, NORM, ROPE>,
                                                  kBlock, 0);
    if (per_sm < 1) per_sm = 1;
  }
  const bool dw = NORM && (a.t[0].dw != nullptr || a.t[1].dw != nullptr);
  long long total = (long long)sm_count() * per_sm;
  if (total > g0 + g1) total = g0 + g1;
  if (dw && total > part_rows) total = part_rows;
  if (total < 1) total = 1;
  if (g0 > 0 && g1 > 0 && total < 2) total = 2;
  if (dw && (a.part == nullptr || total > part_rows)) return (int)cudaErrorInvalidValue;
  long long b0 = g1 == 0 ? total : g0 == 0 ? 0 : (total * g0 + (g0 + g1) / 2) / (g0 + g1);
  if (g0 > 0 && b0 < 1) b0 = 1;
  if (g1 > 0 && b0 > total - 1) b0 = total - 1;
  a.blocks0 = (int)b0;
  bwd_kernel<T, W, PPT, NORM, ROPE><<<(unsigned)total, kBlock, 0, stream>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || !dw) return rc;
  dim3 grid((a.n + 31) / 32, 2), block(32, 32);
  dw_kernel<W><<<grid, block, 0, stream>>>(a.part, (int)b0, (int)(total - b0), a.t[0].dw,
                                           a.t[1].dw, a.n);
  return (int)cudaGetLastError();
}

template <typename T, typename W, int PPT>
int by_mode(const Args& a, bool norm, bool rope, bool backward, int part_rows,
            cudaStream_t s) {
  if constexpr (PPT <= 2) {
    if (norm && rope) return launch<T, W, PPT, true, true>(a, backward, part_rows, s);
    if constexpr (std::is_same<W, float>::value) {
      if (rope) return launch<T, W, PPT, false, true>(a, backward, part_rows, s);
    }
  }
  if (norm && !rope) return launch<T, W, PPT, true, false>(a, backward, part_rows, s);
  return (int)cudaErrorInvalidValue;
}

// rows of up to 16 chunk pairs (head rows) take one pair a thread, wider rows
// two (four past 512 pairs), so a row never needs more than kMaxTpr threads
template <typename T, typename W>
int by_width(const Args& a, bool norm, bool rope, bool backward, int part_rows,
             cudaStream_t s) {
  const int hc = a.n / 2 / (16 / (int)sizeof(T));
  if (hc <= 16) return by_mode<T, W, 1>(a, norm, rope, backward, part_rows, s);
  if (hc <= 512) return by_mode<T, W, 2>(a, norm, rope, backward, part_rows, s);
  return by_mode<T, W, 4>(a, norm, rope, backward, part_rows, s);
}

}  // namespace rownorm

// One entry point, both passes.  Tensor i's rows are x_i [rows_i, n] (a head
// row's token is row / heads_i); its norm weight w_i [n] (w_0 null: no norm,
// and then no weight at all); table [2, table_batch, seq, n / 2] f32 (null: no
// rotation).  Forward (backward 0): out_i = y, rstd_i = 1 / rms a row (may be
// null).  Backward: dy_i the output gradient, out_i = dx, rstd_i the
// forward's, dw_i the weight gradient (null: not wanted) through the f32
// scratch part [part_rows, n].  dtype / w_dtype: 0 f32, 1 bf16.  Every
// pointer 16-byte aligned and each tensor contiguous; n a multiple of two
// 16-byte chunks.  Returns a cudaError_t.
extern "C" int dstack_rownorm(const void* x0, const void* x1, const void* dy0, const void* dy1,
                              void* out0, void* out1, const void* w0, const void* w1,
                              void* rstd0, void* rstd1, void* dw0, void* dw1,
                              const void* table, void* part, long long rows0, long long rows1,
                              int n, int heads0, int heads1, int seq, int table_batch, int dtype,
                              int w_dtype, int backward, int part_rows, float eps, void* stream) {
  using rownorm::bf16;
  const bool norm = w0 != nullptr, rope = table != nullptr;
  const int chunk = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || (w_dtype != 0 && w_dtype != 1) || n <= 0 ||
      n % (2 * chunk) || rows0 < 0 || rows1 < 0 || (!norm && !rope) ||
      (rows1 > 0 && norm && w1 == nullptr) ||
      (rope && (heads0 <= 0 || (rows1 > 0 && heads1 <= 0) || seq <= 0 || table_batch <= 0)) ||
      (backward && norm && (rstd0 == nullptr || (rows1 > 0 && rstd1 == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  rownorm::Args a{};
  a.t[0] = {x0, dy0, out0, w0, static_cast<float*>(rstd0), dw0, rows0, heads0};
  a.t[1] = {x1, dy1, out1, w1, static_cast<float*>(rstd1), dw1, rows1, heads1};
  a.table = static_cast<const float*>(table);
  a.part = static_cast<float*>(part);
  a.n = n;
  a.seq = seq;
  a.table_batch = table_batch;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bwd = backward != 0;
  if (!norm) w_dtype = 0;  // no weight: one instantiation a row type
  if (dtype == 1 && w_dtype == 1) return rownorm::by_width<bf16, bf16>(a, norm, rope, bwd, part_rows, s);
  if (dtype == 1) return rownorm::by_width<bf16, float>(a, norm, rope, bwd, part_rows, s);
  if (w_dtype == 1) return rownorm::by_width<float, bf16>(a, norm, rope, bwd, part_rows, s);
  return rownorm::by_width<float, float>(a, norm, rope, bwd, part_rows, s);
}
