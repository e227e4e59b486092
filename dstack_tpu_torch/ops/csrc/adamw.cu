// AdamW with optax's global-norm clip folded in, for Hopper (sm_90a): a
// training step's whole optimizer in two passes over the gradients.
//
// Replaces no Pallas kernel: the JAX package leaves optax's
// clip_by_global_norm and adamw to XLA.  In eager PyTorch the same update ran
// as three passes: the gradients' norms (_foreach_norm), the clip's multiply
// (_foreach_mul_ by a device scalar, reading and writing every gradient), then
// torch's fused AdamW: 20 bytes a bf16 parameter.
//
// What bounds it: bytes.  The global norm must be whole before any parameter
// moves, so the least is two passes: one read of every gradient for the norm,
// then one read of p, g, m and v and one write of p, m and v, 2 + 14 = 16
// bytes a bf16 parameter (32 an f32 one), against a few dozen flops.
//
// What the design does about it:
//   * Launch 1 (norm_kernel): one grid over every gradient leaf of either
//     dtype, from a leaf table in the kernel's parameters.  A thread sums the
//     squares of its 16-byte vectors in f32, a block reduces by shuffles and
//     shared memory in a fixed order and writes its partial, and the last block
//     to finish (an integer counter) adds the partials in a fixed order: no
//     float atomics, the same bits on every run.  Block 0 adds 1 to every
//     leaf's step count, as torch's fused step did before it ran.
//   * Launch 2 (step_kernel, one a leaf dtype): a grid-stride walk over tiles
//     of every leaf, 16-byte loads and stores that stream past the L2
//     (__ldcs / __stcs: nothing is read twice).  The clip coefficient comes
//     from the norm's sum in device memory, so nothing waits for the host, and
//     the clipped gradient is never written.
//   * The arithmetic is the three passes' own, operation for operation: the
//     clip multiplies a bf16 gradient by the coefficient rounded to bf16 and
//     rounds the product to bf16 (a CUDA binary op of a bf16 tensor and an
//     f32 0-dim one loads both as bf16 and computes in f32), then torch's
//     fused AdamW (ATen/native/cuda/fused_adam_utils.cuh: adam_math with its
//     fmas, the bias corrections from the leaf's step), in f32, rounding p, m
//     and v once into the leaf's type.
//   * A table holds at most kMaxLeaves leaves (the parameters' 4 KB); the
//     wrapper splits a longer one into launches, the norm's partials carried
//     from one launch to the next (`first`, `last`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace adamw {

using bf16 = __nv_bfloat16;

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kNormUnroll = 4;  // 16-byte vectors a thread a tile: the norm
constexpr int kStepUnroll = 2;  // and the step (four tensors a vector)

// the wrapper's table: int64 [leaves, kCols], one row a leaf
enum Col { kP, kG, kM, kV, kStep, kNumel, kFlags, kCols };
constexpr int kBf16 = 1;     // flags: the leaf is bf16 (else f32)
constexpr int kInNorm = 2;   // its gradient counts in the norm (owned)
constexpr int kAligned = 4;  // set here: its pointers take 16-byte vectors

struct Leaf {
  void* p;
  const void* g;
  void* m;
  void* v;
  float* step;
  long long numel;
  int tile0;  // the leaf's first tile in the launch
  int flags;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
  int tiles;
};

struct Hyper {
  float lr, beta1, beta2, weight_decay, eps, clip;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float (&out)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int k = 0; k < 16 / (int)sizeof(T); ++k) out[k] = to_f(e[k]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&in)[16 / sizeof(T)]) {
  uint4 r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int k = 0; k < 16 / (int)sizeof(T); ++k) e[k] = from_f<T>(in[k]);
  return r;
}

// the tile's leaf: tiles rise through a block's walk, so a cursor moves on
__device__ __forceinline__ int leaf_of(const Table& t, int tile, int leaf) {
  while (leaf + 1 < t.count && tile >= t.leaf[leaf + 1].tile0) ++leaf;
  return leaf;
}

// the sum of ``v`` over the block, in thread 0, in a fixed order
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  }
  return s;
}

// this thread's squares of tile ``tile`` of leaf ``L`` (its own tile count)
template <typename T>
__device__ __forceinline__ float squares(const Leaf& L, long long tile) {
  constexpr int kVec = 16 / sizeof(T);
  const long long v0 = tile * (kThreads * kNormUnroll) + threadIdx.x;
  float acc = 0.f;
  if (L.flags & kAligned) {
    const uint4* g = static_cast<const uint4*>(L.g);
    const long long whole = L.numel / kVec;
    uint4 r[kNormUnroll];
#pragma unroll
    for (int u = 0; u < kNormUnroll; ++u) {
      const long long vi = v0 + u * kThreads;
      if (vi < whole) r[u] = __ldcs(g + vi);
    }
#pragma unroll
    for (int u = 0; u < kNormUnroll; ++u) {
      const long long vi = v0 + u * kThreads;
      if (vi < whole) {
        float x[kVec];
        unpack<T>(r[u], x);
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc = fmaf(x[k], x[k], acc);
      } else if (vi == whole) {  // the leaf's last, partial vector
        for (long long e = vi * kVec; e < L.numel; ++e) {
          const float x = to_f(static_cast<const T*>(L.g)[e]);
          acc = fmaf(x, x, acc);
        }
      }
    }
    return acc;
  }
  const T* g = static_cast<const T*>(L.g);
  for (int u = 0; u < kNormUnroll; ++u) {
    const long long e0 = (v0 + u * kThreads) * kVec;
    for (long long e = e0; e < e0 + kVec && e < L.numel; ++e) {
      const float x = to_f(g[e]);
      acc = fmaf(x, x, acc);
    }
  }
  return acc;
}

// partials[b] = (first ? 0 : partials[b]) + block b's squares; the last
// launch's last block writes the sum of the partials to *sumsq.  Block 0 adds
// 1 to every leaf's step.
__global__ void __launch_bounds__(kThreads)
    norm_kernel(const Table t, float* partials, unsigned* counter, float* sumsq, int first,
                int last) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ bool is_last;
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < t.count; i += kThreads) {
      if (t.leaf[i].step != nullptr) *t.leaf[i].step += 1.f;
    }
  }
  float acc = 0.f;
  int leaf = 0;
  for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    leaf = leaf_of(t, tile, leaf);
    const Leaf& L = t.leaf[leaf];
    acc += (L.flags & kBf16) ? squares<bf16>(L, tile - L.tile0)
                             : squares<float>(L, tile - L.tile0);
  }
  const float s = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = first ? s : __ldcg(partials + blockIdx.x) + s;
  }
  if (!last) return;
  if (threadIdx.x == 0) {
    __threadfence();
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float mine = 0.f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) mine += __ldcg(partials + b);
  __syncthreads();  // warp_sums is read again
  const float total = block_sum(mine, warp_sums);
  if (threadIdx.x == 0) {
    *sumsq = total;
    *counter = 0u;
  }
}

// torch's fused AdamW on one element, in f32 (fused_adam_utils.cuh adam_math,
// ADAMW, no amsgrad, no maximize, no grad scale)
__device__ __forceinline__ void adam(float& param, float grad, float& exp_avg, float& exp_avg_sq,
                                     const Hyper& h, float bias_correction1,
                                     float bias_correction2_sqrt) {
  const float lr = h.lr, beta1 = h.beta1, beta2 = h.beta2, weight_decay = h.weight_decay;
  if (weight_decay != 0) param -= lr * weight_decay * param;
  exp_avg = fmaf(beta1, exp_avg, fmaf(-beta1, grad, grad));
  exp_avg_sq = fmaf(beta2, exp_avg_sq, fmaf(-beta2, grad * grad, grad * grad));
  const float step_size = lr / bias_correction1;
  const float denom = (sqrtf(exp_avg_sq) / bias_correction2_sqrt) + h.eps;
  param -= step_size * exp_avg / denom;
}

// the clipped gradient as the clip's multiply left it in the leaf's type
__device__ __forceinline__ float clipped(float g, float scale, float) { return g * scale; }
__device__ __forceinline__ float clipped(float g, float scale, bf16) {
  return __bfloat162float(__float2bfloat16_rn(g * scale));
}

template <typename T>
__device__ __forceinline__ void step_one(const Leaf& L, long long e, float scale, const Hyper& h,
                                         float bc1, float bc2s) {
  T* P = static_cast<T*>(L.p);
  T* M = static_cast<T*>(L.m);
  T* V = static_cast<T*>(L.v);
  float p = to_f(P[e]), m = to_f(M[e]), v = to_f(V[e]);
  const float g = clipped(to_f(static_cast<const T*>(L.g)[e]), scale, T());
  adam(p, g, m, v, h, bc1, bc2s);
  P[e] = from_f<T>(p);
  M[e] = from_f<T>(m);
  V[e] = from_f<T>(v);
}

template <typename T>
__device__ __forceinline__ void step_tile(const Leaf& L, long long tile, float scale,
                                          const Hyper& h, float bc1, float bc2s) {
  constexpr int kVec = 16 / sizeof(T);
  const long long v0 = tile * (kThreads * kStepUnroll) + threadIdx.x;
  if (!(L.flags & kAligned)) {
    for (int u = 0; u < kStepUnroll; ++u) {
      const long long e0 = (v0 + u * kThreads) * kVec;
      for (long long e = e0; e < e0 + kVec && e < L.numel; ++e) {
        step_one<T>(L, e, scale, h, bc1, bc2s);
      }
    }
    return;
  }
  uint4* P = static_cast<uint4*>(L.p);
  const uint4* G = static_cast<const uint4*>(L.g);
  uint4* M = static_cast<uint4*>(L.m);
  uint4* V = static_cast<uint4*>(L.v);
  const long long whole = L.numel / kVec;
  uint4 rp[kStepUnroll], rg[kStepUnroll], rm[kStepUnroll], rv[kStepUnroll];
#pragma unroll
  for (int u = 0; u < kStepUnroll; ++u) {
    const long long vi = v0 + u * kThreads;
    if (vi < whole) {
      rp[u] = __ldcs(P + vi);
      rg[u] = __ldcs(G + vi);
      rm[u] = __ldcs(M + vi);
      rv[u] = __ldcs(V + vi);
    }
  }
#pragma unroll
  for (int u = 0; u < kStepUnroll; ++u) {
    const long long vi = v0 + u * kThreads;
    if (vi < whole) {
      float p[kVec], g[kVec], m[kVec], v[kVec];
      unpack<T>(rp[u], p);
      unpack<T>(rg[u], g);
      unpack<T>(rm[u], m);
      unpack<T>(rv[u], v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) adam(p[k], clipped(g[k], scale, T()), m[k], v[k], h, bc1, bc2s);
      __stcs(P + vi, pack<T>(p));
      __stcs(M + vi, pack<T>(m));
      __stcs(V + vi, pack<T>(v));
    } else if (vi == whole) {  // the leaf's last, partial vector
      for (long long e = vi * kVec; e < L.numel; ++e) step_one<T>(L, e, scale, h, bc1, bc2s);
    }
  }
}

// every leaf of the table (one dtype) stepped in place from its gradient
// clipped by the global norm sqrt(*sumsq); *norm (when not null) gets that
// norm
template <typename T>
__global__ void __launch_bounds__(kThreads)
    step_kernel(const Table t, const float* sumsq, float* norm, const Hyper h) {
  // optax's clip as the eager chain computed it: norm.clamp_min(clip) (NaN
  // stays NaN), its reciprocal times clip; a bf16 gradient's multiply reads
  // the coefficient as bf16
  const float n = sqrtf(*sumsq);
  if (norm != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *norm = n;
  const float scale = to_f(from_f<T>((1.0f / (n < h.clip ? h.clip : n)) * h.clip));
  int leaf = 0, cur = -1;
  float bc1 = 1.f, bc2s = 1.f;
  for (int tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    leaf = leaf_of(t, tile, leaf);
    const Leaf& L = t.leaf[leaf];
    if (leaf != cur) {
      // fused_adam_utils.cuh: 1 - pow(beta, step), the second's square root
      const float step_count = *L.step;
      bc1 = 1 - powf(h.beta1, step_count);
      bc2s = sqrtf(1 - powf(h.beta2, step_count));
      cur = leaf;
    }
    step_tile<T>(L, tile - L.tile0, scale, h, bc1, bc2s);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <typename T>
int launch_step(const Table& t, const float* sumsq, float* norm, const Hyper& h, int blocks,
                cudaStream_t s) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, step_kernel<T>, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  long long grid = (long long)sm_count() * per_sm;
  if (grid > blocks) grid = blocks;
  if (grid > t.tiles) grid = t.tiles;
  if (grid < 1) grid = 1;
  step_kernel<T><<<(unsigned)grid, kThreads, 0, s>>>(t, sumsq, norm, h);
  return (int)cudaGetLastError();
}

}  // namespace adamw

// One entry point, both launches.  ``table`` is a host int64 [leaves, 7]
// (p, g, m, v, step, numel, flags: bit 0 bf16, bit 1 counted in the norm),
// at most kMaxLeaves rows, each leaf contiguous.  phase 0: the norm over the
// rows counted in it into partials [blocks] (first: start them; last: then
// sum them into *sumsq through the zeroed *counter), and every row's step
// += 1.  phase 1: the step of every row (all of ``dtype``: 0 f32, 1 bf16) from
// *sumsq, writing the norm to *norm when not null, on at most ``blocks``
// blocks.  Returns a cudaError_t.
extern "C" int dstack_adamw(void* sumsq, void* partials, void* counter, void* norm,
                            const void* table, int leaves, int phase, int dtype, int first,
                            int last, int blocks, float lr, float beta1, float beta2,
                            float weight_decay, float eps, float clip, void* stream) {
  using namespace adamw;
  if (leaves < 1 || leaves > kMaxLeaves || (phase != 0 && phase != 1) || blocks < 1 ||
      sumsq == nullptr || table == nullptr ||
      (phase == 0 && (partials == nullptr || counter == nullptr)) ||
      (phase == 1 && dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long* rows = static_cast<const long long*>(table);
  Table t{};
  t.count = leaves;
  long long tiles = 0;
  for (int i = 0; i < leaves; ++i) {
    const long long* r = rows + (long long)i * kCols;
    Leaf& L = t.leaf[i];
    L.p = reinterpret_cast<void*>(r[kP]);
    L.g = reinterpret_cast<const void*>(r[kG]);
    L.m = reinterpret_cast<void*>(r[kM]);
    L.v = reinterpret_cast<void*>(r[kV]);
    L.step = reinterpret_cast<float*>(r[kStep]);
    L.numel = r[kNumel];
    const int flags = (int)r[kFlags] & (kBf16 | kInNorm);
    const bool is_bf16 = flags & kBf16;
    const bool counted = phase == 1 || (flags & kInNorm);
    if (L.numel < 0 || L.step == nullptr || (counted && L.g == nullptr) ||
        (phase == 1 && (is_bf16 != (dtype == 1) || !L.p || !L.m || !L.v))) {
      return (int)cudaErrorInvalidValue;
    }
    const long long ptrs = phase == 0 ? r[kG] : (r[kP] | r[kG] | r[kM] | r[kV]);
    L.flags = flags | ((ptrs & 15) == 0 ? kAligned : 0);
    L.tile0 = (int)tiles;
    const long long per_tile =
        (long long)(is_bf16 ? 8 : 4) * kThreads * (phase == 0 ? kNormUnroll : kStepUnroll);
    if (counted) tiles += (L.numel + per_tile - 1) / per_tile;
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  t.tiles = (int)tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phase == 0) {
    norm_kernel<<<blocks, kThreads, 0, s>>>(t, static_cast<float*>(partials),
                                            static_cast<unsigned*>(counter),
                                            static_cast<float*>(sumsq), first, last);
    return (int)cudaGetLastError();
  }
  const Hyper h{lr, beta1, beta2, weight_decay, eps, clip};
  const float* sq = static_cast<const float*>(sumsq);
  float* out = static_cast<float*>(norm);
  return dtype == 1 ? launch_step<bf16>(t, sq, out, h, blocks, s)
                    : launch_step<float>(t, sq, out, h, blocks, s);
}
