// Causal GQA flash-attention forward for Hopper (sm_90a), head_dim 64 or 128,
// and its sliding-window form (query i sees key j iff 0 <= i - j < W).
//
// Replaces two Pallas TPU kernels of dstack_tpu/ops/flash_attention.py:
// _fwd_kernel (head_dim 128, launched by _fwd) and _fwd_packed_kernel (head
// dim 64, head pairs packed into 128 lanes and scores rebuilt by a sum/diff
// identity).  The lane packing is a fix for the TPU's 128-lane registers;
// here head_dim 64 is simply the D = 64 instance of the same kernel.
//
// What bounds it: tensor-core operations.  4 * D flops per (query, key)
// pair kept by the causal mask, against q, k, v, o and lse read or written
// once: at the card's peak rates the operations take ~1.4x as long as the
// bytes at the Llama-3.2-1B training shape (S = 1024, D = 64) and ~2.8x at
// the Llama-3-8B one (S = 2048, D = 128).
//
// What the design does about it (FlashAttention-3's forward, without its
// intra-warpgroup pipelining):
//   * One CTA per (batch, query head, 128-row query tile), three
//     warpgroups: two consumers of 64 query rows each and one producer.
//     Tiles are issued longest causal walk first.  setmaxnreg gives the
//     consumers 240 registers a thread and the producer 24.
//   * The producer loads Q once and keeps a ring of K/V stages full with
//     TMA loads (4-D tensor maps over [B, S, H, D], so a box never crosses
//     into the next sequence; rows past S read as zero) into 128-byte
//     swizzled shared memory, each stage with a full and an empty mbarrier.
//     It walks the key tiles from the diagonal down to 0.
//   * S = Q K^T is one wgmma chain per key tile with both operands in
//     shared memory.  The online softmax runs on the accumulator registers
//     (row max and sum are shuffles within the quad that holds a row), the
//     rescale multiplies the O accumulator in registers, and O += P V takes
//     P as the register A operand (the S accumulator rounded to bf16 in
//     place) and V as the MN-major B operand.  Nothing of S, P or O goes to
//     shared memory; the two consumer warpgroups overlap one another's
//     softmax with their products.
//
// The windowed form is its own instantiation, fwd_kernel<D, true> (the
// causal one keeps its name, fwd_kernel<D>): a query tile walks only the
// key tiles that meet its rows' windows, from the diagonal down to the
// tile that holds its first row's oldest key, and masks, besides the
// diagonal tile, each tile that some row's window cuts.
//
// Multi-head latent attention (DeepSeek-V2/V3's MLA, trained) is causal
// attention whose q and k are 192 wide (128 latent, 64 rotated) and whose
// v is 128 wide: mla_fwd_kernel<192, 128>, the same body with the QK
// product reduced over 192 (three column blocks of Q and K) and O over
// 128.  Its Q tile and K stages grow by half: Q 48 KB, two stages of K
// (48 KB) and V (32 KB), 209 KB in all; the accumulators (S and O, 64
// f32 a thread each) are D = 128's.
//
// Numerics held to the JAX kernels: s = (q . k) * scale in f32 (exp taken
// as one exp2 of (q . k - m) * scale * log2(e), an FFMA); -1e30 above the
// diagonal (only the diagonal tile is masked); p = exp(s - m_new) in f32,
// summed unrounded into l; p rounded to bf16 before the PV product;
// o = acc / l rounded to bf16; lse = m + log(l) in natural log, f32.

#include "flash_common.cuh"

namespace flash {
namespace {

constexpr int kBM = 128;  // query rows per CTA (64 per consumer warpgroup)
constexpr int kBN = 128;  // key rows per K/V tile
constexpr int kThreads = 384;

// D: the QK width, DV: the V (and O) width
template <int D, int DV = D>
struct Fwd {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKBytes = kBN * D * 2;   // one K tile
  static constexpr int kVBytes = kBN * DV * 2;  // one V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr size_t kSmem = 1024 + kQBytes + kStages * kStageBytes +
                                  (1 + 2 * kStages) * sizeof(uint64_t);
  static_assert(kSmem <= 227 * 1024, "shared memory over the SM's 227 KB");
};

// The kernel's body: kWindow false is the causal kernel (window unused);
// DV < D is latent attention's (v and o narrower than q and k)
template <int D, bool kWindow, int DV = D>
__device__ __forceinline__ void fwd_body(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                         const CUtensorMap* v_map, bf16* __restrict__ o,
                                         float* __restrict__ lse, int seq, int hq, int hkv,
                                         float scale, float scale_log2, int window) {
  using C = Fwd<D, DV>;
  constexpr int S = C::kStages;
  constexpr int kStageElems = C::kStageBytes / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = reinterpret_cast<bf16*>(smem + C::kQBytes);  // stage st: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kQBytes + S * C::kStageBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  // the longest causal walks first: blocks are issued in index order
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int wg = threadIdx.x / 128;
  // key tiles walked: the diagonal one and those below it down to the tile
  // of the first row's oldest key in the window (tile 0 when causal)
  int tiles = iq + 1;
  if (kWindow) {
    const int oldest = iq * kBM - window + 1;
    tiles = iq + 1 - (oldest > 0 ? oldest / kBN : 0);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: one thread issues every load
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, C::kQBytes);
      tma_load_tile<D>(q_s, kBM, q_map, q_full, h, iq * kBM, b);
      for (int n = 0; n < tiles; ++n) {
        const int st = n % S, j = iq - n;
        mbar_wait(empty + st, ((n / S) & 1) ^ 1);
        mbar_expect_tx(full + st, C::kStageBytes);
        bf16* k_st = kv_s + st * kStageElems;
        tma_load_tile<D>(k_st, kBN, k_map, full + st, hk, j * kBN, b);
        tma_load_tile<DV>(k_st + kBN * D, kBN, v_map, full + st, hk, j * kBN, b);
      }
    }
  } else {  // consumer warpgroup wg: query rows 64 * wg .. + 63 of the tile
    regs_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row = wg * 64 + warp * 16 + lane / 4;  // and row + 8
    const int c0 = 2 * (lane % 4);
    const int qpos = iq * kBM + row;
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int n = 0; n < tiles; ++n) {
      const int st = n % S, j = iq - n;
      const bf16* k_st = kv_s + st * kStageElems;
      const bf16* v_st = k_st + kBN * D;
      mbar_wait(full + st, (n / S) & 1);

      float s[kBN / 2];  // S = Q_wg K^T, [64, kBN]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int cb = kk / 4, k16 = (kk % 4) * 16;
        WgmmaSS<kBN, 0, 0>::run(s, desc_b128(q_s + cb * kBM * 64 + wg * 64 * 64 + k16),
                                desc_b128(k_st + cb * kBN * 64 + k16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();

      // online softmax on the accumulator: this thread's rows are row and
      // row + 8 (e = 0, 1), its columns 8i + c0 and 8i + c0 + 1.  The max
      // is taken over the unscaled q . k (the scale is positive) and the
      // scale joins the exponent's FFMA.
      if (n == 0) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int key = j * kBN + (i / 4) * 8 + c0 + (i & 1);
          if (key > qpos + 8 * ((i >> 1) & 1)) s[i] = kNegInf;
        }
      }
      // a tile the window cuts: the keys window or more behind a row
      if (kWindow && j * kBN < iq * kBM + kBM - window) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int behind = qpos + 8 * ((i >> 1) & 1) - (j * kBN + (i / 4) * 8 + c0 + (i & 1));
          if (behind >= window) s[i] = kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        // the diagonal tile comes first and holds each row's own key, so
        // the new max is finite from the first tile on and the first
        // alpha = exp2((-1e30 - m_new) * scale) is 0 (a row the window
        // masks whole in a later tile keeps its max: p = 0 there)
        const float m_new = fmaxf(m[e], mx[e]);
        alpha[e] = ex2((m[e] - m_new) * scale_log2);
        m[e] = m_new;
        neg_m[e] = -m_new * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const float p = ex2(fmaf(s[i], scale_log2, neg_m[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += p;
        s[i] = p;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 1);
        sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 2);
        l[e] = l[e] * alpha[e] + sum[e];
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: P from the registers (bf16), V MN-major in shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        uint32_t a[4];
        a_fragment(a, s, kk);
        WgmmaRS<DV, 1>::run(acc, a, desc_b128(v_st + kk * 16 * 64, kBN * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
      mbar_arrive(empty + st);
    }

    // o = acc / l (bf16), lse = m + log(l) (natural log); rows past S are
    // the ragged last tile's padding
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pos = qpos + 8 * e;
      if (pos >= seq) continue;
      bf16* orow = o + (((long long)b * seq + pos) * hq + h) * DV + c0;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16(acc[4 * i + 2 * e] / l[e], acc[4 * i + 2 * e + 1] / l[e]);
      if (lane % 4 == 0) lse[((long long)b * hq + h) * seq + pos] = m[e] * scale + logf(l[e]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
           float* __restrict__ lse, int seq, int hq, int hkv, float scale, float scale_log2) {
  fwd_body<D, false>(&q_map, &k_map, &v_map, o, lse, seq, hq, hkv, scale, scale_log2, 0);
}

// the windowed instantiation: kWindow is true (its own name in a trace)
template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
           float* __restrict__ lse, int seq, int hq, int hkv, float scale, float scale_log2,
           int window) {
  fwd_body<D, kWindow>(&q_map, &k_map, &v_map, o, lse, seq, hq, hkv, scale, scale_log2, window);
}

// latent attention's instantiation: QK width D, V width DV (its own name
// in a trace; causal only)
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
mla_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
               float* __restrict__ lse, int seq, int hq, int hkv, float scale, float scale_log2) {
  fwd_body<D, false, DV>(&q_map, &k_map, &v_map, o, lse, seq, hq, hkv, scale, scale_log2, 0);
}

template <int D, int DV>
int launch_mla_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                   int seq, int hq, int hkv, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, batch, seq, hq, D, kBM) ||
      !make_map(&k_map, k, batch, seq, hkv, D, kBN) ||
      !make_map(&v_map, v, batch, seq, hkv, DV, kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((seq + kBM - 1) / kBM, hq, batch);
  void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, bf16*, float*, int,
                 int, int, float, float) = mla_fwd_kernel<D, DV>;
  const cudaError_t err = allow_smem(kernel, Fwd<D, DV>::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, Fwd<D, DV>::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse), seq, hq, hkv, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
               int seq, int hq, int hkv, int window, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, batch, seq, hq, D, kBM) ||
      !make_map(&k_map, k, batch, seq, hkv, D, kBN) ||
      !make_map(&v_map, v, batch, seq, hkv, D, kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((seq + kBM - 1) / kBM, hq, batch);
  cudaError_t err;
  if (window > 0) {
    void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, bf16*, float*, int,
                   int, int, float, float, int) = fwd_kernel<D, true>;
    err = allow_smem(kernel, Fwd<D>::kSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, Fwd<D>::kSmem, stream>>>(
        q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse), seq, hq, hkv,
        scale, scale * kLog2e, window);
  } else {
    void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, bf16*, float*, int,
                   int, int, float, float) = fwd_kernel<D>;
    err = allow_smem(kernel, Fwd<D>::kSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, Fwd<D>::kSmem, stream>>>(
        q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse), seq, hq, hkv,
        scale, scale * kLog2e);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes).  q [B, S, Hq, D], k
// [B, S, Hkv, D], v [B, S, Hkv, Dv] bf16, contiguous, 16-byte aligned, S a
// multiple of 64; writes o [B, S, Hq, Dv] bf16 and lse [B, Hq, S] f32.
// (D, Dv) is (64, 64), (128, 128) or latent attention's (192, 128).
// window 0 is causal, a window W in [1, S) the sliding-window
// instantiation (equal widths only).  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dstack_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                int batch, int seq, int hq, int hkv, int head_dim, int head_dim_v,
                                int window, float scale, void* stream) {
  if (seq <= 0 || seq % 64 || hkv <= 0 || hq % hkv || batch <= 0 || window < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (window >= seq) window = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim_v != head_dim) {
    if (head_dim == 192 && head_dim_v == 128 && window == 0) {
      return flash::launch_mla_fwd<192, 128>(q, k, v, o, lse, batch, seq, hq, hkv, scale, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (head_dim == 64) {
    return flash::launch_fwd<64>(q, k, v, o, lse, batch, seq, hq, hkv, window, scale, s);
  }
  if (head_dim == 128) {
    return flash::launch_fwd<128>(q, k, v, o, lse, batch, seq, hq, hkv, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
