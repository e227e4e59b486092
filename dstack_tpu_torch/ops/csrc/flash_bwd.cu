// Causal GQA flash-attention backward for Hopper (sm_90a), head_dim 64 or 128.
//
// Replaces two Pallas TPU kernels of dstack_tpu/ops/flash_attention.py:
// _bwd_merged_kernel (head_dim 128, launched by _bwd_merged) and
// _bwd_merged_packed_kernel (head_dim 64, head pairs packed in 128 lanes).
// Given q, k, v, do, the forward's lse and delta = rowsum(do * o) (computed
// by the caller, as the JAX code computes it outside its kernel), it writes
// dq, dk and dv.
//
// The TPU kernels are one pass per (query head, key block): dk/dv partials
// per query head, and dq accumulated across key blocks in a whole-sequence
// VMEM scratch, which is only sound because the TPU grid runs in order.
// CUDA blocks run in no order, so this is FlashAttention-2's split into two
// kernels, with no atomics and a deterministic result:
//   * dkdv_kernel: one CTA per (batch, kv head, 64-row key block).  It loops
//     over the group's query heads and, for each, the query blocks from the
//     diagonal on; dk and dv accumulate in registers over the whole group,
//     which replaces the JAX code's separate sum of per-head partials.  Each
//     warp owns 16 key rows and works on the transposed scores S^T = K Q^T.
//   * dq_kernel: one CTA per (batch, query head, 64-row query block), looping
//     over the key blocks up to the diagonal; each warp owns 16 query rows.
// Each kernel recomputes p from lse, so the pair does 7 tile products per
// (query block, key block) pair where the merged TPU kernel does 5.
//
// Numerics held to the JAX kernels: s = (q . k) * scale in f32, -1e30 above
// the diagonal; p = exp(s - lse) in f32; dv += bf16(p)^T do; dp = do v^T in
// f32; ds = bf16(p * (dp - delta)); dk += ds^T q and dq += ds k in f32; dk
// and dq times scale at the end, each output rounded once to bf16.
//
// What bounds it: tensor-core operations, as for the forward (5 products
// where the forward has 2, over the same bytes plus do, dq, dk and dv).
// WMMA fragments staged in shared memory, no pipelining: later work.

#include "flash_common.cuh"

namespace flash {
namespace {

// s (masked) -> p = exp(s - lse) for the lane's 32 columns of a [16, 64]
// f32 tile row; `masked(c)` says whether column c lies above the diagonal.
// p stays in f32 registers for ds, and goes to `p_row` rounded to bf16.
template <typename Masked, typename Lse>
__device__ __forceinline__ void probs(float (&pv)[32], const float* s_row, bf16* p_row,
                                      float scale, Masked masked, Lse lse_of) {
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    float s = s_row[c] * scale;
    if (masked(c)) s = kNegInf;
    pv[c] = expf(s - lse_of(c));
    p_row[c] = __float2bfloat16(pv[c]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int hq, int hkv,
            float scale) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kBlock * T::kLdh;
  bf16* q_s = v_s + kBlock * T::kLdh;
  bf16* do_s = q_s + kBlock * T::kLdh;
  float* st_s = reinterpret_cast<float*>(do_s + kBlock * T::kLdh);  // S^T, then dP^T
  bf16* pt_s = reinterpret_cast<bf16*>(st_s + kBlock * T::kLds);    // bf16(P^T)
  bf16* dst_s = pt_s + kBlock * T::kLdp;                            // bf16(dS^T)
  float* lse_s = reinterpret_cast<float*>(dst_s + kBlock * T::kLdp);
  float* delta_s = lse_s + kBlock;

  const int jk = blockIdx.x;  // small jk walks the most query blocks: issued first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv, nblk = seq / kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q_stride = (long long)hq * D, kv_stride = (long long)hkv * D;
  const long long kv_off = (((long long)b * seq + jk * kBlock) * hkv + hk) * D;
  load_tile<D>(k_s, k + kv_off, kv_stride);
  load_tile<D>(v_s, v + kv_off, kv_stride);

  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int kpos = jk * kBlock + warp * 16 + r;
  float* st_w = st_s + warp * 16 * T::kLds;
  bf16* pt_w = pt_s + warp * 16 * T::kLdp;
  bf16* dst_w = dst_s + warp * 16 * T::kLdp;
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) {
    wmma::fill_fragment(dk_acc[dn], 0.f);
    wmma::fill_fragment(dv_acc[dn], 0.f);
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int i = jk; i < nblk; ++i) {
      __syncthreads();  // every warp is done with the previous q/do tiles
      const long long q_off = (((long long)b * seq + i * kBlock) * hq + h) * D;
      load_tile<D>(q_s, q + q_off, q_stride);
      load_tile<D>(do_s, dout + q_off, q_stride);
      const long long row_off = ((long long)b * hq + h) * seq + i * kBlock;
      if (threadIdx.x < kBlock) lse_s[threadIdx.x] = lse[row_off + threadIdx.x];
      else delta_s[threadIdx.x - kBlock] = delta[row_off + threadIdx.x - kBlock];
      __syncthreads();

      {  // S^T_w = K_w Q^T, [16 key rows, 64 query columns]
        FragC acc[4];
        rows_times_tile_t<D>(acc, k_s + warp * 16 * T::kLdh, T::kLdh, q_s);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          wmma::store_matrix_sync(st_w + n * 16, acc[n], T::kLds, wmma::mem_row_major);
      }
      __syncwarp();
      float pv[32];
      const int qbase = i * kBlock + c0;
      probs(pv, st_w + r * T::kLds + c0, pt_w + r * T::kLdp + c0, scale,
            [&](int c) { return i == jk && kpos > qbase + c; },
            [&](int c) { return lse_s[c0 + c]; });
      __syncwarp();  // S^T is read: its buffer takes dP^T next

      {  // dP^T_w = V_w dO^T
        FragC acc[4];
        rows_times_tile_t<D>(acc, v_s + warp * 16 * T::kLdh, T::kLdh, do_s);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          wmma::store_matrix_sync(st_w + n * 16, acc[n], T::kLds, wmma::mem_row_major);
      }
      __syncwarp();
      {
        const float* dp_row = st_w + r * T::kLds + c0;
        bf16* ds_row = dst_w + r * T::kLdp + c0;
#pragma unroll
        for (int c = 0; c < 32; ++c)
          ds_row[c] = __float2bfloat16(pv[c] * (dp_row[c] - delta_s[c0 + c]));
      }
      __syncwarp();

      // dV_w += bf16(P^T)_w dO, dK_w += bf16(dS^T)_w Q
      accumulate_rows_times_tile<D>(dv_acc, pt_w, do_s);
      accumulate_rows_times_tile<D>(dk_acc, dst_w, q_s);
    }
  }

  // epilogue through shared memory (the q/do tiles' space, f32 [64, D+4])
  __syncthreads();
  float* out_s = reinterpret_cast<float*>(q_s);
  float* out_w = out_s + warp * 16 * T::kLdf;
  const long long out_off = (((long long)b * seq + kpos) * hkv + hk) * D + (lane & 1) * (D / 2);
  const float* out_row = out_w + r * T::kLdf + (lane & 1) * (D / 2);
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn)
    wmma::store_matrix_sync(out_w + dn * 16, dk_acc[dn], T::kLdf, wmma::mem_row_major);
  __syncwarp();
  store_row<false>(dk + out_off, out_row, scale, D / 2);
  __syncwarp();
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn)
    wmma::store_matrix_sync(out_w + dn * 16, dv_acc[dn], T::kLdf, wmma::mem_row_major);
  __syncwarp();
  store_row<false>(dv + out_off, out_row, 1.f, D / 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int seq, int hq, int hkv, float scale) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kBlock * T::kLdh;
  bf16* k_s = do_s + kBlock * T::kLdh;
  bf16* v_s = k_s + kBlock * T::kLdh;
  float* s_s = reinterpret_cast<float*>(v_s + kBlock * T::kLdh);  // S, then dP
  bf16* ds_s = reinterpret_cast<bf16*>(s_s + kBlock * T::kLds);   // bf16(dS)

  const int iq = gridDim.x - 1 - blockIdx.x;  // the longest walks first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q_stride = (long long)hq * D, kv_stride = (long long)hkv * D;
  const long long q_off = (((long long)b * seq + iq * kBlock) * hq + h) * D;
  load_tile<D>(q_s, q + q_off, q_stride);
  load_tile<D>(do_s, dout + q_off, q_stride);

  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int qpos = iq * kBlock + warp * 16 + r;
  const float lse_r = lse[((long long)b * hq + h) * seq + qpos];
  const float delta_r = delta[((long long)b * hq + h) * seq + qpos];
  float* s_w = s_s + warp * 16 * T::kLds;
  bf16* ds_w = ds_s + warp * 16 * T::kLdp;
  FragC dq_acc[D / 16];
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) wmma::fill_fragment(dq_acc[dn], 0.f);

  for (int j = 0; j <= iq; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tiles
    const long long kv_off = (((long long)b * seq + j * kBlock) * hkv + hk) * D;
    load_tile<D>(k_s, k + kv_off, kv_stride);
    load_tile<D>(v_s, v + kv_off, kv_stride);
    __syncthreads();

    {  // S_w = Q_w K^T
      FragC acc[4];
      rows_times_tile_t<D>(acc, q_s + warp * 16 * T::kLdh, T::kLdh, k_s);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(s_w + n * 16, acc[n], T::kLds, wmma::mem_row_major);
    }
    __syncwarp();
    float pv[32];
    const int kbase = j * kBlock + c0;
    // bf16(p) is not needed here: ds_w takes the rounded values as scratch
    probs(pv, s_w + r * T::kLds + c0, ds_w + r * T::kLdp + c0, scale,
          [&](int c) { return j == iq && kbase + c > qpos; },
          [&](int) { return lse_r; });
    __syncwarp();

    {  // dP_w = dO_w V^T
      FragC acc[4];
      rows_times_tile_t<D>(acc, do_s + warp * 16 * T::kLdh, T::kLdh, v_s);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(s_w + n * 16, acc[n], T::kLds, wmma::mem_row_major);
    }
    __syncwarp();
    {
      const float* dp_row = s_w + r * T::kLds + c0;
      bf16* ds_row = ds_w + r * T::kLdp + c0;
#pragma unroll
      for (int c = 0; c < 32; ++c) ds_row[c] = __float2bfloat16(pv[c] * (dp_row[c] - delta_r));
    }
    __syncwarp();
    accumulate_rows_times_tile<D>(dq_acc, ds_w, k_s);  // dQ_w += bf16(dS)_w K
  }

  __syncthreads();  // the K/V tiles' space holds the f32 [64, D+4] result
  float* out_w = reinterpret_cast<float*>(k_s) + warp * 16 * T::kLdf;
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn)
    wmma::store_matrix_sync(out_w + dn * 16, dq_acc[dn], T::kLdf, wmma::mem_row_major);
  __syncwarp();
  store_row<false>(dq + (((long long)b * seq + qpos) * hq + h) * D + (lane & 1) * (D / 2),
                   out_w + r * T::kLdf + (lane & 1) * (D / 2), scale, D / 2);
}

template <int D>
constexpr size_t dkdv_smem() {
  return 4 * Tile<D>::kHalfBytes + Tile<D>::kScoreBytes + 2 * Tile<D>::kProbBytes +
         2 * kBlock * sizeof(float);
}

template <int D>
constexpr size_t dq_smem() {
  return 4 * Tile<D>::kHalfBytes + Tile<D>::kScoreBytes + Tile<D>::kProbBytes;
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int batch, int seq, int hq,
               int hkv, float scale, cudaStream_t stream) {
  static_assert(2 * Tile<D>::kHalfBytes >= Tile<D>::kF32Bytes,
                "the epilogues reuse two bf16 tiles as one f32 tile");
  auto kv_kernel = dkdv_kernel<D>;
  auto q_kernel = dq_kernel<D>;
  cudaError_t err = allow_smem(kv_kernel, dkdv_smem<D>());
  if (err == cudaSuccess) err = allow_smem(q_kernel, dq_smem<D>());
  if (err != cudaSuccess) return (int)err;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* dob = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  kv_kernel<<<dim3(seq / kBlock, hkv, batch), kThreads, dkdv_smem<D>(), stream>>>(
      qb, kb, vb, dob, lf, df, static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, hq, hkv,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  q_kernel<<<dim3(seq / kBlock, hq, batch), kThreads, dq_smem<D>(), stream>>>(
      qb, kb, vb, dob, lf, df, static_cast<bf16*>(dq), seq, hq, hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes).  q/do [B, S, Hq, D], k/v
// [B, S, Hkv, D] bf16, lse/delta [B, Hq, S] f32, all contiguous and 16-byte
// aligned; writes dq [B, S, Hq, D] and dk/dv [B, S, Hkv, D] bf16.  Launches
// the two kernels on `stream` and returns cudaGetLastError() after them.
extern "C" int dstack_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, void* dk,
                                void* dv, int batch, int seq, int hq, int hkv, int head_dim,
                                float scale, void* stream) {
  if (seq <= 0 || seq % flash::kBlock || hkv <= 0 || hq % hkv || batch <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return flash::launch_bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq, hq, hkv,
                                 scale, s);
  }
  if (head_dim == 128) {
    return flash::launch_bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, batch, seq, hq, hkv,
                                  scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
