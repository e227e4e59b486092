// Causal GQA flash-attention forward for Hopper (sm_90a), head_dim 64 or 128.
//
// Replaces two Pallas TPU kernels of dstack_tpu/ops/flash_attention.py:
// _fwd_kernel (head_dim 128, launched by _fwd) and _fwd_packed_kernel (head
// dim 64, head pairs packed into 128 lanes and scores rebuilt by a sum/diff
// identity).  The lane packing is a fix for the TPU's 128-lane registers;
// here head_dim 64 is simply the D = 64 instance of the same kernel.
//
// Same function, not the TPU's schedule:
//   * One CTA per (batch, query head, 64-row query block).  A loop inside the
//     CTA walks the key blocks 0..i (causal), which the TPU kernel did with
//     an in-kernel fori_loop over a whole-sequence K/V block in VMEM; here
//     K and V stream through shared memory one 64-row tile at a time.
//   * Each of the 4 warps owns 16 query rows: scores, the online softmax
//     state (m, l in registers of the row's two lanes) and the f32 output
//     accumulator (in shared memory) are private to the warp, so the only
//     CTA-wide barriers are around the K/V tile loads.
//   * Both products run on the tensor cores (WMMA bf16 16x16x16, f32
//     accumulate): S = Q K^T, then O += P V.
//
// Numerics held to the JAX kernels: s = (q . k) * scale in f32; -1e30 above
// the diagonal (only the diagonal block is masked); p = exp(s - m_new) in
// f32, summed unrounded into l; p rounded to bf16 before the PV product;
// o = acc / l rounded to bf16; lse = m + log(l) in f32.
//
// What bounds it: tensor-core operations.  4 * D flops per (query, key)
// pair kept by the causal mask, against q, k, v, o and lse read or written
// once: at peak rates the operations take ~1.4x as long as the bytes at the
// Llama-3.2-1B training shape (S = 1024, D = 64) and ~2.8x at the
// Llama-3-8B one (S = 2048, D = 128).
// This first version reaches the tensor cores through WMMA fragments staged
// in shared memory; wgmma, TMA loads and a pipelined K/V ring are later work.

#include "flash_common.cuh"

namespace flash {
namespace {

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
           int seq, int hq, int hkv, float scale) {
  using T = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kBlock * T::kLdh;
  bf16* v_s = k_s + kBlock * T::kLdh;
  float* s_s = reinterpret_cast<float*>(v_s + kBlock * T::kLdh);  // [64, 64+4]
  bf16* p_s = reinterpret_cast<bf16*>(s_s + kBlock * T::kLds);    // [64, 64+8]
  float* o_s = reinterpret_cast<float*>(p_s + kBlock * T::kLdp);  // [64, D+4]

  // the longest causal walks first: blocks are issued in index order
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q_stride = (long long)hq * D, kv_stride = (long long)hkv * D;

  load_tile<D>(q_s, q + (((long long)b * seq + iq * kBlock) * hq + h) * D, q_stride);
  for (int i = threadIdx.x; i < kBlock * T::kLdf; i += kThreads) o_s[i] = 0.f;

  // this lane's share of the softmax: row r of the warp's 16, 32 of the
  // block's 64 columns (the lane pair 2r, 2r+1 covers the row)
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  const int row = warp * 16 + r;
  const int qpos = iq * kBlock + row;
  float m_i = kNegInf, l_i = 0.f;
  float* s_w = s_s + warp * 16 * T::kLds;
  bf16* p_w = p_s + warp * 16 * T::kLdp;
  float* o_w = o_s + warp * 16 * T::kLdf;

  for (int j = 0; j <= iq; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tiles
    const long long kv_off = (((long long)b * seq + j * kBlock) * hkv + hk) * D;
    load_tile<D>(k_s, k + kv_off, kv_stride);
    load_tile<D>(v_s, v + kv_off, kv_stride);
    __syncthreads();

    {  // S_w = Q_w K^T, [16, 64] f32
      FragC acc[4];
      rows_times_tile_t<D>(acc, q_s + warp * 16 * T::kLdh, T::kLdh, k_s);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        wmma::store_matrix_sync(s_w + n * 16, acc[n], T::kLds, wmma::mem_row_major);
    }
    __syncwarp();

    {  // online softmax of row r over this block
      const float* srow = s_w + r * T::kLds + c0;
      float sv[32];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        float s = srow[c] * scale;
        if (j == iq && j * kBlock + c0 + c > qpos) s = kNegInf;
        sv[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      // block 0 always holds key 0 <= qpos, so m_new is finite from the
      // first block on, and the first alpha = exp(-1e30 - m_new) is 0
      const float m_new = fmaxf(m_i, mx);
      bf16* prow = p_w + r * T::kLdp + c0;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float p = expf(sv[c] - m_new);
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(m_i - m_new);
      l_i = l_i * alpha + sum;
      m_i = m_new;
      float* orow = o_w + r * T::kLdf + (lane & 1) * (D / 2);
#pragma unroll 8
      for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    {  // O_w += P_w V
      FragC acc[D / 16];
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn)
        wmma::load_matrix_sync(acc[dn], o_w + dn * 16, T::kLdf, wmma::mem_row_major);
      accumulate_rows_times_tile<D>(acc, p_w, v_s);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn)
        wmma::store_matrix_sync(o_w + dn * 16, acc[dn], T::kLdf, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // o = acc / l (bf16), lse = m + log(l); the lane pair splits the row
  store_row<true>(o + (((long long)b * seq + qpos) * hq + h) * D + (lane & 1) * (D / 2),
                  o_w + r * T::kLdf + (lane & 1) * (D / 2), l_i, D / 2);
  if ((lane & 1) == 0) lse[((long long)b * hq + h) * seq + qpos] = m_i + logf(l_i);
}

template <int D>
constexpr size_t fwd_smem() {
  return 3 * Tile<D>::kHalfBytes + Tile<D>::kScoreBytes + Tile<D>::kProbBytes +
         Tile<D>::kF32Bytes;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
               int seq, int hq, int hkv, float scale, cudaStream_t stream) {
  auto kernel = fwd_kernel<D>;
  cudaError_t err = allow_smem(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(seq / kBlock, hq, batch);
  kernel<<<grid, kThreads, fwd_smem<D>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), seq, hq, hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes).  q [B, S, Hq, D], k/v
// [B, S, Hkv, D] bf16, contiguous, 16-byte aligned; writes o [B, S, Hq, D]
// bf16 and lse [B, Hq, S] f32.  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dstack_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                int batch, int seq, int hq, int hkv, int head_dim, float scale,
                                void* stream) {
  if (seq <= 0 || seq % flash::kBlock || hkv <= 0 || hq % hkv || batch <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return flash::launch_fwd<64>(q, k, v, o, lse, batch, seq, hq, hkv, scale, s);
  if (head_dim == 128) return flash::launch_fwd<128>(q, k, v, o, lse, batch, seq, hq, hkv, scale, s);
  return (int)cudaErrorInvalidValue;
}
