// Paged single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces dstack_tpu/ops/flash_attention.py::_paged_decode_kernel (the
// Pallas TPU kernel behind paged_decode_attention).  Same function, not the
// same schedule:
//
//   * One CTA per (kv head, slot) holds the G query rows of that kv head
//     (query head h = kv * G + g).  A loop inside the CTA walks the slot's
//     block-table columns i while i * BS < length; it replaces the TPU's
//     sequential grid axis and the VMEM scratch (acc, m, l) it carried from
//     one grid step to the next: here m and l live in shared memory and acc
//     in registers for the whole walk.
//   * The CTA reads the page id from tables[b, i] itself (the TPU kernel got
//     it by scalar prefetch).  The table may be a column slice of a wider
//     table, so its row stride is an argument.
//   * Scores and the online softmax are f32; positions >= length are masked
//     with the finite -1e30 sentinel; p is rounded to bf16 before the PV
//     product; int8 pages are dequantised as (int8 -> f32) * scale, rounded
//     to bf16, before either dot.  A slot with length 0 gets o = 0 and
//     lse = -1e30 (the engine's logsumexp merge relies on that sentinel).
//
// What bounds it: device-memory bytes.  A decode step reads every owned
// page of K and V once: 2 * sum(length) * Hkv * D * 2 bytes in bf16 (half
// that plus the scales for int8) against ~4 * sum(length) * Hq * D flops,
// about one flop per byte, far below the ~295 flop/byte where an H100's
// bf16 tensor cores would become the limit.  So the design only has to keep
// each byte read once: a page is staged in shared memory and every one of
// the G query rows reads it from there.
//
// Known limits of this first version (later work): the grid is only
// B * Hkv CTAs (64 for 8 slots of Llama-3-8B, on 132 SMs), so the card is
// under-filled; a split over the KV length (flash-decoding) with a second
// merge pass would fill it.  Page loads are plain 4-byte loads with no
// cp.async/TMA pipelining, so each CTA waits on every page it loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// accumulators per thread: G * D <= kThreads * kMaxAcc (checked by the
// launcher and the Python wrapper)
constexpr int kMaxAcc = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Hkv, G, D]
                    const void* __restrict__ k_pages,     // [NB, BS, Hkv, D]
                    const void* __restrict__ v_pages,     //   bf16, or int8
                    const float* __restrict__ k_scales,   // [NB, BS, Hkv]
                    const float* __restrict__ v_scales,   //   (int8 only)
                    const int* __restrict__ tables,       // [B, >= NBK]
                    long long table_stride,
                    const int* __restrict__ lengths,      // [B]
                    float* __restrict__ out,              // [B, Hkv, G, D]
                    float* __restrict__ lse,              // [B, Hkv, G]
                    int hkv, int group, int head_dim, int block_size,
                    int nbk, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int G = group, D = head_dim, BS = block_size;
  const int D2 = D / 2;
  // K rows padded by one word: in the score loop lane t reads row t, and an
  // odd row stride (in 4-byte words) puts the 32 lanes on 32 banks
  const int kstride = D2 + 1;

  float* q_s = smem;             // [G, D]  query rows, f32
  float* p_s = q_s + G * D;      // [G, BS] scores, then probabilities
  float* m_s = p_s + G * BS;     // [G]     running max
  float* l_s = m_s + G;          // [G]     running sum
  float* a_s = l_s + G;          // [G]     this page's rescale factor
  __nv_bfloat162* k_s = reinterpret_cast<__nv_bfloat162*>(a_s + G);  // [BS, kstride]
  __nv_bfloat162* v_s = k_s + BS * kstride;                          // [BS, D2]

  const long long qrow = ((long long)b * hkv + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = __bfloat162float(q[qrow + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;

  const int length = lengths[b];
  const int* trow = tables + (long long)b * table_stride;
  const int warp = tid / 32, lane = tid % 32;
  __syncthreads();

  for (int i = 0; i < nbk && i * BS < length; ++i) {
    const long long page = trow[i];
    // -- stage this page's K and V rows of kv head h, as bf16 ------------
    for (int idx = tid; idx < BS * D2; idx += kThreads) {
      const int t = idx / D2, d2 = idx - t * D2;
      const long long row = (page * BS + t) * hkv + h;
      if (kQuant) {
        const char2 kq = reinterpret_cast<const char2*>(
            static_cast<const int8_t*>(k_pages) + row * D)[d2];
        const char2 vq = reinterpret_cast<const char2*>(
            static_cast<const int8_t*>(v_pages) + row * D)[d2];
        const float ks = k_scales[row], vs = v_scales[row];
        k_s[t * kstride + d2] = __floats2bfloat162_rn((float)kq.x * ks, (float)kq.y * ks);
        v_s[t * D2 + d2] = __floats2bfloat162_rn((float)vq.x * vs, (float)vq.y * vs);
      } else {
        k_s[t * kstride + d2] =
            static_cast<const __nv_bfloat162*>(k_pages)[row * D2 + d2];
        v_s[t * D2 + d2] = static_cast<const __nv_bfloat162*>(v_pages)[row * D2 + d2];
      }
    }
    __syncthreads();

    // -- scores s[g, t] = q[g] . k[t] * scale, masked past length ---------
    for (int idx = tid; idx < G * BS; idx += kThreads) {
      const int g = idx / BS, t = idx - g * BS;
      const float2* qg = reinterpret_cast<const float2*>(q_s + g * D);
      const __nv_bfloat162* kr = k_s + t * kstride;
      float s = 0.f;
      for (int d2 = 0; d2 < D2; ++d2) {
        const float2 kk = __bfloat1622float2(kr[d2]);
        const float2 qq = qg[d2];
        s = fmaf(qq.x, kk.x, s);
        s = fmaf(qq.y, kk.y, s);
      }
      p_s[idx] = (i * BS + t < length) ? s * scale : kNegInf;
    }
    __syncthreads();

    // -- online softmax, one warp per query row ----------------------------
    // column 0 of this page is valid (i * BS < length), so m_new is finite
    // and the first page's m_prev = -1e30 gives alpha = 0 exactly
    for (int g = warp; g < G; g += kThreads / 32) {
      float* pr = p_s + g * BS;
      float mx = kNegInf;
      for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < BS; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // -- acc[g, d] = acc * alpha + bf16(p[g]) . v[:, d] --------------------
    const __nv_bfloat16* v_h = reinterpret_cast<const __nv_bfloat16*>(v_s);
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < G * D) {
        const int g = idx / D, d = idx - g * D;
        const float* pr = p_s + g * BS;
        float s = 0.f;
        for (int t = 0; t < BS; ++t) {
          const float p = __bfloat162float(__float2bfloat16(pr[t]));
          s = fmaf(p, __bfloat162float(v_h[t * D + d]), s);
        }
        acc[j] = acc[j] * a_s[g] + s;
      }
    }
    __syncthreads();  // the next page overwrites k_s, v_s and p_s
  }

  // -- normalise; empty slots give o = 0 and the -1e30 sentinel -----------
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < G * D) {
      const float l = l_s[idx / D];
      out[qrow + idx] = l > 0.f ? acc[j] / l : 0.f;
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    const float l = l_s[g];
    lse[((long long)b * hkv + h) * G + g] = l > 0.f ? m_s[g] + logf(l) : kNegInf;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dstack_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                   const void* k_scales, const void* v_scales,
                                   const void* tables, long long table_stride,
                                   const void* lengths, void* out, void* lse, int batch,
                                   int hkv, int group, int head_dim, int block_size, int nbk,
                                   float scale, int quant, void* stream) {
  if (group * head_dim > kThreads * kMaxAcc || head_dim % 2 != 0 || block_size < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(float) * (size_t)(group * head_dim + group * block_size + 3 * group) +
      sizeof(__nv_bfloat162) * (size_t)block_size * (size_t)(head_dim + 1);
  const dim3 grid(hkv, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = quant ? paged_decode_kernel<true> : paged_decode_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), k_pages, v_pages,
      static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
      static_cast<const int*>(tables), table_stride, static_cast<const int*>(lengths),
      static_cast<float*>(out), static_cast<float*>(lse), hkv, group, head_dim, block_size,
      nbk, scale);
  return (int)cudaGetLastError();
}
