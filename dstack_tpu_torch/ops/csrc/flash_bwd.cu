// Causal GQA flash-attention backward for Hopper (sm_90a), head_dim 64 or 128.
//
// Replaces two Pallas TPU kernels of dstack_tpu/ops/flash_attention.py:
// _bwd_merged_kernel (head_dim 128, launched by _bwd_merged) and
// _bwd_merged_packed_kernel (head_dim 64, head pairs packed in 128 lanes).
// Given q, k, v, o, do and the forward's lse, it writes dq, dk and dv.
//
// What bounds it: tensor-core operations.  10 * D flops per (query, key)
// pair kept by the causal mask (five products where the forward has two)
// over q, k, v, o, do, lse read and dq, dk, dv written once: at peak rates
// the operations take ~1.7x as long as the bytes at the Llama-3.2-1B
// training shape (S = 1024, D = 64) and ~3.5x at the Llama-3-8B one
// (S = 2048, D = 128).
//
// What the design does about it (FlashAttention-3's one-pass backward):
//   * prep_kernel: delta = rowsum(do * o) in f32 (the JAX code computes it
//     outside its kernel) and a zeroed f32 dq_accum [B, S, Hq, D].
//   * bwd_kernel: one CTA per (batch, kv head, 128-row key tile), two
//     consumer warpgroups of 64 key rows and one producer warpgroup
//     (setmaxnreg: 240 / 24 registers).  The producer loads K and V once
//     and streams Q, dO, lse and delta tiles (128 query rows at D = 64,
//     64 at D = 128) through a ring of TMA / bulk-copy stages: every
//     query head of the GQA group, and for each the query tiles from the
//     diagonal on.  dK and dV accumulate in registers over the whole
//     group, which replaces the JAX code's separate sum of per-head
//     partials.  Per (query tile, key tile) pair, five wgmma products:
//     S^T = K Q^T and dP^T = V dO^T (shared memory operands); P^T and
//     dS^T made in registers from those accumulators and, as bf16, the
//     register A operands of dV += P^T dO and dK += dS^T Q; dS^T also goes
//     to shared memory once, as bf16, to be the transposed A operand of
//     dQ = dS K, of which each consumer warpgroup takes one [64, 64] block
//     and adds it into dq_accum with TMA bulk reduce-adds
//     (cp.reduce.async.bulk.tensor) from shared memory, which run while
//     the next pair is computed.  No f32 tile passes through shared memory
//     inside the products; the dQ block does so once, on its way out.
//   * post_kernel: dq = bf16(dq_accum * scale).
// dq is summed by reduce-adds in an order that changes from run to run, so
// it is not bitwise repeatable (dk and dv are).
//
// Numerics held to the JAX kernels: s = (q . k) * scale in f32, -1e30
// above the diagonal; p = exp(s - lse) in f32 (as exp2 of base-2 values);
// dv += bf16(p)^T do; dp = do v^T in f32; ds = bf16(p * (dp - delta));
// dk += ds^T q and dq += ds k in f32; dk and dq times scale at the end,
// each output rounded once to bf16.

#include "flash_common.cuh"

namespace flash {
namespace {

constexpr int kBN = 128;  // key rows per CTA (64 per consumer warpgroup)
constexpr int kThreads = 384;
constexpr int kStages = 2;

// Tile shapes by head_dim: kBM query rows per streamed tile (128 at D = 64,
// so that each tile pair carries twice the work of a 64-row tile; 64 at
// D = 128), S^T and dP^T made kQN query columns at a time.  The dK and dV
// accumulators hold D f32 a thread; the slices keep the rest of each
// consumer's registers (P^T, dS^T, and the previous slice's fragments
// still read by its dV and dK products) under the 240 setmaxnreg gives it.
template <int D>
struct Bwd {
  static constexpr int kBM = D == 64 ? 128 : 64;
  static constexpr int kQN = D == 64 ? 64 : 32;
  static constexpr int kKVBytes = kBN * D * 2;  // the K or the V tile
  static constexpr int kQBytes = kBM * D * 2;   // one Q or dO tile
  static constexpr int kDsBytes = kBN * kBM * 2;
  static constexpr int kRowBytes = kBM * 4;     // one lse or delta tile
  static constexpr int kDqBytes = 64 * 64 * 4;  // one warpgroup's [64, 64] f32 dQ block
  static constexpr int kTiles =
      2 * kKVBytes + kStages * 2 * kQBytes + 2 * kDsBytes + 2 * kDqBytes;
  static constexpr size_t kSmem =
      1024 + kTiles + kStages * 2 * kRowBytes + (1 + 2 * kStages) * sizeof(uint64_t);
};

// dq_accum[s0 .. s0 + 63, h, d0 .. d0 + 63] += dq (a warpgroup's [64, 64]
// partial): to shared memory as two [64, 32] swizzled f32 blocks, then one
// bulk reduce-add a block, issued by the warpgroup's first thread once its
// previous reduce-adds have read the buffer
__device__ __forceinline__ void reduce_dq(const float (&dq)[32], unsigned char* dq_w,
                                          const CUtensorMap* dq_map, int t, int wg, int row,
                                          int c0, int d0, int h, int s0, int b) {
  if (t == 0) bulk_wait_read();
  named_barrier(2 + wg, 128);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(dq_w + (i / 4) * 64 * 128 +
                                 swizzled_f32(row + 8 * e, 8 * (i % 4) + c0)) =
          make_float2(dq[4 * i + 2 * e], dq[4 * i + 2 * e + 1]);
  fence_proxy_async();
  named_barrier(2 + wg, 128);
  if (t == 0) {
    tma_reduce_add_4d(dq_map, dq_w, d0, h, s0, b);
    tma_reduce_add_4d(dq_map, dq_w + 64 * 128, d0 + 32, h, s0, b);
    bulk_commit();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
           const __grid_constant__ CUtensorMap dq_map, const float* __restrict__ lse,
           const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int seq,
           int hq, int hkv, float scale, float scale_log2) {
  using C = Bwd<D>;
  constexpr int kBM = C::kBM, kQN = C::kQN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kBN * D;
  bf16* qdo_s = v_s + kBN * D;  // stage st: Q, then dO
  // two dS^T buffers, each [kBM / 64 query blocks][128 keys][64 queries]
  unsigned char* ds_s = smem + 2 * C::kKVBytes + kStages * 2 * C::kQBytes;
  unsigned char* dq_s = ds_s + 2 * C::kDsBytes;  // each warpgroup's f32 dQ block
  float* rows_s = reinterpret_cast<float*>(smem + C::kTiles);  // stage st: lse, then delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kTiles + kStages * 2 * C::kRowBytes);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int jk = blockIdx.x;  // small jk walks the most query tiles: issued first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv, nq = (seq + kBM - 1) / kBM;
  const int first = jk * kBN / kBM;  // the first query tile that sees this key tile
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: one thread issues every load
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * C::kKVBytes);
      tma_load_tile<D>(k_s, kBN, &k_map, kv_full, hk, jk * kBN, b);
      tma_load_tile<D>(v_s, kBN, &v_map, kv_full, hk, jk * kBN, b);
      int n = 0;
      for (int g = 0; g < group; ++g) {
        const int h = hk * group + g;
        for (int it = first; it < nq; ++it, ++n) {
          const int st = n % kStages;
          // lse and delta rows of this tile inside the sequence (a ragged
          // last tile's Q and dO rows past S read as zero)
          const int rows = min(kBM, seq - it * kBM);
          mbar_wait(empty + st, ((n / kStages) & 1) ^ 1);
          mbar_expect_tx(full + st, 2 * C::kQBytes + 2 * rows * 4);
          bf16* q_st = qdo_s + st * 2 * kBM * D;
          tma_load_tile<D>(q_st, kBM, &q_map, full + st, h, it * kBM, b);
          tma_load_tile<D>(q_st + kBM * D, kBM, &do_map, full + st, h, it * kBM, b);
          const long long row_off = ((long long)b * hq + h) * seq + it * kBM;
          float* r_st = rows_s + st * 2 * kBM;
          bulk_load(r_st, lse + row_off, rows * 4, full + st);
          bulk_load(r_st + kBM, delta + row_off, rows * 4, full + st);
        }
      }
    }
  } else {  // consumer warpgroup wg: key rows 64 * wg .. + 63 of the tile
    regs_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row = warp * 16 + lane / 4;  // this thread's rows: row, row + 8
    const int c0 = 2 * (lane % 4);
    const int kpos = jk * kBN + wg * 64 + row;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const bf16* k_w = k_s + wg * 64 * 64;  // this warpgroup's rows of each column block
    const bf16* v_w = v_s + wg * 64 * 64;
    // this warpgroup's [64, 64] block of each tile's dQ: query rows
    // qrow0 .., head_dim columns dcol0 ..
    const int qrow0 = kBM == 128 ? wg * 64 : 0, dcol0 = D == 128 ? wg * 64 : 0;
    unsigned char* dq_w = dq_s + wg * C::kDqBytes;
    mbar_wait(kv_full, 0);

    int n = 0;
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      for (int it = first; it < nq; ++it, ++n) {
        const int st = n % kStages;
        const bf16* q_st = qdo_s + st * 2 * kBM * D;
        const bf16* do_st = q_st + kBM * D;
        const float* lse_st = rows_s + st * 2 * kBM;
        const float* delta_st = lse_st + kBM;
        unsigned char* ds_buf = ds_s + (n & 1) * C::kDsBytes;
        const bool diag = it * kBM < (jk + 1) * kBN;  // the pair straddles the diagonal
        const bool edge = diag || (it + 1) * kBM > seq;  // some pair is masked
        mbar_wait(full + st, (n / kStages) & 1);

#pragma unroll
        for (int hf = 0; hf < kBM / kQN; ++hf) {
          // S^T = K_w Q^T and dP^T = V_w dO^T, [64 keys, kQN queries] each
          float sp[kQN / 2], dp[kQN / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int off = (kk / 4) * kBN * 64 + (kk % 4) * 16;
            const int qoff = (kk / 4) * kBM * 64 + hf * kQN * 64 + (kk % 4) * 16;
            WgmmaSS<kQN, 0, 0>::run(sp, desc_b128(k_w + off), desc_b128(q_st + qoff), kk > 0);
          }
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int off = (kk / 4) * kBN * 64 + (kk % 4) * 16;
            const int qoff = (kk / 4) * kBM * 64 + hf * kQN * 64 + (kk % 4) * 16;
            WgmmaSS<kQN, 0, 0>::run(dp, desc_b128(v_w + off), desc_b128(do_st + qoff), kk > 0);
          }
          wgmma_commit();

          // P^T = exp(s - lse) on the S^T accumulator (columns are
          // queries; 0 above the diagonal and past S, masked only on edge
          // tiles); this wait also retires the previous slice's dV and dK
          // products
          auto qcol = [&](int i) { return hf * kQN + (i / 4) * 8 + c0 + (i & 1); };
          auto masked = [&](int i) {
            const int qpos = it * kBM + qcol(i);
            return qpos >= seq || (diag && kpos + 8 * ((i >> 1) & 1) > qpos);
          };
          wgmma_wait<1>();
#pragma unroll
          for (int i = 0; i < kQN / 2; ++i)
            sp[i] = ex2(sp[i] * scale_log2 - lse_st[qcol(i)] * kLog2e);
          if (edge) {
#pragma unroll
            for (int i = 0; i < kQN / 2; ++i)
              if (masked(i)) sp[i] = 0.f;
          }
          // dS^T = P^T (dP^T - delta), 0 where masked (also where a ragged
          // tile's stale lse or delta made p or ds no number)
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < kQN / 2; ++i) dp[i] = sp[i] * (dp[i] - delta_st[qcol(i)]);
          if (edge) {
#pragma unroll
            for (int i = 0; i < kQN / 2; ++i)
              if (masked(i)) dp[i] = 0.f;
          }
          // P^T and dS^T rounded to bf16 as A fragments (k step kq: this
          // slice's query columns 16kq ..), dS^T also to shared memory: the
          // dQ product's A operand, MN-major
          uint32_t pt[kQN / 16][4], dst[kQN / 16][4];
#pragma unroll
          for (int kq = 0; kq < kQN / 16; ++kq) {
            a_fragment(pt[kq], sp, kq);
            a_fragment(dst[kq], dp, kq);
#pragma unroll
            for (int x = 0; x < 4; ++x) {  // chunk 2kq + x / 2, row + 8 (x % 2)
              const int qc = hf * kQN + 16 * kq + 8 * (x >> 1) + c0;
              *reinterpret_cast<uint32_t*>(ds_buf + (qc / 64) * kBN * 128 +
                                           swizzled(wg * 64 + row + 8 * (x & 1), qc % 64)) =
                  dst[kq][x];
            }
          }
          // dV += P^T dO and dK += dS^T Q over this slice's queries: A from
          // the registers, B MN-major; they run under the next slice's
          // products
          wgmma_fence();
#pragma unroll
          for (int kq = 0; kq < kQN / 16; ++kq) {
            const int kk = hf * (kQN / 16) + kq;
            WgmmaRS<D, 1>::run(dv_acc, pt[kq], desc_b128(do_st + kk * 16 * 64, kBM * 128));
          }
#pragma unroll
          for (int kq = 0; kq < kQN / 16; ++kq) {
            const int kk = hf * (kQN / 16) + kq;
            WgmmaRS<D, 1>::run(dk_acc, dst[kq], desc_b128(q_st + kk * 16 * 64, kBM * 128));
          }
          wgmma_commit();
        }
        wgmma_wait<0>();
        mbar_arrive(empty + st);  // Q, dO, lse and delta of this stage are read

        // this warpgroup's [64, 64] block of dQ = dS K over both warpgroups'
        // keys: wait until both have written dS^T (the other buffer is still
        // read by the previous pair's dQ products until both pass here)
        fence_proxy_async();
        named_barrier(1, 2 * 128);
        float dq[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          WgmmaSS<64, 1, 1>::run(dq, desc_b128(ds_buf + (qrow0 / 64) * kBN * 128 + kk * 16 * 128),
                                 desc_b128(k_s + (dcol0 / 64) * kBN * 64 + kk * 16 * 64),
                                 kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reduce_dq(dq, dq_w, &dq_map, t, wg, row, c0, dcol0, h, it * kBM + qrow0, b);
      }
    }
    if (t == 0) bulk_wait();

    // dk = bf16(dk_acc * scale), dv = bf16(dv_acc); rows past S are the
    // ragged last key tile's padding
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pos = kpos + 8 * e;
      if (pos >= seq) continue;
      const long long off = (((long long)b * seq + pos) * hkv + hk) * D + c0;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * i) =
            pack_bf16(dk_acc[4 * i + 2 * e] * scale, dk_acc[4 * i + 2 * e + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * i) =
            pack_bf16(dv_acc[4 * i + 2 * e], dv_acc[4 * i + 2 * e + 1]);
      }
    }
  }
}

// delta[b, h, s] = sum_d do * o in f32, and dq_accum's row zeroed: one warp
// per (b, s, h) row
template <int D>
__global__ void __launch_bounds__(256)
prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
            float* __restrict__ dq_accum, long long rows, int seq, int hq) {
  const long long r = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  constexpr int kPer = D / 32;  // 2 or 4 values a lane
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; e += 2) {
    const int c = lane * kPer + e;
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(o + r * D + c);
    const __nv_bfloat162 g = *reinterpret_cast<const __nv_bfloat162*>(dout + r * D + c);
    sum += __bfloat162float(a.x) * __bfloat162float(g.x) +
           __bfloat162float(a.y) * __bfloat162float(g.y);
    *reinterpret_cast<float2*>(dq_accum + r * D + c) = make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const long long bs = r / hq;  // r = (b * S + s) * Hq + h
    const int h = (int)(r % hq), s = (int)(bs % seq);
    delta[((bs / seq) * hq + h) * seq + s] = sum;
  }
}

// dq = bf16(dq_accum * scale), 4 values a thread
__global__ void __launch_bounds__(256)
post_kernel(const float* __restrict__ dq_accum, bf16* __restrict__ dq, long long n,
            float scale) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  const float4 a = *reinterpret_cast<const float4*>(dq_accum + i);
  uint2 out;
  out.x = pack_bf16(a.x * scale, a.y * scale);
  out.y = pack_bf16(a.z * scale, a.w * scale);
  *reinterpret_cast<uint2*>(dq + i) = out;
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* delta, void* dq_accum, void* dq, void* dk, void* dv,
               int batch, int seq, int hq, int hkv, float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map, dq_map;
  if (!make_map(&q_map, q, batch, seq, hq, D, Bwd<D>::kBM) ||
      !make_map(&dq_map, dq_accum, batch, seq, hq, D, 64, true) ||
      !make_map(&k_map, k, batch, seq, hkv, D, kBN) ||
      !make_map(&v_map, v, batch, seq, hkv, D, kBN) ||
      !make_map(&do_map, dout, batch, seq, hq, D, Bwd<D>::kBM)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = bwd_kernel<D>;
  cudaError_t err = allow_smem(kernel, Bwd<D>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)batch * seq * hq;
  float* acc = static_cast<float*>(dq_accum);
  prep_kernel<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      acc, rows, seq, hq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((seq + kBN - 1) / kBN, hkv, batch), kThreads, Bwd<D>::kSmem, stream>>>(
      q_map, k_map, v_map, do_map, dq_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq,
      hq, hkv, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = rows * D;
  post_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(acc, static_cast<bf16*>(dq),
                                                                    n, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes).  q/o/do [B, S, Hq, D], k/v
// [B, S, Hkv, D] bf16, lse [B, Hq, S] f32, all contiguous and 16-byte
// aligned, S a multiple of 64; delta [B, Hq, S] and dq_accum [B, S, Hq, D]
// are f32 scratch the caller allocates.  Writes dq [B, S, Hq, D] and dk/dv
// [B, S, Hkv, D] bf16.  Launches the three kernels on `stream` and returns
// cudaGetLastError() after them.
extern "C" int dstack_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* delta, void* dq_accum,
                                void* dq, void* dk, void* dv, int batch, int seq, int hq, int hkv,
                                int head_dim, float scale, void* stream) {
  if (seq <= 0 || seq % 64 || hkv <= 0 || hq % hkv || batch <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    return flash::launch_bwd<64>(q, k, v, o, dout, lse, delta, dq_accum, dq, dk, dv, batch, seq,
                                 hq, hkv, scale, s);
  }
  if (head_dim == 128) {
    return flash::launch_bwd<128>(q, k, v, o, dout, lse, delta, dq_accum, dq, dk, dv, batch, seq,
                                  hq, hkv, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
