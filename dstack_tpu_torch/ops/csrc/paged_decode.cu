// Paged single-query GQA decode attention for Hopper (sm_90a): a split-KV
// walk over the block tables and a logsumexp merge of the splits.
//
// Replaces dstack_tpu/ops/flash_attention.py::_paged_decode_kernel (:703,
// the Pallas TPU kernel behind paged_decode_attention).  Same function:
// f32 scores, positions >= length masked with the finite -1e30 sentinel,
// int8 pages dequantised as (int8 -> f32) * scale rounded to bf16 before
// either dot, p rounded to bf16 before the PV product, a normalised f32 o
// and f32 lse, and for a slot of length 0 o = 0 and lse = -1e30 exactly
// (the engine's logsumexp merge relies on that sentinel).  The table may be
// a column slice of a wider one, so its row stride is an argument.  It
// takes any head_dim D that is a multiple of 16 up to 256 (one template
// instance each), any number G of query heads per kv head, any page block
// size (a power of two walks with a shift), and 16-byte aligned pages.
//
// What bounds it: device-memory bytes.  A call reads every owned page row
// of K and V once, 2 * sum(length) * Hkv * D * 2 bytes in bf16 (half that
// plus the f32 scales in int8), against ~4 * sum(length) * Hq * D flops:
// about one flop per byte, far below the ~295 flop/byte at which an H100's
// bf16 tensor cores would become the limit.  So the design keeps many page
// loads in flight on every SM and reads each byte once:
//
//   * The split.  The TPU walks a slot's table columns in order on one core;
//     one CTA per (kv head, slot) doing the same would run 64 CTAs on 132
//     SMs for 8 slots of Llama-3-8B, each as long as its slot's whole walk.
//     Here the grid is (splits, Hkv * ceil(G / 8), B): CTA `split` walks the
//     contiguous table columns [split * cols, (split + 1) * cols), cols =
//     ceil(NBK / splits), and writes a partial (o normalised over its rows,
//     lse) to an f32 scratch [B, Hkv, splits, G, D] / [B, Hkv, splits, G].
//     A CTA whose run starts at or past the slot's length writes the empty
//     partial (o 0, lse -1e30) and exits.  The wrapper picks `splits` from
//     host integers only (NBK, B, Hkv, the SM count): the lengths stay on
//     the device.  It takes as many splits as keep the grid within two CTAs
//     per SM, each at least 2 columns: measured on an H100, the all-full
//     table (8 slots, 8 kv heads, 32 columns) ran as fast at 2 and 4 splits
//     (1 and 2 CTAs per SM) and slower at 6 and more, and the ragged burst
//     ran fastest at 4 (the per-CTA start, combine and partial traffic
//     outweigh a shorter walk).  A second kernel, paged_decode_merge,
//     launched by the same C entry point on the same stream, merges the
//     partials of each (slot, query head) by logsumexp; every partial empty
//     gives o = 0 and lse = -1e30 exactly.  With one split the walk writes
//     o and lse itself and no merge runs.
//   * Query rows.  A CTA holds up to 8 query rows of its kv head (the n = 8
//     columns of the PV product); a larger G takes ceil(G / 8) CTAs per
//     (split, kv head), each reading the pages.
//   * The ring.  A CTA walks its rows in tiles of 32 keys (one page at the
//     served block size of 32; a tile may span pages or part of one at
//     other sizes).  Each of its 4 warps owns 8 keys of every tile and
//     loads exactly those keys' K and V rows (and int8 scales) itself, with
//     16-byte cp.async.cg copies (4-byte cp.async.ca for the scales) into
//     its own slice of a 4-stage ring in shared memory: 3 tiles are in
//     flight while the warp computes the 4th.  Rows at or past the length
//     are zero-filled, not read.  Since a warp only reads what it loaded,
//     cp.async.wait_group and __syncwarp order the ring; no block-wide
//     barrier runs inside the walk.
//   * The arithmetic runs on registers, on the tensor cores: per tile, each
//     warp's scores of the query rows (padded to 16) against its 8 keys
//     are D / 16 mma.sync m16n8k16 products, and its PV is D / 16 m16n8k8
//     products of V^T against P^T, P^T being the score fragment rounded to
//     bf16 in place.  At ~1 flop per byte the tensor cores are not needed
//     for speed; they cut the instructions per byte to what keeps up with
//     the memory.  Fragments are read from the ring in pieces of up to 16
//     bytes (the order of D along the product's k is free, see below),
//     chunks XOR-swizzled so the reads of a quarter warp hit distinct banks;
//     int8 values are dequantised and rounded to bf16 as the fragments are
//     built.  Each warp keeps its own online-softmax state in the exp2
//     domain (the score takes scale * log2(e) in one multiply).  The warps'
//     states are combined once per split, through shared memory, after the
//     walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeysPerWarp = 8;                   // keys of a tile each warp owns
constexpr int kTileKeys = kWarps * kKeysPerWarp;  // keys per ring stage
constexpr int kStages = 4;                        // ring depth, per warp
constexpr int kRows = 8;                          // query rows per CTA
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes 16 zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x in one MUFU instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, bool kQuant>
struct Layout {
  static_assert(D % 16 == 0 && D <= kMaxHeadDim, "D a multiple of 16, at most 256");
  static constexpr int kEb = kQuant ? 1 : 2;          // bytes per stored value
  static constexpr int kRowBytes = D * kEb;           // one stored K or V row
  static constexpr int kRowChunks = kRowBytes / 16;   // 16-byte copies per row
  static constexpr int kCopies = kKeysPerWarp * kRowChunks;  // per warp and tile, K or V
  static constexpr int kCopiesPerLane = (kCopies + 31) / 32;
  static constexpr int kKSteps = D / 16;  // k16 steps of the score product
  static constexpr int kDBlocks = D / 16;  // m16 blocks of D in the PV product
  // the D / 4 values of k a lane supplies to the scores, in pieces of kPiece
  // consecutive values of a row (4, 8 or 16 bytes): its piece p is the
  // row's piece tig + 4p
  static constexpr int kLaneElems = D / 4;
  static constexpr int kPiece =
      kLaneElems % (16 / kEb) == 0 ? 16 / kEb : (kLaneElems % 8 == 0 ? 8 : 4);
  static constexpr int kPieceBytes = kPiece * kEb;
  static constexpr int kPieces = kLaneElems / kPiece;
  static constexpr int kKWords = kLaneElems * kEb / 4;  // K words a lane reads per tile
  // a run of a V row in the PV product: D / 16 consecutive values
  static constexpr int kRun = D / 16;
  static constexpr int kRunBytes = kRun * kEb;
  static constexpr int kRunWords = (kRunBytes + 3) / 4;
  // XOR mask of the swizzles: within aligned blocks of kSwz + 1 chunks, so
  // a swizzled chunk stays in its row
  static constexpr int kSwz = kRowChunks % 8 == 0   ? 7
                              : kRowChunks % 4 == 0 ? 3
                              : kRowChunks % 2 == 0 ? 1
                                                    : 0;
  // one warp's slice of a stage: 8 K rows, 8 V rows, then 8 K and 8 V scales
  static constexpr int kVOffset = kKeysPerWarp * kRowBytes;
  static constexpr int kScaleOffset = 2 * kKeysPerWarp * kRowBytes;
  static constexpr int kStageBytes = kScaleOffset + (kQuant ? 2 * kKeysPerWarp * 4 : 0);
};

// XOR swizzles of a row's 16-byte chunks in the ring, so that the score and
// PV fragment reads of a quarter warp fall on distinct banks (rows of 8 or
// more chunks): K rows 2r and 2r + 1 are read together, V rows 2t, 2t + 2,
// 2t + 4, 2t + 6 together.
template <int kSwz>
__device__ __forceinline__ int swz_k(int row) {
  return ((row & 1) * 4) & kSwz;
}
template <int kSwz>
__device__ __forceinline__ int swz_v(int row) {
  return (((row >> 1) & 3) * 2) & kSwz;
}

// kBytes bytes from byte `off` of a ring row whose 16-byte chunks are
// XOR-swizzled by `swz`, as 32-bit words (first byte lowest), in the widest
// accesses the size and `off` (a multiple of kBytes) allow; none crosses a
// chunk
template <int kBytes>
__device__ __forceinline__ void read_row(uint32_t* w, const char* row, int off, int swz) {
  constexpr int kW = kBytes % 16 == 0  ? 16
                     : kBytes % 8 == 0 ? 8
                     : kBytes % 4 == 0 ? 4
                     : kBytes % 2 == 0 ? 2
                                       : 1;
#pragma unroll
  for (int i = 0; i < kBytes / kW; ++i) {
    const int o = off + i * kW;
    const char* p = row + (((o >> 4) ^ swz) << 4) + (o & 15);
    if constexpr (kW == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
    } else if constexpr (kW == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[2 * i] = v.x, w[2 * i + 1] = v.y;
    } else if constexpr (kW == 4) {
      w[i] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      const uint32_t v = kW == 2 ? *reinterpret_cast<const uint16_t*>(p)
                                 : *reinterpret_cast<const uint8_t*>(p);
      const int byte = i * kW;
      w[byte / 4] = byte % 4 == 0 ? v : w[byte / 4] | (v << (8 * (byte % 4)));
    }
  }
}

// Start this warp's copies of keys [key0, key0 + 8) of the slot (K rows, V
// rows, int8 scales) into `stage`.  Keys at or past `end` are zero-filled;
// table columns at or past `col_end` are not read.
template <int D, bool kQuant>
__device__ __forceinline__ void load_keys(char* stage, const char* __restrict__ kp,
                                          const char* __restrict__ vp,
                                          const float* __restrict__ ks,
                                          const float* __restrict__ vs,
                                          const int* __restrict__ trow, int key0, int end,
                                          int col_end, int bs, int bs_shift, int hkv, int h,
                                          int lane) {
  using L = Layout<D, kQuant>;
#pragma unroll
  for (int j = 0; j < L::kCopiesPerLane; ++j) {
    const int idx = j * 32 + lane;
    if (L::kCopies % 32 != 0 && idx >= L::kCopies) break;  // a lane with no copy left
    const int key = idx / L::kRowChunks, chunk = idx % L::kRowChunks;
    const int pos = key0 + key;
    const bool valid = pos < end;
    // the page's table column and the row in it
    const int col = bs_shift >= 0 ? pos >> bs_shift : pos / bs;
    const int within = pos - col * bs;
    // the table entry does not wait on the length: every column below
    // col_end is in the table
    const long long page = col < col_end ? trow[col] : 0;
    const long long row = (page * bs + within) * hkv + h;
    const int bytes = valid ? 16 : 0;
    const int kdst = key * L::kRowBytes + (chunk ^ swz_k<L::kSwz>(key)) * 16;
    const int vdst = key * L::kRowBytes + (chunk ^ swz_v<L::kSwz>(key)) * 16;
    cp_async16(stage + kdst, kp + row * L::kRowBytes + chunk * 16, bytes);
    cp_async16(stage + L::kVOffset + vdst, vp + row * L::kRowBytes + chunk * 16, bytes);
    if (kQuant && chunk == 0) {
      float* scales = reinterpret_cast<float*>(stage + L::kScaleOffset);
      cp_async4(scales + key, ks + row, valid ? 4 : 0);
      cp_async4(scales + kKeysPerWarp + key, vs + row, valid ? 4 : 0);
    }
  }
}

// bf16 pair (lo in the low half, the fragment order)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// int8 value i of a 32-bit word, as f32
__device__ __forceinline__ float s8(uint32_t w, int i) {
  return (float)(int8_t)(w >> (8 * i));
}

// 4 int8 values of a 32-bit word, times scale, as two bf16 pairs
__device__ __forceinline__ void dequant4(uint32_t w, float scale, uint32_t& lo, uint32_t& hi) {
  lo = pack_bf16(s8(w, 0) * scale, s8(w, 1) * scale);
  hi = pack_bf16(s8(w, 2) * scale, s8(w, 3) * scale);
}

// D += A B on the tensor cores: bf16 m16n8k16 and m16n8k8, f32 accumulators
__device__ __forceinline__ void mma16(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                      uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The products of one warp's 8 keys of a tile, on the tensor cores (mma.sync;
// lane = 4 * grp + tig as in the PTX fragment layouts):
//
//   S = Q K^T, m16n8k16: rows are the CTA's query rows (padded to 16 with
//   zero A registers), columns the 8 keys, k runs over D.  The order of D
//   along k is free as long as Q and K agree: the 4 values of k step ks
//   that lane (grp, tig) supplies are its elements 4ks ... 4ks + 3, where
//   its elements are the pieces tig, tig + 4, ... of a row (Layout::kPiece
//   values each), so K fragments are whole pieces of key grp's row.  The
//   lane gets S[grp][2tig, 2tig+1].
//
//   O^T += V^T P^T, m16n8k8: rows are D (16 per block), columns the query
//   rows, k the 8 keys.  P^T is the score fragment itself (B's (2tig, grp)
//   is S[grp][2tig]).  Row m of block mb is d = m * D/16 + mb, so lane (grp,
//   tig) reads keys 2tig, 2tig + 1 at d in [grp * D/16, + D/16) and [(grp +
//   8) * D/16, + D/16): two contiguous runs of each row.  The lane keeps
//   O[2tig][d], O[2tig + 1][d] for those d.
template <int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_decode_split(const __nv_bfloat16* __restrict__ q,  // [B, Hkv, G, D]
                   const char* __restrict__ k_pages,     // [NB, BS, Hkv, D]
                   const char* __restrict__ v_pages,     //   bf16, or int8
                   const float* __restrict__ k_scales,   // [NB, BS, Hkv]
                   const float* __restrict__ v_scales,   //   (int8 only)
                   const int* __restrict__ tables,       // [B, >= NBK]
                   long long table_stride,
                   const int* __restrict__ lengths,      // [B]
                   float* __restrict__ o_out,            // [B, Hkv, splits, G, D]
                   float* __restrict__ lse_out,          // [B, Hkv, splits, G]
                   int hkv, int group, int bs, int bs_shift, int nbk, float scale_log2) {
  using L = Layout<D, kQuant>;
  constexpr int kRun = L::kRun;  // d values of one run of a V row
  extern __shared__ __align__(16) char ring[];
  const int split = blockIdx.x, b = blockIdx.z, splits = gridDim.x;
  // kv head h, query rows [g0, g0 + rows) of its group
  const int gblocks = (group + kRows - 1) / kRows;
  const int h = blockIdx.y / gblocks, g0 = (blockIdx.y % gblocks) * kRows;
  const int rows = min(kRows, group - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 4, tig = lane % 4;

  // the merge (launched after this grid) may start its blocks now; they
  // wait for this grid's results before reading them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long long part = ((long long)(b * hkv + h) * splits + split) * group + g0;
  const int length = lengths[b];
  const int cols = (nbk + splits - 1) / splits;
  const int c0 = split * cols;
  const int c1 = min(c0 + cols, nbk);
  const int begin = c0 * bs;
  const int end = min(length, c1 * bs);
  if (begin >= end) {
    for (int i = tid; i < rows * D; i += kThreads) o_out[part * D + i] = 0.f;
    if (tid < rows) lse_out[part + tid] = kNegInf;  // the empty partial: weight 0 in the merge
    return;
  }

  // Q's A fragments (query row g0 + grp; rows past the CTA's stay 0): k
  // step ks takes the words at this lane's elements 4ks and 4ks + 2
  uint32_t qa[L::kKSteps][2];
  {
    const __nv_bfloat16* qrow = q + ((long long)(b * hkv + h) * group + g0 + grp) * D;
#pragma unroll
    for (int ks = 0; ks < L::kKSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * ks + 2 * j;
        const int d = (tig + 4 * (e / L::kPiece)) * L::kPiece + e % L::kPiece;
        qa[ks][j] = grp < rows ? *reinterpret_cast<const uint32_t*>(qrow + d) : 0u;
      }
    }
  }
  // online-softmax state of query row grp (exp2 domain), and this lane's
  // part of O^T: acc[mb] = O[2tig, 2tig + 1][d of rows grp, grp + 8 of mb]
  float m_row = kNegInf, l_row = 0.f;
  float acc[L::kDBlocks][4];
#pragma unroll
  for (int mb = 0; mb < L::kDBlocks; ++mb) acc[mb][0] = acc[mb][1] = acc[mb][2] = acc[mb][3] = 0.f;

  const int* trow = tables + (long long)b * table_stride;
  const int ntiles = (end - begin + kTileKeys - 1) / kTileKeys;
  const int wkey = begin + warp * kKeysPerWarp;  // this warp's first key of tile 0
  auto stage = [&](int t) { return ring + ((t % kStages) * kWarps + warp) * L::kStageBytes; };
  auto load = [&](int t) {
    load_keys<D, kQuant>(stage(t), k_pages, v_pages, k_scales, v_scales, trow,
                         wkey + t * kTileKeys, end, c1, bs, bs_shift, hkv, h, lane);
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load(t);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int t = 0; t < ntiles; ++t) {
    // refill the stage computed one tile ago (every lane left it at the
    // __syncwarp ending that tile)
    if (t + kStages - 1 < ntiles) load(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile t's copies have landed
    __syncwarp();
    const char* st = stage(t);
    const float* scales = reinterpret_cast<const float*>(st + L::kScaleOffset);
    const int key0 = wkey + t * kTileKeys;

    // scores: S[grp][2tig, 2tig + 1] = q . k of keys 2tig, 2tig + 1; key
    // grp's pieces tig, tig + 4, ... hold this lane's elements in order
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    {
      uint32_t kw[L::kKWords];
#pragma unroll
      for (int p = 0; p < L::kPieces; ++p)
        read_row<L::kPieceBytes>(kw + p * L::kPieceBytes / 4, st + grp * L::kRowBytes,
                                 (tig + 4 * p) * L::kPieceBytes, swz_k<L::kSwz>(grp));
#pragma unroll
      for (int ks = 0; ks < L::kKSteps; ++ks) {
        uint32_t b0, b1;
        if constexpr (kQuant) {
          dequant4(kw[ks], scales[grp], b0, b1);
        } else {
          b0 = kw[2 * ks];
          b1 = kw[2 * ks + 1];
        }
        mma16(sc, qa[ks][0], qa[ks][1], b0, b1);
      }
    }

    // online softmax of row grp over the warp's 8 keys of this tile
    const int pos = key0 + 2 * tig;
    float s0 = pos < end ? sc[0] * scale_log2 : kNegInf;
    float s1 = pos + 1 < end ? sc[1] * scale_log2 : kNegInf;
    float mx = fmaxf(s0, s1);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_row, mx);
    // -1e30 - m_new is far below -126 once a key was valid: alpha = 0
    const float alpha = ex2(m_row - m_new);
    m_row = m_new;
    const float p0 = s0 == kNegInf ? 0.f : ex2(s0 - m_new);
    const float p1 = s1 == kNegInf ? 0.f : ex2(s1 - m_new);
    l_row = l_row * alpha + p0 + p1;
    // this lane's O rows are 2tig and 2tig + 1: their rescale factors
    const float alpha0 = __shfl_sync(0xffffffffu, alpha, 8 * tig);
    const float alpha1 = __shfl_sync(0xffffffffu, alpha, 8 * tig + 4);
#pragma unroll
    for (int mb = 0; mb < L::kDBlocks; ++mb) {
      acc[mb][0] *= alpha0;
      acc[mb][1] *= alpha1;
      acc[mb][2] *= alpha0;
      acc[mb][3] *= alpha1;
    }

    // O^T += V^T P^T: P^T's fragment is bf16(p) of this lane's two keys
    const uint32_t pb = pack_bf16(p0, p1);
    const char* vrows = st + L::kVOffset;
    uint32_t va[2][L::kRunWords], vb[2][L::kRunWords];  // runs of keys 2tig, 2tig + 1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = (grp + 8 * r) * L::kRunBytes;
      const int ka = 2 * tig, kb = 2 * tig + 1;
      read_row<L::kRunBytes>(va[r], vrows + ka * L::kRowBytes, off, swz_v<L::kSwz>(ka));
      read_row<L::kRunBytes>(vb[r], vrows + kb * L::kRowBytes, off, swz_v<L::kSwz>(kb));
    }
    if constexpr (kQuant) {
      const float sa = scales[kKeysPerWarp + 2 * tig], sb = scales[kKeysPerWarp + 2 * tig + 1];
#pragma unroll
      for (int mb = 0; mb < L::kDBlocks; ++mb) {
        uint32_t a[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[r] = pack_bf16(s8(va[r][mb / 4], mb % 4) * sa, s8(vb[r][mb / 4], mb % 4) * sb);
        mma8(acc[mb], a[0], a[1], pb);
      }
    } else {
#pragma unroll
      for (int mb = 0; mb < L::kDBlocks; ++mb) {
        uint32_t a[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[r] = __byte_perm(va[r][mb / 2], vb[r][mb / 2], mb % 2 ? 0x7632 : 0x5410);
        mma8(acc[mb], a[0], a[1], pb);
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }

  // -- combine: row grp's l over its 4 lanes, then the 4 warps ------------
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 1);
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 2);
  cp_async_wait<0>();
  __syncthreads();  // the ring's memory now holds the warps' states
  float* red_m = reinterpret_cast<float*>(ring);  // [kWarps, kRows]
  float* red_l = red_m + kWarps * kRows;          // [kWarps, kRows]
  float* red_acc = red_l + kWarps * kRows;        // [kWarps, kRows, D]
  if (tig == 0 && grp < rows) {
    red_m[warp * kRows + grp] = m_row;
    red_l[warp * kRows + grp] = l_row;
  }
#pragma unroll
  for (int mb = 0; mb < L::kDBlocks; ++mb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 2 * tig + (i & 1);
      const int d = (grp + 8 * (i >> 1)) * kRun + mb;
      if (row < rows) red_acc[(warp * kRows + row) * D + d] = acc[mb][i];
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * kRows + g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = ex2(red_m[w * kRows + g] - mx);
      lsum += red_l[w * kRows + g] * wt;
      o += red_acc[(w * kRows + g) * D + i - g * D] * wt;
    }
    o_out[part * D + i] = lsum > 0.f ? o / lsum : 0.f;
    if (i - g * D == 0) lse_out[part + g] = lsum > 0.f ? (mx + log2f(lsum)) * kLn2 : kNegInf;
  }
}

// o, lse of each (slot, kv head, query row) from its `splits` partials by
// logsumexp; every partial empty gives o = 0 and lse = -1e30 exactly.  One
// block per (slot, kv head, query row), one thread per value of D.  It is
// launched as a programmatic dependent of the split walk: its blocks may
// start while the walk's last CTAs run, and wait for the walk's results.
__global__ void paged_decode_merge(const float* __restrict__ o_part,    // [B, Hkv, S, G, D]
                                   const float* __restrict__ lse_part,  // [B, Hkv, S, G]
                                   float* __restrict__ out,             // [B, Hkv, G, D]
                                   float* __restrict__ lse,             // [B, Hkv, G]
                                   int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int g = blockIdx.y, group = gridDim.y, d = threadIdx.x, head_dim = blockDim.x;
  const long long bh = blockIdx.x;
  const float* lp = lse_part + bh * splits * group + g;
  const float* op = o_part + (bh * splits * group + g) * head_dim + d;
  float mx = kNegInf;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, lp[s * group]);
  float wsum = 0.f, o = 0.f;
  if (mx > kNegInf) {
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float wt = expf(lp[s * group] - mx);
      wsum += wt;
      o += wt * op[(long long)s * group * head_dim];
    }
  }
  out[(bh * group + g) * head_dim + d] = wsum > 0.f ? o / wsum : 0.f;
  if (d == 0) lse[bh * group + g] = wsum > 0.f ? mx + logf(wsum) : kNegInf;
}

template <int D, bool kQuant>
int launch_split(dim3 grid, cudaStream_t stream, const void* q, const void* k_pages,
                 const void* v_pages, const void* k_scales, const void* v_scales,
                 const void* tables, long long table_stride, const void* lengths, void* o_out,
                 void* lse_out, int hkv, int group, int bs, int bs_shift, int nbk,
                 float scale_log2) {
  using L = Layout<D, kQuant>;
  constexpr size_t ring = (size_t)kStages * kWarps * L::kStageBytes;
  constexpr size_t red = sizeof(float) * (size_t)kWarps * kRows * (D + 2);
  constexpr size_t smem = ring > red ? ring : red;
  auto kernel = paged_decode_split<D, kQuant>;
  if (smem > 48 * 1024) {
    // the attribute is set once per instance and device
    static bool configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!configured[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      configured[dev] = true;
    }
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const char*>(k_pages),
      static_cast<const char*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(tables), table_stride,
      static_cast<const int*>(lengths), static_cast<float*>(o_out), static_cast<float*>(lse_out),
      hkv, group, bs, bs_shift, nbk, scale_log2);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(dim3, cudaStream_t, const void*, const void*, const void*, const void*,
                         const void*, const void*, long long, const void*, void*, void*, int, int,
                         int, int, int, float);

// the instance for head_dim (a multiple of 16 up to kMaxHeadDim), else null
template <bool kQuant, int D = 16>
LaunchFn pick(int head_dim) {
  if constexpr (D > kMaxHeadDim) {
    return nullptr;
  } else {
    if (head_dim == D) return launch_split<D, kQuant>;
    return pick<kQuant, D + 16>(head_dim);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches the split walk and,
// when splits > 1, the merge on `stream`; returns cudaGetLastError() after
// the launches (0 = launched).  o_part / lse_part are f32 scratch [B, Hkv,
// splits, G, D] / [B, Hkv, splits, G], unused when splits == 1.  Takes
// head_dim a multiple of 16 up to 256, any group and block_size, and
// 16-byte aligned pages.
extern "C" int dstack_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                   const void* k_scales, const void* v_scales,
                                   const void* tables, long long table_stride,
                                   const void* lengths, void* out, void* lse, void* o_part,
                                   void* lse_part, int batch, int hkv, int group, int head_dim,
                                   int block_size, int nbk, int splits, float scale, int quant,
                                   void* stream) {
  const LaunchFn fn = quant ? pick<true>(head_dim) : pick<false>(head_dim);
  const long long grid_y = (long long)hkv * ((group + kRows - 1) / kRows);
  if (fn == nullptr || block_size < 1 || splits < 1 || nbk < 0 || batch < 1 || batch > 65535 ||
      hkv < 1 || group < 1 || group > 65535 || grid_y > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  // a power-of-two block size walks with a shift, any other with a division
  int bs_shift = -1;
  if ((block_size & (block_size - 1)) == 0) {
    bs_shift = 0;
    while ((1 << bs_shift) < block_size) ++bs_shift;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool merge = splits > 1;
  int rc = fn(dim3(splits, (unsigned)grid_y, batch), s, q, k_pages, v_pages, k_scales, v_scales,
              tables, table_stride, lengths, merge ? o_part : out, merge ? lse_part : lse, hkv,
              group, block_size, bs_shift, nbk, scale * kLog2e);
  if (rc != 0 || !merge) return rc;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * hkv, group);
  config.blockDim = dim3(head_dim);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&config, paged_decode_merge, static_cast<const float*>(o_part),
                               static_cast<const float*>(lse_part), static_cast<float*>(out),
                               static_cast<float*>(lse), splits);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
