// Int8 flash-attention forward with in-kernel probability statistics.
//
// Replaces the TPU kernel repro/kernels/int8_attention.py
// (attention_kernel, body _attn_kernel).  One CUDA block owns one
// (head, q block) pair and walks its visited kv blocks in the reference's
// order (_kv_block_base); that loop takes the place of the TPU's
// sequential grid axis, and the online-softmax carries (m, l, acc) stay in
// registers across it.  GQA: head bh reads kv head bh / groups.  Per
// visited tile, in the reference's integers:
//   acc_qk = q . k - trunc(zp_q) * rowsum(k)       (exact int32, mma)
//   s      = alpha_qk * float(acc_qk), masked to -1e30
//   m_new  = max(m, rowmax s);  p = exp(s - m_new), masked p = 0 exactly
//   p_int  = clip(rint(p / scale_p + zp_p), 0, 255)
//   acc_pv = p_int . v - trunc(zp_p) * colsum(v)   (exact int32, mma)
//   acc    = acc * corr + alpha_pv * float(acc_pv);  l likewise with
//            lsum = sum(p_int - trunc(zp_p))
// and the tile is folded into the (min, max, clip, n, err, sig) partials,
// err/sig through the reference's pinned pairwise-halving tree
// (_tree_sum_last2).  Every mul->add seam is rounded separately
// (__fmul_rn / __fadd_rn, and the library is built with -fmad=false),
// division is __fdiv_rn, rounding rintf; exp is the accurate expf.
//
// Both contractions run on the tensor cores (mma.sync m16n8k32 u8 x s8,
// mma_int8.cuh), the u8 operands (q, p_int) fed as they are, and the zero
// points come back as the row/column-sum corrections above (the sums
// themselves an all-ones A operand times the staged tile, on the tensor
// cores too); the reference truncates both zero points (astype int32), so
// the correction is -trunc(zp) * sum, not the int8 matmul's
// rint(128 - zp) - 128.  The operands: q [BH, sq, hd] u8, k [ZB, skv, hd]
// s8 (as stored: already mma's K-contiguous B operand), and V's K-major
// image vt [ZB, hd, skvp] (skvp = skv rounded up to 16, zero-padded),
// which the wrapper writes with the int8 matmul's transpose kernel.  With
// hd and bkv multiples of 16 and 16-byte aligned rows, K and V^T tiles
// reach shared memory by cp.async, double-buffered: the next visited tile
// streams in while the current one is computed; other shapes (direct
// calls, reduced tests) are staged by byte loads.
//
// 16 warps: row group w = warp % 8 owns q rows w + 8 j (j = 0..15), one
// 16-row mma tile whose local rows g and g + 8 are j, and its two warps
// (halves h = warp / 8) split the tile's kv columns for QK^T and the
// softmax, and the out columns for P.V, 64 each; they exchange the row
// max and the p_int row sums through shared memory at a named barrier of
// the pair.  A row's values live in the four lanes t = 0..3 of one lane
// group, so its max and sums are in-thread plus two shuffles, and the
// min/max/clip/n partials (exact in any order) stay in registers until the
// end.  An empty tile (the mask keeps no pair) takes p = 0 and p_int =
// rint(zp_p) everywhere, as the per-element formulas give, without its
// QK^T, exps and divisions, and its P.V is (pi0 - trunc(zp_p)) * colsum(v)
// exactly.  The err/sig tree: for power-of-two bkv the reference's flat
// halving tree over the [bq, bkv] tile is, bit for bit, a halving tree
// over the rows of each column (rows zero-padded to 128, top row bit
// first) and then over the columns; with rows w + 8 j the top four row
// bits are j's, reduced in-thread and by a reduce-scatter over lane bits
// 4, 3, 2; the groups' three bits and the seven column levels run on an
// [8, 128] (err, sig) buffer in the next tile's first phase.  Other bkv
// take the flat tree in shared memory (the choice is made per launch from
// the shape).
//
// Bound on the H100: at the prefill shape (96 heads, S = 1024, hd = 128)
// the int8 operations and the bytes both need ~0.02 ms; what is left is
// the per-element fp32 softmax and requantization (accurate expf and an
// IEEE division per probability, whose slow-path branch splits the code
// into one block per element; no FMA), and the latency of phases that all
// warps run between the tile's barriers.  wgmma/TMA and warp
// specialisation are later work.
//
// Head dims above 128 (nemotron-4-340b's 192; 256) take a wide
// instantiation: hd in (128, 256], a multiple of 16, bq and bkv still <=
// 128.  The Q and K tiles' rows grow to hd + 16 bytes and V^T to hd rows
// (the shared layout is computed from the launch's hd), QK^T takes up to 8
// k-steps, and each half keeps up to 16 out n-tiles (half 0 the first
// `osplit`, half 1 the rest) whose P.V runs in chunks of 8 n-tiles.  At hd
// 256 the layout takes 204 KB before the flat tree's buffer; a non-power-
// of-two bkv whose buffer does not fit the card's 227 KB is refused.
//
// q blocks of 129-256 rows (the tuner's (256, 128) below S = 256) take a
// tall instantiation of either width: row group w owns rows w + 8 j for
// j < 32, as two 16-row mma tiles u = 0, 1 (rows 128 u + w + 8 j', j' <
// 16) whose scores, softmax, P.V and carries run side by side in the same
// warps.  The reference's tree over the [bq, bkv] tile zero-pads the rows
// to 256, so its first level adds row r + 128 to row r: the two tiles'
// values of one element meet in-thread before the row bit 6 level, and
// the rest of the tree is the 128-row one.  The 256-row Q tile takes the
// second K/V buffer's room (at hd 256 both would not fit): the tall
// kernel stages a visited tile after the last one is consumed.
// Tile limits: bq <= 256, bkv <= 128; hd <= 128, or <= 256 in multiples
// of 16.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "mma_int8.cuh"

namespace {

using namespace mma_int8;

constexpr int kMax = 128;            // max bkv (and bq but for the tall
                                     // kernel); hd of the narrow kernel
constexpr int kTallMax = 256;        // max bq of the tall kernel
constexpr int kWideMax = 256;        // max hd of the wide kernel
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 8;           // row groups: rows w + 8 j, j < 16
constexpr int kLd = kMax + 16;       // shared row stride, bytes (no conflicts)
constexpr int kTreeSig = kGroups * kMax + 16;   // sig plane, bank-shifted
constexpr int kSmemOptin = 232448;   // a block's shared memory on the H100
constexpr float kNegInf = -1e30f;
constexpr unsigned kAll = 0xffffffffu;

// Shared memory: K and V^T double buffers (one of each when tall), each
// row group's p_int rows (per mma tile), the q block, the tile's row/column
// sums, the err/sig buffer, the two halves' row max / p_int sum exchange
// (per mma tile), the block reductions, then the flat tree's buffer (bkv
// not a power of two).  Q and K rows are hd + 16 bytes (`ld`), V^T has hd
// rows of kLd; hd = kMax for the narrow kernel.  `tall`: 256 q rows.
struct Layout {
  int ld, tile, vtile;   // Q/K row stride, one 128-row Q or K tile, one V^T
  int k, v, p, q, sum, tree, x, red, flat;   // offsets
};

__host__ __device__ constexpr Layout layout(int hd, bool tall = false) {
  const int u = tall ? 2 : 1;   // mma row tiles a row group owns
  const int nbuf = tall ? 1 : 2;
  Layout L{};
  L.ld = hd + 16;
  L.tile = kMax * L.ld;
  L.vtile = hd * kLd;
  L.k = 0;
  L.v = L.k + nbuf * L.tile;
  L.p = L.v + nbuf * L.vtile;
  L.q = L.p + u * kGroups * 16 * kLd;
  L.sum = L.q + u * L.tile;
  L.tree = L.sum + (kMax + hd) * 4;
  L.x = L.tree + 4 * (kTreeSig + kGroups * kMax);
  L.red = L.x + u * 2 * kWarps * 16 * 4;
  L.flat = L.red + 5 * kWarps * 4;
  return L;
}

constexpr int kSmemMax = layout(kMax).flat + 4 * kMax * (kMax - 1);   // bkv 127

// The kernel's layout: compile-time constants unless wide.
template <bool kWide, bool kTall>
__device__ __forceinline__ Layout kernel_layout(int hd) {
  if constexpr (kWide) {
    return layout(hd, kTall);
  } else {
    constexpr Layout L = layout(kMax, kTall);
    return L;
  }
}

enum Mode { kCausal = 0, kSliding = 1, kPrefix = 2, kCross = 3, kBidir = 4 };

// sq: this launch's q rows, of which the first row_lo are padding (no
// statistics); q_start: the position of its row 0 in the whole call the
// schedule plans (a multiple of bq), so its q block i is the call's
// block q_start / bq + i, with that block's kv visitation and mask.
struct Sched {
  int sq, skv, skvp, hd, bq, bkv, groups, mode, window, prefix_len, width,
      nq, nkv, vec, pow2, q_start, row_lo;
};

// The mask of row qp as a key interval: kp is attended iff lo <= kp < hi
// (the mode's rule, kp < kvlen and kp < skv; kvlim = min(kvlen, skv)).
__device__ __forceinline__ void mask_bounds(int qp, int kvlim,
                                            const Sched& S, int& lo,
                                            int& hi) {
  lo = 0;
  hi = kvlim;
  switch (S.mode) {
    case kCross:
    case kBidir: break;
    case kPrefix: hi = min(hi, max(qp + 1, S.prefix_len)); break;
    case kSliding:
      lo = qp - S.window + 1;
      hi = min(hi, qp + 1);
      break;
    default: hi = min(hi, qp + 1); break;
  }
}

// True when the mask keeps no pair of the tile's real rows [q0, q0 + bq)
// and columns [k0, k0 + bkv).
__device__ __forceinline__ bool tile_empty(int q0, int k0, int kvlim,
                                           const Sched& S) {
  const int qhi = q0 + S.bq - 1, khi = k0 + S.bkv - 1;
  if (k0 >= kvlim) return true;
  switch (S.mode) {
    case kCross:
    case kBidir: return false;
    case kPrefix: return k0 > qhi && k0 >= S.prefix_len;
    case kSliding: return k0 > qhi || q0 - khi >= S.window;
    default: return k0 > qhi;
  }
}

// The number of this lane's columns 8 nt + e (nt < nt_end, e < 2; the
// lane's offset 2 t taken off the limit) below x.
__device__ __forceinline__ int lane_cols(int x, int nt_end) {
  if (x <= 0) return 0;
  const int f = x >> 3;
  return f >= nt_end ? 2 * nt_end : 2 * f + min(x & 7, 2);
}

__device__ __forceinline__ int kv_block_base(int i, const Sched& S) {
  if (S.mode != kSliding || S.width >= S.nkv) return 0;
  const int hi = min((S.q_start + i * S.bq + S.bq - 1) / S.bkv, S.nkv - 1);
  const int top = max(S.nkv - S.width, 0);
  return min(max(hi - (S.width - 1), 0), top);
}

__device__ __forceinline__ bool block_visited(int i, int ki, const Sched& S) {
  if (S.mode == kCross || S.mode == kBidir || S.mode == kSliding) return true;
  const bool causal = ki * S.bkv <= S.q_start + i * S.bq + S.bq - 1;
  if (S.mode == kPrefix) return causal || (ki * S.bkv < S.prefix_len);
  return causal;
}

// The first visited kv block after ki below `end`, or -1.
__device__ __forceinline__ int next_visited(int i, int ki, int end,
                                            const Sched& S) {
  for (++ki; ki < end; ++ki)
    if (block_visited(i, ki, S)) return ki;
  return -1;
}

// Shared row of q row r: 128-row tiles, within one (r % 8) * 16 + (r %
// 128) / 8 (row group w's rows w + 8 j of a tile are then contiguous).
__device__ __forceinline__ int q_slot(int r) {
  return ((r >> 7) << 7) + ((r & 7) << 4) + ((r & 127) >> 3);
}

// Stage `rows` <= kRows rows x `chunks` <= kChunks 16-byte chunks of a
// tile (shared row stride `ld`): row r of src (row stride `stride` bytes)
// lands in shared row r, or with kQSlots in row q_slot(r).  Rows >= valid_rows and bytes
// >= valid_bytes are zero.  `vec`: 16-byte aligned rows and valid_bytes a
// multiple of 16, copied by cp.async; otherwise byte loads.
template <bool kQSlots, int kRows, int kChunks>
__device__ __forceinline__ void stage_tile(uint8_t* dst, const uint8_t* src,
                                           int stride, int rows,
                                           int valid_rows, int chunks,
                                           int valid_bytes, bool vec, int t,
                                           int ld) {
  if (vec) {
    const uint32_t d = smem_addr(dst);
#pragma unroll
    for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
      const unsigned e = t + it * kThreads;
      const int r = e / kChunks, c = e % kChunks;
      if (r < rows && c < chunks) {
        const int dr = kQSlots ? q_slot(r) : r;
        const bool in = r < valid_rows && 16 * c < valid_bytes;
        cp_async_16(d + dr * ld + 16 * c,
                    in ? src + static_cast<long long>(r) * stride + 16 * c
                       : src,
                    in ? 16 : 0);
      }
    }
  } else {
    const int w = t >> 5, l = t & 31;
    for (int r = w; r < rows; r += kWarps) {
      const int dr = kQSlots ? q_slot(r) : r;
      for (int b = l; b < 16 * chunks; b += 32)
        dst[dr * ld + b] =
            (r < valid_rows && b < valid_bytes)
                ? src[static_cast<long long>(r) * stride + b]
                : 0;
    }
  }
}

// sums[r] = sum of the bytes of staged row r (ksteps <= kKs times 32 of
// them, row stride ld), for the 16 rows of warp w's n-tile pair (if it is
// below nt_end n-tiles): C = ones (16 x 32) . rows^T, whose every row
// holds the sums.
template <int kKs>
__device__ __forceinline__ void row_sums(uint32_t tile, int ld, int ksteps,
                                         int nt_end, int* sums, int w,
                                         int lane) {
  if (2 * w >= nt_end) return;
  const uint32_t ones[4] = {0x01010101u, 0x01010101u, 0x01010101u,
                            0x01010101u};
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_chunk = (lane >> 3) & 1;
  int c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
    if (ks >= ksteps) break;
    uint32_t bf[4];
    ldmatrix_x4(bf, tile + (b_row + 16 * w) * ld + (2 * ks + b_chunk) * 16);
    mma_u8s8(c0, ones, bf[0], bf[1]);
    mma_u8s8(c1, ones, bf[2], bf[3]);
  }
  if (lane < 4) {   // row g = 0 of C: columns 2 t, 2 t + 1 of each n-tile
    sums[16 * w + 2 * lane] = c0[0];
    sums[16 * w + 2 * lane + 1] = c0[1];
    sums[16 * w + 8 + 2 * lane] = c1[0];
    sums[16 * w + 8 + 2 * lane + 1] = c1[1];
  }
}

// One halving level of the reduce-scatter over lane bit `mask`: the lower
// lane keeps v[0..n/2), the upper v[n/2..n), each adding its partner's.
template <int N>
__device__ __forceinline__ void scatter_half(float (&v)[16], int mask,
                                             bool upper) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? v[i] : v[i + N / 2];
    const float keep = upper ? v[i + N / 2] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(kAll, send, mask));
  }
}

// acc[i] += A . B_i^T on the tensor cores: A the 16 staged rows at `a`
// (q, or the group's p_int), B_i the staged rows 8 i..8 i + 7 at `b` (K,
// or V^T), both K-contiguous over ksteps <= kKs times 32 bytes with row
// stride ld, for i < nt_end.
template <int kKs>
__device__ __forceinline__ void tile_mma(int (&acc)[8][4], uint32_t a,
                                         uint32_t b, int ld, int ksteps,
                                         int nt_end, int lane) {
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_chunk = (lane >> 3) & 1;
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
    if (ks >= ksteps) break;
    uint32_t af[4];
    ldmatrix_x4(af, a + a_row * ld + (2 * ks + a_chunk) * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (2 * np >= nt_end) break;
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (b_row + 16 * np) * ld + (2 * ks + b_chunk) * 16);
      mma_u8s8(acc[2 * np], af, bf[0], bf[1]);
      if (2 * np + 1 < nt_end) mma_u8s8(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// The err/sig buffer holds, for each row group w (after its row levels)
// and each column c, err at [w * 128 + pos(c)] and sig kTreeSig floats
// further, pos(c) = (c % 8) * 16 + c / 8: the columns w + 8 m are then
// contiguous for tree_cols.
__device__ __forceinline__ int tree_pos(int c) {
  return ((c & 7) << 4) + (c >> 3);
}

// Row bits 5, 4, 3 of the power-of-two tree (lane bits 4, 3, 2) as a
// reduce-scatter: lane (g, t) of half h is left with columns
// 64 h + 8 g + 2 t + {0, 1}, which it writes to its group's row of the
// err/sig buffer.
__device__ __forceinline__ void tree_rows(float (&te)[16], float (&ts)[16],
                                          float* tree, int w, int h,
                                          int lane) {
  scatter_half<16>(te, 16, (lane >> 4) & 1);
  scatter_half<16>(ts, 16, (lane >> 4) & 1);
  scatter_half<8>(te, 8, (lane >> 3) & 1);
  scatter_half<8>(ts, 8, (lane >> 3) & 1);
  scatter_half<4>(te, 4, (lane >> 2) & 1);
  scatter_half<4>(ts, 4, (lane >> 2) & 1);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int at = w * kMax + tree_pos(64 * h + 8 * g + 2 * tq + e);
    tree[at] = te[e];
    tree[kTreeSig + at] = ts[e];
  }
}

// Row group w's columns c = w + 8 m, m = lane % 16, err on lanes 0..15 and
// sig on 16..31: the last three row levels (the groups' bits 2, 1, 0),
// then column bits 6..3 (m's bits 3..0, by shuffles); the partial for
// column bits 2..0 = w goes to part[2 w + quantity].
__device__ __forceinline__ void tree_cols(const float* tree, float* part,
                                          int w, int lane) {
  const int m = lane & 15, qd = lane >> 4;
  const float* src = tree + qd * kTreeSig + (w << 4) + m;
  float b[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) b[r] = src[r * kMax];
#pragma unroll
  for (int r = 0; r < 4; ++r) b[r] = __fadd_rn(b[r], b[r + 4]);
#pragma unroll
  for (int r = 0; r < 2; ++r) b[r] = __fadd_rn(b[r], b[r + 2]);
  float v = __fadd_rn(b[0], b[1]);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kAll, v, off));
  if (m == 0) part[2 * w + qd] = v;
}

// Column bits 2, 1, 0 over the groups' partials, folded into (err, sig).
__device__ __forceinline__ void tree_total(const float* part, float& st_err,
                                           float& st_sig) {
  float b[2][8];
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    b[0][w] = part[2 * w];
    b[1][w] = part[2 * w + 1];
  }
#pragma unroll
  for (int qd = 0; qd < 2; ++qd) {
#pragma unroll
    for (int w = 0; w < 4; ++w) b[qd][w] = __fadd_rn(b[qd][w], b[qd][w + 4]);
#pragma unroll
    for (int w = 0; w < 2; ++w) b[qd][w] = __fadd_rn(b[qd][w], b[qd][w + 2]);
  }
  st_err = __fadd_rn(st_err, __fadd_rn(b[0][0], b[0][1]));
  st_sig = __fadd_rn(st_sig, __fadd_rn(b[1][0], b[1][1]));
}

// The flat tree over the n values of buf (zero-padded to a power of two),
// in place, by the whole block; returns buf[0] (to every thread).
__device__ __forceinline__ float flat_tree(float* buf, int n, int t) {
  __syncthreads();
  int h = 1;
  while (h < n) h <<= 1;
  for (h >>= 1; h >= 1; h >>= 1) {
    for (int j = t; j < h; j += kThreads)
      buf[j] = __fadd_rn(buf[j], j + h < n ? buf[j + h] : 0.f);
    __syncthreads();
  }
  const float v = buf[0];
  __syncthreads();
  return v;
}

// The two warps of row group w (halves 0 and 1) meet at named barrier w + 1.
__device__ __forceinline__ void pair_sync(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(w + 1), "r"(64) : "memory");
}

// kFix: hd = bkv = 128 with cp.async staging (the model's shape), every
// tile width a compile-time constant; otherwise the widths of the launch.
// kWide: hd in (128, 256], the shared layout from the launch's hd.
// kTall: bq in (128, 256], two mma row tiles per row group, one K/V buffer.
template <bool kFix, bool kWide, bool kTall>
__global__ void __launch_bounds__(kThreads, 1)
int8_attention_kernel(const uint8_t* __restrict__ q,
                      const int8_t* __restrict__ k,
                      const int8_t* __restrict__ vt,
                      const float* __restrict__ regs,
                      const int* __restrict__ kvlen_p,
                      float* __restrict__ out, float* __restrict__ ml,
                      float* __restrict__ pstats, Sched S) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int kDh = kWide ? kWideMax : kMax;   // the widest hd
  constexpr int kKs = kDh / 32;                  // QK^T k-steps at most
  constexpr int kOnt = kDh / 16;                 // a half's out n-tiles
  constexpr int kU = kTall ? 2 : 1;              // a row group's mma tiles
  const Layout L = kernel_layout<kWide, kTall>(S.hd);
  const int hd = kFix ? kMax : S.hd;
  const int bkv = kFix ? kMax : S.bkv;
  const bool vec = kFix || S.vec;
  const bool pow2 = kFix || S.pow2;
  const int nks = kFix ? 4 : (hd + 31) >> 5;    // QK^T k-steps (hd / 32)
  const int nnt = kFix ? 16 : (bkv + 7) >> 3;   // score n-tiles
  const int pks = kFix ? 4 : (bkv + 31) >> 5;   // PV k-steps (bkv / 32)
  const int hnt = kFix ? 16 : (hd + 7) >> 3;    // out n-tiles
  // The wide kernel's halves: out n-tiles [0, osplit) and [osplit, hnt).
  const int osplit = ((hnt + 3) >> 2) << 1;

  int* rowsum_k = reinterpret_cast<int*>(smem + L.sum);
  int* colsum_v = rowsum_k + kMax;
  float* tree = reinterpret_cast<float*>(smem + L.tree);
  // [tile u][warp][row j]
  float* xmax = reinterpret_cast<float*>(smem + L.x);
  int* xsum = reinterpret_cast<int*>(xmax + kU * kWarps * 16);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* part = red + 4 * kWarps;   // the err/sig tree's group partials
  float* flat = reinterpret_cast<float*>(smem + L.flat);

  const int i = blockIdx.x, bh = blockIdx.y, z = bh / S.groups;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  // Row group w (q rows w + 8 j), half h: kv columns 64 h..64 h + 63 of
  // the tile, and out columns from ocol0 (below).
  const int w = warp & 7, h = warp >> 3, partner = warp ^ 8;
  const int g = lane >> 2, tq = lane & 3;
  const float zp_q = regs[0], alpha_qk = regs[1], scale_p = regs[2];
  const float zp_p = regs[3], alpha_pv = regs[4], p_lo = regs[5];
  const float p_hi = regs[6];
  const int kvlim = min(*kvlen_p, S.skv);
  const int tzq = static_cast<int>(zp_q), tzp = static_cast<int>(zp_p);
  // p_int of a masked probability (p = 0), as the per-element formula.
  const float pi0 = fminf(
      fmaxf(rintf(__fadd_rn(__fdiv_rn(0.f, scale_p), zp_p)), 0.f), 255.f);
  const int q0 = i * S.bq;          // the block's first row here
  const int qp0 = S.q_start + q0;   // and its position
  // Tile u's rows of this lane: 128 u + w + 8 g (+ 64).
  int row[kU][2];
  bool row_ok[kU][2];
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[u][r] = kMax * u + w + 8 * g + 64 * r;
      row_ok[u][r] = row[u][r] < S.bq && q0 + row[u][r] < S.sq &&
                     q0 + row[u][r] >= S.row_lo;
    }
  const bool rows_all =
      S.bq == kU * kMax && q0 + kU * kMax <= S.sq && q0 >= S.row_lo;
  const int snt = kFix ? 8 : max(0, min(8, nnt - 8 * h));   // this half's
  const int ont = kFix ? 8                                    // score and
                  : kWide ? (h == 0 ? osplit : hnt - osplit)  // out n-tiles
                          : max(0, min(8, hnt - 8 * h));
  const int cbase = 64 * h + 2 * tq;     // this lane's first column
  // The wide kernel's half: its first out column, and this lane's.
  const int ocol0 = 8 * osplit * h;
  const int obase = kWide ? ocol0 + 2 * tq : cbase;

  auto stage_kv = [&](int ki, int buf) {
    const int k0 = ki * S.bkv;
    stage_tile<false, kMax, kDh / 16>(
        smem + L.k + buf * L.tile,
        reinterpret_cast<const uint8_t*>(k) +
            (static_cast<long long>(z) * S.skv + k0) * hd,
        hd, 16 * ((nnt + 1) >> 1), min(bkv, S.skv - k0), 2 * nks, hd, vec,
        t, L.ld);
    stage_tile<false, kDh, kMax / 16>(
        smem + L.v + buf * L.vtile,
        reinterpret_cast<const uint8_t*>(vt) +
            static_cast<long long>(z) * hd * S.skvp + k0,
        S.skvp, 16 * ((hnt + 1) >> 1), hd, 2 * pks, min(bkv, S.skvp - k0),
        vec, t, kLd);
  };

  stage_tile<true, kU * kMax, kDh / 16>(
      smem + L.q, q + (static_cast<long long>(bh) * S.sq + q0) * hd, hd,
      kU * kMax, min(S.bq, S.sq - q0), 2 * nks, hd, vec, t, L.ld);
  const int end = kv_block_base(i, S) + S.width;
  int ki = next_visited(i, kv_block_base(i, S) - 1, end, S);
  if (ki >= 0) stage_kv(ki, 0);
  cp_async_commit();

  float o[kU][kOnt][4];
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int nt = 0; nt < kOnt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[u][nt][e] = 0.f;
  float m_run[kU][2], l_run[kU][2];
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_run[u][r] = kNegInf;
      l_run[u][r] = 0.f;
    }
  float pmn = FLT_MAX, pmx = -FLT_MAX;
  int nclip = 0, ncnt = 0;
  float st_err = 0.f, st_sig = 0.f;   // thread 0's are the block's
  // Tile u's q rows and p_int rows of the group.
  uint32_t qa[kU];
  uint8_t* pw[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    qa[u] = smem_addr(smem + L.q) + (kMax * u + w * 16) * L.ld;
    pw[u] = smem + L.p + (u * kGroups + w) * 16 * kLd;
  }

  int n = 0;   // visited tiles so far
  for (; ki >= 0; ++n) {
    const int buf = kTall ? 0 : n & 1;
    cp_async_wait<0>();
    __syncthreads();   // tile n has landed; tile n - 1 is consumed
    const int nk = next_visited(i, ki, end, S);
    if constexpr (!kTall) {
      if (nk >= 0) stage_kv(nk, buf ^ 1);
      cp_async_commit();
    }
    const uint8_t* Kb = smem + L.k + buf * L.tile;
    const uint8_t* Vb = smem + L.v + buf * L.vtile;
    // Row sums of the K and V^T tiles on the tensor cores (an all-ones A
    // operand; warps 0..7 K, 8..15 V^T), and the err/sig tree's last
    // levels of tile n - 1.
    if (h == 0) {
      row_sums<kKs>(smem_addr(Kb), L.ld, nks, nnt, rowsum_k, w, lane);
      if (pow2 && n > 0) tree_cols(tree, part, w, lane);
    } else {   // V^T's rows in blocks of 128
#pragma unroll
      for (int rb = 0; rb < kDh / kMax; ++rb)
        row_sums<4>(smem_addr(Vb) + rb * kMax * kLd, kLd, pks, hnt - 16 * rb,
                    colsum_v + rb * kMax, w, lane);
    }
    __syncthreads();   // the sums and partials are visible; the err/sig
                       // buffer is free
    if (pow2 && n > 0 && t == 0) tree_total(part, st_err, st_sig);

    const int k0 = ki * S.bkv;
    const bool live = !tile_empty(qp0, k0, kvlim, S);   // uniform
    // This lane's columns are cbase + c, c = 8 i + e: the mask keeps
    // clo[u][r] <= c < chi[u][r] (chi also stops at bkv); the statistics
    // see c < cvalid (kp < skv) on rows row_ok; c < creal is in the tile.
    int clo[kU][2], chi[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int lo, hi;
        mask_bounds(qp0 + row[u][r], kvlim, S, lo, hi);
        clo[u][r] = lo - k0 - cbase;
        chi[u][r] = min(hi - k0, bkv) - cbase;
      }
    const int cvalid = min(bkv, S.skv - k0) - cbase;
    const int creal = bkv - cbase;

    // Scores of a live tile: acc = q . k - trunc(zp_q) * rowsum(k), then
    // the row max over both halves.
    float s[kU][8][4];
    float m_new[kU][2], corr[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[u][r] = m_run[u][r];
        corr[u][r] = 1.f;
      }
    if (live) {
      float rmax[kU][2];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        int acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= snt) break;
          const int2 rs =
              *reinterpret_cast<const int2*>(rowsum_k + cbase + 8 * nt);
          acc[nt][0] = acc[nt][2] = -tzq * rs.x;
          acc[nt][1] = acc[nt][3] = -tzq * rs.y;
        }
        if (snt > 0)
          tile_mma<kKs>(acc, qa[u], smem_addr(Kb) + 64 * h * L.ld, L.ld, nks,
                        snt, lane);
        rmax[u][0] = rmax[u][1] = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= snt) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + (e & 1), r = e >> 1;
            const bool kp = c >= clo[u][r] && c < chi[u][r];
            s[u][nt][e] = kp ? __fmul_rn(alpha_qk,
                                         __int2float_rn(acc[nt][e]))
                             : kNegInf;
            rmax[u][r] = fmaxf(rmax[u][r], s[u][nt][e]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rmax[u][r] = fmaxf(rmax[u][r], __shfl_xor_sync(kAll, rmax[u][r], 1));
          rmax[u][r] = fmaxf(rmax[u][r], __shfl_xor_sync(kAll, rmax[u][r], 2));
          if (tq == 0) xmax[(u * kWarps + warp) * 16 + g + 8 * r] = rmax[u][r];
        }
      }
      pair_sync(w);
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rmax[u][r] = fmaxf(rmax[u][r],
                             xmax[(u * kWarps + partner) * 16 + g + 8 * r]);
          m_new[u][r] = fmaxf(m_run[u][r], rmax[u][r]);
          corr[u][r] = expf(__fsub_rn(m_run[u][r], m_new[u][r]));
        }
    }
    // (An empty tile's scores are all masked: m stays, corr = exp(0) = 1.)

    // Probabilities, their 8-bit image (this half of the group's PV A
    // operand), the p_int row sums, the order-free partials and the
    // err/sig values.  kLive = false is the empty tile: p = 0 and p_int
    // = pi0 everywhere, by the same formulas.  kAll: every entry of the
    // tile is in bounds (no row past sq, no column past skv or bkv).
    int psum[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u) psum[u][0] = psum[u][1] = 0;
    float te[16], ts[16];   // pow2: per column, rows j and j + 8 summed
    auto probs = [&](auto live_tag, auto all_tag) {
      constexpr bool kLive = decltype(live_tag)::value;
      constexpr bool kAll = decltype(all_tag)::value;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        te[2 * nt] = te[2 * nt + 1] = ts[2 * nt] = ts[2 * nt + 1] = 0.f;
        if (nt >= snt) continue;
        float ev[kU][4], sg[kU][4];
        const int c0 = cbase + nt * 8;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          int pb[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + (e & 1), r = e >> 1;
            float p = 0.f, pi = pi0;
            if (kLive) {
              const bool kp = c >= clo[u][r] && c < chi[u][r];
              const float ex = expf(__fsub_rn(s[u][nt][e], m_new[u][r]));
              p = kp ? ex : 0.f;
              pi = fminf(fmaxf(rintf(__fadd_rn(__fdiv_rn(p, scale_p), zp_p)),
                               0.f), 255.f);
            }
            pb[e] = static_cast<int>(pi);
            if (kFix || c < creal) psum[u][r] += pb[e];
            const bool sv = kAll || (row_ok[u][r] && c < cvalid);
            pmn = fminf(pmn, sv ? p : FLT_MAX);
            pmx = fmaxf(pmx, sv ? p : -FLT_MAX);
            nclip += (sv && (p < p_lo || p > p_hi)) ? 1 : 0;
            const float d =
                __fsub_rn(p, __fmul_rn(__fsub_rn(pi, zp_p), scale_p));
            ev[u][e] = sv ? __fmul_rn(d, d) : 0.f;
            sg[u][e] = sv ? __fmul_rn(p, p) : 0.f;
          }
          if (kLive) {
            *reinterpret_cast<uint16_t*>(pw[u] + g * kLd + c0) =
                static_cast<uint16_t>((pb[0] & 0xff) | ((pb[1] & 0xff) << 8));
            *reinterpret_cast<uint16_t*>(pw[u] + (g + 8) * kLd + c0) =
                static_cast<uint16_t>((pb[2] & 0xff) | ((pb[3] & 0xff) << 8));
          }
        }
        if (pow2) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float ea = ev[0][e], eb = ev[0][e + 2];
            float sa = sg[0][e], sb = sg[0][e + 2];
            if constexpr (kTall) {   // row bit 7: rows r and r + 128
              ea = __fadd_rn(ea, ev[1][e]);
              eb = __fadd_rn(eb, ev[1][e + 2]);
              sa = __fadd_rn(sa, sg[1][e]);
              sb = __fadd_rn(sb, sg[1][e + 2]);
            }
            te[2 * nt + e] = __fadd_rn(ea, eb);   // row bit 6
            ts[2 * nt + e] = __fadd_rn(sa, sb);
          }
        } else {   // err now, sig after the err tree (kept in s)
#pragma unroll
          for (int u = 0; u < kU; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = c0 + (e & 1), rr = row[u][e >> 1];
              if (rr < S.bq && col < bkv) flat[rr * bkv + col] = ev[u][e];
              s[u][nt][e] = sg[u][e];
            }
        }
      }
    };
    if (!live) {
      probs(std::false_type{}, std::false_type{});
    } else if (rows_all && cvalid == creal && (bkv & 7) == 0) {
      probs(std::true_type{}, std::true_type{});
    } else {
      probs(std::true_type{}, std::false_type{});
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      ncnt += (static_cast<int>(row_ok[u][0]) +
               static_cast<int>(row_ok[u][1])) *
              lane_cols(cvalid, snt);

    if (pow2) {
      tree_rows(te, ts, tree, w, h, lane);
    } else {   // the flat tree over bq * bkv, err then sig
      const float err = flat_tree(flat, S.bq * bkv, t);
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= snt) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = cbase + nt * 8 + (e & 1), rr = row[u][e >> 1];
            if (rr < S.bq && col < bkv) flat[rr * bkv + col] = s[u][nt][e];
          }
        }
      const float sig = flat_tree(flat, S.bq * bkv, t);
      if (t == 0) {
        st_err = __fadd_rn(st_err, err);
        st_sig = __fadd_rn(st_sig, sig);
      }
    }

    // The carries: lsum = sum(p_int - trunc(zp_p)) over the tile's bkv
    // columns (both halves); acc_pv = p_int . v - trunc(zp_p) * colsum(v)
    // on this half's out columns (A = the group's p_int as u8, B = V^T);
    // an empty tile's are bkv (pi0 - trunc(zp_p)) and (pi0 -
    // trunc(zp_p)) * colsum(v) exactly.
    int lsum[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[u][r] += __shfl_xor_sync(kAll, psum[u][r], 1);
        psum[u][r] += __shfl_xor_sync(kAll, psum[u][r], 2);
        lsum[u][r] = bkv * (static_cast<int>(pi0) - tzp);
      }
    if (live) {
      if (tq == 0) {
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          xsum[(u * kWarps + warp) * 16 + g] = psum[u][0];
          xsum[(u * kWarps + warp) * 16 + g + 8] = psum[u][1];
        }
      }
      pair_sync(w);   // both halves' p_int rows and sums are in
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lsum[u][r] = psum[u][r] +
                       xsum[(u * kWarps + partner) * 16 + g + 8 * r] -
                       bkv * tzp;
    }
    const int pshift = live ? -tzp : static_cast<int>(pi0) - tzp;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if constexpr (kWide) {
        // P.V on this half's out n-tiles, 8 at a time.
#pragma unroll
        for (int oc = 0; oc < kOnt / 8; ++oc) {
          const int cnt = min(8, ont - 8 * oc);
          if (cnt <= 0) break;
          int pacc[8][4];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt >= cnt) break;
            const int2 cs = *reinterpret_cast<const int2*>(
                colsum_v + obase + 64 * oc + 8 * nt);
            pacc[nt][0] = pacc[nt][2] = pshift * cs.x;
            pacc[nt][1] = pacc[nt][3] = pshift * cs.y;
          }
          if (live)
            tile_mma<4>(pacc, smem_addr(pw[u]),
                        smem_addr(Vb) + (ocol0 + 64 * oc) * kLd, kLd, pks,
                        cnt, lane);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt >= cnt) break;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[u][8 * oc + nt][e] = __fadd_rn(
                  __fmul_rn(o[u][8 * oc + nt][e], corr[u][e >> 1]),
                  __fmul_rn(alpha_pv, __int2float_rn(pacc[nt][e])));
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_run[u][r] = __fadd_rn(__fmul_rn(l_run[u][r], corr[u][r]),
                                  __fmul_rn(scale_p,
                                            __int2float_rn(lsum[u][r])));
          m_run[u][r] = m_new[u][r];
        }
      } else {
        int pacc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= ont) break;
          const int2 cs =
              *reinterpret_cast<const int2*>(colsum_v + cbase + 8 * nt);
          pacc[nt][0] = pacc[nt][2] = pshift * cs.x;
          pacc[nt][1] = pacc[nt][3] = pshift * cs.y;
        }
        if (live && ont > 0)
          tile_mma<4>(pacc, smem_addr(pw[u]), smem_addr(Vb) + 64 * h * kLd,
                      kLd, pks, ont, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_run[u][r] = __fadd_rn(__fmul_rn(l_run[u][r], corr[u][r]),
                                  __fmul_rn(scale_p,
                                            __int2float_rn(lsum[u][r])));
          m_run[u][r] = m_new[u][r];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= ont) break;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[u][nt][e] = __fadd_rn(__fmul_rn(o[u][nt][e], corr[u][e >> 1]),
                                    __fmul_rn(alpha_pv,
                                              __int2float_rn(pacc[nt][e])));
        }
      }
    }
    if constexpr (kTall) {   // one K/V buffer: the next tile after this one
      __syncthreads();
      if (nk >= 0) stage_kv(nk, 0);
      cp_async_commit();
    }
    ki = nk;
  }

  // The block's partials: min/max/clip/n over its threads (exact in any
  // order), err/sig of the last tile's tree.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pmn = fminf(pmn, __shfl_xor_sync(kAll, pmn, off));
    pmx = fmaxf(pmx, __shfl_xor_sync(kAll, pmx, off));
    nclip += __shfl_xor_sync(kAll, nclip, off);
    ncnt += __shfl_xor_sync(kAll, ncnt, off);
  }
  int* redi = reinterpret_cast<int*>(red);
  if (lane == 0) {
    red[warp] = pmn;
    red[kWarps + warp] = pmx;
    redi[2 * kWarps + warp] = nclip;
    redi[3 * kWarps + warp] = ncnt;
  }
  if (pow2 && n > 0) {   // the last tile's tree
    __syncthreads();
    if (h == 0) tree_cols(tree, part, w, lane);
  }
  __syncthreads();
  if (t == 0) {
    if (pow2 && n > 0) tree_total(part, st_err, st_sig);
    int tcl = 0, tcn = 0;
    for (int v = 0; v < kWarps; ++v) {
      pmn = fminf(pmn, red[v]);
      pmx = fmaxf(pmx, red[kWarps + v]);
      tcl += redi[2 * kWarps + v];
      tcn += redi[3 * kWarps + v];
    }
    float* prow = pstats + (static_cast<long long>(bh) * S.nq + i) * 6;
    prow[0] = pmn;
    prow[1] = pmx;
    prow[2] = __int2float_rn(tcl);
    prow[3] = __int2float_rn(tcn);
    prow[4] = st_err;
    prow[5] = st_sig;
  }

  // out = acc / max(l, 1e-30) on this half's columns; residuals (m, l).
#pragma unroll
  for (int u = 0; u < kU; ++u)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!row_ok[u][r]) continue;
      const long long qrow =
          static_cast<long long>(bh) * S.sq + q0 + row[u][r];
      const float den = fmaxf(l_run[u][r], 1e-30f);
      float* orow = out + qrow * hd;
#pragma unroll
      for (int nt = 0; nt < kOnt; ++nt) {
        if (nt >= ont) break;
        const int col = obase + 8 * nt;
        const float v0 = __fdiv_rn(o[u][nt][2 * r], den);
        const float v1 = __fdiv_rn(o[u][nt][2 * r + 1], den);
        if ((hd & 1) == 0 && col < hd) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          if (col < hd) orow[col] = v0;
          if (col + 1 < hd) orow[col + 1] = v1;
        }
      }
      if (h == 0 && tq == 0) {
        ml[2 * qrow] = m_run[u][r];
        ml[2 * qrow + 1] = l_run[u][r];
      }
    }
}

// Allow an instantiation's dynamic shared memory (above the 48 KB
// default) once; returns the CUDA error code.
template <bool kFix, bool kWide, bool kTall>
int allow_smem() {
  static int status = -1;
  if (status < 0)
    status = static_cast<int>(cudaFuncSetAttribute(
        int8_attention_kernel<kFix, kWide, kTall>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWide || kTall ? kSmemOptin : kSmemMax));
  return status;
}

template <bool kFix, bool kWide, bool kTall>
int start(dim3 grid, int smem, cudaStream_t st, const void* q, const void* k,
          const void* vt, const void* regs, const void* kvlen, void* out,
          void* ml, void* pstats, const Sched& S) {
  if (const int s = allow_smem<kFix, kWide, kTall>()) return s;
  int8_attention_kernel<kFix, kWide, kTall><<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(vt), static_cast<const float*>(regs),
      static_cast<const int*>(kvlen), static_cast<float*>(out),
      static_cast<float*>(ml), static_cast<float*>(pstats), S);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The general instantiation: the tiles the others do not take (bkv in
// (128, 512], bq above 256, hd in (256, 512], or a flat err/sig buffer
// that does not fit beside the wide layout), up to the reference's own
// limits (hd, bkv <= 512: int32 accumulators below 2**24, exact through
// the fp32 cast).  A right kernel first, not a fast one: dp4a on CUDA
// cores, plain loads, no tensor cores.
//
// The p requantization depends on the block: the reference exponentiates
// each kv block against the running row max AFTER that block's bkv
// columns.  So a block's scores are formed whole before any exp: K
// streams through shared memory in sub-tiles of 64 kv rows (at hd 512 a
// 512-row K tile would be 256 KB, above a CTA's 227 KB), each writing its
// scores into a [16, bkv] fp32 buffer; then the row max, then the
// probabilities (their bytes, the row sums of p_int, the order-free
// partials and the err/sig values), then V^T streams in sub-tiles of 64
// kv columns for P.V.  The integer contractions are the reference's:
// acc_qk = q . k - trunc(zp_q) * rowsum(k) and acc_pv = p_int . v -
// trunc(zp_p) * colsum(v) over the block's bkv columns, exact in int32
// whatever the sub-tiling (|acc| < 2**24 for hd, bkv <= 512), and every
// seam rounded as the other instantiations round it.
//
// q rows are independent, so a reference q block of any bq is split over
// CTAs of 16 rows (grid.x = nq * nsub, nsub = ceil(bq / 16)): each walks
// the q block's visited kv blocks with its own (m, l, acc) carries, and
// writes its own (min, max, clip, n, err, sig) partials, [BH, nq, nsub,
// 6], which the wrapper folds over nsub (min, max, clip and n exactly;
// err/sig as a sum of per-CTA halving trees over each CTA's [16, bkv]
// slice of the tile, within 1e-4 of the reference's tree over the whole
// [bq, bkv] tile).
//
// Bound on the H100: the int8 operations on the CUDA cores (dp4a, 4 MACs
// an instruction, far below the tensor cores' int8 rate) and the shared
// memory traffic of their operands; wgmma / mma.sync is later work.
constexpr int kGRows = 16;         // q rows of one CTA
constexpr int kGThreads = 256;
constexpr int kGWarps = kGThreads / 32;
constexpr int kGSub = 64;          // kv rows (K) / columns (V^T) a sub-tile
constexpr int kGMax = 512;         // hd and bkv limit

struct GLayout {
  int ld, vld, pld;                // Q/K row, V^T row, p_int row (bytes)
  int q, kv, s, e, p, row, red, total;
};

__host__ __device__ constexpr GLayout glayout(int hd, int bkv) {
  GLayout L{};
  L.ld = hd + 16;
  L.vld = kGSub + 16;
  L.pld = ((bkv + kGSub - 1) / kGSub) * kGSub + 16;
  L.q = 0;
  L.kv = L.q + kGRows * L.ld;
  const int kb = kGSub * L.ld, vb = hd * L.vld;
  L.s = L.kv + (kb > vb ? kb : vb);
  L.e = L.s + 4 * kGRows * bkv;
  L.p = L.e + 4 * kGRows * bkv;
  L.row = L.p + kGRows * L.pld;           // m_run, l_run, m_new, corr, lsum
  L.red = L.row + 5 * kGRows * 4;
  L.total = L.red + 4 * kGWarps * 4;
  return L;
}

// d = c + sum of the four u8 bytes of a times the four s8 bytes of b.
__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ int dp4a_us4(const uint4& a, const uint4& b,
                                        int c) {
  c = dp4a_us(a.x, b.x, c);
  c = dp4a_us(a.y, b.y, c);
  c = dp4a_us(a.z, b.z, c);
  return dp4a_us(a.w, b.w, c);
}

// The flat halving tree over the n values of buf (zero-padded to a power
// of two), in place, by all kT threads; returns buf[0] to every thread.
template <int kT>
__device__ __forceinline__ float flat_tree_n(float* buf, int n, int t) {
  __syncthreads();
  int h = 1;
  while (h < n) h <<= 1;
  for (h >>= 1; h >= 1; h >>= 1) {
    for (int j = t; j < h; j += kT)
      buf[j] = __fadd_rn(buf[j], j + h < n ? buf[j + h] : 0.f);
    __syncthreads();
  }
  const float v = buf[0];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kGThreads, 1)
int8_attention_general_kernel(const uint8_t* __restrict__ q,
                              const int8_t* __restrict__ k,
                              const int8_t* __restrict__ vt,
                              const float* __restrict__ regs,
                              const int* __restrict__ kvlen_p,
                              float* __restrict__ out, float* __restrict__ ml,
                              float* __restrict__ partials, Sched S) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int hd = S.hd, bkv = S.bkv;
  const GLayout L = glayout(hd, bkv);
  uint8_t* qs = smem + L.q;
  uint8_t* kvs = smem + L.kv;
  float* sbuf = reinterpret_cast<float*>(smem + L.s);
  float* ebuf = reinterpret_cast<float*>(smem + L.e);
  uint8_t* ps = smem + L.p;
  float* m_run = reinterpret_cast<float*>(smem + L.row);
  float* l_run = m_run + kGRows;
  float* m_new = l_run + kGRows;
  float* corr = m_new + kGRows;
  int* lsum = reinterpret_cast<int*>(corr + kGRows);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int nsub = gridDim.x / S.nq;
  const int i = blockIdx.x / nsub, sub = blockIdx.x % nsub;
  const int bh = blockIdx.y, z = bh / S.groups;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const float zp_q = regs[0], alpha_qk = regs[1], scale_p = regs[2];
  const float zp_p = regs[3], alpha_pv = regs[4], p_lo = regs[5];
  const float p_hi = regs[6];
  const int kvlim = min(*kvlen_p, S.skv);
  const int tzq = static_cast<int>(zp_q), tzp = static_cast<int>(zp_p);
  const int lr0 = sub * kGRows;            // first row within the q block
  const int q0 = i * S.bq + lr0;           // its row here
  const int qp0 = S.q_start + q0;          // and its position
  const int nch = hd >> 4;                 // 16-byte chunks of a row
  const uint32_t kOnes = 0x01010101u;

  // The q rows (rows past the q block or sq zero), the carries, and the
  // p_int buffer's columns past bkv (zero: they meet the next block's V).
  for (int e = t; e < kGRows * nch; e += kGThreads) {
    const int r = e / nch, c = e % nch;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (lr0 + r < S.bq && q0 + r < S.sq)
      v = *reinterpret_cast<const uint4*>(
          q + (static_cast<long long>(bh) * S.sq + q0 + r) * hd + 16 * c);
    *reinterpret_cast<uint4*>(qs + r * L.ld + 16 * c) = v;
  }
  for (int e = t; e < kGRows * L.pld; e += kGThreads) ps[e] = 0;
  if (t < kGRows) {
    m_run[t] = kNegInf;
    l_run[t] = 0.f;
  }
  // PV outputs: columns h = t + 256 hh (hh < 2), all 16 rows.
  float o[kGRows][2];
#pragma unroll
  for (int r = 0; r < kGRows; ++r) o[r][0] = o[r][1] = 0.f;
  float pmn = FLT_MAX, pmx = -FLT_MAX;
  int nclip = 0, ncnt = 0;
  float st_err = 0.f, st_sig = 0.f;   // thread 0's are the CTA's
  const int nsb = (bkv + kGSub - 1) / kGSub;   // sub-tiles of a block

  const int end = kv_block_base(i, S) + S.width;
  for (int ki = next_visited(i, kv_block_base(i, S) - 1, end, S); ki >= 0;
       ki = next_visited(i, ki, end, S)) {
    const int k0 = ki * bkv;
    // ---- scores: S[r][c] = alpha_qk * (q . k - trunc(zp_q) rowsum(k)),
    // masked to -1e30; thread t: kv row j = t % 64, rows t / 64 + 4 ii.
    for (int sb = 0; sb < nsb; ++sb) {
      __syncthreads();   // the buffer's last reader is done
      for (int e = t; e < kGSub * nch; e += kGThreads) {
        const int j = e / nch, c = e % nch;
        const int cb = sb * kGSub + j, kp = k0 + cb;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (cb < bkv && kp < S.skv)
          v = *reinterpret_cast<const uint4*>(
              k + (static_cast<long long>(z) * S.skv + kp) * hd + 16 * c);
        *reinterpret_cast<uint4*>(kvs + j * L.ld + 16 * c) = v;
      }
      __syncthreads();
      const int j = t % kGSub, rq = t / kGSub;
      const int cb = sb * kGSub + j, kp = k0 + cb;
      int acc[4] = {0, 0, 0, 0}, rs = 0;
      for (int c = 0; c < nch; ++c) {
        const uint4 kv4 = *reinterpret_cast<const uint4*>(kvs + j * L.ld +
                                                          16 * c);
        rs = dp4a_us4(make_uint4(kOnes, kOnes, kOnes, kOnes), kv4, rs);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const uint4 q4 = *reinterpret_cast<const uint4*>(
              qs + (rq + 4 * ii) * L.ld + 16 * c);
          acc[ii] = dp4a_us4(q4, kv4, acc[ii]);
        }
      }
      if (cb < bkv) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int r = rq + 4 * ii;
          int lo, hi;
          mask_bounds(qp0 + r, kvlim, S, lo, hi);
          sbuf[r * bkv + cb] =
              (kp >= lo && kp < hi)
                  ? __fmul_rn(alpha_qk, __int2float_rn(acc[ii] - tzq * rs))
                  : kNegInf;
        }
      }
    }
    __syncthreads();
    // ---- the row max over the block, then p, its byte, the row sums of
    // p_int, the partials and err (ebuf) / sig (over the scores); warp w
    // takes rows w and w + 8.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp + kGWarps * rr;
      float mx = kNegInf;
      for (int c = lane; c < bkv; c += 32) mx = fmaxf(mx, sbuf[r * bkv + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
      const float mr = m_run[r];
      const float mn = fmaxf(mr, mx);
      int lo, hi;
      mask_bounds(qp0 + r, kvlim, S, lo, hi);
      const bool row_ok =
          lr0 + r < S.bq && q0 + r < S.sq && q0 + r >= S.row_lo;
      int psum = 0;
      for (int c = lane; c < bkv; c += 32) {
        const int kp = k0 + c;
        const float s = sbuf[r * bkv + c];
        const float p =
            (kp >= lo && kp < hi) ? expf(__fsub_rn(s, mn)) : 0.f;
        const float pi = fminf(
            fmaxf(rintf(__fadd_rn(__fdiv_rn(p, scale_p), zp_p)), 0.f), 255.f);
        ps[r * L.pld + c] = static_cast<uint8_t>(static_cast<int>(pi));
        psum += static_cast<int>(pi);
        const bool sv = row_ok && kp < S.skv;
        pmn = fminf(pmn, sv ? p : FLT_MAX);
        pmx = fmaxf(pmx, sv ? p : -FLT_MAX);
        nclip += (sv && (p < p_lo || p > p_hi)) ? 1 : 0;
        ncnt += sv ? 1 : 0;
        const float d = __fsub_rn(p, __fmul_rn(__fsub_rn(pi, zp_p), scale_p));
        ebuf[r * bkv + c] = sv ? __fmul_rn(d, d) : 0.f;
        sbuf[r * bkv + c] = sv ? __fmul_rn(p, p) : 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(kAll, psum, off);
      if (lane == 0) {
        m_new[r] = mn;
        corr[r] = expf(__fsub_rn(mr, mn));
        lsum[r] = psum - bkv * tzp;
      }
    }
    const float err = flat_tree_n<kGThreads>(ebuf, kGRows * bkv, t);
    const float sig = flat_tree_n<kGThreads>(sbuf, kGRows * bkv, t);
    if (t == 0) {
      st_err = __fadd_rn(st_err, err);
      st_sig = __fadd_rn(st_sig, sig);
    }
    // ---- P.V: acc_pv[r][h] = p_int . v - trunc(zp_p) colsum(v), V^T in
    // sub-tiles of 64 kv columns; thread t owns columns t and t + 256.
    int pacc[kGRows][2], csum[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < kGRows; ++r) pacc[r][0] = pacc[r][1] = 0;
    const bool vvec = (bkv & 15) == 0;   // 16-byte aligned V^T chunks
    for (int sb = 0; sb < nsb; ++sb) {
      __syncthreads();   // the buffer's last reader is done
      const int c0 = k0 + sb * kGSub;   // the sub-tile's first kv column
      const int valid = max(0, min(min(kGSub, bkv - sb * kGSub),
                                   S.skvp - c0));
      for (int e = t; e < hd * (kGSub / 16); e += kGThreads) {
        const int h = e / (kGSub / 16), c = e % (kGSub / 16);
        const int8_t* src = vt + (static_cast<long long>(z) * hd + h) *
                                     S.skvp + c0 + 16 * c;
        uint8_t* dst = kvs + h * L.vld + 16 * c;
        if (vvec) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (16 * c < valid) v = *reinterpret_cast<const uint4*>(src);
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          for (int b = 0; b < 16; ++b)
            dst[b] = 16 * c + b < valid
                         ? static_cast<uint8_t>(src[b]) : 0;
        }
      }
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int h = t + kGThreads * hh;
        if (h >= hd) break;
#pragma unroll
        for (int c = 0; c < kGSub / 16; ++c) {
          const uint4 v4 = *reinterpret_cast<const uint4*>(
              kvs + h * L.vld + 16 * c);
          csum[hh] = dp4a_us4(make_uint4(kOnes, kOnes, kOnes, kOnes), v4,
                              csum[hh]);
#pragma unroll
          for (int r = 0; r < kGRows; ++r) {
            const uint4 p4 = *reinterpret_cast<const uint4*>(
                ps + r * L.pld + sb * kGSub + 16 * c);
            pacc[r][hh] = dp4a_us4(p4, v4, pacc[r][hh]);
          }
        }
      }
    }
    // ---- the carries
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (t + kGThreads * hh >= hd) break;
#pragma unroll
      for (int r = 0; r < kGRows; ++r)
        o[r][hh] = __fadd_rn(
            __fmul_rn(o[r][hh], corr[r]),
            __fmul_rn(alpha_pv,
                      __int2float_rn(pacc[r][hh] - tzp * csum[hh])));
    }
    __syncthreads();   // every thread has read corr
    if (t < kGRows) {
      l_run[t] = __fadd_rn(__fmul_rn(l_run[t], corr[t]),
                           __fmul_rn(scale_p, __int2float_rn(lsum[t])));
      m_run[t] = m_new[t];
    }
  }
  __syncthreads();

  // The CTA's partials: min/max/clip/n over its threads, err/sig its own.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pmn = fminf(pmn, __shfl_xor_sync(kAll, pmn, off));
    pmx = fmaxf(pmx, __shfl_xor_sync(kAll, pmx, off));
    nclip += __shfl_xor_sync(kAll, nclip, off);
    ncnt += __shfl_xor_sync(kAll, ncnt, off);
  }
  int* redi = reinterpret_cast<int*>(red);
  if (lane == 0) {
    red[warp] = pmn;
    red[kGWarps + warp] = pmx;
    redi[2 * kGWarps + warp] = nclip;
    redi[3 * kGWarps + warp] = ncnt;
  }
  __syncthreads();
  if (t == 0) {
    int tcl = 0, tcn = 0;
    for (int v = 0; v < kGWarps; ++v) {
      pmn = fminf(pmn, red[v]);
      pmx = fmaxf(pmx, red[kGWarps + v]);
      tcl += redi[2 * kGWarps + v];
      tcn += redi[3 * kGWarps + v];
    }
    float* prow = partials +
                  (static_cast<long long>(bh) * gridDim.x + blockIdx.x) * 6;
    prow[0] = pmn;
    prow[1] = pmx;
    prow[2] = __int2float_rn(tcl);
    prow[3] = __int2float_rn(tcn);
    prow[4] = st_err;
    prow[5] = st_sig;
  }
  // out = acc / max(l, 1e-30); residuals (m, l).
#pragma unroll
  for (int r = 0; r < kGRows; ++r) {
    if (lr0 + r >= S.bq || q0 + r >= S.sq) continue;
    const long long qrow = static_cast<long long>(bh) * S.sq + q0 + r;
    const float den = fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int h = t + kGThreads * hh;
      if (h < hd) out[qrow * hd + h] = __fdiv_rn(o[r][hh], den);
    }
    if (t == 0) {
      ml[2 * qrow] = m_run[r];
      ml[2 * qrow + 1] = l_run[r];
    }
  }
}

int allow_general_smem() {
  static int status = -1;
  if (status < 0)
    status = static_cast<int>(cudaFuncSetAttribute(
        int8_attention_general_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin));
  return status;
}

}  // namespace

// The general instantiation's dynamic shared memory at (hd, bkv), bytes.
extern "C" int repro_int8_attention_general_smem(int hd, int bkv) {
  return glayout(hd, bkv).total;
}

// The general instantiation (see above): operands as repro_int8_attention
// takes them, hd a multiple of 16 and q, k, vt 16-byte aligned; partials
// fp32 [BH, nq, nsub, 6], nsub = ceil(bq / 16), for the wrapper to fold.
extern "C" int repro_int8_attention_general(
    const void* q, const void* k, const void* vt, const void* regs,
    const void* kvlen, void* out, void* ml, void* partials, int bh, int sq,
    int skv, int hd, int bq, int bkv, int groups, int mode, int window,
    int prefix_len, int width, int q_start, int row_lo, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (bq < 1 || bkv < 1 || bkv > kGMax || hd < 16 || hd > kGMax ||
      hd % 16 != 0 || !aligned(q) || !aligned(k) || !aligned(vt) ||
      q_start < 0 || q_start % bq != 0 || row_lo < 0 || row_lo >= bq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = glayout(hd, bkv).total;
  if (smem > kSmemOptin) return static_cast<int>(cudaErrorInvalidValue);
  if (const int s = allow_general_smem()) return s;
  Sched S{};
  S.sq = sq;
  S.skv = skv;
  S.skvp = (skv + 15) & ~15;
  S.hd = hd;
  S.bq = bq;
  S.bkv = bkv;
  S.groups = groups;
  S.mode = mode;
  S.window = window;
  S.prefix_len = prefix_len;
  S.width = width;
  S.q_start = q_start;
  S.row_lo = row_lo;
  S.nq = (sq + bq - 1) / bq;
  S.nkv = (skv + bkv - 1) / bkv;
  const int nsub = (bq + kGRows - 1) / kGRows;
  const dim3 grid(S.nq * nsub, bh);
  int8_attention_general_kernel<<<grid, kGThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(vt), static_cast<const float*>(regs),
      static_cast<const int*>(kvlen), static_cast<float*>(out),
      static_cast<float*>(ml), static_cast<float*>(partials), S);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a launch at (hd, bq, bkv) needs, in bytes.
extern "C" int repro_int8_attention_smem(int hd, int bq, int bkv) {
  const bool pow2 = (bkv & (bkv - 1)) == 0;
  return layout(hd > kMax ? hd : kMax, bq > kMax).flat +
         (pow2 ? 0 : 4 * bq * bkv);
}

// q u8 [BH, sq, hd]; k s8 [ZB, skv, hd]; vt s8 [ZB, hd, skvp], V's K-major
// image (skvp = skv rounded up to 16, zero-padded); regs fp32 [8]; kvlen
// int32 [1].  Out: out fp32 [BH, sq, hd], ml fp32 [BH, sq, 2], pstats
// fp32 [BH, nq, 6].
extern "C" int repro_int8_attention(const void* q, const void* k,
                                    const void* vt, const void* regs,
                                    const void* kvlen, void* out, void* ml,
                                    void* pstats, int bh, int sq, int skv,
                                    int hd, int bq, int bkv, int groups,
                                    int mode, int window, int prefix_len,
                                    int width, int q_start, int row_lo,
                                    void* stream) {
  const bool wide = hd > kMax, tall = bq > kMax;
  if (bq < 1 || bkv < 1 || hd < 1 || bq > kTallMax || bkv > kMax ||
      hd > kWideMax || (wide && hd % 16 != 0) || q_start < 0 ||
      q_start % bq != 0 || row_lo < 0 || row_lo >= bq)
    return static_cast<int>(cudaErrorInvalidValue);
  Sched S;
  S.sq = sq;
  S.skv = skv;
  S.skvp = (skv + 15) & ~15;
  S.hd = hd;
  S.bq = bq;
  S.bkv = bkv;
  S.groups = groups;
  S.mode = mode;
  S.window = window;
  S.prefix_len = prefix_len;
  S.width = width;
  S.q_start = q_start;
  S.row_lo = row_lo;
  S.nq = (sq + bq - 1) / bq;
  S.nkv = (skv + bkv - 1) / bkv;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  S.vec = hd % 16 == 0 && bkv % 16 == 0 && aligned(q) && aligned(k) &&
          aligned(vt);
  S.pow2 = (bkv & (bkv - 1)) == 0;
  const bool fix = S.vec && hd == kMax && bkv == kMax && !tall;
  const int smem = repro_int8_attention_smem(hd, bq, bkv);
  if (smem > kSmemOptin) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(S.nq, bh);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tall)
    return wide ? start<false, true, true>(grid, smem, st, q, k, vt, regs,
                                           kvlen, out, ml, pstats, S)
                : start<false, false, true>(grid, smem, st, q, k, vt, regs,
                                            kvlen, out, ml, pstats, S);
  if (fix)
    return start<true, false, false>(grid, smem, st, q, k, vt, regs, kvlen,
                                     out, ml, pstats, S);
  if (wide)
    return start<false, true, false>(grid, smem, st, q, k, vt, regs, kvlen,
                                     out, ml, pstats, S);
  return start<false, false, false>(grid, smem, st, q, k, vt, regs, kvlen,
                                    out, ml, pstats, S);
}
