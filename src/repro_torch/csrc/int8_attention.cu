// Int8 flash-attention forward with in-kernel probability statistics.
//
// Replaces the TPU kernel repro/kernels/int8_attention.py
// (attention_kernel, body _attn_kernel).  One CUDA block owns one
// (head, q block) pair and walks its `width` kv blocks in the reference's
// order (_kv_block_base); that loop takes the place of the TPU's
// sequential grid axis, and the online-softmax carries (m, l, acc) live in
// shared memory and registers across it.  GQA: head bh reads kv head
// bh / groups.  Per visited tile:
//   acc_qk = sum_h (q - zp_q) * k                (exact int32, __dp4a)
//   s      = alpha_qk * float(acc_qk), masked to -1e30
//   m_new  = max(m, rowmax s);  p = exp(s - m_new), masked p = 0 exactly
//   p_int  = clip(rint(p / scale_p + zp_p), 0, 255)
//   acc_pv = sum_kv (p_int - zp_p) * v           (exact int32, __dp4a)
//   acc    = acc * corr + alpha_pv * float(acc_pv);  l likewise
// and the tile is folded into the (min, max, clip, n, err, sig) partials,
// err/sig through the reference's pinned pairwise-halving tree
// (_tree_sum_last2).  Every mul->add seam is rounded separately
// (__fmul_rn / __fadd_rn, and the library is built with -fmad=false),
// division is __fdiv_rn, rounding rintf; exp is the accurate expf.
//
// u8/s8 operands are moved onto the signed grid while staged in shared
// memory (u8 ^ 0x80 == u8 - 128) and the zero points are restored with
// row/column sums: (q - zp_q).k = (q - 128).k + (128 - zp_q) * rowsum(k),
// (p_int - zp_p).v likewise with colsum(v).
//
// Bound on the H100: at the prefill shape (96 heads, S = 1024, hd = 128)
// the int8 operations and the bytes both need well under a millisecond;
// this simple version is bound by its own instruction issue: __dp4a on
// 128 x 128 tiles (256 threads, 8 x 8 outputs each) plus the serial fp32
// softmax and the two 13-level shared-memory tree sums per tile.
// Tensor-core MMA, a warp-specialised pipeline and TMA are later work.
// Tile limits: bq, bkv, hd <= 128 (the slice runs 128, 128, 128).
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMax = 128;            // max bq, bkv, hd
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLdi = kMax / 4 + 1;   // padded row stride, 32-bit words
constexpr float kNegInf = -1e30f;

enum Mode { kCausal = 0, kSliding = 1, kPrefix = 2, kCross = 3, kBidir = 4 };

struct Sched {
  int sq, skv, hd, bq, bkv, groups, mode, window, prefix_len, width, nq, nkv;
};

constexpr size_t kTileBytes = sizeof(int) * kMax * kLdi;
constexpr size_t kSmemBytes = 4 * kTileBytes                 // q, k, v^T, p
                              + sizeof(float) * kMax * kMax  // s / p
                              + sizeof(float) * kMax * kMax / 2  // tree
                              + sizeof(int) * 2 * kMax        // rowsum, colsum
                              + sizeof(float) * 3 * kMax      // m, l, corr
                              + sizeof(float) * 4 * kWarps;   // reductions

__device__ __forceinline__ bool elem_mask(int qp, int kp, int kvlen,
                                          const Sched& S) {
  bool m;
  switch (S.mode) {
    case kCross:
    case kBidir: m = true; break;
    case kPrefix: m = (kp <= qp) || (kp < S.prefix_len); break;
    case kSliding: m = (kp <= qp) && (qp - kp < S.window); break;
    default: m = kp <= qp; break;
  }
  return m && (kp < kvlen) && (kp < S.skv);
}

__device__ __forceinline__ int kv_block_base(int i, const Sched& S) {
  if (S.mode != kSliding || S.width >= S.nkv) return 0;
  const int hi = min((i * S.bq + S.bq - 1) / S.bkv, S.nkv - 1);
  const int top = max(S.nkv - S.width, 0);
  return min(max(hi - (S.width - 1), 0), top);
}

__device__ __forceinline__ bool block_visited(int i, int ki, const Sched& S) {
  if (S.mode == kCross || S.mode == kBidir || S.mode == kSliding) return true;
  const bool causal = ki * S.bkv <= i * S.bq + S.bq - 1;
  if (S.mode == kPrefix) return causal || (ki * S.bkv < S.prefix_len);
  return causal;
}

// rows x cols bytes of `src` (row stride `cols`) -> words of dst (stride
// kLdi), rows >= valid and columns >= cols zero; `flip` = 0x80 moves a
// u8 operand onto the signed grid (applied to real bytes only).
__device__ void stage_rows(int* dst, const uint8_t* src, int rows, int valid,
                           int cols, uint32_t flip, bool words) {
  const int cw = (cols + 3) / 4;
  for (int e = threadIdx.x; e < rows * cw; e += kThreads) {
    const int r = e / cw, c4 = e % cw, c = 4 * c4;
    uint32_t v = 0;
    if (r < valid) {
      const uint8_t* p = src + static_cast<long long>(r) * cols + c;
      if (words && c + 3 < cols) {
        v = *reinterpret_cast<const uint32_t*>(p) ^ (flip * 0x01010101u);
      } else {
        for (int b = 0; b < 4; ++b)
          if (c + b < cols) v |= (static_cast<uint32_t>(p[b]) ^ flip) << (8 * b);
      }
    }
    dst[r * kLdi + c4] = static_cast<int>(v);
  }
}

// 128 x 128 tile of dot products over `kw` words: acc[r][c] = A[row] . B[col]
// with row = ty + 16 r, col = tx + 16 c.
__device__ __forceinline__ void tile_dot(const int* A, const int* B, int kw,
                                         int acc[8][8], int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0;
  for (int kk = 0; kk < kw; ++kk) {
    int a[8], b[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = A[(ty + 16 * r) * kLdi + kk];
#pragma unroll
    for (int c = 0; c < 8; ++c) b[c] = B[(tx + 16 * c) * kLdi + kk];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = __dp4a(a[r], b[c], acc[r][c]);
  }
}

// Pinned pairwise-halving sum of f(idx) for idx < n (zero-padded to the
// next power of two), the association of the reference's _tree_sum_last2.
template <typename F>
__device__ float tree_sum(float* buf, int n, F f) {
  int p = 1;
  while (p < n) p *= 2;
  if (p == 1) {
    __syncthreads();
    const float v = f(0);
    __syncthreads();
    return v;
  }
  int h = p / 2;
  for (int j = threadIdx.x; j < h; j += kThreads) {
    const float a = f(j);
    const float b = (j + h < n) ? f(j + h) : 0.f;
    buf[j] = __fadd_rn(a, b);
  }
  __syncthreads();
  for (h /= 2; h >= 1; h /= 2) {
    for (int j = threadIdx.x; j < h; j += kThreads)
      buf[j] = __fadd_rn(buf[j], buf[j + h]);
    __syncthreads();
  }
  const float v = buf[0];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
int8_attention_kernel(const uint8_t* __restrict__ q,
                      const int8_t* __restrict__ k,
                      const int8_t* __restrict__ v,
                      const float* __restrict__ regs,
                      const int* __restrict__ kvlen_p,
                      float* __restrict__ out, float* __restrict__ ml,
                      float* __restrict__ pstats, Sched S, int words) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* qs = reinterpret_cast<int*>(smem);
  int* ks = qs + kMax * kLdi;
  int* vt = ks + kMax * kLdi;
  int* ps = vt + kMax * kLdi;
  float* sbuf = reinterpret_cast<float*>(ps + kMax * kLdi);
  float* tbuf = sbuf + kMax * kMax;
  int* rowsum_k = reinterpret_cast<int*>(tbuf + kMax * kMax / 2);
  int* colsum_v = rowsum_k + kMax;
  float* m_s = reinterpret_cast<float*>(colsum_v + kMax);
  float* l_s = m_s + kMax;
  float* corr_s = l_s + kMax;
  float* red = corr_s + kMax;
  int8_t* psb = reinterpret_cast<int8_t*>(ps);
  int8_t* vtb = reinterpret_cast<int8_t*>(vt);

  const int i = blockIdx.x, bh = blockIdx.y, z = bh / S.groups;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int warp = t / 32, lane = t % 32;
  const float zp_q = regs[0], alpha_qk = regs[1], scale_p = regs[2];
  const float zp_p = regs[3], alpha_pv = regs[4], p_lo = regs[5];
  const float p_hi = regs[6];
  const int kvlen = *kvlen_p;
  const int shift_q = 128 - static_cast<int>(zp_q);
  const int shift_p = 128 - static_cast<int>(zp_p);
  const int q0 = i * S.bq;
  const int hw = (S.hd + 3) / 4, kw = (S.bkv + 3) / 4;

  stage_rows(qs, q + (static_cast<long long>(bh) * S.sq + q0) * S.hd, S.bq,
             min(S.bq, S.sq - q0), S.hd, 0x80u, words);
  for (int r = t; r < S.bq; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float o[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) o[r][c] = 0.f;
  // (min, max, clip, n, err, sig); only thread 0's copy is kept.
  float st[6] = {FLT_MAX, -FLT_MAX, 0.f, 0.f, 0.f, 0.f};

  const int base = kv_block_base(i, S);
  for (int tt = 0; tt < S.width; ++tt) {
    const int ki = base + tt;
    if (!block_visited(i, ki, S)) continue;
    const int k0 = ki * S.bkv;
    const int kvalid = min(S.bkv, S.skv - k0);
    const long long kv_off = (static_cast<long long>(z) * S.skv + k0) * S.hd;
    __syncthreads();  // previous tile fully consumed
    stage_rows(ks, reinterpret_cast<const uint8_t*>(k + kv_off), S.bkv, kvalid,
               S.hd, 0u, words);
    for (int e = t; e < 4 * kw * S.hd; e += kThreads) {
      const int kv = e / S.hd, h = e % S.hd;
      vtb[h * kLdi * 4 + kv] =
          kv < kvalid ? v[kv_off + static_cast<long long>(kv) * S.hd + h] : 0;
    }
    __syncthreads();
    if (t < S.bkv) {
      int s = 0;
      for (int kk = 0; kk < hw; ++kk) s = __dp4a(ks[t * kLdi + kk], 0x01010101, s);
      rowsum_k[t] = s;
    }
    if (t < S.hd) {
      int s = 0;
      for (int kk = 0; kk < kw; ++kk) s = __dp4a(vt[t * kLdi + kk], 0x01010101, s);
      colsum_v[t] = s;
    }
    __syncthreads();

    // Scores.
    int acc[8][8];
    tile_dot(qs, ks, hw, acc, tx, ty);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 16 * c;
        if (row < S.bq && col < S.bkv) {
          const int a = acc[r][c] + shift_q * rowsum_k[col];
          float s = __fmul_rn(alpha_qk, __int2float_rn(a));
          if (!elem_mask(q0 + row, k0 + col, kvlen, S)) s = kNegInf;
          sbuf[row * S.bkv + col] = s;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per row; p requantized on [p_lo, p_hi].
    float pmn = FLT_MAX, pmx = -FLT_MAX, clip = 0.f, cnt = 0.f;
    for (int row = warp; row < S.bq; row += kWarps) {
      float rmax = kNegInf;
      for (int col = lane; col < S.bkv; col += 32)
        rmax = fmaxf(rmax, sbuf[row * S.bkv + col]);
      for (int off = 16; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, rmax);
      const int qp = q0 + row;
      int lsum = 0;
      for (int col = lane; col < S.bkv; col += 32) {
        const int kp = k0 + col;
        float p = expf(__fsub_rn(sbuf[row * S.bkv + col], m_new));
        if (!elem_mask(qp, kp, kvlen, S)) p = 0.f;
        float pi = rintf(__fadd_rn(__fdiv_rn(p, scale_p), zp_p));
        pi = fminf(fmaxf(pi, 0.f), 255.f);
        lsum += static_cast<int>(pi) - static_cast<int>(zp_p);
        sbuf[row * S.bkv + col] = p;
        psb[row * kLdi * 4 + col] = static_cast<int8_t>(static_cast<int>(pi) - 128);
        if (qp < S.sq && kp < S.skv) {
          pmn = fminf(pmn, p);
          pmx = fmaxf(pmx, p);
          clip += (p < p_lo || p > p_hi) ? 1.f : 0.f;
          cnt += 1.f;
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
      if (lane == 0) {
        const float corr = expf(__fsub_rn(m_prev, m_new));
        corr_s[row] = corr;
        m_s[row] = m_new;
        l_s[row] = __fadd_rn(__fmul_rn(l_s[row], corr),
                             __fmul_rn(scale_p, __int2float_rn(lsum)));
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      pmn = fminf(pmn, __shfl_xor_sync(0xffffffffu, pmn, off));
      pmx = fmaxf(pmx, __shfl_xor_sync(0xffffffffu, pmx, off));
      clip += __shfl_xor_sync(0xffffffffu, clip, off);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    }
    if (lane == 0) {
      red[warp] = pmn;
      red[kWarps + warp] = pmx;
      red[2 * kWarps + warp] = clip;
      red[3 * kWarps + warp] = cnt;
    }
    __syncthreads();

    // P.V and the carry update.
    tile_dot(ps, vt, kw, acc, tx, ty);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = ty + 16 * r;
      if (row >= S.bq) continue;
      const float corr = corr_s[row];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = tx + 16 * c;
        if (col < S.hd) {
          const int a = acc[r][c] + shift_p * colsum_v[col];
          o[r][c] = __fadd_rn(__fmul_rn(o[r][c], corr),
                              __fmul_rn(alpha_pv, __int2float_rn(a)));
        }
      }
    }

    // Statistics of this tile (min/max/counts exact in any order).
    if (t == 0) {
      float tmn = FLT_MAX, tmx = -FLT_MAX, tcl = 0.f, tcn = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        tmn = fminf(tmn, red[w]);
        tmx = fmaxf(tmx, red[kWarps + w]);
        tcl += red[2 * kWarps + w];
        tcn += red[3 * kWarps + w];
      }
      st[0] = fminf(st[0], tmn);
      st[1] = fmaxf(st[1], tmx);
      st[2] = __fadd_rn(st[2], tcl);
      st[3] = __fadd_rn(st[3], tcn);
    }
    const int n = S.bq * S.bkv;
    const int bkv = S.bkv;
    auto in_bounds = [&](int idx) {
      return (q0 + idx / bkv < S.sq) && (k0 + idx % bkv < S.skv);
    };
    const float err = tree_sum(tbuf, n, [&](int idx) {
      if (!in_bounds(idx)) return 0.f;
      const float p = sbuf[idx];
      const float pi = static_cast<float>(psb[(idx / bkv) * kLdi * 4 + idx % bkv] + 128);
      const float p_hat = __fmul_rn(__fsub_rn(pi, zp_p), scale_p);
      const float d = __fsub_rn(p, p_hat);
      return __fmul_rn(d, d);
    });
    const float sig = tree_sum(tbuf, n, [&](int idx) {
      if (!in_bounds(idx)) return 0.f;
      const float p = sbuf[idx];
      return __fmul_rn(p, p);
    });
    if (t == 0) {
      st[4] = __fadd_rn(st[4], err);
      st[5] = __fadd_rn(st[5], sig);
    }
  }
  __syncthreads();

  // out = acc / max(l, 1e-30); residuals (m, l); the statistics partials.
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = ty + 16 * r;
    if (row >= S.bq || q0 + row >= S.sq) continue;
    const float den = fmaxf(l_s[row], 1e-30f);
    float* orow = out + (static_cast<long long>(bh) * S.sq + q0 + row) * S.hd;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < S.hd) orow[col] = __fdiv_rn(o[r][c], den);
    }
  }
  for (int row = t; row < S.bq; row += kThreads) {
    if (q0 + row >= S.sq) continue;
    float* mrow = ml + (static_cast<long long>(bh) * S.sq + q0 + row) * 2;
    mrow[0] = m_s[row];
    mrow[1] = l_s[row];
  }
  if (t == 0) {
    float* prow = pstats + (static_cast<long long>(bh) * S.nq + i) * 6;
    for (int s = 0; s < 6; ++s) prow[s] = st[s];
  }
}

}  // namespace

extern "C" int repro_int8_attention(const void* q, const void* k,
                                    const void* v, const void* regs,
                                    const void* kvlen, void* out, void* ml,
                                    void* pstats, int bh, int sq, int skv,
                                    int hd, int bq, int bkv, int groups,
                                    int mode, int window, int prefix_len,
                                    int width, void* stream) {
  if (bq < 1 || bkv < 1 || hd < 1 || bq > kMax || bkv > kMax || hd > kMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      int8_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  Sched S;
  S.sq = sq;
  S.skv = skv;
  S.hd = hd;
  S.bq = bq;
  S.bkv = bkv;
  S.groups = groups;
  S.mode = mode;
  S.window = window;
  S.prefix_len = prefix_len;
  S.width = width;
  S.nq = (sq + bq - 1) / bq;
  S.nkv = (skv + bkv - 1) / bkv;
  const int words = (hd % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(q) % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(k) % 4 == 0);
  int8_attention_kernel<<<dim3(S.nq, bh), kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(regs),
      static_cast<const int*>(kvlen), static_cast<float*>(out),
      static_cast<float*>(ml), static_cast<float*>(pstats), S, words);
  return static_cast<int>(cudaGetLastError());
}
