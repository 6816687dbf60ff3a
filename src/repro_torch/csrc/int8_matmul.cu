// The int8 x int8 -> int32 matmuls of the port, with their fused epilogues
// and min/max statistics.  One main loop, two epilogues:
//
//   int8_matmul_fp     replaces repro/kernels/int8_matmul.py:139
//                      (int8_matmul_fp_kernel, body _fp_kernel): batched
//                      [B, M, K] x [B, K, N], fp32 y out.
//   int8_matmul_fused  replaces repro/kernels/int8_matmul.py:196
//                      (int8_matmul_fused_kernel, body _kernel): one 2-D
//                      [M, K] x [K, N] product with the paper's whole layer
//                      epilogue (Fig. 2/3), the int8 image out.
//
// For every batch slice b:
//     acc[m, n]  = sum_k (x[m, k] - 128) * w[k, n]            (exact int32)
//     corr[n]    = round(128 - zp_x) * colsum_w[n]  (+ round(bias[n] / alpha))
//     y[m, n]    = alpha * float(acc + corr)                 (one rounding)
// which is exactly alpha * sum_k (x - zp_x) * w (+ the int32 image of the
// bias), the reference's integer contraction and its single fp32 rounding.
// The fused epilogue then requantizes y statically onto the in-hindsight
// grid of the next site, q = clamp(rint(y / scale + zp), int_min, int_max),
// and writes the byte (uint8 asymmetric / int8 symmetric, no -128 shift).
// Both emit per-block (min, max) partials of y for the wrapper to reduce.
//
// x arrives as uint8 on the asymmetric [0, 255] grid; it is moved onto the
// signed grid while the tile is staged in shared memory (u8 ^ 0x80 ==
// u8 - 128 as s8), so the products run on signed __dp4a.
//
// Bound on the H100: int8 operations at the LM shapes (M = 4096 prefill),
// bytes at decode (M = 4) and at the CNN layers of the paper's Table 5 as
// im2col products (K = 16..2304, N = 64..256).  The fused epilogue writes
// 1 B per output element where the two-pass route (int8_matmul_fp, then
// fused_quantize) writes 4, reads them back and writes 1: at MobileNetV2's
// 1x1 16 -> 96 layer that is ~45 MB against ~353 MB of device traffic.
// This first version is deliberately simple: 128 x 128 output tiles,
// 32-byte K slices staged in padded shared memory (conflict-free row
// strides), the weight slice transposed on the way in so both operands are
// K-contiguous 32-bit words, and each of the 256 threads accumulating an
// 8 x 8 block with __dp4a (4 MACs/instruction).  It reaches a fraction of
// the tensor-core rate; wgmma + TMA come later, in this shared main loop.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kKI = kBK / 4;  // 32-bit words per K slice row
constexpr int kLds = kKI + 1;  // padded row stride in words

// The requant registers of the fused epilogue.
struct Requant {
  const float* bias;     // fp32 [N], or null
  const float* qparams;  // fp32 [2] = (scale, zero point) of the out grid
  int int_min, int_max;
};

// One block's 128 x 128 output tile: the main loop, then the epilogue that
// kRequant selects (fp32 y, or the requantized byte).
template <bool kRequant>
__device__ __forceinline__ void int8_matmul_tile(
    const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
    void* __restrict__ out, float* __restrict__ partials,
    const float* __restrict__ alpha_p, const float* __restrict__ zp_p,
    const Requant& rq, int M, int K, int N, int x_words) {
  __shared__ int xs[kBM * kLds];
  __shared__ int ws[kBN * kLds];
  __shared__ int corr[kBN];
  __shared__ float red[2 * kThreads / 32];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  x += static_cast<long long>(b) * M * K;
  w += static_cast<long long>(b) * K * N;
  const long long out_base = static_cast<long long>(b) * M * N;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;

  // ---- main loop (shared by both epilogues) ----
  int acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0;
  int csum = 0;

  int8_t* wsb = reinterpret_cast<int8_t*>(ws);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x slice [kBM][kBK] -> signed words.  Bytes past K are paired with
    // zero weights, so their value does not matter.
    for (int e = t; e < kBM * kKI; e += kThreads) {
      const int r = e / kKI, c4 = e % kKI;
      const int gr = i0 + r, gk = k0 + 4 * c4;
      uint32_t v = 0;
      if (gr < M) {
        const uint8_t* src = x + static_cast<long long>(gr) * K + gk;
        if (x_words && gk + 3 < K) {
          v = *reinterpret_cast<const uint32_t*>(src);
        } else {
          for (int bb = 0; bb < 4; ++bb)
            if (gk + bb < K) v |= static_cast<uint32_t>(src[bb]) << (8 * bb);
        }
      }
      xs[r * kLds + c4] = static_cast<int>(v ^ 0x80808080u);
    }
    // w slice [kBK][kBN] -> transposed [kBN][kBK] bytes, zero past K / N.
    for (int e = t; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, n = e % kBN;
      const int gk = k0 + kk, gn = j0 + n;
      int8_t v = 0;
      if (gk < K && gn < N) v = w[static_cast<long long>(gk) * N + gn];
      wsb[n * kLds * 4 + kk] = v;
    }
    __syncthreads();

    if (t < kBN) {
#pragma unroll
      for (int kk = 0; kk < kKI; ++kk)
        csum = __dp4a(ws[t * kLds + kk], 0x01010101, csum);
    }
#pragma unroll
    for (int kk = 0; kk < kKI; ++kk) {
      int a[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = xs[(ty + 16 * r) * kLds + kk];
#pragma unroll
      for (int c = 0; c < 8; ++c) bv[c] = ws[(tx + 16 * c) * kLds + kk];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = __dp4a(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

  // ---- epilogue: the integer correction of each column, in int32 ----
  const float alpha = *alpha_p;
  const int shift = static_cast<int>(rintf(__fsub_rn(128.f, *zp_p)));
  if (t < kBN) {
    int bias_i = 0;
    if (kRequant && rq.bias != nullptr && j0 + t < N)
      bias_i = static_cast<int>(rintf(__fdiv_rn(rq.bias[j0 + t], alpha)));
    corr[t] = shift * csum + bias_i;
  }
  __syncthreads();

  float scale = 1.f, zp_out = 0.f;
  if (kRequant) {
    scale = rq.qparams[0];
    zp_out = rq.qparams[1];
  }
  const float qlo = static_cast<float>(rq.int_min);
  const float qhi = static_cast<float>(rq.int_max);
  float mn = FLT_MAX, mx = -FLT_MAX;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = j0 + tx + 16 * c;
      if (row < M && col < N) {
        const int v = acc[r][c] + corr[tx + 16 * c];
        const float f = __fmul_rn(alpha, __int2float_rn(v));
        const long long idx = out_base + static_cast<long long>(row) * N + col;
        if (kRequant) {
          // round half to even (rintf), like torch.round / jnp.round; the
          // low byte of the int is the uint8 or int8 image.
          float q = rintf(__fadd_rn(__fdiv_rn(f, scale), zp_out));
          q = fminf(fmaxf(q, qlo), qhi);
          static_cast<uint8_t*>(out)[idx] =
              static_cast<uint8_t>(static_cast<int>(q));
        } else {
          static_cast<float*>(out)[idx] = f;
        }
        mn = fminf(mn, f);
        mx = fmaxf(mx, f);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  const int warp = t / 32, lane = t % 32;
  if (lane == 0) {
    red[2 * warp] = mn;
    red[2 * warp + 1] = mx;
  }
  __syncthreads();
  if (t == 0) {
    for (int wi = 1; wi < kThreads / 32; ++wi) {
      mn = fminf(mn, red[2 * wi]);
      mx = fmaxf(mx, red[2 * wi + 1]);
    }
    const long long p =
        (static_cast<long long>(b) * gridDim.y + blockIdx.y) * gridDim.x +
        blockIdx.x;
    partials[2 * p] = mn;
    partials[2 * p + 1] = mx;
  }
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_fp_kernel(const uint8_t* __restrict__ x,
                      const int8_t* __restrict__ w, float* __restrict__ y,
                      float* __restrict__ partials,
                      const float* __restrict__ alpha_p,
                      const float* __restrict__ zp_p, int M, int K, int N,
                      int x_words) {
  int8_matmul_tile<false>(x, w, y, partials, alpha_p, zp_p,
                          Requant{nullptr, nullptr, 0, 0}, M, K, N, x_words);
}

__global__ void __launch_bounds__(kThreads)
int8_matmul_fused_kernel(const uint8_t* __restrict__ x,
                         const int8_t* __restrict__ w, uint8_t* __restrict__ q,
                         float* __restrict__ partials,
                         const float* __restrict__ alpha_p,
                         const float* __restrict__ zp_p, Requant rq, int M,
                         int K, int N, int x_words) {
  int8_matmul_tile<true>(x, w, q, partials, alpha_p, zp_p, rq, M, K, N,
                         x_words);
}

int can_load_words(const void* x, int K) {
  return (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
}

}  // namespace

extern "C" int repro_int8_matmul_fp(const void* x, const void* w, void* y,
                                    void* partials, const void* alpha,
                                    const void* zp, int B, int M, int K, int N,
                                    void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, B);
  int8_matmul_fp_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(y), static_cast<float*>(partials),
      static_cast<const float*>(alpha), static_cast<const float*>(zp), M, K, N,
      can_load_words(x, K));
  return static_cast<int>(cudaGetLastError());
}

// q [M, N] (uint8 or int8 by the grid [int_min, int_max]) and partials
// [gm, gn, 2] of y; bias may be null.
extern "C" int repro_int8_matmul_fused(const void* x, const void* w, void* q,
                                       void* partials, const void* alpha,
                                       const void* zp, const void* bias,
                                       const void* qparams, int M, int K,
                                       int N, int int_min, int int_max,
                                       void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, 1);
  const Requant rq{static_cast<const float*>(bias),
                   static_cast<const float*>(qparams), int_min, int_max};
  int8_matmul_fused_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<uint8_t*>(q), static_cast<float*>(partials),
      static_cast<const float*>(alpha), static_cast<const float*>(zp), rq, M,
      K, N, can_load_words(x, K));
  return static_cast<int>(cudaGetLastError());
}
