// Batched int8 x int8 -> int32 matmul with an fp32 epilogue and fused
// min/max statistics.
//
// Replaces the TPU kernel repro/kernels/int8_matmul.py
// (int8_matmul_fp_kernel, body _fp_kernel).  For every batch slice b:
//     acc[m, n] = sum_k (x[m, k] - 128) * w[k, n]            (exact int32)
//     y[m, n]   = alpha * float(acc + round(128 - zp_x) * colsum_w[n])
// which is exactly alpha * sum_k (x - zp_x) * w, the reference's integer
// contraction and its single fp32 rounding.  x arrives as uint8 on the
// asymmetric [0, 255] grid; it is moved onto the signed grid while the
// tile is staged in shared memory (u8 ^ 0x80 == u8 - 128 as s8), so the
// products run on signed __dp4a.  Per-block (min, max) partials of y are
// emitted for the wrapper to reduce.
//
// Bound on the H100: int8 operations for the prefill shapes (M = 4096),
// bytes for decode (M = 4).  This first version is deliberately simple:
// 128 x 128 output tiles, 32-byte K slices staged in padded shared memory
// (conflict-free row strides), the weight slice transposed on the way in
// so both operands are K-contiguous 32-bit words, and each of the 256
// threads accumulating an 8 x 8 block with __dp4a (4 MACs/instruction).
// It reaches a fraction of the tensor-core rate; wgmma + TMA come later.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kKI = kBK / 4;  // 32-bit words per K slice row
constexpr int kLds = kKI + 1;  // padded row stride in words

__global__ void __launch_bounds__(kThreads)
int8_matmul_fp_kernel(const uint8_t* __restrict__ x,
                      const int8_t* __restrict__ w, float* __restrict__ y,
                      float* __restrict__ partials,
                      const float* __restrict__ alpha_p,
                      const float* __restrict__ zp_p, int M, int K, int N,
                      int x_words) {
  __shared__ int xs[kBM * kLds];
  __shared__ int ws[kBN * kLds];
  __shared__ int colsum[kBN];
  __shared__ float red[2 * kThreads / 32];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  x += static_cast<long long>(b) * M * K;
  w += static_cast<long long>(b) * K * N;
  y += static_cast<long long>(b) * M * N;
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;

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
  if (t < kBN) colsum[t] = csum;
  __syncthreads();

  const float alpha = *alpha_p;
  const int shift = static_cast<int>(rintf(__fsub_rn(128.f, *zp_p)));
  float mn = FLT_MAX, mx = -FLT_MAX;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = j0 + tx + 16 * c;
      if (row < M && col < N) {
        const int v = acc[r][c] + shift * colsum[tx + 16 * c];
        const float f = __fmul_rn(alpha, __int2float_rn(v));
        y[static_cast<long long>(row) * N + col] = f;
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

}  // namespace

extern "C" int repro_int8_matmul_fp(const void* x, const void* w, void* y,
                                    void* partials, const void* alpha,
                                    const void* zp, int B, int M, int K, int N,
                                    void* stream) {
  const int x_words = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, B);
  int8_matmul_fp_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(y), static_cast<float*>(partials),
      static_cast<const float*>(alpha), static_cast<const float*>(zp), M, K, N,
      x_words);
  return static_cast<int>(cudaGetLastError());
}
