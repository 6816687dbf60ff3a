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
//     acc[m, n]  = sum_k x[m, k] * w[k, n]          (u8 x s8, exact int32)
//     corr[n]    = (round(128 - zp_x) - 128) * colsum_w[n]
//                  (+ round(bias[n] / alpha))
//     y[m, n]    = alpha * float(acc + corr)                 (one rounding)
// acc + corr is the integer (x - 128) . w + round(128 - zp_x) * colsum_w
// (+ the int32 image of the bias) of the reference, rewritten: the same
// int32, so one fp32 rounding gives the reference's y bit for bit.  The
// fused epilogue then requantizes y statically onto the in-hindsight grid
// of the next site, q = clamp(rint(y / scale + zp), int_min, int_max), and
// writes the byte (uint8 asymmetric / int8 symmetric, no -128 shift).
// Both emit per-block (min, max) partials of y for the wrapper to reduce.
//
// Operands, as the wrapper stages them: x u8 [B, M, K], w s8 [B, N, K]
// (K-major: mma's B operand is K-contiguous), K zero-padded to a multiple
// of 16 in both, so every 16-byte chunk of a row is a whole cp.async copy.
// The third kernel here, int8_transpose, writes that weight image from the
// [B, K, N] the weight sites produce (64 x 64 byte tiles through shared
// memory, 16-byte loads and stores; bound by bytes).
//
// Main loop: the tensor cores through warp-level
// mma.sync.m16n8k32.s32.u8.s8 (mma_int8.cuh), u8 activations fed as they
// are.  A block computes a BM x 128 output tile with 8 warps; K advances
// in 128-byte slabs through a 3-stage cp.async ring in dynamic shared
// memory, rows XOR-swizzled in 16-byte chunks so the ldmatrix fragment
// loads and the cp.async stores are free of bank conflicts.  Each thread
// also sums half a weight row of every slab with __dp4a for the column
// sums.  The int32 contraction is exact in any order, so the tile
// schedule cannot change a result.
//
// The row tile BM is a template parameter (the counterpart of the Pallas
// block's bm, which the reference resolves through tuning.matmul_block
// and clamps to the operand, min(bm, M)).  Instantiated:
//   BM = 128  8 warps of 64 x 32, a 96 KB ring (the default tile);
//   BM =  64  8 warps of 32 x 32, a 72 KB ring;
//   BM =  32  8 warps of 16 x 32, a 60 KB ring;
//   BM =  16  8 warps of 16 x 16 laid across N, a 54 KB ring (m16n8k32
//             makes 16 rows the least tile).
// 32 and 16 are the row clamps: a product with fewer rows than its tile
// runs the least tile that covers them, so decode's M = 1..4 computes 16
// rows, not 128.  BN = BK = 128 in every instantiation.
//
// Bound on the H100: int8 operations at the LM shapes (M = 4096 prefill),
// bytes at decode (M = 4) and at the CNN layers of the paper's Table 5 as
// im2col products (K = 16..2304, N = 64..256).  What bounds this kernel is
// the warp-level MMA: mma.sync reaches only part of Hopper's int8
// tensor-core rate, and its register fragments cost shared-memory
// bandwidth (each warp of a 64 x 32 tile reloads the A rows its three
// neighbours load too; by the count of 16-byte wavefronts the loop keeps
// shared memory two thirds to three quarters busy at the LM shapes).  The full rate needs the
// asynchronous warpgroup MMA (wgmma), which reads its operands from shared
// memory in the tensor cores.  mma.sync came first because its fragments
// are register-level and the epilogues carry over unchanged; the next
// step is wgmma + TMA loads + a persistent, warp-specialised schedule in
// this same shared main loop, with weight sites that write the K-major
// image directly in place of the transpose.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "mma_int8.cuh"

namespace {

using namespace mma_int8;

constexpr int kBN = 128, kBK = 128;
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kChunks = kBK / 16;                // 16-byte chunks a slab row
constexpr int kOutLd = kBN + 16;                 // byte-staging row stride

// The geometry of one row tile BM: the 8 warps as kWarpRows x kWarpCols,
// each owning a kTM x kTN block of kMI x kNI mma tiles of 16 x 8.
template <int BM>
struct Tile {
  static constexpr int kWarpRows = BM >= 32 ? 2 : 1;
  static constexpr int kWarpCols = kThreads / 32 / kWarpRows;
  static constexpr int kTM = BM / kWarpRows, kTN = kBN / kWarpCols;
  static constexpr int kMI = kTM / 16, kNI = kTN / 8, kNP = kNI / 2;
  static constexpr int kXBytes = BM * kBK;            // the x slab
  static constexpr int kStageBytes = kXBytes + kBN * kBK;   // x, then w
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static_assert(kTM % 16 == 0 && kTN % 16 == 0, "whole mma tiles a warp");
  static_assert(BM * kOutLd <= kSmemBytes, "byte staging fits the ring");
};

// Byte offset of 16-byte chunk c (0..7) of slab row r: chunks XOR-swizzled
// by r % 8, so 8 consecutive rows at one chunk (an ldmatrix read) and the
// 8 chunks of one row (a cp.async write) fall in 8 distinct 16-byte bank
// groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBK + ((c ^ (r & 7)) << 4);
}

// The requant registers of the fused epilogue.
struct Requant {
  const float* bias;     // fp32 [N], or null
  const float* qparams;  // fp32 [2] = (scale, zero point) of the out grid
  int int_min, int_max;
};

// Start the cp.async copies of K slab kt (x rows i0.., w rows j0..) into
// one stage; rows past M / N and chunks past K are zero-filled.  The w
// slab has kBN * kChunks chunks, the x slab BM * kChunks (half a pass of
// the threads at BM = 16).
template <int BM>
__device__ __forceinline__ void load_slab(uint8_t* stage,
                                          const uint8_t* __restrict__ x,
                                          const int8_t* __restrict__ w, int i0,
                                          int j0, int M, int N, int K, int kt,
                                          int t) {
  constexpr int kX = BM * kChunks;
  const uint32_t xs = smem_addr(stage);
  const uint32_t ws = smem_addr(stage + Tile<BM>::kXBytes);
#pragma unroll
  for (int i = 0; i < kBN * kChunks / kThreads; ++i) {
    const int e = t + i * kThreads, r = e / kChunks, c = e % kChunks;
    const int gk = kt * kBK + 16 * c;
    const bool kin = gk < K;
    if (i < kX / kThreads || e < kX) {   // a whole pass, or part of one
      const bool xin = kin && i0 + r < M;
      cp_async_16(xs + swz(r, c),
                  xin ? x + static_cast<long long>(i0 + r) * K + gk : x,
                  xin ? 16 : 0);
    }
    const bool win = kin && j0 + r < N;
    cp_async_16(ws + swz(r, c),
                win ? w + static_cast<long long>(j0 + r) * K + gk : w,
                win ? 16 : 0);
  }
}

// One block's BM x 128 output tile: the main loop, then the epilogue that
// kRequant selects (fp32 y, or the requantized byte).
template <int BM, bool kRequant>
__device__ __forceinline__ void int8_matmul_tile(
    const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
    void* __restrict__ out, float* __restrict__ partials,
    const float* __restrict__ alpha_p, const float* __restrict__ zp_p,
    const Requant& rq, int M, int K, int N) {
  using T = Tile<BM>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int corr[kBN];
  __shared__ float red[2 * kThreads / 32];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * kBN;
  x += static_cast<long long>(b) * M * K;
  w += static_cast<long long>(b) * N * K;
  const long long out_base = static_cast<long long>(b) * M * N;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  // warp tile rows wm * kTM.., cols wn * kTN..
  const int wm = warp / T::kWarpCols, wn = warp % T::kWarpCols;
  const int g = lane >> 2, tq = lane & 3;

  // ---- main loop (shared by both epilogues) ----
  int acc[T::kMI][T::kNI][4];
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
  int csum = 0;   // column t / 2 of the tile, over K-half t % 2 of each slab

  const int KT = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT)
      load_slab<BM>(smem + s * T::kStageBytes, x, w, i0, j0, M, N, K, s, t);
    cp_async_commit();
  }
  // Per-lane ldmatrix rows and chunk offsets (see mma_int8.cuh).
  const int a_row = wm * T::kTM + (lane & 15), a_chunk = lane >> 4;
  const int b_row = wn * T::kTN + (lane & 7) + 8 * (lane >> 4);
  const int b_chunk = (lane >> 3) & 1;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nt = kt + kStages - 1;
    if (nt < KT)
      load_slab<BM>(smem + (nt % kStages) * T::kStageBytes, x, w, i0, j0, M,
                    N, K, nt, t);
    cp_async_commit();

    const uint8_t* xs = smem + (kt % kStages) * T::kStageBytes;
    const uint8_t* ws = xs + T::kXBytes;
#pragma unroll
    for (int h = 0; h < kBK / 32; ++h) {
      const int c = (t & 1) * (kBK / 32) + h;
      const uint4 v = *reinterpret_cast<const uint4*>(ws + swz(t >> 1, c));
      csum = __dp4a(static_cast<int>(v.x), 0x01010101, csum);
      csum = __dp4a(static_cast<int>(v.y), 0x01010101, csum);
      csum = __dp4a(static_cast<int>(v.z), 0x01010101, csum);
      csum = __dp4a(static_cast<int>(v.w), 0x01010101, csum);
    }
    const uint32_t xs_a = smem_addr(xs), ws_a = smem_addr(ws);
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[T::kMI][4], bf[T::kNP][4];
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
        ldmatrix_x4(af[mi], xs_a + swz(a_row + 16 * mi, 2 * ks + a_chunk));
#pragma unroll
      for (int np = 0; np < T::kNP; ++np)
        ldmatrix_x4(bf[np], ws_a + swz(b_row + 16 * np, 2 * ks + b_chunk));
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::kNI; ++ni)
          mma_u8s8(acc[mi][ni], af[mi], bf[ni >> 1][2 * (ni & 1)],
                   bf[ni >> 1][2 * (ni & 1) + 1]);
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: the integer correction of each column, in int32 ----
  csum += __shfl_xor_sync(0xffffffffu, csum, 1);
  const float alpha = *alpha_p;
  const int shift = static_cast<int>(rintf(__fsub_rn(128.f, *zp_p)));
  if ((t & 1) == 0) {
    const int col = t >> 1;
    int bias_i = 0;
    if (kRequant && rq.bias != nullptr && j0 + col < N)
      bias_i = static_cast<int>(rintf(__fdiv_rn(rq.bias[j0 + col], alpha)));
    corr[col] = (shift - 128) * csum + bias_i;
  }
  __syncthreads();   // corr is set, and the ring is free for byte staging

  float scale = 1.f, zp_out = 0.f;
  if (kRequant) {
    scale = rq.qparams[0];
    zp_out = rq.qparams[1];
  }
  const float qlo = static_cast<float>(rq.int_min);
  const float qhi = static_cast<float>(rq.int_max);
  const bool pairs = (N % 2) == 0;   // float2 stores stay 8-byte aligned
  float mn = FLT_MAX, mx = -FLT_MAX;
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row_l = wm * T::kTM + 16 * mi + g + 8 * h;
      const int row = i0 + row_l;
#pragma unroll
      for (int ni = 0; ni < T::kNI; ++ni) {
        const int col_l = wn * T::kTN + 8 * ni + 2 * tq;
        const int col = j0 + col_l;
        const float f0 = __fmul_rn(
            alpha, __int2float_rn(acc[mi][ni][2 * h] + corr[col_l]));
        const float f1 = __fmul_rn(
            alpha, __int2float_rn(acc[mi][ni][2 * h + 1] + corr[col_l + 1]));
        const bool in0 = row < M && col < N, in1 = row < M && col + 1 < N;
        if (kRequant) {
          // round half to even (rintf), like torch.round / jnp.round; the
          // low byte of the int is the uint8 or int8 image.  Outside the
          // matrix nothing is stored, so nothing is divided.
          int q0 = 0, q1 = 0;
          if (in0)
            q0 = static_cast<int>(fminf(fmaxf(rintf(__fadd_rn(
                __fdiv_rn(f0, scale), zp_out)), qlo), qhi));
          if (in1)
            q1 = static_cast<int>(fminf(fmaxf(rintf(__fadd_rn(
                __fdiv_rn(f1, scale), zp_out)), qlo), qhi));
          *reinterpret_cast<uint16_t*>(smem + row_l * kOutLd + col_l) =
              static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
        } else if (row < M) {
          float* y = static_cast<float*>(out) + out_base +
                     static_cast<long long>(row) * N + col;
          if (pairs && in1) {
            *reinterpret_cast<float2*>(y) = make_float2(f0, f1);
          } else {
            if (in0) y[0] = f0;
            if (in1) y[1] = f1;
          }
        }
        if (in0) {
          mn = fminf(mn, f0);
          mx = fmaxf(mx, f0);
        }
        if (in1) {
          mn = fminf(mn, f1);
          mx = fmaxf(mx, f1);
        }
      }
    }
  }
  if (kRequant) {
    // The staged byte tile out in 16-byte row segments (BM * 8 of them:
    // half a pass of the threads at BM = 16).
    __syncthreads();
    uint8_t* q = static_cast<uint8_t*>(out) + out_base;
    const bool vec = (N % 16) == 0;
    constexpr int kSegs = BM * (kBN / 16);
#pragma unroll
    for (int i = 0; i < (kSegs + kThreads - 1) / kThreads; ++i) {
      const int e = t + i * kThreads, row_l = e >> 3, c = e & 7;
      const int row = i0 + row_l, col = j0 + 16 * c;
      if (e >= kSegs || row >= M || col >= N) continue;
      const uint8_t* src = smem + row_l * kOutLd + 16 * c;
      uint8_t* dst = q + static_cast<long long>(row) * N + col;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < 16 && col + j < N; ++j) dst[j] = src[j];
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
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

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_fp_kernel(const uint8_t* __restrict__ x,
                      const int8_t* __restrict__ w, float* __restrict__ y,
                      float* __restrict__ partials,
                      const float* __restrict__ alpha_p,
                      const float* __restrict__ zp_p, int M, int K, int N) {
  int8_matmul_tile<BM, false>(x, w, y, partials, alpha_p, zp_p,
                              Requant{nullptr, nullptr, 0, 0}, M, K, N);
}

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_fused_kernel(const uint8_t* __restrict__ x,
                         const int8_t* __restrict__ w, uint8_t* __restrict__ q,
                         float* __restrict__ partials,
                         const float* __restrict__ alpha_p,
                         const float* __restrict__ zp_p, Requant rq, int M,
                         int K, int N) {
  int8_matmul_tile<BM, true>(x, w, q, partials, alpha_p, zp_p, rq, M, K, N);
}

// The weight's K-major image for mma's B operand: w [B, K, N] -> wt
// [B, N, kx], kx = K rounded up to 16, zeros from K on.  A block moves one
// 64 x 64 byte tile through shared memory: 16-byte loads along N, 16-byte
// stores along K.
constexpr int kTT = 64, kTLd = kTT + 4;
__global__ void __launch_bounds__(kThreads)
int8_transpose_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt,
                      int K, int N, int kx) {
  __shared__ uint32_t tile[kTT * kTLd / 4];
  const int k0 = blockIdx.y * kTT, n0 = blockIdx.x * kTT;
  w += static_cast<long long>(blockIdx.z) * K * N;
  wt += static_cast<long long>(blockIdx.z) * N * kx;
  const int t = threadIdx.x;
  {
    const int r = t >> 2, c = t & 3, k = k0 + r, n = n0 + 16 * c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k < K) {
      const int8_t* src = w + static_cast<long long>(k) * N + n;
      if (N % 16 == 0 && n < N) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n + j < N)
            words[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[j]))
                            << (8 * (j % 4));
        v = make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
    uint32_t* row = tile + (r * kTLd + 16 * c) / 4;
    row[0] = v.x;
    row[1] = v.y;
    row[2] = v.z;
    row[3] = v.w;
  }
  __syncthreads();
  const int n = t >> 2, kc = t & 3;
  if (n0 + n >= N || k0 + 16 * kc >= kx) return;
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(tile);
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      word |= static_cast<uint32_t>(bytes[(16 * kc + 4 * j + i) * kTLd + n])
              << (8 * i);
    out[j] = word;
  }
  *reinterpret_cast<uint4*>(wt + static_cast<long long>(n0 + n) * kx + k0 +
                            16 * kc) = make_uint4(out[0], out[1], out[2],
                                                  out[3]);
}

// Allow the ring's dynamic shared memory (above the 48 KB default) once
// per kernel instantiation; returns the CUDA error code.
template <int BM, bool kRequant, typename Kernel>
int allow_smem(Kernel kernel) {
  static int status = -1;
  if (status < 0)
    status = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<BM>::kSmemBytes));
  return status;
}

template <int BM>
int launch_fp(const void* x, const void* w, void* y, void* partials,
              const void* alpha, const void* zp, int B, int M, int K, int N,
              cudaStream_t stream) {
  if (const int s = allow_smem<BM, false>(int8_matmul_fp_kernel<BM>)) return s;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, B);
  int8_matmul_fp_kernel<BM><<<grid, kThreads, Tile<BM>::kSmemBytes, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<float*>(y), static_cast<float*>(partials),
      static_cast<const float*>(alpha), static_cast<const float*>(zp), M, K,
      N);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_fused(const void* x, const void* w, void* q, void* partials,
                 const void* alpha, const void* zp, const Requant& rq, int M,
                 int K, int N, cudaStream_t stream) {
  if (const int s = allow_smem<BM, true>(int8_matmul_fused_kernel<BM>))
    return s;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, 1);
  int8_matmul_fused_kernel<BM>
      <<<grid, kThreads, Tile<BM>::kSmemBytes, stream>>>(
          static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<uint8_t*>(q), static_cast<float*>(partials),
          static_cast<const float*>(alpha), static_cast<const float*>(zp), rq,
          M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w s8 [B, K, N] -> its K-major image wt [B, N, kx] (kx = K rounded up to
// 16, zero-padded), the layout the two matmuls below read.
extern "C" int repro_int8_transpose(const void* w, void* wt, int B, int K,
                                    int N, void* stream) {
  const int kx = (K + 15) & ~15;
  const dim3 grid((N + kTT - 1) / kTT, (kx + kTT - 1) / kTT, B);
  int8_transpose_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), K, N, kx);
  return static_cast<int>(cudaGetLastError());
}

// x u8 [B, M, K], w s8 [B, N, K] (K-major), K a multiple of 16; y fp32
// [B, M, N] and partials [B, gm, gn, 2] on the row tile bm (128, 64, 32
// or 16; any other is refused), gm = ceil(M / bm).
extern "C" int repro_int8_matmul_fp(const void* x, const void* w, void* y,
                                    void* partials, const void* alpha,
                                    const void* zp, int B, int M, int K, int N,
                                    int bm, void* stream) {
  if (K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 128: return launch_fp<128>(x, w, y, partials, alpha, zp, B, M, K, N, st);
    case 64: return launch_fp<64>(x, w, y, partials, alpha, zp, B, M, K, N, st);
    case 32: return launch_fp<32>(x, w, y, partials, alpha, zp, B, M, K, N, st);
    case 16: return launch_fp<16>(x, w, y, partials, alpha, zp, B, M, K, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x u8 [M, K], w s8 [N, K] (K-major), K a multiple of 16; q [M, N] (uint8
// or int8 by the grid [int_min, int_max]) and partials [gm, gn, 2] of y on
// the row tile bm (as above); bias may be null.
extern "C" int repro_int8_matmul_fused(const void* x, const void* w, void* q,
                                       void* partials, const void* alpha,
                                       const void* zp, const void* bias,
                                       const void* qparams, int M, int K,
                                       int N, int int_min, int int_max, int bm,
                                       void* stream) {
  if (K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Requant rq{static_cast<const float*>(bias),
                   static_cast<const float*>(qparams), int_min, int_max};
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 128: return launch_fused<128>(x, w, q, partials, alpha, zp, rq, M, K, N, st);
    case 64: return launch_fused<64>(x, w, q, partials, alpha, zp, rq, M, K, N, st);
    case 32: return launch_fused<32>(x, w, q, partials, alpha, zp, rq, M, K, N, st);
    case 16: return launch_fused<16>(x, w, q, partials, alpha, zp, rq, M, K, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
