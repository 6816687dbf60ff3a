// Single-pass stochastic-rounding quantization + online min/max statistics
// (the gradient quantizer Q_G).
//
// Replaces the TPU kernel repro/kernels/stochastic_quantize.py
// (stochastic_quantize_kernel, bodies _kernel and _kernel_onchip).  Computes
//     q = clip(floor(x / scale + zp + u), int_min, int_max)
// from pre-computed quant registers [scale, zp] (device memory), written in
// the core storage convention (uint8 asymmetric / int8 symmetric, no -128
// shift), plus per-block fp32 (min, max) partials of the unquantized x that
// the wrapper reduces (exact in any order).  Two forms:
//
//   operand  u is an fp32 tensor of x's shape, read from device memory (the
//            bit-reproducible form every backend can replay);
//   on-chip  u is drawn in the kernel from a counter-based Philox4x32-10:
//            key = (seed * 0x9E3779B9, 0) — the reference's Weyl mixing of
//            the site seed — and counter = element index / 4, one 32-bit
//            word per element (lane = element index % 4).  The top 24 bits
//            map exactly to [0, 1).  Every element has its own counter, so
//            no two tiles (or sites with different seeds) share noise; the
//            4 B/element noise read disappears.
//
// Bound on the H100: bytes.  The operand form moves 9 B per element (x 4,
// u 4, q 1), the on-chip form 5 B; both do a few fp32 ops (Philox adds ten
// rounds of two 32-bit multiplies per 4 elements), far below the ridge
// point.  The structure is fused_quantize.cu's: 16-byte vector loads, packed
// 4-byte stores, a bounded grid-stride loop and one block reduction.
//
// Arithmetic is the reference's, op for op: IEEE division (__fdiv_rn), two
// separately rounded adds (no FMA; built with -fmad=false), floorf.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t sq_byte(float x, float u, float scale,
                                            float zp, float lo, float hi) {
  float v = floorf(__fadd_rn(__fadd_rn(__fdiv_rn(x, scale), zp), u));
  v = fminf(fmaxf(v, lo), hi);
  return static_cast<uint32_t>(static_cast<int>(v)) & 0xffu;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kW0;
    k.y += kW1;
  }
  return c;
}

__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return static_cast<float>(b >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ uint4 philox_group(long long group, uint2 key) {
  const unsigned long long g = static_cast<unsigned long long>(group);
  return philox4x32_10(make_uint4(static_cast<uint32_t>(g),
                                  static_cast<uint32_t>(g >> 32), 0u, 0u),
                       key);
}

__device__ __forceinline__ uint32_t pick(uint4 r, int lane) {
  return lane == 0 ? r.x : lane == 1 ? r.y : lane == 2 ? r.z : r.w;
}

__device__ __forceinline__ void block_minmax(float mn, float mx,
                                             float* __restrict__ partials) {
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  __shared__ float smn[kThreads / 32], smx[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    smn[warp] = mn;
    smx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      mn = fminf(mn, smn[w]);
      mx = fmaxf(mx, smx[w]);
    }
    partials[2 * blockIdx.x] = mn;
    partials[2 * blockIdx.x + 1] = mx;
  }
}

// ONCHIP selects the noise source at compile time: the operand tensor
// `noise` (false) or Philox keyed by `key` (true).
template <bool ONCHIP>
__global__ void __launch_bounds__(kThreads)
stochastic_quantize_kernel(const float* __restrict__ x,
                           const float* __restrict__ noise,
                           uint8_t* __restrict__ q,
                           float* __restrict__ partials,
                           const float* __restrict__ qparams, long long n,
                           int symmetric, int vec, uint2 key) {
  const float scale = qparams[0];
  const float zp = qparams[1];
  const float lo = symmetric ? -128.f : 0.f;
  const float hi = symmetric ? 127.f : 255.f;
  float mn = FLT_MAX, mx = -FLT_MAX;

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long nvec = vec ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* u4 = reinterpret_cast<const float4*>(noise);
  uint32_t* q4 = reinterpret_cast<uint32_t*>(q);
  for (long long i = tid; i < nvec; i += stride) {
    const float4 v = x4[i];
    float4 u;
    if (ONCHIP) {
      const uint4 r = philox_group(i, key);
      u = make_float4(bits_to_unit(r.x), bits_to_unit(r.y),
                      bits_to_unit(r.z), bits_to_unit(r.w));
    } else {
      u = u4[i];
    }
    mn = fminf(mn, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
    mx = fmaxf(mx, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    q4[i] = sq_byte(v.x, u.x, scale, zp, lo, hi) |
            (sq_byte(v.y, u.y, scale, zp, lo, hi) << 8) |
            (sq_byte(v.z, u.z, scale, zp, lo, hi) << 16) |
            (sq_byte(v.w, u.w, scale, zp, lo, hi) << 24);
  }
  for (long long i = nvec * 4 + tid; i < n; i += stride) {
    const float v = x[i];
    const float u = ONCHIP ? bits_to_unit(pick(philox_group(i >> 2, key),
                                               static_cast<int>(i & 3)))
                           : noise[i];
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
    q[i] = static_cast<uint8_t>(sq_byte(v, u, scale, zp, lo, hi));
  }
  block_minmax(mn, mx, partials);
}

}  // namespace

extern "C" int repro_stochastic_quantize(const void* x, const void* noise,
                                         void* q, void* partials,
                                         const void* qparams, long long n,
                                         int symmetric, int grid,
                                         void* stream) {
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(noise) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  stochastic_quantize_kernel<false><<<grid, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(noise),
      static_cast<uint8_t*>(q), static_cast<float*>(partials),
      static_cast<const float*>(qparams), n, symmetric, vec, make_uint2(0, 0));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_stochastic_quantize_onchip(const void* x, void* q,
                                                void* partials,
                                                const void* qparams,
                                                long long n, int symmetric,
                                                unsigned int seed, int grid,
                                                void* stream) {
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  const uint2 key = make_uint2(seed * 0x9E3779B9u, 0u);
  stochastic_quantize_kernel<true><<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), nullptr, static_cast<uint8_t*>(q),
      static_cast<float*>(partials), static_cast<const float*>(qparams), n,
      symmetric, vec, key);
  return static_cast<int>(cudaGetLastError());
}
