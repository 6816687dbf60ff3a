// Single-pass static quantization + online min/max statistics.
//
// Replaces the TPU kernel repro/kernels/fused_quantize.py
// (fused_quantize_kernel, body _kernel).  Computes
//     q = clip(rint(x / scale + zp), int_min, int_max)
// from pre-computed quant registers [scale, zp] (device memory, so the
// host never waits), written directly in the core storage convention
// (uint8 for the asymmetric grid, int8 for the symmetric one: no -128
// shift is needed on this card), plus per-block fp32 (min, max) partials
// of the unquantized x that the wrapper reduces (min/max are exact in
// any order).
//
// Bound on the H100: bytes.  Per element it reads 4 B and writes 1 B and
// does a handful of fp32 ops, far below the card's ridge point.  The
// design therefore only cares about streaming: 16-byte vector loads
// (float4), 4-byte packed stores, a grid-stride loop with a bounded grid
// so the partials buffer stays tiny, and one block-level reduction.
//
// Arithmetic is the reference's, op for op: IEEE division (__fdiv_rn),
// a separate rounded add (no FMA), rintf = round half to even.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t quant_byte(float x, float scale, float zp,
                                               float lo, float hi) {
  float v = rintf(__fadd_rn(__fdiv_rn(x, scale), zp));
  v = fminf(fmaxf(v, lo), hi);
  return static_cast<uint32_t>(static_cast<int>(v)) & 0xffu;
}

__global__ void __launch_bounds__(kThreads)
fused_quantize_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                      float* __restrict__ partials,
                      const float* __restrict__ qparams, long long n,
                      int symmetric, int vec) {
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
  uint32_t* q4 = reinterpret_cast<uint32_t*>(q);
  for (long long i = tid; i < nvec; i += stride) {
    const float4 v = x4[i];
    mn = fminf(mn, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
    mx = fmaxf(mx, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    q4[i] = quant_byte(v.x, scale, zp, lo, hi) |
            (quant_byte(v.y, scale, zp, lo, hi) << 8) |
            (quant_byte(v.z, scale, zp, lo, hi) << 16) |
            (quant_byte(v.w, scale, zp, lo, hi) << 24);
  }
  for (long long i = nvec * 4 + tid; i < n; i += stride) {
    const float v = x[i];
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
    q[i] = static_cast<uint8_t>(quant_byte(v, scale, zp, lo, hi));
  }

  // Block reduction of the (min, max) partial.
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

}  // namespace

extern "C" int repro_fused_quantize(const void* x, void* q, void* partials,
                                    const void* qparams, long long n,
                                    int symmetric, int grid, void* stream) {
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  fused_quantize_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(q),
      static_cast<float*>(partials), static_cast<const float*>(qparams), n,
      symmetric, vec);
  return static_cast<int>(cudaGetLastError());
}
