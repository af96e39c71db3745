// Per-ray compositing helpers shared by the composite kernels (composite.cu)
// and the coarse field's epilogue (coarse_field.cu): the activations as the
// JAX package computes them, warp scans, and the single-density (vanilla
// NeRF) composite of one ray by one warp.
//
// Replaces, as a device function: texpose_tpu/kernels/
// fused_composite_coarse.py::_forward_core + _fwd_kernel (the composite part
// of kernels/fused_coarse_render.py::_mega_fwd_kernel).  The TPU kernel's
// exclusive cumsum is a triangular matmul; here it is a running sum inside
// the lane plus a warp shuffle scan of the lane totals.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// jax.nn.softplus: max(x,0) + log1p(exp(-|x|)), no linear cut-over
__device__ __forceinline__ float softplusf_(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Exclusive prefix of v over the lanes of a warp.
__device__ __forceinline__ float warp_exclusive_sum(float v, int lane) {
  float x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  const float prev = __shfl_up_sync(kFull, x, 1);
  return lane == 0 ? 0.f : prev;
}

// Σ of v over the lanes above this one.
__device__ __forceinline__ float warp_strict_suffix_sum(float v, int lane) {
  float suf = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(kFull, suf, o);
    if (lane + o < 32) suf += y;
  }
  return suf - v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One ray by one warp, S = ceil(N/32) consecutive samples per lane:
// c = sigmoid(rgb_raw), σδ = softplus(dens_raw)·dist, T = exp(−exclusive
// cumsum σδ), w = T·(1 − e^{−σδ}); lane 0 writes the packed row
//   out[0..2] = Σ w·c | out[3] = Σ w·depth | out[4] = Σ w | out[5..7] = 0.
// rgb_raw [M,3] and dens_raw [M,1] are read with plain loads: the mega
// kernel writes them earlier in the same launch.  All in float32.
template <int S>
__device__ __forceinline__ void composite_coarse_ray(
    const float* rgb_raw, const float* dens_raw, const float* dist,
    const float* depth, int ray, int N, int lane, float* out) {
  float cs[3][S], sd[S], dep[S];
  float tot = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = lane * S + s;
    if (n < N) {
      const size_t row = (size_t)ray * N + n;
#pragma unroll
      for (int c = 0; c < 3; ++c) cs[c][s] = sigmoidf_(rgb_raw[row * 3 + c]);
      sd[s] = softplusf_(dens_raw[row]) * __ldg(dist + row);
      dep[s] = __ldg(depth + row);
    } else {                                  // padding lanes weigh nothing
#pragma unroll
      for (int c = 0; c < 3; ++c) cs[c][s] = 0.f;
      sd[s] = dep[s] = 0.f;
    }
    tot += sd[s];
  }
  float run = warp_exclusive_sum(tot, lane);
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float w = expf(-run) * (1.f - expf(-sd[s]));
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += w * cs[c][s];
    acc[3] += w * dep[s];
    acc[4] += w;
    run += sd[s];
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) acc[j] = warp_sum(acc[j]);
  if (lane == 0) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)ray * 8);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], 0.f, 0.f, 0.f);
  }
}

}  // namespace
