// Forward of the NeRF-W dual-density composite, written by hand for Hopper
// (sm_90a) and bound to PyTorch through ctypes
// (texpose_tpu_torch/kernels/composite.py).
//
// Replaces: texpose_tpu/kernels/fused_composite.py::_run_fwd (the forward
// pallas_call; _forward_core + _fwd_cols).
//
// One warp per ray, S = ceil(N/32) consecutive samples per lane (N = 64: two).
// Each lane reads its samples' raw field outputs straight from the
// interleaved [M,3] / [M,5] / [M,1] buffers (row = ray*N + n), so the
// TPU kernel's [BR,N] channel planes are never materialized.  Activations:
// sigmoid for colors, softplus (as jax.nn.softplus: max(x,0) +
// log1p(exp(-|x|))) for both densities and the uncertainty.  The three
// exclusive prefix sums of σδ (joint, static, transient) that give the
// transmittances are a running sum inside the lane plus a warp shuffle scan
// of the lane totals — the TPU's triangular-matmul cumsum has no reason to
// exist here.  All in float32.  The 15 per-ray sums are butterfly-reduced
// across the warp and lane 0 writes the packed [BR,16] row:
//   0-2 rgb | 3-5 rgb_static | 6-8 rgb_transient | 9 depth | 10 opacity
//   11 opacity_static | 12 opacity_transient | 13 uncert
//   14 sum_n softplus(transient density raw) | 15 zero
//
// What bounds it: memory — 44 B read per sample (11 f32) and 64 B written
// per ray, about 40 flops and 7 transcendentals per sample.  Design: each
// warp's loads cover contiguous rows, nothing is staged in shared memory,
// and no intermediate leaves registers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 rays per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int S>
__global__ void __launch_bounds__(kThreads)
    composite_st_fwd_kernel(const float* __restrict__ rgb,
                            const float* __restrict__ tr,
                            const float* __restrict__ dens,
                            const float* __restrict__ depth,
                            const float* __restrict__ dist, int BR, int N,
                            float min_uncert, float* __restrict__ out) {
  const int ray = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ray >= BR) return;                      // uniform across the warp

  float cs[3][S], ct[3][S], dt[S], u[S], sds[S], sdt[S], dep[S];
  float tot = 0.f, tot_s = 0.f, tot_t = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = lane * S + s;
    if (n < N) {
      const size_t row = (size_t)ray * N + n;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cs[c][s] = sigmoidf_(__ldg(rgb + row * 3 + c));
        ct[c][s] = sigmoidf_(__ldg(tr + row * 5 + c));
      }
      dt[s] = softplusf_(__ldg(tr + row * 5 + 3));
      u[s] = softplusf_(__ldg(tr + row * 5 + 4));
      const float d = __ldg(dist + row);
      sds[s] = softplusf_(__ldg(dens + row)) * d;
      sdt[s] = dt[s] * d;
      dep[s] = __ldg(depth + row);
    } else {                                  // padding lanes weigh nothing
#pragma unroll
      for (int c = 0; c < 3; ++c) cs[c][s] = ct[c][s] = 0.f;
      dt[s] = u[s] = sds[s] = sdt[s] = dep[s] = 0.f;
    }
    tot += sds[s] + sdt[s];
    tot_s += sds[s];
    tot_t += sdt[s];
  }
  float run = warp_exclusive_sum(tot, lane);
  float run_s = warp_exclusive_sum(tot_s, lane);
  float run_t = warp_exclusive_sum(tot_t, lane);

  float acc[15];
#pragma unroll
  for (int j = 0; j < 15; ++j) acc[j] = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float T = expf(-run), Ts = expf(-run_s), Tt = expf(-run_t);
    const float sd = sds[s] + sdt[s];
    const float a_s = 1.f - expf(-sds[s]);
    const float a_t = 1.f - expf(-sdt[s]);
    const float a = 1.f - expf(-sd);
    const float ps = T * a_s, pt = T * a_t, pj = T * a;
    const float ws = Ts * a_s, wt = Tt * a_t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[c] += ps * cs[c][s] + pt * ct[c][s];
      acc[3 + c] += ws * cs[c][s];
      acc[6 + c] += wt * ct[c][s];
    }
    acc[9] += ws * dep[s];
    acc[10] += pj;
    acc[11] += ws;
    acc[12] += wt;
    acc[13] += u[s] * pt;
    acc[14] += dt[s];
    run += sd;
    run_s += sds[s];
    run_t += sdt[s];
  }
#pragma unroll
  for (int j = 0; j < 15; ++j) acc[j] = warp_sum(acc[j]);
  if (lane == 0) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)ray * 16);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    o[2] = make_float4(acc[8], acc[9], acc[10], acc[11]);
    o[3] = make_float4(acc[12], acc[13] + min_uncert, acc[14], 0.f);
  }
}

template <int S>
void launch(const float* rgb, const float* tr, const float* dens,
            const float* depth, const float* dist, int BR, int N,
            float min_uncert, float* out, cudaStream_t stream) {
  const int blocks = (BR * 32 + kThreads - 1) / kThreads;
  composite_st_fwd_kernel<S><<<blocks, kThreads, 0, stream>>>(
      rgb, tr, dens, depth, dist, BR, N, min_uncert, out);
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int composite_st_fwd(const void* rgb, const void* tr,
                                const void* dens, const void* depth,
                                const void* dist, int BR, int N,
                                float min_uncert, void* out, void* stream) {
  if (BR <= 0) return 0;
  const float* a = static_cast<const float*>(rgb);
  const float* b = static_cast<const float*>(tr);
  const float* c = static_cast<const float*>(dens);
  const float* d = static_cast<const float*>(depth);
  const float* e = static_cast<const float*>(dist);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaErrorInvalidValue;
  if (N <= 32)
    launch<1>(a, b, c, d, e, BR, N, min_uncert, o, st);
  else if (N <= 64)
    launch<2>(a, b, c, d, e, BR, N, min_uncert, o, st);
  else if (N <= 128)
    launch<4>(a, b, c, d, e, BR, N, min_uncert, o, st);
  else if (N <= 256)
    launch<8>(a, b, c, d, e, BR, N, min_uncert, o, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
