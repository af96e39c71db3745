// The composites, written by hand for Hopper (sm_90a) and bound to PyTorch
// through ctypes (texpose_tpu_torch/kernels/composite.py): the NeRF-W
// dual-density composite of the texture model, forward (row 3) and
// backward (row 4), and the single-density composite of the pretrain,
// forward (row 9a) and backward (row 9b).
//
// Replaces: texpose_tpu/kernels/fused_composite.py::_run_fwd (_forward_core
// + _fwd_cols) and ::_run_bwd (_bwd_cols), with their flat-input variants
// _run_fwd_flat / _run_bwd_flat; texpose_tpu/kernels/
// fused_composite_coarse.py::_run_fwd (_fwd_kernel) and ::_run_bwd
// (_bwd_kernel), with _run_fwd_flat / _run_bwd_flat.  Every kernel here
// reads the field's flat [M,C] outputs (row = ray*N + n) and writes flat
// gradients, so kernels.composite_flat selects the same launches, and the
// TPU kernels' [BR,N] channel planes are never materialized.
//
// All four are segmented (composite_seg.cuh says how and why): a segment
// of L = 32 lanes per ray, S consecutive samples per lane (S = 2 up to 64
// samples a ray, 4 up to 128, 8 up to 256: kernels/composite.py
// segment_plan), 256-thread blocks, vector loads and stores when the
// wrapper finds every base 16-byte aligned and N % S == 0 (VEC), else the
// scalar variant of the same body.  The TPU kernels' triangular-matmul
// cumsums are running sums inside the lane plus segmented shuffle scans of
// the lane totals; transmittances are products inside the lane.  All in
// float32, with the activations of the twins (sigmoid with the IEEE
// division; softplus as jax.nn.softplus: max(x,0) + log1p(exp(-|x|))).
//
//   composite_st_fwd_seg_kernel (row 3): raw rgb [M,3], trans [M,5], static
//     density [M,1], depth, dist → the packed [BR,16] row
//       0-2 rgb | 3-5 rgb_static | 6-8 rgb_transient | 9 depth | 10 opacity
//       11 opacity_static | 12 opacity_transient | 13 uncert
//       14 sum_n softplus(transient density raw) | 15 zero
//     (composite_st_seg; 44 B read a sample, 64 B written a ray).
//   composite_st_bwd_seg_kernel (row 4): the closed-form VJP of _bwd_cols
//     from the packed [BR,16] cotangent → d rgb_raw [M,3], d trans_raw
//     [M,5]; the static density is frozen-trunk output and gets no
//     gradient (composite_st_bwd_seg; 40 B read and 32 B written a sample).
//   composite_coarse_fwd_seg_kernel (row 9a): raw rgb [M,3], density [M,1],
//     dist, depth → packed [BR,8] = rgb | depth | opacity | 0,0,0
//     (composite_coarse_seg; 24 B read a sample, 32 B written a ray).
//   composite_coarse_bwd_seg_kernel (row 9b): its VJP from the packed
//     [BR,8] cotangent → d rgb_raw [M,3], d dens_raw [M,1]
//     (composite_coarse_bwd_seg; 24 B read and 16 B written a sample).
//
// What bounds them: by their bytes, memory (a few µs at 2048 rays × 64
// samples); measured (PERF.md), the issue of their instructions, most of
// them the IEEE expf / division / log1pf sequences of the activations,
// then their loads when the inputs are not in L2.  The first design of
// rows 4, 9a and 9b (one warp per ray, S = ⌈N/32⌉, 4-byte loads, a branch
// per sample, warp scans, five-step butterflies per column and lane 0
// storing the row) stays compiled only under -DCOMPOSITE_WARP_PER_RAY,
// for the in-call A/B (chip_smoke.py, tools/probe_composite.py); row 3's
// went once the segmented form read no slower in turns (PERF.md).  The per-ray bodies
// composite_st_ray_bwd (composite_st.cuh) and composite_coarse_ray
// (composite_coarse.cuh) remain the composite stages of the render
// kernels (st_render.cu) and of the field forward's epilogue
// (field_fwd.cuh).

#include <cuda_runtime.h>

#include "composite_coarse.cuh"
#include "composite_seg.cuh"
#include "composite_st.cuh"

namespace {

constexpr int kSegThreads = 256;   // 256/L rays per block

template <int S, int L, bool VEC>
__global__ void __launch_bounds__(kSegThreads)
    composite_st_fwd_seg_kernel(const float* __restrict__ rgb,
                                const float* __restrict__ tr,
                                const float* __restrict__ dens,
                                const float* __restrict__ depth,
                                const float* __restrict__ dist, int BR,
                                int N, float min_uncert,
                                float* __restrict__ out) {
  const int ray = blockIdx.x * (kSegThreads / L) + threadIdx.x / L;
  composite_st_seg<S, L, VEC>(rgb, tr, dens, depth, dist, ray, BR, N,
                              min_uncert, threadIdx.x & (L - 1), out);
}

template <int S, int L, bool VEC>
__global__ void __launch_bounds__(kSegThreads)
    composite_st_bwd_seg_kernel(const float* __restrict__ rgb,
                                const float* __restrict__ tr,
                                const float* __restrict__ dens,
                                const float* __restrict__ dist,
                                const float* __restrict__ gpk, int BR, int N,
                                float* __restrict__ d_rgb,
                                float* __restrict__ d_tr) {
  const int ray = blockIdx.x * (kSegThreads / L) + threadIdx.x / L;
  composite_st_bwd_seg<S, L, VEC>(rgb, tr, dens, dist, gpk, ray, BR, N,
                                  threadIdx.x & (L - 1), d_rgb, d_tr);
}

template <int S, int L, bool VEC>
__global__ void __launch_bounds__(kSegThreads)
    composite_coarse_fwd_seg_kernel(const float* __restrict__ rgb,
                                    const float* __restrict__ dens,
                                    const float* __restrict__ dist,
                                    const float* __restrict__ depth, int BR,
                                    int N, float* __restrict__ out) {
  const int ray = blockIdx.x * (kSegThreads / L) + threadIdx.x / L;
  composite_coarse_seg<S, L, VEC>(rgb, dens, dist, depth, ray, BR, N,
                                  threadIdx.x & (L - 1), out);
}

template <int S, int L, bool VEC>
__global__ void __launch_bounds__(kSegThreads)
    composite_coarse_bwd_seg_kernel(const float* __restrict__ rgb,
                                    const float* __restrict__ dens,
                                    const float* __restrict__ dist,
                                    const float* __restrict__ depth,
                                    const float* __restrict__ gpk, int BR,
                                    int N, float* __restrict__ d_rgb,
                                    float* __restrict__ d_dens) {
  const int ray = blockIdx.x * (kSegThreads / L) + threadIdx.x / L;
  composite_coarse_bwd_seg<S, L, VEC>(rgb, dens, dist, depth, gpk, ray, BR,
                                      N, threadIdx.x & (L - 1), d_rgb,
                                      d_dens);
}

#ifdef COMPOSITE_WARP_PER_RAY
constexpr int kThreads = 256;      // warp per ray: 8 rays per block

template <int S>
__global__ void __launch_bounds__(kThreads)
    composite_st_bwd_kernel(const float* __restrict__ rgb,
                            const float* __restrict__ tr,
                            const float* __restrict__ dens,
                            const float* __restrict__ dist,
                            const float* __restrict__ gpk, int BR, int N,
                            float* __restrict__ d_rgb,
                            float* __restrict__ d_tr) {
  const int ray = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ray >= BR) return;                      // uniform across the warp
  const size_t row = (size_t)ray * N;
  composite_st_ray_bwd<S>(rgb + row * 3, tr + row * 5, dens + row,
                          dist + row, gpk + (size_t)ray * 16, N, lane,
                          d_rgb + row * 3, d_tr + row * 5);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
    composite_coarse_fwd_kernel(const float* __restrict__ rgb,
                                const float* __restrict__ dens,
                                const float* __restrict__ dist,
                                const float* __restrict__ depth, int BR, int N,
                                float* __restrict__ out) {
  const int ray = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ray >= BR) return;                      // uniform across the warp
  composite_coarse_ray<S>(rgb, dens, dist, depth, ray, N, lane, out);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
    composite_coarse_bwd_kernel(const float* __restrict__ rgb,
                                const float* __restrict__ dens,
                                const float* __restrict__ dist,
                                const float* __restrict__ depth,
                                const float* __restrict__ gpk, int BR, int N,
                                float* __restrict__ d_rgb,
                                float* __restrict__ d_dens) {
  const int ray = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ray >= BR) return;                      // uniform across the warp

  float g[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) g[j] = __ldg(gpk + (size_t)ray * 8 + j);

  float cs[3][S], sd[S], dd[S], dep[S], sg[S];
  float tot = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = lane * S + s;
    if (n < N) {
      const size_t row = (size_t)ray * N + n;
#pragma unroll
      for (int c = 0; c < 3; ++c) cs[c][s] = sigmoidf_(__ldg(rgb + row * 3 + c));
      const float x = __ldg(dens + row);
      sg[s] = sigmoidf_(x);
      dd[s] = __ldg(dist + row);
      sd[s] = softplusf_(x) * dd[s];
      dep[s] = __ldg(depth + row);
    } else {                                  // padding lanes weigh nothing
#pragma unroll
      for (int c = 0; c < 3; ++c) cs[c][s] = 0.f;
      sg[s] = dd[s] = sd[s] = dep[s] = 0.f;
    }
    tot += sd[s];
  }
  float run = warp_exclusive_sum(tot, lane);

  // per sample: w, the local part of dL/ds, and v = G·w, which every
  // earlier sample's s takes with a minus sign (through T)
  float w[S], loc[S], v[S];
  float vtot = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float T = expf(-run), e = expf(-sd[s]);
    w[s] = T * (1.f - e);
    const float G = cs[0][s] * g[0] + cs[1][s] * g[1] + cs[2][s] * g[2] +
                    dep[s] * g[3] + g[4];
    loc[s] = G * T * e;
    v[s] = G * w[s];
    vtot += v[s];
    run += sd[s];
  }
  float suf = warp_strict_suffix_sum(vtot, lane);
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    const float strict = suf;                 // Σ_{n' > n} v_n'
    suf += v[s];
    const int n = lane * S + s;
    if (n >= N) continue;
    const size_t row = (size_t)ray * N + n;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      d_rgb[row * 3 + c] = w[s] * g[c] * cs[c][s] * (1.f - cs[c][s]);
    d_dens[row] = (loc[s] - strict) * dd[s] * sg[s];
  }
}

int warp_blocks(int BR) { return (BR * 32 + kThreads - 1) / kThreads; }
#endif  // COMPOSITE_WARP_PER_RAY

}  // namespace

// The (S, L) pairs the wrapper plans (kernels/composite.py segment_plan):
// L = 32 lanes a ray, S = 2 up to 64 samples, 4 up to 128, 8 up to 256.
// SEG_LAUNCH(launch) runs `launch` with S, L and VEC constexpr as planned
// by the entry's (samples, lanes, vec, blocks); the entry returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan that is not one
// of these or does not cover every sample and every ray (S·L ≥ N,
// blocks·kSegThreads ≥ BR·L lanes).
#define SEG_PLANS(...)          \
  SEG_CASE(2, 32, __VA_ARGS__)  \
  SEG_CASE(4, 32, __VA_ARGS__)  \
  SEG_CASE(8, 32, __VA_ARGS__)
#define SEG_VARIANT(S_, L_, VEC_, ...) \
  {                                    \
    constexpr int S = S_, L = L_;      \
    constexpr bool VEC = VEC_;         \
    __VA_ARGS__;                       \
  }
#define SEG_CASE(S_, L_, ...)                       \
  case S_ * 64 + L_:                                \
    if (vec)                                        \
      SEG_VARIANT(S_, L_, true, __VA_ARGS__)        \
    else                                            \
      SEG_VARIANT(S_, L_, false, __VA_ARGS__)       \
    break;
#define SEG_LAUNCH(...)                                          \
  if (N > samples * lanes ||                                     \
      (long long)blocks * kSegThreads < (long long)BR * lanes)   \
    return (int)cudaErrorInvalidValue;                           \
  switch (samples * 64 + lanes) {                                \
    SEG_PLANS(__VA_ARGS__)                                       \
    default:                                                     \
      return (int)cudaErrorInvalidValue;                         \
  }                                                              \
  return (int)cudaGetLastError();

// The warp-per-ray forms: WARP_LAUNCH(launch) runs `launch` with S =
// ⌈N/32⌉ rounded up to a power of two constexpr (N ≤ 256).
#define WARP_CASE(S_, ...)   \
  {                          \
    constexpr int S = S_;    \
    __VA_ARGS__;             \
  }
#define WARP_LAUNCH(...)                 \
  if (N <= 32)                           \
    WARP_CASE(1, __VA_ARGS__)            \
  else if (N <= 64)                      \
    WARP_CASE(2, __VA_ARGS__)            \
  else if (N <= 128)                     \
    WARP_CASE(4, __VA_ARGS__)            \
  else if (N <= 256)                     \
    WARP_CASE(8, __VA_ARGS__)            \
  else                                   \
    return (int)cudaErrorInvalidValue;   \
  return (int)cudaGetLastError();

// Each entry launches its kernel on `stream` as the wrapper planned it:
// `samples` a lane, `lanes` a ray, vector loads if `vec`, `blocks` blocks
// (the -DCOMPOSITE_WARP_PER_RAY build ignores the plan of rows 4, 9a and
// 9b and launches their warp-per-ray forms); returns cudaGetLastError()
// (0 = launched).

// Row 3: → packed [BR,16].
extern "C" int composite_st_fwd(const void* rgb, const void* tr,
                                const void* dens, const void* depth,
                                const void* dist, int BR, int N,
                                float min_uncert, int samples, int lanes,
                                int vec, int blocks, void* out,
                                void* stream) {
  if (BR <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(rgb);
  const float* b = static_cast<const float*>(tr);
  const float* c = static_cast<const float*>(dens);
  const float* d = static_cast<const float*>(depth);
  const float* e = static_cast<const float*>(dist);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SEG_LAUNCH(
    composite_st_fwd_seg_kernel<S, L, VEC>
        <<<blocks, kSegThreads, 0, st>>>(a, b, c, d, e, BR, N, min_uncert,
                                         o));
}

// Row 4: g [BR,16] → d_rgb [M,3], d_tr [M,5].
extern "C" int composite_st_bwd(const void* rgb, const void* tr,
                                const void* dens, const void* dist,
                                const void* g, int BR, int N, int samples,
                                int lanes, int vec, int blocks, void* d_rgb,
                                void* d_tr, void* stream) {
  if (BR <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(rgb);
  const float* b = static_cast<const float*>(tr);
  const float* c = static_cast<const float*>(dens);
  const float* e = static_cast<const float*>(dist);
  const float* gg = static_cast<const float*>(g);
  float* o1 = static_cast<float*>(d_rgb);
  float* o2 = static_cast<float*>(d_tr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef COMPOSITE_WARP_PER_RAY
  WARP_LAUNCH(
    composite_st_bwd_kernel<S>
        <<<warp_blocks(BR), kThreads, 0, st>>>(a, b, c, e, gg, BR, N, o1,
                                               o2));
#else
  SEG_LAUNCH(
    composite_st_bwd_seg_kernel<S, L, VEC>
        <<<blocks, kSegThreads, 0, st>>>(a, b, c, e, gg, BR, N, o1, o2));
#endif
}

// Row 9a: rgb_raw [M,3], dens_raw [M,1], dist, depth [BR,N] → packed
// [BR,8].
extern "C" int composite_coarse_fwd(const void* rgb, const void* dens,
                                    const void* dist, const void* depth,
                                    int BR, int N, int samples, int lanes,
                                    int vec, int blocks, void* out,
                                    void* stream) {
  if (BR <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(rgb);
  const float* b = static_cast<const float*>(dens);
  const float* c = static_cast<const float*>(dist);
  const float* d = static_cast<const float*>(depth);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef COMPOSITE_WARP_PER_RAY
  WARP_LAUNCH(
    composite_coarse_fwd_kernel<S>
        <<<warp_blocks(BR), kThreads, 0, st>>>(a, b, c, d, BR, N, o));
#else
  SEG_LAUNCH(
    composite_coarse_fwd_seg_kernel<S, L, VEC>
        <<<blocks, kSegThreads, 0, st>>>(a, b, c, d, BR, N, o));
#endif
}

// Row 9b: g [BR,8] → d_rgb [M,3], d_dens [M,1].
extern "C" int composite_coarse_bwd(const void* rgb, const void* dens,
                                    const void* dist, const void* depth,
                                    const void* g, int BR, int N,
                                    int samples, int lanes, int vec,
                                    int blocks, void* d_rgb, void* d_dens,
                                    void* stream) {
  if (BR <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(rgb);
  const float* b = static_cast<const float*>(dens);
  const float* c = static_cast<const float*>(dist);
  const float* d = static_cast<const float*>(depth);
  const float* gg = static_cast<const float*>(g);
  float* o1 = static_cast<float*>(d_rgb);
  float* o2 = static_cast<float*>(d_dens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef COMPOSITE_WARP_PER_RAY
  WARP_LAUNCH(
    composite_coarse_bwd_kernel<S>
        <<<warp_blocks(BR), kThreads, 0, st>>>(a, b, c, d, gg, BR, N, o1,
                                               o2));
#else
  SEG_LAUNCH(
    composite_coarse_bwd_seg_kernel<S, L, VEC>
        <<<blocks, kSegThreads, 0, st>>>(a, b, c, d, gg, BR, N, o1, o2));
#endif
}
