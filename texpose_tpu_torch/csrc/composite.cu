// Forward and backward of the NeRF-W dual-density composite, written by hand
// for Hopper (sm_90a) and bound to PyTorch through ctypes
// (texpose_tpu_torch/kernels/composite.py).
//
// Replaces: texpose_tpu/kernels/fused_composite.py::_run_fwd (the forward
// pallas_call; _forward_core + _fwd_cols) and ::_run_bwd (the backward
// pallas_call; _bwd_cols), and their flat-input variants _run_fwd_flat /
// _run_bwd_flat: both kernels here read and write the flat [M,C] layout.
//
// FORWARD (composite_st_fwd_seg_kernel<S, L, VEC>).
// A segment of L lanes per ray, S consecutive samples per lane (S = 2 up
// to 64 samples a ray), 32/L rays per warp, 256-thread blocks
// (composite_st_seg, composite_seg.cuh, says how and why).  Each lane
// reads its samples' raw field outputs straight from the interleaved
// [M,3] / [M,5] / [M,1] buffers (row = ray*N + n), with vector loads when
// the wrapper finds every base 16-byte aligned and N % S == 0 (VEC), else
// with scalar loads, so the TPU kernel's [BR,N]
// channel planes are never materialized.  Activations: sigmoid for colors,
// softplus (as jax.nn.softplus: max(x,0) + log1p(exp(-|x|))) for both
// densities and the uncertainty.  The two exclusive prefix sums of σδ
// (static, transient) that give the transmittances are a running sum
// inside the lane plus one segmented shuffle scan of the lane totals — the
// TPU's triangular-matmul cumsum has no reason to exist here — and the
// joint transmittance is their product.  All in
// float32.  The 16 per-ray columns are reduced across the segment by
// recursive halving and every lane writes its share of the packed [BR,16]
// row:
//   0-2 rgb | 3-5 rgb_static | 6-8 rgb_transient | 9 depth | 10 opacity
//   11 opacity_static | 12 opacity_transient | 13 uncert
//   14 sum_n softplus(transient density raw) | 15 zero
//
// What bounds it: by its bytes, memory — 44 B read per sample (11 f32) and
// 64 B written per ray, about 60 flops and 7 transcendentals per sample;
// measured, the issue of its instructions (mostly the IEEE expf /
// division / log1pf sequences), hence S = 2 for threads,
// then its loads when the inputs are not in L2.  The first
// design (one warp per ray, S = ⌈N/32⌉, 4-byte loads, a branch per sample,
// five-step butterflies per column and lane 0 storing the row) stays
// compiled only under -DCOMPOSITE_WARP_PER_RAY, for the in-call A/B
// (chip_smoke.py, tools/probe_composite.py).
//
// BACKWARD (composite_st_bwd_kernel): the closed-form VJP of _bwd_cols from
// the packed [BR,16] cotangent, one warp per ray (S = ceil(N/32) samples
// per lane; the segmented design is next for it).  It recomputes
// the forward quantities, then the two strict suffix sums of _bwd_cols
// (through the joint T and through T_t; both enter d sdt with a minus sign,
// so they are taken as one sum) as a reverse running sum inside the lane
// plus a warp shuffle scan of the lane totals.  It writes d rgb_raw [M,3]
// and d trans_raw [M,5] in the flat layout the field's backward reads; the
// static density is frozen-trunk output and gets no gradient.  Bound and
// design as the forward: 40 B read and 32 B written per sample, ~80 flops,
// everything in registers.
// Its per-ray body is the device function composite_st_ray_bwd
// (composite_st.cuh); that and the warp-per-ray forward composite_st_ray
// are the composite stages of the ST render kernels (st_render.cu) and the
// field forward's epilogue (field_fwd.cuh).
//
// COARSE FORWARD (composite_coarse_fwd_kernel).
// Replaces: texpose_tpu/kernels/fused_composite_coarse.py::_run_fwd (the
// single-density composite on [BR,N] channel planes, _fwd_kernel) and
// ::_run_fwd_flat (the same on the flat [M,3]/[M,1] outputs,
// _fwd_kernel_flat).  The field kernel writes the flat layout and this
// kernel reads it, so one kernel serves both (kernels.composite_flat
// selects the same launch).  One warp per ray, S = ceil(N/32) samples per
// lane (N ≤ 256): composite_coarse_ray (composite_coarse.cuh), the device
// function the coarse mega forward runs as its epilogue.  What bounds it:
// memory — 24 B read per sample and 32 B written per ray, ~25 flops and 3
// transcendentals per sample.  Design: as the dual composite, nothing
// staged, everything in registers.
//
// COARSE BACKWARD (composite_coarse_bwd_seg_kernel<S, L, VEC>).
// Replaces: texpose_tpu/kernels/fused_composite_coarse.py::_run_bwd (the
// closed-form VJP of the single-density composite, _bwd_kernel), the
// pretrain step's composite backward.  Segmented as the forward above:
// composite_coarse_bwd_seg (composite_seg.cuh).  From the packed [BR,8]
// cotangent (0-2 rgb, 3 depth, 4 opacity), read once per segment and
// broadcast by shuffle, with c = sigmoid(rgb_raw), s = softplus(dens_raw)·δ,
// w = T·(1−e^{−s}) and the per-sample coefficient G = Σ_c g_c·c +
// g_depth·depth + g_opacity:
//   d rgb_raw_c = w·g_c·c·(1−c)
//   dL/ds = G·T·e^{−s} − Σ_{n'>n} G·w  (reverse running sum + segment scan)
//   d dens_raw = dL/ds · δ · sigmoid(dens_raw)       (softplus' = sigmoid)
// The activations are recomputed from the f32 pre-activation residuals.
// What bounds it: by its bytes, memory — 24 B read and 16 B written per
// sample (0.0016 ms of traffic at 131,072 samples), ~40 flops and 4
// transcendentals per sample; measured, instruction issue, as the
// forward's.  N ≤ 256: the hierarchical fine field's 64 +
// 128 samples and the two-kernel route at any N.  The warp-per-ray form
// stays compiled only under -DCOMPOSITE_WARP_PER_RAY, as the forward's.

#include <cuda_runtime.h>

#include "composite_coarse.cuh"
#include "composite_seg.cuh"
#include "composite_st.cuh"

namespace {

constexpr int kThreads = 256;      // warp per ray: 8 rays per block
constexpr int kSegThreads = 256;   // segmented: 256/L rays per block

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
  const size_t row = (size_t)ray * N;
  composite_st_ray<S>(rgb + row * 3, tr + row * 5, dens + row, depth + row,
                      dist + row, N, min_uncert, lane,
                      out + (size_t)ray * 16);
}

#endif  // COMPOSITE_WARP_PER_RAY

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

#ifdef COMPOSITE_WARP_PER_RAY
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

#endif  // COMPOSITE_WARP_PER_RAY

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
void launch_coarse_fwd(const float* rgb, const float* dens, const float* dist,
                       const float* depth, int BR, int N, float* out,
                       cudaStream_t stream) {
  const int blocks = (BR * 32 + kThreads - 1) / kThreads;
  composite_coarse_fwd_kernel<S><<<blocks, kThreads, 0, stream>>>(
      rgb, dens, dist, depth, BR, N, out);
}

// The segmented kernels at S samples a lane and L lanes a ray: the vector
// or the scalar-load variant.
template <int S, int L>
void launch_st_seg(const float* rgb, const float* tr, const float* dens,
                   const float* depth, const float* dist, int BR, int N,
                   float min_uncert, bool vec, int blocks, float* out,
                   cudaStream_t stream) {
  if (vec)
    composite_st_fwd_seg_kernel<S, L, true>
        <<<blocks, kSegThreads, 0, stream>>>(rgb, tr, dens, depth, dist, BR,
                                             N, min_uncert, out);
  else
    composite_st_fwd_seg_kernel<S, L, false>
        <<<blocks, kSegThreads, 0, stream>>>(rgb, tr, dens, depth, dist, BR,
                                             N, min_uncert, out);
}

template <int S, int L>
void launch_coarse_bwd_seg(const float* rgb, const float* dens,
                           const float* dist, const float* depth,
                           const float* g, int BR, int N, bool vec,
                           int blocks, float* d_rgb, float* d_dens,
                           cudaStream_t stream) {
  if (vec)
    composite_coarse_bwd_seg_kernel<S, L, true>
        <<<blocks, kSegThreads, 0, stream>>>(rgb, dens, dist, depth, g, BR, N,
                                             d_rgb, d_dens);
  else
    composite_coarse_bwd_seg_kernel<S, L, false>
        <<<blocks, kSegThreads, 0, stream>>>(rgb, dens, dist, depth, g, BR, N,
                                             d_rgb, d_dens);
}

// The (S, L) pairs the wrapper plans (kernels/composite.py segment_plan):
// S = 2 with L = 1..32 up to 64 samples a ray, then S = 4 and S = 8 with
// L = 32.
#define SEG_PLANS(X) \
  X(2, 1) X(2, 2) X(2, 4) X(2, 8) X(2, 16) X(2, 32) X(4, 32) X(8, 32)

#ifndef COMPOSITE_WARP_PER_RAY
// The launch the wrapper planned covers every sample and every ray: S·L ≥
// N and blocks·kSegThreads ≥ BR·L lanes (the (S, L) pair itself is checked
// by the entries' switch over SEG_PLANS).
bool seg_plan_ok(int BR, int N, int samples, int lanes, int blocks) {
  return N <= samples * lanes &&
         (long long)blocks * kSegThreads >= (long long)BR * lanes;
}
#else
template <int S>
void launch_coarse_bwd(const float* rgb, const float* dens, const float* dist,
                       const float* depth, const float* g, int BR, int N,
                       float* d_rgb, float* d_dens, cudaStream_t stream) {
  const int blocks = (BR * 32 + kThreads - 1) / kThreads;
  composite_coarse_bwd_kernel<S><<<blocks, kThreads, 0, stream>>>(
      rgb, dens, dist, depth, g, BR, N, d_rgb, d_dens);
}

template <int S>
void launch(const float* rgb, const float* tr, const float* dens,
            const float* depth, const float* dist, int BR, int N,
            float min_uncert, float* out, cudaStream_t stream) {
  const int blocks = (BR * 32 + kThreads - 1) / kThreads;
  composite_st_fwd_kernel<S><<<blocks, kThreads, 0, stream>>>(
      rgb, tr, dens, depth, dist, BR, N, min_uncert, out);
}

#endif  // COMPOSITE_WARP_PER_RAY

template <int S>
void launch_bwd(const float* rgb, const float* tr, const float* dens,
                const float* dist, const float* g, int BR, int N,
                float* d_rgb, float* d_tr, cudaStream_t stream) {
  const int blocks = (BR * 32 + kThreads - 1) / kThreads;
  composite_st_bwd_kernel<S><<<blocks, kThreads, 0, stream>>>(
      rgb, tr, dens, dist, g, BR, N, d_rgb, d_tr);
}

}  // namespace

// Launches the forward on `stream` as planned: `samples` a lane, `lanes`
// a ray, vector loads if `vec`, `blocks` blocks (the
// -DCOMPOSITE_WARP_PER_RAY build ignores the plan and launches the
// warp-per-ray form); returns cudaGetLastError() (0 = launched).
extern "C" int composite_st_fwd(const void* rgb, const void* tr,
                                const void* dens, const void* depth,
                                const void* dist, int BR, int N,
                                float min_uncert, int samples, int lanes,
                                int vec, int blocks, void* out,
                                void* stream) {
  if (BR <= 0) return 0;
  const float* a = static_cast<const float*>(rgb);
  const float* b = static_cast<const float*>(tr);
  const float* c = static_cast<const float*>(dens);
  const float* d = static_cast<const float*>(depth);
  const float* e = static_cast<const float*>(dist);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaErrorInvalidValue;
#ifdef COMPOSITE_WARP_PER_RAY
  (void)samples, (void)lanes, (void)vec, (void)blocks;
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
#else
  if (!seg_plan_ok(BR, N, samples, lanes, blocks))
    return (int)cudaErrorInvalidValue;
#define ST_CASE(S_, L_)                                                     \
  case S_ * 64 + L_:                                                        \
    launch_st_seg<S_, L_>(a, b, c, d, e, BR, N, min_uncert, vec, blocks, o, \
                          st);                                              \
    break;
  switch (samples * 64 + lanes) {
    SEG_PLANS(ST_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ST_CASE
#endif
  return (int)cudaGetLastError();
}

// Launches the backward on `stream`: g [BR,16] → d_rgb [M,3], d_tr [M,5];
// returns cudaGetLastError() (0 = launched).
extern "C" int composite_st_bwd(const void* rgb, const void* tr,
                                const void* dens, const void* dist,
                                const void* g, int BR, int N, void* d_rgb,
                                void* d_tr, void* stream) {
  if (BR <= 0) return 0;
  const float* a = static_cast<const float*>(rgb);
  const float* b = static_cast<const float*>(tr);
  const float* c = static_cast<const float*>(dens);
  const float* e = static_cast<const float*>(dist);
  const float* gg = static_cast<const float*>(g);
  float* o1 = static_cast<float*>(d_rgb);
  float* o2 = static_cast<float*>(d_tr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaErrorInvalidValue;
  if (N <= 32)
    launch_bwd<1>(a, b, c, e, gg, BR, N, o1, o2, st);
  else if (N <= 64)
    launch_bwd<2>(a, b, c, e, gg, BR, N, o1, o2, st);
  else if (N <= 128)
    launch_bwd<4>(a, b, c, e, gg, BR, N, o1, o2, st);
  else if (N <= 256)
    launch_bwd<8>(a, b, c, e, gg, BR, N, o1, o2, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Launches the coarse backward on `stream` as planned (as the forward):
// g [BR,8] → d_rgb [M,3], d_dens [M,1]; returns cudaGetLastError().
extern "C" int composite_coarse_bwd(const void* rgb, const void* dens,
                                    const void* dist, const void* depth,
                                    const void* g, int BR, int N,
                                    int samples, int lanes, int vec,
                                    int blocks, void* d_rgb, void* d_dens,
                                    void* stream) {
  if (BR <= 0) return 0;
  const float* a = static_cast<const float*>(rgb);
  const float* b = static_cast<const float*>(dens);
  const float* c = static_cast<const float*>(dist);
  const float* d = static_cast<const float*>(depth);
  const float* gg = static_cast<const float*>(g);
  float* o1 = static_cast<float*>(d_rgb);
  float* o2 = static_cast<float*>(d_dens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaErrorInvalidValue;
#ifdef COMPOSITE_WARP_PER_RAY
  (void)samples, (void)lanes, (void)vec, (void)blocks;
  if (N <= 32)
    launch_coarse_bwd<1>(a, b, c, d, gg, BR, N, o1, o2, st);
  else if (N <= 64)
    launch_coarse_bwd<2>(a, b, c, d, gg, BR, N, o1, o2, st);
  else if (N <= 128)
    launch_coarse_bwd<4>(a, b, c, d, gg, BR, N, o1, o2, st);
  else if (N <= 256)
    launch_coarse_bwd<8>(a, b, c, d, gg, BR, N, o1, o2, st);
  else
    return (int)cudaErrorInvalidValue;
#else
  if (!seg_plan_ok(BR, N, samples, lanes, blocks))
    return (int)cudaErrorInvalidValue;
#define BWD_CASE(S_, L_)                                                    \
  case S_ * 64 + L_:                                                        \
    launch_coarse_bwd_seg<S_, L_>(a, b, c, d, gg, BR, N, vec, blocks, o1,   \
                                  o2, st);                                  \
    break;
  switch (samples * 64 + lanes) {
    SEG_PLANS(BWD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
#endif
  return (int)cudaGetLastError();
}

// Launches the coarse forward on `stream`: rgb_raw [M,3], dens_raw [M,1],
// dist, depth [BR,N] → packed [BR,8]; returns cudaGetLastError().
extern "C" int composite_coarse_fwd(const void* rgb, const void* dens,
                                    const void* dist, const void* depth,
                                    int BR, int N, void* out, void* stream) {
  if (BR <= 0) return 0;
  const float* a = static_cast<const float*>(rgb);
  const float* b = static_cast<const float*>(dens);
  const float* c = static_cast<const float*>(dist);
  const float* d = static_cast<const float*>(depth);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaErrorInvalidValue;
  if (N <= 32)
    launch_coarse_fwd<1>(a, b, c, d, BR, N, o, st);
  else if (N <= 64)
    launch_coarse_fwd<2>(a, b, c, d, BR, N, o, st);
  else if (N <= 128)
    launch_coarse_fwd<4>(a, b, c, d, BR, N, o, st);
  else if (N <= 256)
    launch_coarse_fwd<8>(a, b, c, d, BR, N, o, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
