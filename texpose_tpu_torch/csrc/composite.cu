// Forward and backward of the NeRF-W dual-density composite, written by hand
// for Hopper (sm_90a) and bound to PyTorch through ctypes
// (texpose_tpu_torch/kernels/composite.py).
//
// Replaces: texpose_tpu/kernels/fused_composite.py::_run_fwd (the forward
// pallas_call; _forward_core + _fwd_cols) and ::_run_bwd (the backward
// pallas_call; _bwd_cols), and their flat-input variants _run_fwd_flat /
// _run_bwd_flat: both kernels here read and write the flat [M,C] layout.
//
// FORWARD (composite_st_fwd_kernel).
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
//
// BACKWARD (composite_st_bwd_kernel): the closed-form VJP of _bwd_cols from
// the packed [BR,16] cotangent, one warp per ray as above.  It recomputes
// the forward quantities, then the two strict suffix sums of _bwd_cols
// (through the joint T and through T_t; both enter d sdt with a minus sign,
// so they are taken as one sum) as a reverse running sum inside the lane
// plus a warp shuffle scan of the lane totals.  It writes d rgb_raw [M,3]
// and d trans_raw [M,5] in the flat layout the field's backward reads; the
// static density is frozen-trunk output and gets no gradient.  Bound and
// design as the forward: 40 B read and 32 B written per sample, ~80 flops,
// everything in registers.
//
// COARSE BACKWARD (composite_coarse_bwd_kernel).
// Replaces: texpose_tpu/kernels/fused_composite_coarse.py::_run_bwd (the
// closed-form VJP of the single-density composite, _bwd_kernel), the
// pretrain step's composite backward.  One warp per ray as above.  From the
// packed [BR,8] cotangent (0-2 rgb, 3 depth, 4 opacity), with c =
// sigmoid(rgb_raw), s = softplus(dens_raw)·δ, w = T·(1−e^{−s}) and the
// per-sample coefficient G = Σ_c g_c·c + g_depth·depth + g_opacity:
//   d rgb_raw_c = w·g_c·c·(1−c)
//   dL/ds = G·T·e^{−s} − Σ_{n'>n} G·w     (reverse running sum + warp scan)
//   d dens_raw = dL/ds · δ · sigmoid(dens_raw)       (softplus' = sigmoid)
// The activations are recomputed from the f32 pre-activation residuals.
// What bounds it: memory — 24 B read and 16 B written per sample
// (0.016 ms of traffic at 131,072 samples), ~40 flops and 4 transcendentals
// per sample.  Design: as the forward, nothing staged, nothing spilled.

#include <cuda_runtime.h>

#include "composite_coarse.cuh"

namespace {

constexpr int kThreads = 256;   // 8 rays per block

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

  float g[15];                                // column 15 is padding
#pragma unroll
  for (int j = 0; j < 15; ++j) g[j] = __ldg(gpk + (size_t)ray * 16 + j);

  float cs[3][S], ct[3][S], u[S], sds[S], sdt[S], dd[S], sg3[S], sg4[S];
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
      const float t3 = __ldg(tr + row * 5 + 3);
      const float t4 = __ldg(tr + row * 5 + 4);
      u[s] = softplusf_(t4);
      sg3[s] = sigmoidf_(t3);                 // softplus' = sigmoid
      sg4[s] = sigmoidf_(t4);
      dd[s] = __ldg(dist + row);
      sds[s] = softplusf_(__ldg(dens + row)) * dd[s];
      sdt[s] = softplusf_(t3) * dd[s];
    } else {                                  // padding lanes weigh nothing
#pragma unroll
      for (int c = 0; c < 3; ++c) cs[c][s] = ct[c][s] = 0.f;
      u[s] = sds[s] = sdt[s] = dd[s] = sg3[s] = sg4[s] = 0.f;
    }
    tot += sds[s] + sdt[s];
    tot_s += sds[s];
    tot_t += sdt[s];
  }
  float run = warp_exclusive_sum(tot, lane);
  float run_s = warp_exclusive_sum(tot_s, lane);
  float run_t = warp_exclusive_sum(tot_t, lane);

  // per sample: the weights, the local part of d sdt, and v = what the
  // sample's T_n and T_t,n pass to every earlier sample's sdt
  float ps[S], pt[S], ws[S], wt[S], loc[S], v[S];
  float vtot = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float T = expf(-run), Ts = expf(-run_s), Tt = expf(-run_t);
    const float sd = sds[s] + sdt[s];
    const float e_s = expf(-sds[s]), e_t = expf(-sdt[s]), e = expf(-sd);
    ps[s] = T * (1.f - e_s);
    pt[s] = T * (1.f - e_t);
    ws[s] = Ts * (1.f - e_s);
    wt[s] = Tt * (1.f - e_t);
    const float pj = T * (1.f - e);
    float F_ps = 0.f, F_pt = u[s] * g[13], F_wt = g[12];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      F_ps += cs[c][s] * g[c];
      F_pt += ct[c][s] * g[c];
      F_wt += ct[c][s] * g[6 + c];
    }
    loc[s] = F_pt * T * e_t + F_wt * Tt * e_t + g[10] * T * e;
    v[s] = F_ps * ps[s] + F_pt * pt[s] + g[10] * pj + F_wt * wt[s];
    vtot += v[s];
    run += sd;
    run_s += sds[s];
    run_t += sdt[s];
  }
  // Σ of v over the lanes above this one (suffix scan of the lane totals)
  float suf = vtot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(kFull, suf, o);
    if (lane + o < 32) suf += y;
  }
  suf -= vtot;
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    const float strict = suf;                 // Σ_{n' > n} v_n'
    suf += v[s];
    const int n = lane * S + s;
    if (n >= N) continue;
    const size_t row = (size_t)ray * N + n;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d_rgb[row * 3 + c] =
          (ps[s] * g[c] + ws[s] * g[3 + c]) * cs[c][s] * (1.f - cs[c][s]);
      d_tr[row * 5 + c] =
          (pt[s] * g[c] + wt[s] * g[6 + c]) * ct[c][s] * (1.f - ct[c][s]);
    }
    d_tr[row * 5 + 3] = ((loc[s] - strict) * dd[s] + g[14]) * sg3[s];
    d_tr[row * 5 + 4] = pt[s] * g[13] * sg4[s];
  }
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

template <int S>
void launch_bwd(const float* rgb, const float* tr, const float* dens,
                const float* dist, const float* g, int BR, int N,
                float* d_rgb, float* d_tr, cudaStream_t stream) {
  const int blocks = (BR * 32 + kThreads - 1) / kThreads;
  composite_st_bwd_kernel<S><<<blocks, kThreads, 0, stream>>>(
      rgb, tr, dens, dist, g, BR, N, d_rgb, d_tr);
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

// Launches the coarse backward on `stream`: g [BR,8] → d_rgb [M,3],
// d_dens [M,1]; returns cudaGetLastError() (0 = launched).
extern "C" int composite_coarse_bwd(const void* rgb, const void* dens,
                                    const void* dist, const void* depth,
                                    const void* g, int BR, int N, void* d_rgb,
                                    void* d_dens, void* stream) {
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
  // N up to the coarse render forward's 64-row tile, its only producer
  if (N <= 32)
    launch_coarse_bwd<1>(a, b, c, d, gg, BR, N, o1, o2, st);
  else if (N <= 64)
    launch_coarse_bwd<2>(a, b, c, d, gg, BR, N, o1, o2, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
