// The NeRF-W dual-density composite of one ray by one warp, forward and
// closed-form backward: the per-ray bodies of the composite kernels
// (composite.cu) and the epilogues of the ST render kernels (st_render.cu).
//
// Replaces, as device functions: texpose_tpu/kernels/fused_composite.py::
// _forward_core + _fwd_cols (forward) and _bwd_cols (backward), the
// composite parts of kernels/fused_st_render.py::_mega_fwd_kernel and
// ::_mega_bwd_kernel.  The TPU kernels' exclusive and suffix cumsums are
// triangular matmuls; here they are running sums inside the lane plus warp
// shuffle scans of the lane totals.  All in float32.
//
// Every pointer points at the ray's first sample (row n of the ray at
// rgb[3n], tr[5n], dens[n], depth[n], dist[n]), so the callers choose where
// the rows live: device memory (the composite kernels), the field's raw
// outputs written earlier in the same launch (the render forward), or a
// shared-memory tile (the render backward).  The loads are plain loads for
// that reason.  S = ceil(N/32) consecutive samples per lane.

#pragma once

#include "composite_coarse.cuh"

namespace {

// Forward: sigmoid colors, softplus densities and uncertainty; lane 0
// writes the packed row out[0..15]:
//   0-2 rgb | 3-5 rgb_static | 6-8 rgb_transient | 9 depth | 10 opacity
//   11 opacity_static | 12 opacity_transient | 13 uncert
//   14 sum_n softplus(transient density raw) | 15 zero
template <int S>
__device__ __forceinline__ void composite_st_ray(
    const float* rgb, const float* tr, const float* dens, const float* depth,
    const float* dist, int N, float min_uncert, int lane, float* out) {
  float cs[3][S], ct[3][S], dt[S], u[S], sds[S], sdt[S], dep[S];
  float tot = 0.f, tot_s = 0.f, tot_t = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = lane * S + s;
    if (n < N) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cs[c][s] = sigmoidf_(rgb[n * 3 + c]);
        ct[c][s] = sigmoidf_(tr[n * 5 + c]);
      }
      dt[s] = softplusf_(tr[n * 5 + 3]);
      u[s] = softplusf_(tr[n * 5 + 4]);
      const float d = dist[n];
      sds[s] = softplusf_(dens[n]) * d;
      sdt[s] = dt[s] * d;
      dep[s] = depth[n];
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
    float4* o = reinterpret_cast<float4*>(out);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    o[2] = make_float4(acc[8], acc[9], acc[10], acc[11]);
    o[3] = make_float4(acc[12], acc[13] + min_uncert, acc[14], 0.f);
  }
}

// Backward (_bwd_cols in closed form) from the ray's packed cotangent g[16]:
// recomputes the forward quantities, then the two strict suffix sums (through
// the joint T and through T_t; both enter d sdt with a minus sign, so they
// are taken as one sum) as a reverse running sum inside the lane plus a warp
// shuffle scan of the lane totals.  Writes d rgb_raw (3 per sample) and
// d trans_raw (5 per sample); the static density is frozen-trunk output and
// gets no gradient.
template <int S>
__device__ __forceinline__ void composite_st_ray_bwd(
    const float* rgb, const float* tr, const float* dens, const float* dist,
    const float* gpk, int N, int lane, float* d_rgb, float* d_tr) {
  float g[15];                                // column 15 is padding
#pragma unroll
  for (int j = 0; j < 15; ++j) g[j] = gpk[j];

  float cs[3][S], ct[3][S], u[S], sds[S], sdt[S], dd[S], sg3[S], sg4[S];
  float tot = 0.f, tot_s = 0.f, tot_t = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = lane * S + s;
    if (n < N) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cs[c][s] = sigmoidf_(rgb[n * 3 + c]);
        ct[c][s] = sigmoidf_(tr[n * 5 + c]);
      }
      const float t3 = tr[n * 5 + 3];
      const float t4 = tr[n * 5 + 4];
      u[s] = softplusf_(t4);
      sg3[s] = sigmoidf_(t3);                 // softplus' = sigmoid
      sg4[s] = sigmoidf_(t4);
      dd[s] = dist[n];
      sds[s] = softplusf_(dens[n]) * dd[s];
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
  float suf = warp_strict_suffix_sum(vtot, lane);
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    const float strict = suf;                 // Σ_{n' > n} v_n'
    suf += v[s];
    const int n = lane * S + s;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d_rgb[n * 3 + c] =
          (ps[s] * g[c] + ws[s] * g[3 + c]) * cs[c][s] * (1.f - cs[c][s]);
      d_tr[n * 5 + c] =
          (pt[s] * g[c] + wt[s] * g[6 + c]) * ct[c][s] * (1.f - ct[c][s]);
    }
    d_tr[n * 5 + 3] = ((loc[s] - strict) * dd[s] + g[14]) * sg3[s];
    d_tr[n * 5 + 4] = pt[s] * g[13] * sg4[s];
  }
}

}  // namespace
