// Segmented composites: a segment of L lanes per ray, S consecutive samples
// per lane, L = 32 (the launches, kernels/composite.py segment_plan; the
// bodies take any power of two L ≥ ⌈N/S⌉, 32/L rays a warp).  The per-ray
// bodies of the four composite kernels in composite.cu: rows 3 (dual
// composite forward), 4 (its VJP), 9a (single-density composite forward)
// and 9b (its VJP).
//
// Replaces, as device functions: texpose_tpu/kernels/fused_composite.py::
// _forward_core + _fwd_cols and _bwd_cols, texpose_tpu/kernels/
// fused_composite_coarse.py::_fwd_kernel and _bwd_kernel.  The TPU
// kernels' triangular-matmul cumsums become running sums inside the lane
// plus segmented shuffle scans (log2 L steps, shfl width L) of the lane
// totals.  All in float32, with the activations of composite_coarse.cuh
// (sigmoidf_ with the IEEE division, softplusf_ with jax.nn.softplus's
// formula), as the twins and the per-ray bodies of the fused epilogues.
//
// What bounds them: by their bytes, memory (per sample, rows 3 / 4 / 9a /
// 9b read 44 / 40 / 24 / 24 B; row 3 writes 64 B a ray, row 4 32 B a
// sample, 9a 32 B a ray, 9b 16 B a sample); measured (PERF.md), the issue
// of their instructions, most of them the expf / division / log1pf
// sequences of the activations and transmittances, then, with the inputs
// in device memory, their loads: the whole grid is one wave, so the loads
// and the arithmetic do not overlap, and neither coalescing the loads
// through shared memory, another block size nor issuing two rays' loads a
// segment before any arithmetic made them faster.  So the samples a lane
// are chosen for threads, not for load width: S = 2 up to 64 samples a
// ray, 4 up to 128, 8 up to 256, so 2048 rays × 64 samples keep 65,536
// threads, 16 warps an SM; S = 8 there left one warp per scheduler and ran
// 1.3-1.9× slower, and row 4 at S = 1 over two warps a ray (131,072
// threads, the warps' totals exchanged through shared memory) ran slower
// than at S = 2 (PERF.md).  The rest of the design:
//  - vector loads and stores when VEC: a lane's S rows are contiguous and
//    whole when every input's base is 16-byte aligned and N % S == 0, so a
//    vector access never passes the ray's last row (rgb 3·S floats, trans
//    5·S, dens / dist / depth S each: float4s at S ≥ 4, float2s at S = 2);
//    otherwise (N = 99, an offset view) the same body with scalar loads;
//  - fewer instructions: the transmittances come from one exclusive scan
//    of the lane totals (both densities' at once in rows 3 and 4; no
//    "inclusive − own": see seg_exclusive), then, in rows 3, 4 and 9a, by
//    products inside the lane (T = T_s·T_t, T_{n+1} = T_n·e^{−σδ_n},
//    e = e_s·e_t): one expf a sample and density instead of one per
//    transmittance and weight; the VJPs' suffix sums are one
//    seg_strict_suffix of the lane totals;
//  - the forwards' columns are reduced by recursive halving (row 3's 16:
//    8 + 4 + 2 + 1 + 1 = 16 shuffles at L = 32, against 75 butterflies;
//    9a's 8, three of them zero: 4 + 2 + 1 + 2 = 9, against 25) and the
//    segment writes its packed row with coalesced stores by the lanes that
//    hold the sums, not by lane 0;
//  - the VJPs' cotangent row is read by every lane of the segment (row 4:
//    four broadcast float4 loads) or by lane 0 and broadcast by shuffle
//    (9b);
//  - no branch per sample: a sample past N loads zeros, and its zero
//    interval δ makes every weight it carries zero, so only row 3's sum of
//    transient densities (column 14) masks it; nothing past N is stored.
// Every lane of the warp reaches every shuffle: a lane past the last ray
// computes on zeros and stores nothing.

#pragma once

#include <cuda_runtime.h>

#include "composite_coarse.cuh"

namespace {

template <int L>
struct SegLog {
  static constexpr int value = 1 + SegLog<L / 2>::value;
};
template <>
struct SegLog<1> {
  static constexpr int value = 0;
};

// Loads n consecutive floats from p into v: as float4s when VEC and n % 4
// == 0 (p 16-byte aligned), as float2s when VEC and n % 4 != 0 (p 8-byte
// aligned: 2 rows of 3 or 5 floats), else one by one; zeros unless live.
template <int n, bool VEC>
__device__ __forceinline__ void seg_load(const float* __restrict__ p,
                                         bool live, float (&v)[n]) {
  static_assert(!VEC || n % 2 == 0, "vector loads of an even count");
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = 0.f;
  if (!live) return;
  if constexpr (VEC && n % 4 == 0) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < n / 4; ++i) {
      const float4 x = __ldg(q + i);
      v[4 * i] = x.x;
      v[4 * i + 1] = x.y;
      v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else if constexpr (VEC) {
    const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float2 x = __ldg(q + i);
      v[2 * i] = x.x;
      v[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] = __ldg(p + i);
  }
}

// The lane's S samples' rows, C floats per row: every row of the lane when
// VEC (all or none valid), else row by row while n < N; zeros elsewhere.
template <int S, int C, bool VEC>
__device__ __forceinline__ void seg_rows(const float* __restrict__ base,
                                         bool live, int first, int N,
                                         float (&v)[C * S]) {
  if constexpr (VEC) {
    seg_load<C * S, true>(base, live, v);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[s * C + c] = 0.f;
      if (live && first + s < N) {
#pragma unroll
        for (int c = 0; c < C; ++c) v[s * C + c] = __ldg(base + s * C + c);
      }
    }
  }
}

// Stores n consecutive floats to p (as seg_load loads them), if live.
template <int n, bool VEC>
__device__ __forceinline__ void seg_store(float* __restrict__ p, bool live,
                                          int first, int N, int C,
                                          const float (&v)[n]) {
  static_assert(!VEC || n % 2 == 0, "vector stores of an even count");
  if (!live) return;
  if constexpr (VEC && n % 4 == 0) {
    float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int i = 0; i < n / 4; ++i)
      q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else if constexpr (VEC) {
    float2* q = reinterpret_cast<float2*>(p);
#pragma unroll
    for (int i = 0; i < n / 2; ++i) q[i] = make_float2(v[2 * i], v[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i)
      if (first + i / C < N) p[i] = v[i];
  }
}

// Exclusive prefix over the segment's lanes of K values at once, in log2 L
// shfl_up steps (width L): each step's shuffled partial x_{ℓ−o} (the sum
// of lanes ℓ−2o+1 .. ℓ−o) is added both to the running inclusive sum x and
// to the exclusive sum e, so e never holds the lane's own total.  A lane
// total can be huge (the ray's last interval is 1e10·|ray|): inclusive −
// own would lose every lane below it.
template <int L, int K>
__device__ __forceinline__ void seg_exclusive(float (&v)[K], int seg_lane) {
  float e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) e[k] = 0.f;
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float y = __shfl_up_sync(kFull, v[k], o, L);
      if (seg_lane >= o) {
        e[k] += y;
        v[k] += y;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = e[k];
}

// Σ of v over the segment's lanes above this one: the same scan mirrored
// (shfl_down, width L).
template <int L>
__device__ __forceinline__ float seg_strict_suffix(float v, int seg_lane) {
  float e = 0.f;
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
    const float y = __shfl_down_sync(kFull, v, o, L);
    if (seg_lane + o < L) {
      e += y;
      v += y;
    }
  }
  return e;
}

// The halving steps of seg_halve<L, C> (C a power of two): min(log2 L,
// log2 C); W = C >> H columns a lane holds after them, shared by groups of
// 2^R lanes, R = log2 L − H.
template <int L, int C>
struct SegHalve {
  static constexpr int H = SegLog<L>::value < SegLog<C>::value
                               ? SegLog<L>::value
                               : SegLog<C>::value;
  static constexpr int W = C >> H, R = SegLog<L>::value - H;
};

// Sums acc[0..C-1] over the segment's L lanes: H steps of recursive
// halving, then butterflies.  Step i (offset L >> (i+1)) halves the columns
// a lane holds: a lane whose offset bit is clear keeps the lower half and
// sends the upper, its partner the reverse, and each adds what it receives.
// Past C lanes the last R steps are plain butterflies on the W columns
// left.  After it lane ℓ holds columns (ℓ >> R)·W .. (ℓ >> R)·W + W − 1 in
// acc[0..W−1]; the 2^R lanes of a group hold the same sums.
template <int L, int C>
__device__ __forceinline__ void seg_halve(float (&acc)[C], int seg_lane) {
  constexpr int H = SegHalve<L, C>::H, W = SegHalve<L, C>::W;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int o = L >> (i + 1);
    const int half = (C / 2) >> i;
    const bool up = (seg_lane & o) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = up ? acc[j] : acc[j + half];
      const float keep = up ? acc[j + half] : acc[j];
      acc[j] = keep + __shfl_xor_sync(kFull, send, o, L);
    }
  }
#pragma unroll
  for (int o = (L >> H) >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < W; ++j)
      acc[j] += __shfl_xor_sync(kFull, acc[j], o, L);
}

// Stores what seg_halve<L, C> left: the first lane of each group of 2^R
// writes its W columns to row[(ℓ >> R)·W ..] (as float4s, a float2 or a
// float; row 16-byte aligned: the wrapper's), if `live`.
template <int L, int C>
__device__ __forceinline__ void seg_store_cols(const float (&acc)[C],
                                               bool live, int seg_lane,
                                               float* __restrict__ row) {
  constexpr int W = SegHalve<L, C>::W, R = SegHalve<L, C>::R;
  if (!live || (seg_lane & ((1 << R) - 1)) != 0) return;
  float* o = row + (seg_lane >> R) * W;
  if constexpr (W >= 4) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i)
      reinterpret_cast<float4*>(o)[i] =
          make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                      acc[4 * i + 3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
    *o = acc[0];
  }
}

// Row 3 per segment: the NeRF-W dual-density composite of ray `ray` (< BR
// for a live segment) → the packed row out[ray·16 .. +15]:
//   0-2 rgb | 3-5 rgb_static | 6-8 rgb_transient | 9 depth | 10 opacity
//   11 opacity_static | 12 opacity_transient | 13 uncert (+ min_uncert)
//   14 sum_n softplus(transient density raw) | 15 zero
// The formulas of composite_st_ray, in another order and with the
// transmittances as products inside the lane (see below).
template <int S, int L, bool VEC>
__device__ __forceinline__ void composite_st_seg(
    const float* __restrict__ rgb, const float* __restrict__ tr,
    const float* __restrict__ dens, const float* __restrict__ depth,
    const float* __restrict__ dist, int ray, int BR, int N,
    float min_uncert, int seg_lane, float* __restrict__ out) {
  const int first = seg_lane * S;             // the lane's first sample
  const bool live = ray < BR && first < N;
  const size_t row = (size_t)ray * N + first;
  float r[3 * S], t[5 * S], dn[S], dp[S], ds[S];
  seg_rows<S, 3, VEC>(rgb + row * 3, live, first, N, r);
  seg_rows<S, 5, VEC>(tr + row * 5, live, first, N, t);
  seg_rows<S, 1, VEC>(dens + row, live, first, N, dn);
  seg_rows<S, 1, VEC>(depth + row, live, first, N, dp);
  seg_rows<S, 1, VEC>(dist + row, live, first, N, ds);

  // a sample past N has δ = 0: zero σδ, zero weights
  float cs[3][S], ct[3][S], dt[S], u[S], sds[S], sdt[S];
  float tot[2] = {0.f, 0.f};                  // static, transient
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      cs[c][s] = sigmoidf_(r[3 * s + c]);
      ct[c][s] = sigmoidf_(t[5 * s + c]);
    }
    dt[s] = softplusf_(t[5 * s + 3]);
    u[s] = softplusf_(t[5 * s + 4]);
    sds[s] = softplusf_(dn[s]) * ds[s];
    sdt[s] = dt[s] * ds[s];
    tot[0] += sds[s];
    tot[1] += sdt[s];
  }
  seg_exclusive<L, 2>(tot, seg_lane);
  // the transmittances at the lane's first sample, then by products: the
  // joint T = T_s·T_t and e^{−σδ} = e^{−σ_sδ}·e^{−σ_tδ} (one rounding each
  // instead of an exp each; the kernel issues its instructions, PERF.md)
  float Ts = expf(-tot[0]), Tt = expf(-tot[1]);

  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float e_s = expf(-sds[s]), e_t = expf(-sdt[s]);
    const float T = Ts * Tt;
    const float a_s = 1.f - e_s, a_t = 1.f - e_t, a = 1.f - e_s * e_t;
    const float ps = T * a_s, pt = T * a_t, pj = T * a;
    const float ws = Ts * a_s, wt = Tt * a_t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[c] += ps * cs[c][s] + pt * ct[c][s];
      acc[3 + c] += ws * cs[c][s];
      acc[6 + c] += wt * ct[c][s];
    }
    acc[9] += ws * dp[s];
    acc[10] += pj;
    acc[11] += ws;
    acc[12] += wt;
    acc[13] += u[s] * pt;
    if (live && (VEC || first + s < N)) acc[14] += dt[s];   // masked: δ·0
    Ts *= e_s;
    Tt *= e_t;
  }

  seg_halve<L, 16>(acc, seg_lane);
  constexpr int W = SegHalve<L, 16>::W, R = SegHalve<L, 16>::R;
  const int c0 = (seg_lane >> R) * W;
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (c0 + j == 13) acc[j] += min_uncert;
  seg_store_cols<L, 16>(acc, ray < BR, seg_lane, out + (size_t)ray * 16);
}

// Row 9b per segment: the closed-form VJP of the single-density composite
// of ray `ray` from its packed cotangent g[ray·8 .. +4] (0-2 rgb, 3 depth,
// 4 opacity).  With c = sigmoid(rgb_raw), s = softplus(dens_raw)·δ,
// w = T·(1−e^{−s}) and G = Σ_c g_c·c + g_depth·depth + g_opacity:
//   d rgb_raw_c = w·g_c·c·(1−c)
//   dL/ds = G·T·e^{−s} − Σ_{n'>n} G·w    (reverse running sum + segment scan)
//   d dens_raw = dL/ds · δ · sigmoid(dens_raw)      (softplus' = sigmoid)
// Segment lane 0 reads the cotangent (two float4 when VEC) and broadcasts
// it by shuffle; each lane stores its S rows of d rgb_raw [M,3] and
// d dens_raw [M,1] (as seg_load loads).  A sample past N (δ = 0, w = 0)
// adds nothing to the sums and is not stored.
template <int S, int L, bool VEC>
__device__ __forceinline__ void composite_coarse_bwd_seg(
    const float* __restrict__ rgb, const float* __restrict__ dens,
    const float* __restrict__ dist, const float* __restrict__ depth,
    const float* __restrict__ gpk, int ray, int BR, int N, int seg_lane,
    float* __restrict__ d_rgb, float* __restrict__ d_dens) {
  const int first = seg_lane * S;
  const bool live = ray < BR && first < N;
  const size_t row = (size_t)ray * N + first;
  float gl[8];
  seg_load<8, VEC>(gpk + (size_t)ray * 8, ray < BR && seg_lane == 0, gl);
  float r[3 * S], x[S], dd[S], dp[S];
  seg_rows<S, 3, VEC>(rgb + row * 3, live, first, N, r);
  seg_rows<S, 1, VEC>(dens + row, live, first, N, x);
  seg_rows<S, 1, VEC>(dist + row, live, first, N, dd);
  seg_rows<S, 1, VEC>(depth + row, live, first, N, dp);
  float g[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) g[j] = __shfl_sync(kFull, gl[j], 0, L);

  float cs[3][S], sg[S], sd[S];
  float tot[1] = {0.f};
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) cs[c][s] = sigmoidf_(r[3 * s + c]);
    sg[s] = sigmoidf_(x[s]);
    sd[s] = softplusf_(x[s]) * dd[s];
    tot[0] += sd[s];
  }
  seg_exclusive<L, 1>(tot, seg_lane);
  float run = tot[0];

  // per sample: w, the local part of dL/ds, and v = G·w, which every
  // earlier sample's s takes with a minus sign (through T)
  float w[S], loc[S], v[S];
  float vtot = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float T = expf(-run), e = expf(-sd[s]);
    w[s] = T * (1.f - e);
    const float G = cs[0][s] * g[0] + cs[1][s] * g[1] + cs[2][s] * g[2] +
                    dp[s] * g[3] + g[4];
    loc[s] = G * T * e;
    v[s] = G * w[s];
    vtot += v[s];
    run += sd[s];
  }
  float suf = seg_strict_suffix<L>(vtot, seg_lane);
  float o_rgb[3 * S], o_dens[S];
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    const float strict = suf;                 // Σ_{n' > n} v_n'
    suf += v[s];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o_rgb[3 * s + c] = w[s] * g[c] * cs[c][s] * (1.f - cs[c][s]);
    o_dens[s] = (loc[s] - strict) * dd[s] * sg[s];
  }
  seg_store<3 * S, VEC>(d_rgb + row * 3, live, first, N, 3, o_rgb);
  seg_store<S, VEC>(d_dens + row, live, first, N, 1, o_dens);
}

// Row 4 per segment: the closed-form VJP of the dual composite
// (_bwd_cols) of ray `ray` from its packed cotangent g[ray·16 .. +14]
// (columns as row 3's output) → d rgb_raw [M,3] and d trans_raw [M,5]; the
// static density is frozen-trunk output and gets no gradient.  With c_s,
// c_t the colors, σ_sδ, σ_tδ the densities times δ, T_s, T_t their
// transmittances, T = T_s·T_t, e_x = e^{−σ_xδ}, e = e_s·e_t and the weights
// p_s = T(1−e_s), p_t = T(1−e_t), p = T(1−e), w_s = T_s(1−e_s),
// w_t = T_t(1−e_t):
//   d rgb_raw_c   = (p_s·g_c + w_s·g_{3+c})·c_s(1−c_s)
//   d trans_raw_c = (p_t·g_c + w_t·g_{6+c})·c_t(1−c_t)
//   d trans_raw_3 = (dL/dσ_tδ · δ + g_14)·sigmoid(trans_raw_3)
//   d trans_raw_4 = p_t·g_13·sigmoid(trans_raw_4)    (softplus' = sigmoid)
//   dL/dσ_tδ = F_pt·T·e_t + F_wt·T_t·e_t + g_10·T·e − Σ_{n'>n} v_n'
// with F_pt = Σ_c c_t·g_c + u·g_13, F_wt = Σ_c c_t·g_{6+c} + g_12,
// F_ps = Σ_c c_s·g_c and v = F_ps·p_s + F_pt·p_t + g_10·p + F_wt·w_t, what
// the sample's T and T_t pass to every earlier σ_tδ (one sum: both enter
// with a minus sign).  The transmittances as in row 3: one 2-value
// segmented scan of the lane totals, then products inside the lane; the
// suffix sum one seg_strict_suffix of the lane totals of v.  Every lane
// reads the cotangent row itself (the lanes of a ray read the same
// address: one broadcast load per float4).  A sample past N (zero loads,
// δ = 0) has zero weights and v, so it moves no sum, and is not stored.
template <int S, int L, bool VEC>
__device__ __forceinline__ void composite_st_bwd_seg(
    const float* __restrict__ rgb, const float* __restrict__ tr,
    const float* __restrict__ dens, const float* __restrict__ dist,
    const float* __restrict__ gpk, int ray, int BR, int N, int seg_lane,
    float* __restrict__ d_rgb, float* __restrict__ d_tr) {
  const int first = seg_lane * S;
  const bool live = ray < BR && first < N;
  const size_t row = (size_t)ray * N + first;
  float g[16];                                // column 15 is padding
  seg_load<16, VEC>(gpk + (size_t)ray * 16, ray < BR, g);
  float r[3 * S], t[5 * S], dn[S], dd[S];
  seg_rows<S, 3, VEC>(rgb + row * 3, live, first, N, r);
  seg_rows<S, 5, VEC>(tr + row * 5, live, first, N, t);
  seg_rows<S, 1, VEC>(dens + row, live, first, N, dn);
  seg_rows<S, 1, VEC>(dist + row, live, first, N, dd);

  float cs[3][S], ct[3][S], u[S], sg3[S], sg4[S], sds[S], sdt[S];
  float tot[2] = {0.f, 0.f};                  // static, transient
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      cs[c][s] = sigmoidf_(r[3 * s + c]);
      ct[c][s] = sigmoidf_(t[5 * s + c]);
    }
    u[s] = softplusf_(t[5 * s + 4]);
    sg3[s] = sigmoidf_(t[5 * s + 3]);
    sg4[s] = sigmoidf_(t[5 * s + 4]);
    sds[s] = softplusf_(dn[s]) * dd[s];
    sdt[s] = softplusf_(t[5 * s + 3]) * dd[s];
    tot[0] += sds[s];
    tot[1] += sdt[s];
  }
  seg_exclusive<L, 2>(tot, seg_lane);
  float Ts = expf(-tot[0]), Tt = expf(-tot[1]);

  float ps[S], pt[S], ws[S], wt[S], loc[S], v[S];
  float vtot = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float e_s = expf(-sds[s]), e_t = expf(-sdt[s]), e = e_s * e_t;
    const float T = Ts * Tt;
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
    Ts *= e_s;
    Tt *= e_t;
  }
  float suf = seg_strict_suffix<L>(vtot, seg_lane);
  float o_rgb[3 * S], o_tr[5 * S];
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    const float strict = suf;                 // Σ_{n' > n} v_n'
    suf += v[s];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o_rgb[3 * s + c] =
          (ps[s] * g[c] + ws[s] * g[3 + c]) * cs[c][s] * (1.f - cs[c][s]);
      o_tr[5 * s + c] =
          (pt[s] * g[c] + wt[s] * g[6 + c]) * ct[c][s] * (1.f - ct[c][s]);
    }
    o_tr[5 * s + 3] = ((loc[s] - strict) * dd[s] + g[14]) * sg3[s];
    o_tr[5 * s + 4] = pt[s] * g[13] * sg4[s];
  }
  seg_store<3 * S, VEC>(d_rgb + row * 3, live, first, N, 3, o_rgb);
  seg_store<5 * S, VEC>(d_tr + row * 5, live, first, N, 5, o_tr);
}

// Row 9a per segment: the single-density composite of ray `ray` → the
// packed row out[ray·8 .. +7] = Σ w·c (0-2) | Σ w·depth (3) | Σ w (4) |
// 0, 0, 0, with c = sigmoid(rgb_raw), σδ = softplus(dens_raw)·δ,
// w = T·(1 − e^{−σδ}).  T from one segmented scan of the lane totals,
// then T_{n+1} = T_n·e^{−σδ_n} inside the lane (one expf a sample for
// the weights).  The 8 columns (three of them zero) are reduced by
// recursive halving and written by the lanes that hold them.  A sample
// past N (zero loads, δ = 0) weighs nothing.
template <int S, int L, bool VEC>
__device__ __forceinline__ void composite_coarse_seg(
    const float* __restrict__ rgb, const float* __restrict__ dens,
    const float* __restrict__ dist, const float* __restrict__ depth,
    int ray, int BR, int N, int seg_lane, float* __restrict__ out) {
  const int first = seg_lane * S;
  const bool live = ray < BR && first < N;
  const size_t row = (size_t)ray * N + first;
  float r[3 * S], x[S], dd[S], dp[S];
  seg_rows<S, 3, VEC>(rgb + row * 3, live, first, N, r);
  seg_rows<S, 1, VEC>(dens + row, live, first, N, x);
  seg_rows<S, 1, VEC>(dist + row, live, first, N, dd);
  seg_rows<S, 1, VEC>(depth + row, live, first, N, dp);

  float cs[3][S], sd[S];
  float tot[1] = {0.f};
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) cs[c][s] = sigmoidf_(r[3 * s + c]);
    sd[s] = softplusf_(x[s]) * dd[s];
    tot[0] += sd[s];
  }
  seg_exclusive<L, 1>(tot, seg_lane);
  float T = expf(-tot[0]);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float e = expf(-sd[s]);
    const float w = T * (1.f - e);
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] += w * cs[c][s];
    acc[3] += w * dp[s];
    acc[4] += w;
    T *= e;
  }
  seg_halve<L, 8>(acc, seg_lane);
  seg_store_cols<L, 8>(acc, ray < BR, seg_lane, out + (size_t)ray * 8);
}

}  // namespace
