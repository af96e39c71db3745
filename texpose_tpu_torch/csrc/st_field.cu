// Forward and backward of the texture model's static/transient/light field,
// written by hand for Hopper (sm_90a) and bound to PyTorch through ctypes
// (texpose_tpu_torch/kernels/st_field.py).
//
// Replaces: texpose_tpu/kernels/fused_st_field.py::_run_fwd (the forward
// pallas_call) and ::_run_bwd (the heads-only backward pallas_call, split
// mode: _bwd_kernel + _heads_bwd_subtile).
//
// FORWARD (st_field_fwd_kernel).  Per 64-row tile, entirely in shared memory:
//   xext [64,kx]  -> 8x256 trunk (skip layers re-read xext) -> feat, density
//   feat ⊕ enc⊕pts [64,256+ke] -> RGB head (+ light-latent row) -> rgb_raw
//   feat            [64,256]    -> transient head (+ trans-latent row) -> trans_raw
// Each layer is bf16 x bf16 -> f32 on the tensor cores (mma.sync m16n8k16),
// then bias (+ latent row) in f32, ReLU, and one rounding to bf16 at the next
// layer's input — the arithmetic of the JAX kernel at compute_dtype=bfloat16.
// When the caller passes a `feat` buffer (training), the trunk's 256 ReLU'd
// feature columns are also stored, in bf16, straight from shared memory: the
// backward's residual.  Evaluation passes null and stores nothing more.
//
// What bounds it: ~1.79 MFLOP per row (234 GFLOP per 131,072-row eval
// chunk) against ~0.1 KB of row input/output, so the card's tensor cores;
// the ~1.8 MB of bf16 weights are re-read from L2 by every tile.
// Design against that: activations never leave shared memory (three
// 64x264 bf16 ping-pong buffers, rows padded so ldmatrix and the epilogue
// stores are bank-conflict free); weights are packed once on the host in
// mma fragment order so a warp fetches each 16x8 B tile with one coalesced
// 256-byte load, prefetched one k-step ahead; every warp owns all 64 rows and
// a disjoint 32-column slice, so each weight element is read once per tile.
// 114,688 B of shared memory per block lets two blocks share an SM.
// The trunk and the mma/ldmatrix building blocks are in trunk.cuh, shared
// with the coarse field (coarse_field.cu).
// Rows past M are zero-filled on load and never stored, so M needs no
// tiling contract; the latent row of each row is indexed by
// row / rows_per_img.
//
// BACKWARD (st_field_bwd_kernel).  The trunk is frozen, so only the heads
// differentiate.  Per 64-row tile and per head: recompute the head's hidden
// activations from the feat residual exactly as the forward does (same
// packs, same rounding points), then walk the layers down:
//   dW_l += h_{l-1}ᵀ · bf16(g_l)        (ldmatrix.trans of both operands)
//   g_{l-1} = (bf16(g_l) · W_lᵀ) ⊙ [h_{l-1} > 0]   (W_lᵀ packed on the host)
//   db_l += Σ_rows g_l                   (f32, before the bf16 rounding)
// g_{l-1} overwrites h_{l-1} in place once dW_l has read it, so a head needs
// no gradient buffer beyond its activations.  Layer 0 takes no dX (nothing
// upstream trains): its dW is featᵀ·g0 (and enc⊕ptsᵀ·g0 for RGB), and the
// latents' gradient is the per-image row sum of g0 (d_lrow / d_trow), which
// the wrapper finishes in f32 (lightᵀ·d_lrow, d_lrow·W_lᵀ).  The output
// layers (N = 3 and 5) are padded to one n8 tile on both sides.
// Cross-tile reduction: every tile adds its dW/db partials to the zeroed f32
// output with atomicAdd (no second pass; ~400 K adds per tile land in the
// 1.8 MB gradient buffer, which stays in L2).  The summation order therefore
// varies from run to run; each sum is over M f32 terms.  Per-image sums use
// one add per column when the tile lies in one image and per-row adds when
// it straddles an image boundary, so images never mix.
// What bounds it: ~2.1 MFLOP per row (forward recompute 0.8, dW 0.8, dX
// 0.5; 280 GFLOP per 131,072 rows — tensor cores) plus the atomics;
// 143,360 B of shared memory (feat, three hidden buffers, enc⊕pts and the
// padded output gradient) allow one block per SM.

#include "trunk.cuh"

namespace {

constexpr int kMaxHeadLayers = 16;

struct Params {
  const bf16* xe;        // [M, kx+ke] bf16: xext | enc⊕pts, zero padded
  const uint2* wpack;    // trunk layers in walk order, fragment packed
  const float* bias;     // trunk biases in walk order, padded to 256 or 8
  const uint2* wpack_heads;  // RGB head then transient head, fragment packed
  const float* bias_heads;
  const float* lrow;     // [n_img, 256] light latent @ its layer-0 rows
  const float* trow;     // [n_img, 256] trans latent @ its layer-0 rows
  float* rgb;            // [M, 3]
  float* dens;           // [M, 1]
  float* trans;          // [M, 5]
  bf16* feat;            // [M, 256] or null
  int M, kx, ke, rows_per_img, n_img, n_trunk, n_rgb, n_trans;
  unsigned skip_mask;
};

// One head: layer 0 reads feat (+ `extra`), adds the latent row; the last
// layer writes `ncols` raw outputs.  Hidden activations alternate between the
// two buffers that are not `feat`.
__device__ __forceinline__ void run_head(int n, const Seg& extra,
                                         const float* lat, float* out,
                                         int ncols, bf16* const (&act)[3],
                                         int feat, const uint2*& w,
                                         const float*& b, const Params& p,
                                         const Seg& none, int row0, int nt0,
                                         int warp, int lane) {
  int cur = feat;
  for (int li = 0; li < n; ++li) {
    const Seg a1 = {act[cur], kActStride, kHidden};
    const Seg a2 = li == 0 ? extra : none;
    const int kt_total = (a1.k + a2.k) >> 4;
    if (li < n - 1) {
      const int nxt = cur == feat ? (feat + 1) % 3 : 3 - cur - feat;
      float acc[4][kTilesPerWarp][4];
      warp_gemm<kTilesPerWarp>(acc, a1, a2, w, nt0, lane);
      store_hidden<kTilesPerWarp>(acc, act[nxt], b, li == 0 ? lat : nullptr,
                                  p.rows_per_img, p.n_img, row0, nt0, lane);
      w += (size_t)kt_total * (kHidden / 8) * 32;
      b += kHidden;
      cur = nxt;
    } else {
      if (warp == 0) {
        float acc[4][1][4];
        warp_gemm<1>(acc, a1, a2, w, 0, lane);
        store_out(acc, out, ncols, b, row0, p.M, lane);
      }
      w += (size_t)kt_total * 32;
      b += 8;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    st_field_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const act[3] = {
      reinterpret_cast<bf16*>(smem),
      reinterpret_cast<bf16*>(smem) + kTile * kActStride,
      reinterpret_cast<bf16*>(smem) + 2 * kTile * kActStride};
  bf16* const xe = act[2] + kTile * kActStride;
  const int xw = p.kx + p.ke;
  const int xs = xw + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTile;
  const int nt0 = warp * kTilesPerWarp;

  // stage the tile's xext | enc⊕pts rows (rows past M = 0)
  load_rows(xe, xs, p.xe, xw, row0, p.M);
  __syncthreads();

  const Seg none = {xe, xs, 0};
  const Seg xseg = {xe, xs, p.kx};
  const Seg eseg = {xe + p.kx, xs, p.ke};
  // trunk: layer li reads act[cur] (xext at layer 0; skip layers add xext)
  const int feat = trunk_forward(xseg, none, act, p.wpack, p.bias, p.n_trunk,
                                 p.skip_mask, p.dens, nullptr, row0, p.M,
                                 warp, lane);
  // the backward's residual: the feature tile as the heads read it
  if (p.feat != nullptr) store_tile(p.feat, act[feat], row0, p.M);
  const uint2* wh = p.wpack_heads;
  const float* bh = p.bias_heads;
  run_head(p.n_rgb, eseg, p.lrow, p.rgb, 3, act, feat, wh, bh, p, none, row0,
           nt0, warp, lane);
  run_head(p.n_trans, none, p.trow, p.trans, 5, act, feat, wh, bh, p, none,
           row0, nt0, warp, lane);
}

// ------------------------------------------------------------------ backward

struct BwdParams {
  const bf16* feat;          // [M, 256] the forward's residual
  const bf16* ep;            // [M, ke] enc⊕pts, zero padded
  const float* g_rgb;        // [M, 3]
  const float* g_trans;      // [M, 5]
  const uint2* wpack_heads;  // the forward's head packs (same walk order)
  const float* bias_heads;
  const uint2* wpackT;       // W_lᵀ packs: RGB layers 1..n-1, then transient
  const float* lrow;         // [n_img, 256]
  const float* trow;
  float* grads;              // zeroed f32; per head and layer: dW [, dW_ep], db
  float* d_lrow;             // [n_img, 256] zeroed
  float* d_trow;
  int M, ke, rows_per_img, n_img, n_rgb, n_trans;
};

// dX epilogue: g = acc ⊙ [h > 0] written in place over h (bf16), column
// sums of the f32 g added to db and, for layer 0, to the per-image latent
// gradient rows dlat.
__device__ __forceinline__ void store_grad(
    const float (&acc)[4][kTilesPerWarp][4], bf16* h, float* db, float* dlat,
    const BwdParams& p, int row0, int nt0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  float v[4][kTilesPerWarp][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = i * 16 + g + hh * 8;
#pragma unroll
      for (int t = 0; t < kTilesPerWarp; ++t) {
        const int col = (nt0 + t) * 8 + 2 * q;
        __nv_bfloat162* ptr =
            reinterpret_cast<__nv_bfloat162*>(h + r * kActStride + col);
        const float2 hv = __bfloat1622float2(*ptr);
        const float v0 = hv.x > 0.f ? acc[i][t][2 * hh] : 0.f;
        const float v1 = hv.y > 0.f ? acc[i][t][2 * hh + 1] : 0.f;
        v[i][t][2 * hh] = v0;
        v[i][t][2 * hh + 1] = v1;
        *ptr = __floats2bfloat162_rn(v0, v1);
      }
    }
  const int last = min(row0 + kTile, p.M) - 1;
  const int img_lo = min(row0 / p.rows_per_img, p.n_img - 1);
  const int img_hi = min(last / p.rows_per_img, p.n_img - 1);
  const bool one_img = img_lo == img_hi;
#pragma unroll
  for (int t = 0; t < kTilesPerWarp; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) s += v[i][t][e] + v[i][t][2 + e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      const int col = (nt0 + t) * 8 + 2 * q + e;
      if (g == 0) {
        atomicAdd(db + col, s);
        if (dlat != nullptr && one_img)
          atomicAdd(dlat + (size_t)img_lo * kHidden + col, s);
      }
    }
  if (dlat != nullptr && !one_img) {
    // the tile straddles an image boundary: per-row adds keep images apart
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + i * 16 + g + hh * 8;
        const int img = min(row / p.rows_per_img, p.n_img - 1);
#pragma unroll
        for (int t = 0; t < kTilesPerWarp; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = v[i][t][2 * hh + e];
            if (x != 0.f)
              atomicAdd(dlat + (size_t)img * kHidden + (nt0 + t) * 8 + 2 * q + e,
                        x);
          }
      }
  }
}

// Forward recompute + backward of one head for the block's tile.
//   h[0..n-2]: hidden activation buffers, later the gradients in place
//   gout: [64][kOutStride] bf16 output gradient (columns ≥ ncols zero)
__device__ void head_bwd(int n, bool rgb, const BwdParams& p, const Seg& feat,
                         const Seg& ep, bf16* const* h, bf16* gout,
                         const uint2*& w, const float*& b, const uint2*& wT,
                         float*& gw, const float* lat_rows, float* dlat,
                         const float* g_in, int ncols, int row0, int warp,
                         int lane) {
  const int nt0 = warp * kTilesPerWarp;
  const Seg none = {ep.base, ep.stride, 0};
  const uint2* wTl[kMaxHeadLayers];
  float* dWl[kMaxHeadLayers];
  float* dbl[kMaxHeadLayers];
  float* dWep = nullptr;

  // ---- forward recompute of the hidden layers (as run_head) ----
  for (int li = 0; li < n - 1; ++li) {
    const Seg a1 = li == 0 ? feat : Seg{h[li - 1], kActStride, kHidden};
    const Seg a2 = (li == 0 && rgb) ? ep : none;
    const int kt_total = (a1.k + a2.k) >> 4;
    float acc[4][kTilesPerWarp][4];
    warp_gemm<kTilesPerWarp>(acc, a1, a2, w, nt0, lane);
    store_hidden<kTilesPerWarp>(acc, h[li], b, li == 0 ? lat_rows : nullptr,
                                p.rows_per_img, p.n_img, row0, nt0, lane);
    w += (size_t)kt_total * (kHidden / 8) * 32;
    b += kHidden;
    __syncthreads();
  }
  w += (size_t)(kHidden >> 4) * 32;                // output layer, unused
  b += 8;

  // ---- this head's slices of the gradient output and the Wᵀ packs ----
  for (int li = 0; li < n; ++li) {
    dWl[li] = gw;
    if (li < n - 1) {
      gw += kHidden * kHidden;
      if (li == 0 && rgb) {
        dWep = gw;
        gw += p.ke * kHidden;
      }
      dbl[li] = gw;
      gw += kHidden;
    } else {
      gw += kHidden * 8;
      dbl[li] = gw;
      gw += 8;
    }
  }
  for (int li = 1; li < n; ++li) {
    wTl[li] = wT;
    wT += (size_t)(li == n - 1 ? 1 : kHidden >> 4) * (kHidden / 8) * 32;
  }

  // ---- output gradient: bf16 copy for the products, f32 column sums ----
  for (int i = threadIdx.x; i < kTile * kOutPad; i += kThreads) {
    const int r = i / kOutPad, c = i - r * kOutPad;
    float x = 0.f;
    if (c < ncols && row0 + r < p.M)
      x = __ldg(g_in + (size_t)(row0 + r) * ncols + c);
    gout[r * kOutStride + c] = __float2bfloat16_rn(x);
  }
  if (warp < ncols) {
    float s = 0.f;
    for (int r = lane; r < kTile; r += 32)
      if (row0 + r < p.M) s += __ldg(g_in + (size_t)(row0 + r) * ncols + warp);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) atomicAdd(dbl[n - 1] + warp, s);
  }
  __syncthreads();

  // ---- layers n-1 .. 1: dW_l, then g_{l-1} in place over h[l-1] ----
  for (int li = n - 1; li >= 1; --li) {
    const bf16* gl = li == n - 1 ? gout : h[li];
    const int sg = li == n - 1 ? kOutStride : kActStride;
    if (li == n - 1)
      warp_dw<2, 1>(h[li - 1], kActStride, warp * 32, 2, gl, sg, 0, dWl[li],
                    8, lane);
    else
      for (int i0 = 0; i0 < kHidden; i0 += 64)
        warp_dw<4, kTilesPerWarp>(h[li - 1], kActStride, i0, 4, gl, sg,
                                  nt0 * 8, dWl[li], kHidden, lane);
    __syncthreads();
    {
      const Seg a1 = {gl, sg, li == n - 1 ? kOutPad : kHidden};
      float acc[4][kTilesPerWarp][4];
      warp_gemm<kTilesPerWarp>(acc, a1, none, wTl[li], nt0, lane);
      store_grad(acc, h[li - 1], dbl[li - 1], li == 1 ? dlat : nullptr, p,
                 row0, nt0, lane);
    }
    __syncthreads();
  }

  // ---- layer 0: dW of the feat block (and of the enc⊕pts block) ----
  for (int i0 = 0; i0 < kHidden; i0 += 64)
    warp_dw<4, kTilesPerWarp>(feat.base, kActStride, i0, 4, h[0], kActStride,
                              nt0 * 8, dWl[0], kHidden, lane);
  if (rgb)
    for (int i0 = 0; i0 < p.ke; i0 += 64)
      warp_dw<4, kTilesPerWarp>(ep.base, ep.stride, i0,
                                min(4, (p.ke - i0) >> 4), h[0], kActStride,
                                nt0 * 8, dWep, kHidden, lane);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    st_field_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_max = max(p.n_rgb, p.n_trans);
  bf16* const feat = reinterpret_cast<bf16*>(smem);
  bf16* h[kMaxHeadLayers];
  for (int i = 0; i < n_max - 1; ++i) h[i] = feat + (i + 1) * kTile * kActStride;
  bf16* const ep = feat + n_max * kTile * kActStride;
  const int es = p.ke + 8;
  bf16* const gout = ep + kTile * es;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTile;

  // stage the tile's feat and enc⊕pts rows (rows past M = 0)
  load_rows(feat, kActStride, p.feat, kHidden, row0, p.M);
  load_rows(ep, es, p.ep, p.ke, row0, p.M);
  __syncthreads();

  const Seg fseg = {feat, kActStride, kHidden};
  const Seg eseg = {ep, es, p.ke};
  const uint2* w = p.wpack_heads;
  const float* b = p.bias_heads;
  const uint2* wT = p.wpackT;
  float* gw = p.grads;
  head_bwd(p.n_rgb, true, p, fseg, eseg, h, gout, w, b, wT, gw, p.lrow,
           p.d_lrow, p.g_rgb, 3, row0, warp, lane);
  head_bwd(p.n_trans, false, p, fseg, eseg, h, gout, w, b, wT, gw, p.trow,
           p.d_trow, p.g_trans, 5, row0, warp, lane);
}

// The kernels' dynamic shared-memory limits as already set on each device.
int g_smem_limit_fwd[kMaxDevices];
int g_smem_limit_bwd[kMaxDevices];

}  // namespace

// Launches the forward on `stream`; returns cudaGetLastError() (0 =
// launched).  feat may be null (no residual).
extern "C" int st_field_fwd(const void* xe, const void* wpack,
                            const void* bias, const void* wpack_heads,
                            const void* bias_heads, const void* lrow,
                            const void* trow, void* rgb, void* dens,
                            void* trans, void* feat, int M, int kx, int ke,
                            int rows_per_img, int n_img, int n_trunk,
                            int n_rgb, int n_trans, int skip_mask,
                            void* stream) {
  if (M <= 0) return 0;
  if (kx % 16 || ke % 16 || kx <= 0 || ke <= 0 || rows_per_img <= 0 ||
      n_img <= 0 || n_trunk < 1 || n_rgb < 2 || n_trans < 2)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xe = static_cast<const bf16*>(xe);
  p.wpack = static_cast<const uint2*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.wpack_heads = static_cast<const uint2*>(wpack_heads);
  p.bias_heads = static_cast<const float*>(bias_heads);
  p.lrow = static_cast<const float*>(lrow);
  p.trow = static_cast<const float*>(trow);
  p.rgb = static_cast<float*>(rgb);
  p.dens = static_cast<float*>(dens);
  p.trans = static_cast<float*>(trans);
  p.feat = static_cast<bf16*>(feat);
  p.M = M;
  p.kx = kx;
  p.ke = ke;
  p.rows_per_img = rows_per_img;
  p.n_img = n_img;
  p.n_trunk = n_trunk;
  p.n_rgb = n_rgb;
  p.n_trans = n_trans;
  p.skip_mask = static_cast<unsigned>(skip_mask);
  const int smem =
      (3 * kTile * kActStride + kTile * (kx + ke + 8)) * (int)sizeof(bf16);
  cudaError_t e = ensure_smem(st_field_fwd_kernel, smem, g_smem_limit_fwd);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTile - 1) / kTile);
  st_field_fwd_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Launches the heads' backward on `stream`; grads, d_lrow and d_trow must
// be zeroed by the caller (the kernel adds into them).  Returns
// cudaGetLastError() (0 = launched).
extern "C" int st_field_bwd(const void* feat, const void* ep,
                            const void* g_rgb, const void* g_trans,
                            const void* wpack_heads, const void* bias_heads,
                            const void* wpackT, const void* lrow,
                            const void* trow, void* grads, void* d_lrow,
                            void* d_trow, int M, int ke, int rows_per_img,
                            int n_img, int n_rgb, int n_trans, void* stream) {
  if (M <= 0) return 0;
  if (ke % 16 || ke <= 0 || rows_per_img <= 0 || n_img <= 0 || n_rgb < 2 ||
      n_trans < 2 || n_rgb > kMaxHeadLayers || n_trans > kMaxHeadLayers)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.feat = static_cast<const bf16*>(feat);
  p.ep = static_cast<const bf16*>(ep);
  p.g_rgb = static_cast<const float*>(g_rgb);
  p.g_trans = static_cast<const float*>(g_trans);
  p.wpack_heads = static_cast<const uint2*>(wpack_heads);
  p.bias_heads = static_cast<const float*>(bias_heads);
  p.wpackT = static_cast<const uint2*>(wpackT);
  p.lrow = static_cast<const float*>(lrow);
  p.trow = static_cast<const float*>(trow);
  p.grads = static_cast<float*>(grads);
  p.d_lrow = static_cast<float*>(d_lrow);
  p.d_trow = static_cast<float*>(d_trow);
  p.M = M;
  p.ke = ke;
  p.rows_per_img = rows_per_img;
  p.n_img = n_img;
  p.n_rgb = n_rgb;
  p.n_trans = n_trans;
  const int n_max = n_rgb > n_trans ? n_rgb : n_trans;
  const int smem = (n_max * kTile * kActStride + kTile * (ke + 8) +
                    kTile * kOutStride) *
                   (int)sizeof(bf16);
  cudaError_t e = ensure_smem(st_field_bwd_kernel, smem, g_smem_limit_bwd);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTile - 1) / kTile);
  st_field_bwd_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
