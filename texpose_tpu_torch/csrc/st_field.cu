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
// with the coarse field (coarse_field.cu); the tile bodies of both kernels
// are in st_heads.cuh, shared with the render kernels (st_render.cu).
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

#include "st_heads.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 2)
    st_field_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  st_field_tile(p, smem);
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
  head_bwd(p.n_rgb, true, true, p, fseg, eseg, h, gout, w, b, wT, gw, p.lrow,
           p.d_lrow, p.g_rgb + (size_t)row0 * 3, 3, row0, warp, lane);
  head_bwd(p.n_trans, false, true, p, fseg, eseg, h, gout, w, b, wT, gw,
           p.trow, p.d_trow, p.g_trans + (size_t)row0 * 5, 5, row0, warp,
           lane);
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
  if (bad_field_shape(kx, ke, rows_per_img, n_img, n_trunk, n_rgb, n_trans))
    return (int)cudaErrorInvalidValue;
  const Params p = field_params(xe, wpack, bias, wpack_heads, bias_heads,
                                lrow, trow, rgb, dens, trans, feat, M, kx, ke,
                                rows_per_img, n_img, n_trunk, n_rgb, n_trans,
                                skip_mask);
  const int smem = field_smem(kx, ke);
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
  if (bad_bwd_shape(ke, rows_per_img, n_img, n_rgb, n_trans))
    return (int)cudaErrorInvalidValue;
  BwdParams p = bwd_params(feat, ep, wpack_heads, bias_heads, wpackT, lrow,
                           trow, grads, d_lrow, d_trow, M, ke, rows_per_img,
                           n_img, n_rgb, n_trans);
  p.g_rgb = static_cast<const float*>(g_rgb);
  p.g_trans = static_cast<const float*>(g_trans);
  const int smem = heads_bwd_smem(ke, n_rgb, n_trans);
  cudaError_t e = ensure_smem(st_field_bwd_kernel, smem, g_smem_limit_bwd);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTile - 1) / kTile);
  st_field_bwd_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
