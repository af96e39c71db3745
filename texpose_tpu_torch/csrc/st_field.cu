// Forward and backward of the texture model's static/transient/light field,
// written by hand for Hopper (sm_90a) and bound to PyTorch through ctypes
// (texpose_tpu_torch/kernels/st_field.py).
//
// Replaces: texpose_tpu/kernels/fused_st_field.py::_run_fwd (the forward
// pallas_call) and ::_run_bwd (the heads-only backward pallas_call, split
// mode: _bwd_kernel + _heads_bwd_subtile).
//
// FORWARD (field_fwd_kernel<EPI_NONE>, field_fwd.cuh; entry st_field_fwd).
// Per 128-row tile:
//   xext [128,kx] -> 8x256 trunk (skip layers re-read xext) -> feat, density
//   feat ⊕ enc⊕pts [128,256+ke] -> RGB head (+ light-latent row) -> rgb_raw
//   feat            [128,256]    -> transient head (+ trans-latent row) -> trans_raw
// Each layer is bf16 x bf16 -> f32 on the tensor cores, then bias (+ latent
// row) in f32, ReLU, and one rounding to bf16 at the next layer's input —
// the arithmetic of the JAX kernel at compute_dtype=bfloat16.  When the
// caller passes a `feat` buffer (training), the trunk's 256 ReLU'd feature
// columns are also stored, in bf16, by TMA from shared memory: the
// backward's residual, layout unchanged ([M,256] row-major).  Evaluation
// passes none and stores nothing more.
// What bounds it: ~1.79 MFLOP per row (234 GFLOP per 131,072-row eval
// chunk, 0.237 ms at 989 TFLOP/s) against ~0.1 KB of row input/output, so
// the card's tensor cores.  The mma.sync form it replaced (64-row tiles,
// fragment-packed weights fetched per warp with __ldg) spent most of its
// time in its epilogues (bias, ReLU, bf16 stores between a warp's products,
// behind block barriers: ≈ 0.8 of 1.1 ms), the rest in mma.sync issue and
// the per-64-row weight re-reads from L2 (3.7 GB per chunk, ≈ 0.26 ms)
// (tools/probe_field_fwd.py).  Design (field_fwd.cuh): one persistent
// block per SM, two warpgroups of 64 rows × 256 columns on wgmma
// m64n256k16 (the accumulator in 128 registers a thread), the weights
// streamed as 64-row K slices through a TMA + mbarrier ring that both
// warpgroups consume, so they are read from L2 once per 128 rows (≈ 1.86
// GB per chunk); the epilogue folds ReLU into the bf16 conversion, stores
// with stmatrix, and takes its biases from registers loaded under the
// layer's last products.  Activations stay in shared memory in wgmma's
// swizzled K-major layout and each layer's epilogue overwrites its own
// input rows: feat in A, the RGB head's hidden layers in X (which held
// xext | enc⊕pts until the RGB head's layer 0), the transient head's over
// feat once the RGB head is done with it.  224 KB of shared memory: two 64
// KB activation buffers and a 3-stage 32 KB weight ring.  The weights come
// in plain bf16 [K, 256] and [K, 8] tiles (kernels/field_fwd.py), built on
// the device.  Rows past M are zero-filled by TMA and never stored; the
// latent row of each row is indexed by row / rows_per_img.  The mma.sync
// form (st_field_fwd_kernel, entry st_field_fwd_mma) is compiled only in
// the measurement build -DFIELD_FWD_MMA_SYNC (tools/probe_field_fwd.py,
// chip_smoke.py's in-call comparison).
//
// BACKWARD (st_field_bwd_kernel<true> + dw_gemm.cu: row 2).  The trunk is
// frozen, so only the heads differentiate.  Per 64-row tile and per head:
// recompute the head's hidden activations from the feat residual exactly
// as the forward does (same packs, same rounding points), then walk the
// layers down:
//   g_{l-1} = (bf16(g_l) · W_lᵀ) ⊙ [h_{l-1} > 0]   (W_lᵀ packed on the host)
//   db_l += Σ_rows g_l                   (f32, before the bf16 rounding)
// g_{l-1} overwrites h_{l-1} in place, so a head needs no gradient buffer
// beyond its activations.  Layer 0 takes no dX (nothing upstream trains);
// the latents' gradient is the per-image row sum of g0 (d_lrow / d_trow),
// which the wrapper finishes in f32 (lightᵀ·d_lrow, d_lrow·W_lᵀ).  The
// output layers (N = 3 and 5) are padded to one n8 tile on both sides.
// The weight gradients dW_l = bf16(h_{l-1})ᵀ · bf16(g_l) (layer 0: featᵀ·g0
// and enc⊕ptsᵀ·g0) sum over all M rows.  The one-kernel form
// (st_field_bwd_kernel<false>, entry st_field_bwd_atomic, compiled only in
// the measurement build -DFIELD_BWD_ONE_KERNEL that chip_smoke.py and
// tools/probe_field_bwd_atomics.py time against this one; the render
// backward st_render.cu still runs its head_bwd) adds every tile's
// partials with f32 atomics, ~400 K per tile, 5.6 ms per 131,072 rows on
// the H100, on one block per SM.  The split form stores each head's
// recomputed hidden activations and layer gradients (bf16, 6 + 6 planes of
// 64 MB at 131,072 rows) and the output gradients (a narrow [M, 16] plane)
// to device memory instead, and dw_gemm.cu forms every dW with wgmma over
// all rows and a fixed-order sum of its split partials: no dW atomics, dW
// the same from run to run.  db and the per-image latent sums stay f32
// sums taken before the bf16 rounding, added across tiles with f32 atomics
// (per column when the tile lies in one image, per row when it straddles
// an image boundary, so images never mix); their order varies run to run.
// What bounds the split form: bytes — ≈0.8 GB of planes written here and
// read again by dw_gemm.cu with the feat residual (≈1.77 GB, 0.53 ms at
// 3.35 TB/s, tools/kernel_bounds.py); the function's own bound is 0.28 ms
// of ~2.1 MFLOP per row (recompute 0.8, dW 0.8, dX 0.5) on the tensor
// cores.  Why split: on the H100 the one-kernel form spent 4.2 of its 5.3
// ms at 131,072 rows in the dW products and their atomics (1.4 ms the
// atomics alone) and ran in 1.1 ms without them
// (tools/probe_field_bwd_atomics.py).  This kernel keeps the one-kernel
// form's tile (143,360 B of shared memory: feat, three hidden buffers,
// enc⊕pts and the padded output gradient; one block per SM).

#include "field_fwd.cuh"
#include "st_heads.cuh"

namespace {

#ifdef FIELD_FWD_MMA_SYNC
__global__ void __launch_bounds__(kThreads, 2)
    st_field_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  st_field_tile(p, smem);
}
#endif

// kSplit (the shipped form, entry st_field_bwd_dx): the dX chain alone —
// both heads' recomputed hidden activations, every layer's gradient and the
// output gradients to the planes of `so` (dw_gemm.cu forms dW), db and the
// latent sums to grads / d_lrow / d_trow.  Without it (entry
// st_field_bwd_atomic, built only with -DFIELD_BWD_ONE_KERNEL for the
// in-call comparison and the attribution probe): the one-kernel form, dW
// partials added with atomics.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    st_field_bwd_kernel(const BwdParams p, const SplitOut so_rgb,
                        const SplitOut so_trans) {
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
  head_bwd<kSplit>(p.n_rgb, true, true, p, fseg, eseg, h, gout, w, b, wT, gw,
                   p.lrow, p.d_lrow, p.g_rgb + (size_t)row0 * 3, 3, row0,
                   warp, lane, so_rgb);
  head_bwd<kSplit>(p.n_trans, false, true, p, fseg, eseg, h, gout, w, b, wT,
                   gw, p.trow, p.d_trow, p.g_trans + (size_t)row0 * 5, 5,
                   row0, warp, lane, so_trans);
}

// The kernels' dynamic shared-memory limits as already set on each device.
int g_smem_limit_fwd[kMaxDevices];

}  // namespace

// Launches the forward on `stream`: the flat pointer and int arguments of
// field_fwd.cuh (FwdPtr, FwdInt; res: the [1, M, 256] feature residual, or
// n_res 0) and the walk's table.  Returns a cudaError_t (0 = launched).
extern "C" int st_field_fwd(const long long* ptrs, const int* ints,
                            const int* table, float min_uncert,
                            void* stream) {
  return launch_field_fwd<EPI_NONE>(ptrs, ints, table, min_uncert, stream,
                                    g_smem_limit_fwd);
}

#ifdef FIELD_FWD_MMA_SYNC
// Measurement build only: launches the mma.sync forward on `stream`;
// returns cudaGetLastError() (0 = launched).  feat may be null (no
// residual).
extern "C" int st_field_fwd_mma(const void* xe, const void* wpack,
                                const void* bias, const void* wpack_heads,
                                const void* bias_heads, const void* lrow,
                                const void* trow, void* rgb, void* dens,
                                void* trans, void* feat, int M, int kx,
                                int ke, int rows_per_img, int n_img,
                                int n_trunk, int n_rgb, int n_trans,
                                int skip_mask, void* stream) {
  static int limits[kMaxDevices];
  if (M <= 0) return 0;
  if (bad_field_shape(kx, ke, rows_per_img, n_img, n_trunk, n_rgb, n_trans))
    return (int)cudaErrorInvalidValue;
  const Params p = field_params(xe, wpack, bias, wpack_heads, bias_heads,
                                lrow, trow, rgb, dens, trans, feat, M, kx, ke,
                                rows_per_img, n_img, n_trunk, n_rgb, n_trans,
                                skip_mask);
  const int smem = field_smem(kx, ke);
  cudaError_t e = ensure_smem(st_field_fwd_kernel, smem, limits);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTile - 1) / kTile);
  st_field_fwd_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
#endif

namespace {

// The backward entries' shared checks and launch: kSplit the dX chain,
// else the one-kernel form (measurement build only).
template <bool kSplit>
int launch_bwd(const void* feat, const void* ep, const void* g_rgb,
               const void* g_trans, const void* wpack_heads,
               const void* bias_heads, const void* wpackT, const void* lrow,
               const void* trow, void* grads, void* d_lrow, void* d_trow,
               void* hplanes, void* gplanes, void* gnarrow, int M, int ke,
               int rows_per_img, int n_img, int n_rgb, int n_trans,
               void* stream) {
  static int limits[kMaxDevices];
  if (M <= 0) return 0;
  if (bad_bwd_shape(ke, rows_per_img, n_img, n_rgb, n_trans))
    return (int)cudaErrorInvalidValue;
  BwdParams p = bwd_params(feat, ep, wpack_heads, bias_heads, wpackT, lrow,
                           trow, grads, d_lrow, d_trow, M, ke, rows_per_img,
                           n_img, n_rgb, n_trans);
  p.g_rgb = static_cast<const float*>(g_rgb);
  p.g_trans = static_cast<const float*>(g_trans);
  // the transient head's planes follow the RGB head's n_rgb - 1
  const size_t skip = (size_t)(n_rgb - 1) * M * kHidden;
  bf16* const hp = static_cast<bf16*>(hplanes);
  bf16* const gp = static_cast<bf16*>(gplanes);
  bf16* const gn = static_cast<bf16*>(gnarrow);
  const SplitOut so_rgb = {hp, gp, gn, 0};
  const SplitOut so_trans = {hp ? hp + skip : nullptr,
                             gp ? gp + skip : nullptr, gn, 8};
  const int smem = heads_bwd_smem(ke, n_rgb, n_trans);
  cudaError_t e = ensure_smem(st_field_bwd_kernel<kSplit>, smem, limits);
  if (e != cudaSuccess) return (int)e;
  st_field_bwd_kernel<kSplit><<<(M + kTile - 1) / kTile, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      p, so_rgb, so_trans);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the heads' backward dX chain (phase (a) of the split form) on
// `stream`: db into grads and the latent row sums into d_lrow / d_trow
// (all zeroed by the caller); both heads' hidden activations and layer
// gradients into hplanes / gplanes [n_rgb - 1 + n_trans - 1, M, 256] bf16
// (RGB head first) and the output gradients into gnarrow [M, 16] bf16
// (RGB columns 0-2, transient 8-12).  dW comes from dw_gemm.cu.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int st_field_bwd_dx(const void* feat, const void* ep,
                               const void* g_rgb, const void* g_trans,
                               const void* wpack_heads,
                               const void* bias_heads, const void* wpackT,
                               const void* lrow, const void* trow,
                               void* grads, void* d_lrow, void* d_trow,
                               void* hplanes, void* gplanes, void* gnarrow,
                               int M, int ke, int rows_per_img, int n_img,
                               int n_rgb, int n_trans, void* stream) {
  return launch_bwd<true>(feat, ep, g_rgb, g_trans, wpack_heads, bias_heads,
                          wpackT, lrow, trow, grads, d_lrow, d_trow, hplanes,
                          gplanes, gnarrow, M, ke, rows_per_img, n_img, n_rgb,
                          n_trans, stream);
}

#ifdef FIELD_BWD_ONE_KERNEL
// Measurement build only.  Launches the one-kernel heads' backward (dW
// partials as f32 atomics) on `stream`; grads, d_lrow and d_trow must be
// zeroed by the caller.  Returns cudaGetLastError() (0 = launched).
extern "C" int st_field_bwd_atomic(const void* feat, const void* ep,
                                   const void* g_rgb, const void* g_trans,
                                   const void* wpack_heads,
                                   const void* bias_heads,
                                   const void* wpackT, const void* lrow,
                                   const void* trow, void* grads,
                                   void* d_lrow, void* d_trow, int M, int ke,
                                   int rows_per_img, int n_img, int n_rgb,
                                   int n_trans, void* stream) {
  return launch_bwd<false>(feat, ep, g_rgb, g_trans, wpack_heads, bias_heads,
                           wpackT, lrow, trow, grads, d_lrow, d_trow, nullptr,
                           nullptr, nullptr, M, ke, rows_per_img, n_img,
                           n_rgb, n_trans, stream);
}
#endif
