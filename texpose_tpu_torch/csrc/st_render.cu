// The texture model's render in one kernel per direction: the ST field with
// the dual-density composite fused in (forward), and the composite VJP fused
// into the heads' backward (backward), written by hand for Hopper (sm_90a)
// and bound to PyTorch through ctypes (texpose_tpu_torch/kernels/
// st_render.py).
//
// Replaces: texpose_tpu/kernels/fused_st_render.py::_run_fwd (the mega
// forward pallas_call, _mega_fwd_kernel) and ::_run_bwd (the fully fused
// backward pallas_call, _mega_bwd_kernel, taken with TEXPOSE_MEGA_FULLBWD=1).
//
// FORWARD (field_fwd_kernel<EPI_ST>, field_fwd.cuh; entry st_render_fwd).
// Per 128-row tile, the field forward of st_field.cu (trunk → RGB head →
// transient head, the same weight tiles and bf16 rounding points); then,
// after the block's last tile, a composite epilogue: each warpgroup's
// 64-row halves hold whole rays (N divides 64), and one warp per ray runs
// composite_st_ray (composite_st.cuh) and writes the packed [BR,16] row.
// The raw outputs rgb_raw [M,3], dens_raw [M,1], trans_raw [M,5] go to
// device memory in both variants and the epilogue reads them back (they
// stay in L2: 36 B a row); evaluation hands the kernel scratch buffers for them,
// training keeps them as the hybrid backward's residuals and also passes
// `feat` for the [M,256] bf16 feature residual.  The TPU kernel's eight
// [BR,N] channel planes and its one-hot re-interleave have no counterpart:
// the CUDA composites read the flat layout.
// What bounds it: the field's ~1.79 MFLOP per row on the tensor cores (0.237
// ms at 131,072 rows); the composite adds ~60 f32 operations and the dist /
// depth reads (8 B a sample).  Design: st_field.cu's (wgmma fed by a TMA
// weight ring, 128-row tiles, 224 KB of shared memory, one persistent block
// per SM); the composite keeps every intermediate in registers.  The
// forward recomputes of the backward below stay on mma.sync (head_forward)
// and sum each k16 step's products in another unit than this forward;
// chip_smoke.py reports the largest raw-output difference between the two.
// The mma.sync form (st_render_fwd_kernel, entry st_render_fwd_mma) is
// compiled only in the measurement build -DFIELD_FWD_MMA_SYNC.
//
// BACKWARD (st_render_bwd_kernel).  Per 64-row tile, from the forward's
// feature residual, enc⊕pts, dens_raw, the intervals and the packed
// cotangent g [BR,16]:
//   1. the transient head's forward from feat (hidden layers into the hidden
//      buffers, its 5 raw outputs into a shared f32 tile);
//   2. the RGB head's forward, keeping its hidden activations (3 raw outputs
//      into a shared f32 tile);
//   3. one warp per ray: composite_st_ray_bwd on the shared raw tiles →
//      d rgb_raw [64,3] and d trans_raw [64,5] in shared memory — they never
//      reach device memory;
//   4. the heads' backward of st_field.cu (head_bwd: dW/db by ldmatrix.trans
//      + mma.sync, f32 atomics across tiles, the per-image latent row sums),
//      the RGB head from the activations step 2 kept, the transient head
//      after recomputing its hidden layers (its step-1 activations were
//      overwritten: feat and three hidden buffers are all the shared memory
//      one block per SM has room for beside the rest).
// Both recomputes use the heads' fragment packs, the forward's layer order
// and rounding points, so the two backward routes (this one and
// composite_st_bwd → st_field_bwd) see the forward's composite up to the
// summation order of the products.  The host finishes as for st_field_bwd.
// What bounds it: ~2.5 MFLOP per row on the tensor cores (st_field_bwd's
// 2.1 plus the output layers and the transient head's second recompute,
// 0.4) plus the atomics; 147,456 B of shared memory (st_field_bwd's 143,360
// plus the tile's raw outputs and their gradients, [64,8] f32 each) allow
// one block per SM.

#include "field_fwd.cuh"
#include "st_heads.cuh"

namespace {

#ifdef FIELD_FWD_MMA_SYNC
// The mma.sync forward (measurement build only).
struct RenderParams {
  Params f;                // the field; raw outputs to f.rgb/f.dens/f.trans
  const float* dist;       // [BR, N] intervals
  const float* depth;      // [BR, N] sample depths
  float* out;              // [BR, 16] packed composite
  int N;                   // samples per ray, a divisor of 64
  float min_uncert;
};

__global__ void __launch_bounds__(kThreads, 2)
    st_render_fwd_kernel(const RenderParams rp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Params& p = rp.f;
  st_field_tile(p, smem);            // ends in a block barrier

  // composite epilogue: the tile holds whole rays (N divides 64)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int N = rp.N;
  const int rays = kTile / N;
  const int ray0 = blockIdx.x * kTile / N;
  for (int r = warp; r < rays; r += kWarps) {
    const int ray = ray0 + r;
    const size_t row = (size_t)ray * N;
    if (row >= (size_t)p.M) break;                  // uniform per warp
    float* out = rp.out + (size_t)ray * 16;
    if (N <= 32)
      composite_st_ray<1>(p.rgb + row * 3, p.trans + row * 5, p.dens + row,
                          rp.depth + row, rp.dist + row, N, rp.min_uncert,
                          lane, out);
    else
      composite_st_ray<2>(p.rgb + row * 3, p.trans + row * 5, p.dens + row,
                          rp.depth + row, rp.dist + row, N, rp.min_uncert,
                          lane, out);
  }
}
#endif  // FIELD_FWD_MMA_SYNC

struct RenderBwdParams {
  BwdParams b;             // the heads' backward (b.g_rgb / b.g_trans unused)
  const float* dens;       // [M, 1] the forward's dens_raw
  const float* dist;       // [BR, N]
  const float* g;          // [BR, 16] cotangent of the packed composite
  int N;
};

__global__ void __launch_bounds__(kThreads, 1)
    st_render_bwd_kernel(const RenderBwdParams rp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdParams& p = rp.b;
  const int n_max = max(p.n_rgb, p.n_trans);
  bf16* const feat = reinterpret_cast<bf16*>(smem);
  bf16* h[kMaxHeadLayers];
  for (int i = 0; i < n_max - 1; ++i) h[i] = feat + (i + 1) * kTile * kActStride;
  bf16* const ep = feat + n_max * kTile * kActStride;
  const int es = p.ke + 8;
  bf16* const gout = ep + kTile * es;
  float* const rgb = reinterpret_cast<float*>(gout + kTile * kOutStride);
  float* const tr = rgb + kTile * 3;                  // [64,3] then [64,5]
  float* const d_rgb = tr + kTile * 5;
  float* const d_tr = d_rgb + kTile * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTile;

  // stage the tile's feat and enc⊕pts rows (rows past M = 0)
  load_rows(feat, kActStride, p.feat, kHidden, row0, p.M);
  load_rows(ep, es, p.ep, p.ke, row0, p.M);
  __syncthreads();

  const Seg fseg = {feat, kActStride, kHidden};
  const Seg eseg = {ep, es, p.ke};
  // 1-2. both heads' raw outputs: the transient head first (its hidden
  // layers are overwritten next), then the RGB head, whose hidden
  // activations stay for its backward
  const uint2* w = p.wpack_heads;
  const float* b = p.bias_heads;
  skip_head(p.n_rgb, kHidden + p.ke, w, b);
  head_forward(p.n_trans, false, p, fseg, eseg, h, w, b, p.trow, tr, 5, row0,
               warp, lane);
  w = p.wpack_heads;
  b = p.bias_heads;
  head_forward(p.n_rgb, true, p, fseg, eseg, h, w, b, p.lrow, rgb, 3, row0,
               warp, lane);

  // 3. the composite's VJP, one warp per ray, shared memory in and out
  const int N = rp.N;
  const int rays = kTile / N;
  const int ray0 = row0 / N;
  for (int r = warp; r < rays; r += kWarps) {
    const int ray = ray0 + r;
    const size_t row = (size_t)ray * N;
    if (row >= (size_t)p.M) break;                  // uniform per warp
    const int lr = r * N;                           // the ray's first tile row
    if (N <= 32)
      composite_st_ray_bwd<1>(rgb + lr * 3, tr + lr * 5, rp.dens + row,
                              rp.dist + row, rp.g + (size_t)ray * 16, N, lane,
                              d_rgb + lr * 3, d_tr + lr * 5);
    else
      composite_st_ray_bwd<2>(rgb + lr * 3, tr + lr * 5, rp.dens + row,
                              rp.dist + row, rp.g + (size_t)ray * 16, N, lane,
                              d_rgb + lr * 3, d_tr + lr * 5);
  }
  __syncthreads();

  // 4. the heads' backward from the shared output gradients
  w = p.wpack_heads;
  b = p.bias_heads;
  const uint2* wT = p.wpackT;
  float* gw = p.grads;
  head_bwd(p.n_rgb, true, false, p, fseg, eseg, h, gout, w, b, wT, gw,
           p.lrow, p.d_lrow, d_rgb, 3, row0, warp, lane);
  head_bwd(p.n_trans, false, true, p, fseg, eseg, h, gout, w, b, wT, gw,
           p.trow, p.d_trow, d_tr, 5, row0, warp, lane);
}

int g_smem_limit_fwd[kMaxDevices];
int g_smem_limit_bwd[kMaxDevices];
#ifdef FIELD_FWD_MMA_SYNC
int g_smem_limit_mma[kMaxDevices];

// Measurement build only: steps 1-2 of st_render_bwd_kernel (both heads'
// forward recompute from the feature residual, head_forward on mma.sync),
// their raw outputs written to rgb [M,3] and trans [M,5] — what the fused
// backward's composite VJP reads, for the comparison with the forward's.
__global__ void __launch_bounds__(kThreads, 1)
    st_render_recompute_kernel(const BwdParams p, float* rgb_out,
                               float* tr_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_max = max(p.n_rgb, p.n_trans);
  bf16* const feat = reinterpret_cast<bf16*>(smem);
  bf16* h[kMaxHeadLayers];
  for (int i = 0; i < n_max - 1; ++i) h[i] = feat + (i + 1) * kTile * kActStride;
  bf16* const ep = feat + n_max * kTile * kActStride;
  const int es = p.ke + 8;
  float* const rgb = reinterpret_cast<float*>(ep + kTile * es);
  float* const tr = rgb + kTile * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTile;
  load_rows(feat, kActStride, p.feat, kHidden, row0, p.M);
  load_rows(ep, es, p.ep, p.ke, row0, p.M);
  __syncthreads();
  const Seg fseg = {feat, kActStride, kHidden};
  const Seg eseg = {ep, es, p.ke};
  const uint2* w = p.wpack_heads;
  const float* b = p.bias_heads;
  skip_head(p.n_rgb, kHidden + p.ke, w, b);
  head_forward(p.n_trans, false, p, fseg, eseg, h, w, b, p.trow, tr, 5, row0,
               warp, lane);
  w = p.wpack_heads;
  b = p.bias_heads;
  head_forward(p.n_rgb, true, p, fseg, eseg, h, w, b, p.lrow, rgb, 3, row0,
               warp, lane);
  for (int i = threadIdx.x; i < kTile * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    if (row0 + r >= p.M) continue;
    if (c < 3) rgb_out[(size_t)(row0 + r) * 3 + c] = rgb[r * 3 + c];
    else tr_out[(size_t)(row0 + r) * 5 + c - 3] = tr[r * 5 + c - 3];
  }
}
#endif

}  // namespace

// Launches the render forward on `stream`: the field on M = BR·N rows (rays
// of N samples, N dividing 64), then the packed composite out [BR,16].  The
// flat pointer and int arguments of field_fwd.cuh (FwdPtr, FwdInt: rgb /
// dens / trans receive the raw outputs, scratch or residuals; res is the
// [1, M, 256] feature residual, or n_res 0) and the walk's table.  Returns a
// cudaError_t (0 = launched).
extern "C" int st_render_fwd(const long long* ptrs, const int* ints,
                             const int* table, float min_uncert,
                             void* stream) {
  return launch_field_fwd<EPI_ST>(ptrs, ints, table, min_uncert, stream,
                                  g_smem_limit_fwd);
}

#ifdef FIELD_FWD_MMA_SYNC
// Measurement build only: the mma.sync render forward, as st_render_fwd
// computes it, from the fragment packs.  Returns cudaGetLastError().
extern "C" int st_render_fwd_mma(const void* xe, const void* wpack,
                             const void* bias, const void* wpack_heads,
                             const void* bias_heads, const void* lrow,
                             const void* trow, const void* dist,
                             const void* depth, void* out, void* rgb,
                             void* dens, void* trans, void* feat, int M,
                             int kx, int ke, int N, int rows_per_img,
                             int n_img, int n_trunk, int n_rgb, int n_trans,
                             int skip_mask, float min_uncert, void* stream) {
  if (M <= 0) return 0;
  if (bad_field_shape(kx, ke, rows_per_img, n_img, n_trunk, n_rgb, n_trans) ||
      N <= 0 || kTile % N || M % N)
    return (int)cudaErrorInvalidValue;
  RenderParams rp;
  rp.f = field_params(xe, wpack, bias, wpack_heads, bias_heads, lrow, trow,
                      rgb, dens, trans, feat, M, kx, ke, rows_per_img, n_img,
                      n_trunk, n_rgb, n_trans, skip_mask);
  rp.dist = static_cast<const float*>(dist);
  rp.depth = static_cast<const float*>(depth);
  rp.out = static_cast<float*>(out);
  rp.N = N;
  rp.min_uncert = min_uncert;
  const int smem = field_smem(kx, ke);
  cudaError_t e = ensure_smem(st_render_fwd_kernel, smem, g_smem_limit_mma);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTile - 1) / kTile);
  st_render_fwd_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(rp);
  return (int)cudaGetLastError();
}

// Measurement build only: 6b's forward recompute of both heads' raw outputs
// (st_render_recompute_kernel) into rgb [M,3] / trans [M,5].  Returns
// cudaGetLastError().
extern "C" int st_render_recompute_mma(const void* feat, const void* ep,
                                       const void* wpack_heads,
                                       const void* bias_heads,
                                       const void* lrow, const void* trow,
                                       void* rgb, void* trans, int M, int ke,
                                       int rows_per_img, int n_img, int n_rgb,
                                       int n_trans, void* stream) {
  static int limits[kMaxDevices];
  if (M <= 0) return 0;
  if (bad_bwd_shape(ke, rows_per_img, n_img, n_rgb, n_trans))
    return (int)cudaErrorInvalidValue;
  const BwdParams p = bwd_params(feat, ep, wpack_heads, bias_heads, nullptr,
                                 lrow, trow, nullptr, nullptr, nullptr, M, ke,
                                 rows_per_img, n_img, n_rgb, n_trans);
  const int n_max = n_rgb > n_trans ? n_rgb : n_trans;
  const int smem = (n_max * kTile * kActStride + kTile * (ke + 8)) *
                       (int)sizeof(bf16) + kTile * 8 * (int)sizeof(float);
  cudaError_t e = ensure_smem(st_render_recompute_kernel, smem, limits);
  if (e != cudaSuccess) return (int)e;
  st_render_recompute_kernel<<<(M + kTile - 1) / kTile, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(rgb), static_cast<float*>(trans));
  return (int)cudaGetLastError();
}
#endif  // FIELD_FWD_MMA_SYNC

// Launches the fused backward on `stream`: g [BR,16] → the heads' gradients
// and the latent row sums; grads, d_lrow and d_trow must be zeroed by the
// caller (the kernel adds into them).  Returns cudaGetLastError().
extern "C" int st_render_bwd(const void* feat, const void* ep,
                             const void* dens, const void* dist,
                             const void* g, const void* wpack_heads,
                             const void* bias_heads, const void* wpackT,
                             const void* lrow, const void* trow, void* grads,
                             void* d_lrow, void* d_trow, int M, int ke, int N,
                             int rows_per_img, int n_img, int n_rgb,
                             int n_trans, void* stream) {
  if (M <= 0) return 0;
  if (bad_bwd_shape(ke, rows_per_img, n_img, n_rgb, n_trans) || N <= 0 ||
      kTile % N || M % N)
    return (int)cudaErrorInvalidValue;
  RenderBwdParams rp;
  rp.b = bwd_params(feat, ep, wpack_heads, bias_heads, wpackT, lrow, trow,
                    grads, d_lrow, d_trow, M, ke, rows_per_img, n_img, n_rgb,
                    n_trans);
  rp.dens = static_cast<const float*>(dens);
  rp.dist = static_cast<const float*>(dist);
  rp.g = static_cast<const float*>(g);
  rp.N = N;
  const int smem = heads_bwd_smem(ke, n_rgb, n_trans) +
                   2 * kTile * 8 * (int)sizeof(float);
  cudaError_t e = ensure_smem(st_render_bwd_kernel, smem, g_smem_limit_bwd);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTile - 1) / kTile);
  st_render_bwd_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(rp);
  return (int)cudaGetLastError();
}
