// The pretrain stage's coarse field, forward with the composite fused in and
// the trunk-training backward, written by hand for Hopper (sm_90a) and bound
// to PyTorch through ctypes (texpose_tpu_torch/kernels/coarse_field.py).
//
// Replaces: texpose_tpu/kernels/fused_coarse_render.py::_run_fwd (the coarse
// field + single-density composite mega forward, _mega_fwd_kernel),
// texpose_tpu/kernels/fused_coarse_field.py::_run_fwd (the coarse field
// forward with raw outputs, _fwd_kernel) and ::_run_bwd (the trunk-training
// backward, _bwd_kernel).
//
// FORWARD (coarse_fwd_kernel<kComposite>).  Per 64-row tile, in shared
// memory:
//   xext [64,kx] -> 8x256 trunk (trunk.cuh; skip layers re-read xext)
//        -> feat, raw density
//   feat ⊕ enc⊕pts [64,256+ke] -> RGB head -> rgb_raw
//   then, with kComposite (the mega forward, entry coarse_fwd), the
//   composite of the tile's whole rays (64/N of them, N | 64): one warp per
//   ray (composite_coarse.cuh) -> packed [BR,8] (rgb, depth, opacity).
// Without it (the field forward, entry coarse_field_fwd) the epilogue is
// compiled out and the rows need not form whole rays: any M, any N; the
// composite kernel (composite.cu) or plain PyTorch takes the raw outputs.
// rgb_raw [M,3] and dens_raw [M,1] (f32, no activation) go to global memory
// in every mode: the epilogue reads them back (L2), and in training they are
// the composite backward's residuals.  In training the kernel also stores
// every hidden layer's bf16 ReLU output, [n_trunk + n_rgb - 1, M, 256]
// (11 x 64 MB = 0.74 GB at M = 131,072, 2.21 GB at the fine field's
// 393,216 rows): the field backward's residuals.
// What bounds it: ~1.38 MFLOP per row (181 GFLOP per 131,072-row step) on
// the tensor cores against ~0.2 KB of row input/output in eval; in training
// the 0.74 GB of residual stores (0.22 ms at 3.35 TB/s) stay below the
// math.  Design: as st_field.cu (activations in shared memory, fragment-
// packed weights, every warp all 64 rows × 32 columns); 114,688 B of shared
// memory at most (three 64x264 activation buffers + the xext|enc⊕pts tile)
// lets two blocks share an SM.
//
// BACKWARD (coarse_bwd_kernel<true> + dw_gemm.cu: row 7b).  The pretrain
// trains the trunk, so the backward walks all 12 layers down.  Walking down
// needs every layer's input: 12 x 64 x 264 x 2 B ≈ 405 KB per tile, more
// than a block's 227 KB of shared memory, and a recompute per tile would
// repeat the forward's 1.4 MFLOP/row.  So the forward's residuals come back
// from device memory one layer at a time.  Per 64-row tile, for each layer
// l from the top:
//   db_l += Σ_rows g_l                               (f32, before rounding)
//   g_{l-1} = (bf16(g_l) · W_lᵀ) ⊙ [h_{l-1} > 0]    (W_lᵀ packed on the host)
// bf16(relu(z)) > 0 ⇔ z > 0, so the stored activation is also the ReLU mask.
// g_{l-1} overwrites h_{l-1} in place: two 64x280 buffers ping-pong (280 =
// 256 features + the trunk's density tile + pad).  The RGB head's layer 0
// passes back only its feature rows; the trunk's last layer takes [g_dens |
// g_feat ⊙ (feat > 0)] as one K = 272 operand; the skip layer passes back
// only its activation block; layer 0 takes no dX, and no gradient reaches
// the points (poses are fixed in the pretrain).
// The weight gradients dW_l = bf16(h_{l-1})ᵀ · bf16(g_l) are a reduction
// over all M rows.  The TPU kernel sums them in VMEM scratch over its
// sequential grid; Hopper's blocks run in parallel, and the one-kernel form
// (coarse_bwd_kernel<false>, entry coarse_bwd_atomic, compiled only in the
// measurement build -DFIELD_BWD_ONE_KERNEL that chip_smoke.py and
// tools/probe_field_bwd_atomics.py time against this one) added every
// tile's partials with f32 atomics: ≈ 0.70 M adds per tile, 1.4 G per
// 131,072-row step, 6.3 ms per step on the H100.  So the backward is split:
// this kernel is the dX chain alone and stores each bf16 g_l tile to a
// device plane (11 × 64 MB at 131,072 rows) and the output / density
// gradients to a narrow [M, 16] plane; dw_gemm.cu then forms every dW with
// wgmma over all rows, TMA-fed, and sums its split partials in a fixed
// order, so dW is the same from run to run.  db stays an f32 column sum
// taken before the bf16 rounding, added across tiles with f32 atomics (256
// per layer per tile; their order, and so db's last bits, vary run to
// run).  What bounds the split form: bytes — this kernel reads the 0.74 GB
// of residuals and writes 0.74 GB of gradient planes, dw_gemm.cu reads
// both again (≈2.98 GB with the inputs and the narrow plane, 0.89 ms at
// 3.35 TB/s, tools/kernel_bounds.py; the function's own bound is 0.36 ms
// of dW 1.38 + dX 1.31 MFLOP per row on the tensor cores).  Why split: on
// the H100 the one-kernel form spent 5.2 of its 6.3 ms at 131,072 rows in
// the dW products and their atomics (1.4 ms the atomics alone) and ran in
// 1.0 ms without them (tools/probe_field_bwd_atomics.py).  This kernel
// keeps the one-kernel form's tile (mma.sync, 88,064 B of shared memory at
// most, two blocks per SM) for its 1.31 MFLOP per row of dX.

#include "trunk.cuh"
#include "composite_coarse.cuh"

namespace {

constexpr int kBw = kHidden + 16 + 8;             // backward row stride

struct FwdParams {
  const bf16* xe;          // [M, kx+ke] bf16: xext | enc⊕pts, zero padded
  const uint2* wpack;      // trunk layers in walk order, fragment packed
  const float* bias;
  const uint2* wpack_rgb;  // RGB head layers, fragment packed
  const float* bias_rgb;
  const float* dist;       // [BR, N]
  const float* depth;      // [BR, N]
  float* out;              // [BR, 8]
  float* rgb_raw;          // [M, 3]
  float* dens_raw;         // [M, 1]
  bf16* acts;              // [n_trunk + n_rgb - 1, M, 256] or null
  int M, kx, ke, N, n_trunk, n_rgb;
  unsigned skip_mask;
};

template <bool kComposite>
__global__ void __launch_bounds__(kThreads, 2)
    coarse_fwd_kernel(const FwdParams p) {
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

  load_rows(xe, xs, p.xe, xw, row0, p.M);
  __syncthreads();
  const Seg none = {xe, xs, 0};
  const Seg xseg = {xe, xs, p.kx};
  const Seg eseg = {xe + p.kx, xs, p.ke};
  const int feat = trunk_forward(xseg, none, act, p.wpack, p.bias, p.n_trunk,
                                 p.skip_mask, p.dens_raw, p.acts, row0, p.M,
                                 warp, lane);

  // RGB head: layer 0 reads feat ⊕ enc⊕pts; hidden activations alternate
  // between the two buffers that are not `feat`
  const uint2* w = p.wpack_rgb;
  const float* b = p.bias_rgb;
  int cur = feat;
  for (int li = 0; li < p.n_rgb; ++li) {
    const Seg a1 = {act[cur], kActStride, kHidden};
    const Seg a2 = li == 0 ? eseg : none;
    const int kt_total = (a1.k + a2.k) >> 4;
    if (li < p.n_rgb - 1) {
      const int nxt = cur == feat ? (feat + 1) % 3 : 3 - cur - feat;
      {
        float acc[4][kTilesPerWarp][4];
        warp_gemm<kTilesPerWarp>(acc, a1, a2, w, nt0, lane);
        store_hidden<kTilesPerWarp>(acc, act[nxt], b, nullptr, 1, 1, row0,
                                    nt0, lane);
      }
      w += (size_t)kt_total * (kHidden / 8) * 32;
      b += kHidden;
      __syncthreads();
      if (p.acts != nullptr)
        store_tile(p.acts + (size_t)(p.n_trunk + li) * p.M * kHidden,
                   act[nxt], row0, p.M);
      cur = nxt;
    } else {
      if (warp == 0) {
        float acc[4][1][4];
        warp_gemm<1>(acc, a1, a2, w, 0, lane);
        store_out(acc, p.rgb_raw, 3, b, row0, p.M, lane);
      }
      __syncthreads();
    }
  }

  if constexpr (kComposite) {
    // composite epilogue: the tile holds whole rays (N divides 64)
    const int rays = kTile / p.N;
    const int ray0 = row0 / p.N;
    for (int r = warp; r < rays; r += kWarps) {
      const int ray = ray0 + r;
      if ((size_t)ray * p.N >= (size_t)p.M) break;   // uniform per warp
      if (p.N <= 32)
        composite_coarse_ray<1>(p.rgb_raw, p.dens_raw, p.dist, p.depth, ray,
                                p.N, lane, p.out);
      else
        composite_coarse_ray<2>(p.rgb_raw, p.dens_raw, p.dist, p.depth, ray,
                                p.N, lane, p.out);
    }
  }
}

// ------------------------------------------------------------------ backward

struct BwdParams {
  const bf16* xe;          // [M, kx+ke] the forward's staged input
  const bf16* acts;        // [n_trunk + n_rgb - 1, M, 256] the residuals
  const float* g_rgb;      // [M, 3] d rgb_raw
  const float* g_dens;     // [M, 1] d dens_raw
  const uint2* wT;         // W_lᵀ packs in backward walk order
  float* grads;            // zeroed f32
  const int* offs;         // per layer {dW, dW2, db, db2} offsets into grads
  bf16* gplanes;           // split form: [n_res, M, 256] layer output grads
  bf16* gnarrow;           // split form: [M, 16] d rgb_raw | d dens_raw
  int M, kx, ke, n_trunk, n_rgb;
  unsigned skip_mask;
};

// dX epilogue: g = acc ⊙ [h > 0] written in place over h (bf16), the f32
// column sums of g added to db.
__device__ __forceinline__ void store_grad(
    const float (&acc)[4][kTilesPerWarp][4], bf16* h, float* db, int nt0,
    int lane) {
  const int g = lane >> 2, q = lane & 3;
  float s[kTilesPerWarp][2];
#pragma unroll
  for (int t = 0; t < kTilesPerWarp; ++t) s[t][0] = s[t][1] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = i * 16 + g + hh * 8;
#pragma unroll
      for (int t = 0; t < kTilesPerWarp; ++t) {
        const int col = (nt0 + t) * 8 + 2 * q;
        __nv_bfloat162* ptr =
            reinterpret_cast<__nv_bfloat162*>(h + r * kBw + col);
        const float2 hv = __bfloat1622float2(*ptr);
        const float v0 = hv.x > 0.f ? acc[i][t][2 * hh] : 0.f;
        const float v1 = hv.y > 0.f ? acc[i][t][2 * hh + 1] : 0.f;
        s[t][0] += v0;
        s[t][1] += v1;
        *ptr = __floats2bfloat162_rn(v0, v1);
      }
    }
#pragma unroll
  for (int t = 0; t < kTilesPerWarp; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = s[t][e];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0) atomicAdd(db + (nt0 + t) * 8 + 2 * q + e, x);
    }
}

// A [M, ncols] f32 gradient's tile as bf16 into shared columns col0..col0+15
// (zero past ncols and M), its f32 column sums added to db (warp c < ncols
// sums column c); with gn (the split form) also into the narrow plane's
// columns gcol..gcol+7.
__device__ __forceinline__ void stage_out_grad(bf16* dst, int stride,
                                               const float* g, int ncols,
                                               float* db, int row0, int M,
                                               int warp, int lane,
                                               bf16* gn = nullptr,
                                               int gcol = 0) {
  for (int i = threadIdx.x; i < kTile * 16; i += kThreads) {
    const int r = i >> 4, c = i & 15;
    float x = 0.f;
    if (c < ncols && row0 + r < M) x = __ldg(g + (size_t)(row0 + r) * ncols + c);
    dst[r * stride + c] = __float2bfloat16_rn(x);
  }
  if (gn != nullptr)
    store_narrow(gn, gcol, g + (size_t)row0 * ncols, ncols, row0, M);
  if (warp < ncols) {
    float s = 0.f;
    for (int r = lane; r < kTile; r += 32)
      if (row0 + r < M) s += __ldg(g + (size_t)(row0 + r) * ncols + warp);
    s = warp_sum(s);
    if (lane == 0) atomicAdd(db + warp, s);
  }
}

// dW[0..k) x 256 += Hᵀ·G over the K columns of H (k ≤ 256, a multiple of
// 16), in chunks of 64 input rows.
__device__ __forceinline__ void dw_rows(const bf16* H, int sh, int k,
                                        const bf16* G, float* dW, int nt0,
                                        int lane) {
  for (int i0 = 0; i0 < k; i0 += 64)
    warp_dw<4, kTilesPerWarp>(H, sh, i0, min(4, (k - i0) >> 4), G, kBw,
                              nt0 * 8, dW, kHidden, lane);
}

// kSplit (the shipped form, entry coarse_bwd_dx): the dX chain alone —
// every layer's bf16 output gradient goes to its plane of p.gplanes (plane
// j = the gradient of the layer whose output is residual plane j; the
// output and density gradients to p.gnarrow), db to grads; dw_gemm.cu
// forms dW.  Without it (entry coarse_bwd_atomic, built only with
// -DFIELD_BWD_ONE_KERNEL for the in-call comparison and the attribution
// probe): the one-kernel form it replaced, each tile's dW partials added to
// grads with atomics.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 2)
    coarse_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xes = p.kx + p.ke + 8;
  bf16* const xe = reinterpret_cast<bf16*>(smem);      // xext | enc⊕pts
  bf16* const B[2] = {xe + kTile * xes, xe + kTile * xes + kTile * kBw};
  bf16* const gout = B[1] + kTile * kBw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTile;
  const int nt0 = warp * kTilesPerWarp;
  const int nf = p.n_trunk, nr = p.n_rgb;
  const size_t plane = (size_t)p.M * kHidden;
  const Seg none = {xe, xes, 0};
  float* const gw = p.grads;
  const int* const o = p.offs;                     // layer l: o[4l..4l+3]
  const uint2* wT = p.wT;
  // split form: a layer's output gradient, now in `buf`, to plane j
  auto keep = [&](int j, const bf16* buf) {
    if constexpr (kSplit) store_tile(p.gplanes + j * plane, buf, row0, p.M, kBw);
  };

  if constexpr (!kSplit) load_rows(xe, xes, p.xe, p.kx + p.ke, row0, p.M);
  stage_out_grad(gout, kOutStride, p.g_rgb, 3, gw + o[4 * (nf + nr - 1) + 2],
                 row0, p.M, warp, lane, kSplit ? p.gnarrow : nullptr, 0);
  load_rows(B[0], kBw, p.acts + (nf + nr - 2) * plane, kHidden, row0, p.M);
  __syncthreads();

  // ---- RGB output layer: input r_{nr-2} in B[0], gradient in gout ----
  if constexpr (!kSplit) {
    warp_dw<2, 1>(B[0], kBw, warp * 32, 2, gout, kOutStride, 0,
                  gw + o[4 * (nf + nr - 1)], 8, lane);
    __syncthreads();
  }
  {
    float acc[4][kTilesPerWarp][4];
    dx_gemm<kTilesPerWarp>(acc, Seg{gout, kOutStride, kOutPad}, none, wT,
                           nt0, lane);
    store_grad(acc, B[0], gw + o[4 * (nf + nr - 2) + 2], nt0, lane);
  }
  wT += (size_t)(kOutPad >> 4) * (kHidden / 8) * 32;
  __syncthreads();
  keep(nf + nr - 2, B[0]);
  int cur = 0;                                     // B[cur] = this layer's g

  // ---- RGB hidden layers nr-2 .. 1 ----
  for (int li = nr - 2; li >= 1; --li) {
    bf16* const A = B[1 - cur];
    load_rows(A, kBw, p.acts + (nf + li - 1) * plane, kHidden, row0, p.M);
    __syncthreads();
    if constexpr (!kSplit) {
      dw_rows(A, kBw, kHidden, B[cur], gw + o[4 * (nf + li)], nt0, lane);
      __syncthreads();
    }
    float acc[4][kTilesPerWarp][4];
    dx_gemm<kTilesPerWarp>(acc, Seg{B[cur], kBw, kHidden}, none, wT, nt0,
                           lane);
    wT += (size_t)(kHidden >> 4) * (kHidden / 8) * 32;
    store_grad(acc, A, gw + o[4 * (nf + li - 1) + 2], nt0, lane);
    __syncthreads();
    keep(nf + li - 1, A);
    cur = 1 - cur;
  }

  // ---- RGB layer 0: input feat ⊕ enc⊕pts; dX only to the features ----
  {
    bf16* const A = B[1 - cur];
    load_rows(A, kBw, p.acts + (nf - 1) * plane, kHidden, row0, p.M);
    __syncthreads();
    if constexpr (!kSplit) {
      dw_rows(A, kBw, kHidden, B[cur], gw + o[4 * nf], nt0, lane);
      dw_rows(xe + p.kx, xes, p.ke, B[cur], gw + o[4 * nf + 1], nt0, lane);
      __syncthreads();
    }
    float acc[4][kTilesPerWarp][4];
    dx_gemm<kTilesPerWarp>(acc, Seg{B[cur], kBw, kHidden}, none, wT, nt0,
                           lane);
    wT += (size_t)(kHidden >> 4) * (kHidden / 8) * 32;
    // g_feat ⊙ (feat > 0) in place; the trunk's density gradient beside it
    store_grad(acc, A, gw + o[4 * (nf - 1) + 2], nt0, lane);
    stage_out_grad(A + kHidden, kBw, p.g_dens, 1, gw + o[4 * (nf - 1) + 3],
                   row0, p.M, warp, lane, kSplit ? p.gnarrow : nullptr, 8);
    __syncthreads();
    keep(nf - 1, A);
    cur = 1 - cur;
  }

  // ---- trunk layers nf-1 .. 1 ----
  for (int li = nf - 1; li >= 1; --li) {
    bf16* const A = B[1 - cur];
    load_rows(A, kBw, p.acts + (li - 1) * plane, kHidden, row0, p.M);
    __syncthreads();
    if constexpr (!kSplit) {
      dw_rows(A, kBw, kHidden, B[cur], gw + o[4 * li], nt0, lane);
      if (li == nf - 1)                            // the density tile
        warp_dw<2, 1>(A, kBw, warp * 32, 2, B[cur] + kHidden, kBw, 0,
                      gw + o[4 * li + 1], 8, lane);
      else if ((p.skip_mask >> li) & 1u)           // the skip's xext block
        dw_rows(xe, xes, p.kx, B[cur], gw + o[4 * li + 1], nt0, lane);
      __syncthreads();
    }
    const int K = li == nf - 1 ? kHidden + 16 : kHidden;
    float acc[4][kTilesPerWarp][4];
    dx_gemm<kTilesPerWarp>(acc, Seg{B[cur], kBw, K}, none, wT, nt0, lane);
    wT += (size_t)(K >> 4) * (kHidden / 8) * 32;
    store_grad(acc, A, gw + o[4 * (li - 1) + 2], nt0, lane);
    __syncthreads();
    keep(li - 1, A);
    cur = 1 - cur;
  }

  // ---- trunk layer 0: input xext, no dX ----
  if constexpr (!kSplit) dw_rows(xe, xes, p.kx, B[cur], gw + o[0], nt0, lane);
}

int g_smem_limit_fwd[kMaxDevices];
int g_smem_limit_field[kMaxDevices];

// The forward's parameters shared by both entries (the composite's stay
// null/0 for the field forward).
FwdParams fwd_params(const void* xe, const void* wpack, const void* bias,
                     const void* wpack_rgb, const void* bias_rgb,
                     void* rgb_raw, void* dens_raw, void* acts, int M, int kx,
                     int ke, int n_trunk, int n_rgb, int skip_mask) {
  FwdParams p = {};
  p.xe = static_cast<const bf16*>(xe);
  p.wpack = static_cast<const uint2*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.wpack_rgb = static_cast<const uint2*>(wpack_rgb);
  p.bias_rgb = static_cast<const float*>(bias_rgb);
  p.rgb_raw = static_cast<float*>(rgb_raw);
  p.dens_raw = static_cast<float*>(dens_raw);
  p.acts = static_cast<bf16*>(acts);
  p.M = M;
  p.kx = kx;
  p.ke = ke;
  p.n_trunk = n_trunk;
  p.n_rgb = n_rgb;
  p.skip_mask = static_cast<unsigned>(skip_mask);
  return p;
}

bool bad_fwd_shape(int kx, int ke, int n_trunk, int n_rgb) {
  return kx % 16 || ke % 16 || kx <= 0 || ke <= 0 || kx + ke > 256 ||
         n_trunk < 2 || n_rgb < 2;
}

template <bool kComposite>
int launch_fwd(const FwdParams& p, int* limits, void* stream) {
  const int smem =
      (3 * kTile * kActStride + kTile * (p.kx + p.ke + 8)) * (int)sizeof(bf16);
  cudaError_t e = ensure_smem(coarse_fwd_kernel<kComposite>, smem, limits);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.M + kTile - 1) / kTile);
  coarse_fwd_kernel<kComposite><<<grid, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the mega forward (field + composite) on `stream`; returns
// cudaGetLastError() (0 = launched).  acts may be null (no residuals:
// evaluation).
extern "C" int coarse_fwd(const void* xe, const void* wpack, const void* bias,
                          const void* wpack_rgb, const void* bias_rgb,
                          const void* dist, const void* depth, void* out,
                          void* rgb_raw, void* dens_raw, void* acts, int M,
                          int kx, int ke, int N, int n_trunk, int n_rgb,
                          int skip_mask, void* stream) {
  if (M <= 0) return 0;
  if (bad_fwd_shape(kx, ke, n_trunk, n_rgb) || N <= 0 || kTile % N || M % N)
    return (int)cudaErrorInvalidValue;
  FwdParams p = fwd_params(xe, wpack, bias, wpack_rgb, bias_rgb, rgb_raw,
                           dens_raw, acts, M, kx, ke, n_trunk, n_rgb,
                           skip_mask);
  p.dist = static_cast<const float*>(dist);
  p.depth = static_cast<const float*>(depth);
  p.out = static_cast<float*>(out);
  p.N = N;
  return launch_fwd<true>(p, g_smem_limit_fwd, stream);
}

// Launches the field forward (raw outputs, no composite) on `stream`: any M,
// the rows need not form whole rays.  acts may be null (no residuals).
// Returns cudaGetLastError().
extern "C" int coarse_field_fwd(const void* xe, const void* wpack,
                                const void* bias, const void* wpack_rgb,
                                const void* bias_rgb, void* rgb_raw,
                                void* dens_raw, void* acts, int M, int kx,
                                int ke, int n_trunk, int n_rgb, int skip_mask,
                                void* stream) {
  if (M <= 0) return 0;
  if (bad_fwd_shape(kx, ke, n_trunk, n_rgb)) return (int)cudaErrorInvalidValue;
  const FwdParams p = fwd_params(xe, wpack, bias, wpack_rgb, bias_rgb,
                                 rgb_raw, dens_raw, acts, M, kx, ke, n_trunk,
                                 n_rgb, skip_mask);
  return launch_fwd<false>(p, g_smem_limit_field, stream);
}

namespace {

// The backward entries' shared checks and launch: kSplit the dX chain,
// else the one-kernel form (measurement build only).
template <bool kSplit>
int launch_bwd(const void* xe, const void* acts, const void* g_rgb,
               const void* g_dens, const void* wT, void* grads,
               const void* offs, void* gplanes, void* gnarrow, int M, int kx,
               int ke, int n_trunk, int n_rgb, int skip_mask, void* stream) {
  static int limits[kMaxDevices];
  if (M <= 0) return 0;
  if (kx % 16 || ke % 16 || kx <= 0 || ke <= 0 || kx + ke > 256 ||
      n_trunk < 2 || n_rgb < 2 || (skip_mask & 1) ||
      ((skip_mask >> (n_trunk - 1)) & 1))
    return (int)cudaErrorInvalidValue;
  BwdParams p = {};
  p.xe = static_cast<const bf16*>(xe);
  p.acts = static_cast<const bf16*>(acts);
  p.g_rgb = static_cast<const float*>(g_rgb);
  p.g_dens = static_cast<const float*>(g_dens);
  p.wT = static_cast<const uint2*>(wT);
  p.grads = static_cast<float*>(grads);
  p.offs = static_cast<const int*>(offs);
  p.gplanes = static_cast<bf16*>(gplanes);
  p.gnarrow = static_cast<bf16*>(gnarrow);
  p.M = M;
  p.kx = kx;
  p.ke = ke;
  p.n_trunk = n_trunk;
  p.n_rgb = n_rgb;
  p.skip_mask = static_cast<unsigned>(skip_mask);
  const int smem =
      (kTile * (kx + ke + 8) + 2 * kTile * kBw + kTile * kOutStride) *
      (int)sizeof(bf16);
  cudaError_t e = ensure_smem(coarse_bwd_kernel<kSplit>, smem, limits);
  if (e != cudaSuccess) return (int)e;
  coarse_bwd_kernel<kSplit><<<(M + kTile - 1) / kTile, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the backward's dX chain (phase (a) of the split form) on
// `stream`: db into grads (zeroed by the caller), every layer's output
// gradient into gplanes [n_trunk + n_rgb - 1, M, 256] bf16 and the output /
// density gradients into gnarrow [M, 16] bf16 (columns 0-2 / 8).  dW comes
// from dw_gemm.cu.  Returns cudaGetLastError().
extern "C" int coarse_bwd_dx(const void* acts, const void* g_rgb,
                             const void* g_dens, const void* wT, void* grads,
                             const void* offs, void* gplanes, void* gnarrow,
                             int M, int kx, int ke, int n_trunk, int n_rgb,
                             int skip_mask, void* stream) {
  return launch_bwd<true>(nullptr, acts, g_rgb, g_dens, wT, grads, offs,
                          gplanes, gnarrow, M, kx, ke, n_trunk, n_rgb,
                          skip_mask, stream);
}

#ifdef FIELD_BWD_ONE_KERNEL
// Measurement build only.  Launches the one-kernel backward (dW partials as
// f32 atomics) on `stream`; grads must be zeroed by the caller.  Returns
// cudaGetLastError().
extern "C" int coarse_bwd_atomic(const void* xe, const void* acts,
                                 const void* g_rgb, const void* g_dens,
                                 const void* wT, void* grads,
                                 const void* offs, int M, int kx, int ke,
                                 int n_trunk, int n_rgb, int skip_mask,
                                 void* stream) {
  return launch_bwd<false>(xe, acts, g_rgb, g_dens, wT, grads, offs, nullptr,
                           nullptr, M, kx, ke, n_trunk, n_rgb, skip_mask,
                           stream);
}
#endif
