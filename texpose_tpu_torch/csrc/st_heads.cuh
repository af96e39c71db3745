// The static/transient/light field's mma.sync tile bodies, shared by the
// field kernels (st_field.cu) and the render kernels (st_render.cu): the
// heads' forward recompute from the feature residual and the heads'
// backward, and, in the measurement build -DFIELD_FWD_MMA_SYNC only, the
// mma.sync forward of one 64-row tile (trunk → RGB head → transient head)
// that field_fwd.cuh's wgmma tile replaced.  The arithmetic and the design
// are described in the header of st_field.cu; the trunk and the
// mma/ldmatrix building blocks are in trunk.cuh.

#pragma once

#include "trunk.cuh"

namespace {

constexpr int kMaxHeadLayers = 16;

#ifdef FIELD_FWD_MMA_SYNC
// The mma.sync forward (measurement build only).
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

// The field forward of the block's tile: xext | enc⊕pts staged in shared
// memory, the trunk, the feature residual (when p.feat is set), both heads.
// The raw outputs go to p.rgb / p.dens / p.trans; the last step is a block
// barrier, so they are visible to the whole block on return.
__device__ __forceinline__ void st_field_tile(const Params& p,
                                              unsigned char* smem) {
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
  if (p.feat != nullptr) store_residual(p.feat, act[feat], row0, p.M);
  const uint2* wh = p.wpack_heads;
  const float* bh = p.bias_heads;
  run_head(p.n_rgb, eseg, p.lrow, p.rgb, 3, act, feat, wh, bh, p, none, row0,
           nt0, warp, lane);
  run_head(p.n_trans, none, p.trow, p.trans, 5, act, feat, wh, bh, p, none,
           row0, nt0, warp, lane);
}

// The forward's parameters from the C entry points' arguments, and the shapes
// the forward kernels refuse.
Params field_params(const void* xe, const void* wpack, const void* bias,
                    const void* wpack_heads, const void* bias_heads,
                    const void* lrow, const void* trow, void* rgb, void* dens,
                    void* trans, void* feat, int M, int kx, int ke,
                    int rows_per_img, int n_img, int n_trunk, int n_rgb,
                    int n_trans, int skip_mask) {
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
  return p;
}

bool bad_field_shape(int kx, int ke, int rows_per_img, int n_img, int n_trunk,
                     int n_rgb, int n_trans) {
  return kx % 16 || ke % 16 || kx <= 0 || ke <= 0 || rows_per_img <= 0 ||
         n_img <= 0 || n_trunk < 1 || n_rgb < 2 || n_trans < 2;
}

// The forward tile's dynamic shared memory: three activation buffers and
// the staged xext | enc⊕pts rows.
int field_smem(int kx, int ke) {
  return (3 * kTile * kActStride + kTile * (kx + ke + 8)) * (int)sizeof(bf16);
}
#endif  // FIELD_FWD_MMA_SYNC

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

// Output-layer epilogue into a shared f32 tile out[64][ncols] (+ bias, no
// activation): the raw outputs the render backward's composite stage reads.
__device__ __forceinline__ void store_out_tile(const float (&acc)[4][1][4],
                                               float* out, int ncols,
                                               const float* bias, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = i * 16 + g + hh * 8;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * q + e;
        if (col < ncols)
          out[r * ncols + col] = acc[i][0][2 * hh + e] + __ldg(bias + col);
      }
    }
}

// The forward of one head from the staged feature tile, as run_head computes
// it (same packs, same rounding points, so the same values): hidden layer li
// into h[li], then, unless `out` is null, the output layer's `ncols` raw
// outputs into the shared f32 tile `out`.  Advances w and b past the head.
__device__ void head_forward(int n, bool rgb, const BwdParams& p,
                             const Seg& feat, const Seg& ep, bf16* const* h,
                             const uint2*& w, const float*& b,
                             const float* lat_rows, float* out, int ncols,
                             int row0, int warp, int lane) {
  const int nt0 = warp * kTilesPerWarp;
  const Seg none = {ep.base, ep.stride, 0};
  for (int li = 0; li < n; ++li) {
    const Seg a1 = li == 0 ? feat : Seg{h[li - 1], kActStride, kHidden};
    const Seg a2 = (li == 0 && rgb) ? ep : none;
    const int kt_total = (a1.k + a2.k) >> 4;
    if (li < n - 1) {
      float acc[4][kTilesPerWarp][4];
      warp_gemm<kTilesPerWarp>(acc, a1, a2, w, nt0, lane);
      store_hidden<kTilesPerWarp>(acc, h[li], b, li == 0 ? lat_rows : nullptr,
                                  p.rows_per_img, p.n_img, row0, nt0, lane);
      w += (size_t)kt_total * (kHidden / 8) * 32;
      b += kHidden;
    } else {
      if (out == nullptr) {                     // hidden layers only
        w += (size_t)kt_total * 32;
        b += 8;
        break;
      }
      if (warp == 0) {
        float acc[4][1][4];
        warp_gemm<1>(acc, a1, a2, w, 0, lane);
        store_out_tile(acc, out, ncols, b, lane);
      }
      w += (size_t)kt_total * 32;
      b += 8;
    }
    __syncthreads();
  }
}

// Advance w and b past a head of n layers whose layer 0 has k0 input rows.
__device__ __forceinline__ void skip_head(int n, int k0, const uint2*& w,
                                          const float*& b) {
  w += (size_t)(k0 >> 4) * (kHidden / 8) * 32;
  b += kHidden;
  for (int li = 1; li < n - 1; ++li) {
    w += (size_t)(kHidden >> 4) * (kHidden / 8) * 32;
    b += kHidden;
  }
  w += (size_t)(kHidden >> 4) * 32;
  b += 8;
}

// The split backward's planes for one head (dw_gemm.cu reads them): its
// recomputed hidden activations h and their gradients g, [n-1, M, 256]
// bf16 each (this head's first plane), and the narrow [M, 16] plane whose
// columns col..col+7 take the output gradient.
struct SplitOut {
  bf16* h;
  bf16* g;
  bf16* gn;
  int col;
};

// Backward of one head for the block's tile, from the forward recompute of
// its hidden layers (or, with recompute false, from hidden activations
// already in h, as head_forward leaves them).
//   h[0..n-2]: hidden activation buffers, later the gradients in place
//   gout: [64][kOutStride] bf16 output gradient (columns ≥ ncols zero)
//   g_in: the tile's f32 output gradient, row r at g_in[r*ncols] (device or
//         shared memory; rows past M are not read)
// kSplit (the dX chains of rows 2 and 6b): no dW here — the hidden
// activations, each layer's gradient and the output gradient go to the
// planes of `so`, and dw_gemm.cu forms dW; db and the latent sums are added
// as in the one-kernel form (the measurement build -DFIELD_BWD_ONE_KERNEL).
template <bool kSplit = false>
__device__ void head_bwd(int n, bool rgb, bool recompute, const BwdParams& p,
                         const Seg& feat, const Seg& ep, bf16* const* h,
                         bf16* gout, const uint2*& w, const float*& b,
                         const uint2*& wT, float*& gw, const float* lat_rows,
                         float* dlat, const float* g_in, int ncols, int row0,
                         int warp, int lane, const SplitOut& so = SplitOut{}) {
  const size_t plane = (size_t)p.M * kHidden;
  const int nt0 = warp * kTilesPerWarp;
  const Seg none = {ep.base, ep.stride, 0};
  const uint2* wTl[kMaxHeadLayers];
  float* dWl[kMaxHeadLayers];
  float* dbl[kMaxHeadLayers];
  float* dWep = nullptr;

  // ---- forward recompute of the hidden layers (as run_head) ----
  if (recompute)
    head_forward(n, rgb, p, feat, ep, h, w, b, lat_rows, nullptr, 0, row0,
                 warp, lane);
  else
    skip_head(n, rgb ? kHidden + p.ke : kHidden, w, b);
  if constexpr (kSplit)
    if (so.h != nullptr)                    // null: stored by the caller
      for (int li = 0; li < n - 1; ++li)
        store_tile(so.h + li * plane, h[li], row0, p.M);

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
    if (c < ncols && row0 + r < p.M) x = g_in[(size_t)r * ncols + c];
    gout[r * kOutStride + c] = __float2bfloat16_rn(x);
  }
  if constexpr (kSplit) store_narrow(so.gn, so.col, g_in, ncols, row0, p.M);
  if (warp < ncols) {
    float s = 0.f;
    for (int r = lane; r < kTile; r += 32)
      if (row0 + r < p.M) s += g_in[(size_t)r * ncols + warp];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) atomicAdd(dbl[n - 1] + warp, s);
  }
  __syncthreads();

  // ---- layers n-1 .. 1: dW_l, then g_{l-1} in place over h[l-1] ----
  for (int li = n - 1; li >= 1; --li) {
    const bf16* gl = li == n - 1 ? gout : h[li];
    const int sg = li == n - 1 ? kOutStride : kActStride;
    if constexpr (!kSplit) {
      if (li == n - 1)
        warp_dw<2, 1>(h[li - 1], kActStride, warp * 32, 2, gl, sg, 0,
                      dWl[li], 8, lane);
      else
        for (int i0 = 0; i0 < kHidden; i0 += 64)
          warp_dw<4, kTilesPerWarp>(h[li - 1], kActStride, i0, 4, gl, sg,
                                    nt0 * 8, dWl[li], kHidden, lane);
    }
    __syncthreads();
    {
      const Seg a1 = {gl, sg, li == n - 1 ? kOutPad : kHidden};
      float acc[4][kTilesPerWarp][4];
      dx_gemm<kTilesPerWarp>(acc, a1, none, wTl[li], nt0, lane);
      store_grad(acc, h[li - 1], dbl[li - 1], li == 1 ? dlat : nullptr, p,
                 row0, nt0, lane);
    }
    __syncthreads();
    if constexpr (kSplit) store_tile(so.g + (li - 1) * plane, h[li - 1], row0, p.M);
  }

  // ---- layer 0: dW of the feat block (and of the enc⊕pts block) ----
  if constexpr (!kSplit) {
    for (int i0 = 0; i0 < kHidden; i0 += 64)
      warp_dw<4, kTilesPerWarp>(feat.base, kActStride, i0, 4, h[0],
                                kActStride, nt0 * 8, dWl[0], kHidden, lane);
    if (rgb)
      for (int i0 = 0; i0 < p.ke; i0 += 64)
        warp_dw<4, kTilesPerWarp>(ep.base, ep.stride, i0,
                                  min(4, (p.ke - i0) >> 4), h[0], kActStride,
                                  nt0 * 8, dWep, kHidden, lane);
  }
  __syncthreads();
}

BwdParams bwd_params(const void* feat, const void* ep, const void* wpack_heads,
                     const void* bias_heads, const void* wpackT,
                     const void* lrow, const void* trow, void* grads,
                     void* d_lrow, void* d_trow, int M, int ke,
                     int rows_per_img, int n_img, int n_rgb, int n_trans) {
  BwdParams p = {};
  p.feat = static_cast<const bf16*>(feat);
  p.ep = static_cast<const bf16*>(ep);
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
  return p;
}

bool bad_bwd_shape(int ke, int rows_per_img, int n_img, int n_rgb,
                   int n_trans) {
  return ke % 16 || ke <= 0 || rows_per_img <= 0 || n_img <= 0 || n_rgb < 2 ||
         n_trans < 2 || n_rgb > kMaxHeadLayers || n_trans > kMaxHeadLayers;
}

// The heads' backward tile: feat and n_max-1 hidden buffers, enc⊕pts and
// the padded output gradient.
int heads_bwd_smem(int ke, int n_rgb, int n_trans) {
  const int n_max = n_rgb > n_trans ? n_rgb : n_trans;
  return (n_max * kTile * kActStride + kTile * (ke + 8) +
          kTile * kOutStride) *
         (int)sizeof(bf16);
}

}  // namespace
