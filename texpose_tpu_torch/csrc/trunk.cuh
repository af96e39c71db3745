// The mma.sync building blocks of the field kernels: the backwards' dX
// chains (st_field.cu, coarse_field.cu, st_render.cu) and the field and
// trunk forwards' mma.sync form, which is compiled only in the measurement
// build -DFIELD_FWD_MMA_SYNC (the shipped forwards, the trunk's included,
// are field_fwd.cuh's wgmma + TMA tile).
//
// A block owns a 64-row tile with 8 warps; every warp owns all 64 rows and a
// disjoint 32-column slice of each 256-wide layer, so each weight element is
// read once per 64-row tile, from L2.  Activations live in shared memory as
// bf16 rows padded to 264 (bank-conflict free for ldmatrix and the epilogue
// stores).  Weights are packed once on the host in mma fragment order
// (kernels/st_field.py ``_pack_layer``): a warp fetches each 16x8 B tile
// with one coalesced 256-byte load, prefetched one k-step ahead.  Each layer
// is bf16 x bf16 -> f32 (mma.sync m16n8k16), then bias in f32, ReLU, and one
// rounding to bf16 at the next layer's input.
//
// Backward building blocks: ``warp_dw`` accumulates Hᵀ·G over the tile's rows
// (ldmatrix.trans of both operands) and adds it to a global f32 gradient with
// atomicAdd — blocks run in parallel, so the cross-tile sum is atomic.
// Measurement builds (wrong results; tools/probe_field_bwd_atomics.py times
// each, with -DFIELD_BWD_ONE_KERNEL, against the one-kernel field backwards
// of coarse_field.cu and st_field.cu): TRUNK_DW_PLAIN_STORES writes
// each dW partial with a plain store instead of atomicAdd (same products
// and bytes); TRUNK_BWD_NO_DW skips ``warp_dw``; TRUNK_BWD_NO_DX skips the
// backwards' dX products (``dx_gemm``); TRUNK_BWD_NO_LOADS stages zeros in
// place of every row load (``load_rows``).  For the mma.sync forwards
// (tools/probe_field_fwd.py, with -DFIELD_FWD_MMA_SYNC):
// TRUNK_FWD_NO_WEIGHT_LOADS fetches each warp_gemm's first k-step of B
// fragments and reuses them for every k-step (no L2 weight traffic past
// the first); TRUNK_FWD_NO_RES_STORES drops the residual stores
// (``store_residual``); TRUNK_FWD_NO_EPILOGUE drops the hidden layers'
// epilogue (``store_hidden``: bias, ReLU, the bf16 stores to shared).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;                         // rows per block
constexpr int kHidden = 256;                      // width of every hidden layer
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kActStride = kHidden + 8;           // bf16 per shared row
constexpr int kTilesPerWarp = kHidden / 8 / kWarps;   // n8 tiles per warp
constexpr int kOutPad = 16;                       // output-layer grads, padded K
constexpr int kOutStride = kOutPad + 8;

struct Seg {                                      // a K-slice of the A operand
  const bf16* base;                               // shared, [kTile][stride]
  int stride;
  int k;                                          // columns, multiple of 16
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of n8 tiles nt0..nt0+NT-1 at k-step kt.  Packed layout: tile
// (nt, kt) is 32 uint2, lane l holding B[k][n] for n = nt*8 + l/4 and
// k = kt*16 + {2q, 2q+1, 2q+8, 2q+9}, q = l%4.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], const uint2* w,
                                       int kt_total, int nt0, int kt,
                                       int lane) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const uint2 v =
        __ldg(w + ((size_t)(nt0 + t) * kt_total + kt) * 32 + lane);
    b[t][0] = v.x;
    b[t][1] = v.y;
  }
}

// acc[i][t] = rows i*16..+15 x cols (nt0+t)*8..+7 of [s1 | s2] @ W.
template <int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[4][NT][4],
                                          const Seg& s1, const Seg& s2,
                                          const uint2* w, int nt0, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
  const int kt1 = s1.k >> 4;
  const int kt_total = kt1 + (s2.k >> 4);
  const int arow = lane & 15;
  const int acol = (lane >> 4) * 8;
  uint32_t b[NT][2], bn[NT][2];
  load_b<NT>(b, w, kt_total, nt0, 0, lane);
  for (int kt = 0; kt < kt_total; ++kt) {
#ifndef TRUNK_FWD_NO_WEIGHT_LOADS
    if (kt + 1 < kt_total) load_b<NT>(bn, w, kt_total, nt0, kt + 1, lane);
#endif
    const bool first = kt < kt1;
    const bf16* a_base = first ? s1.base : s2.base;
    const int stride = first ? s1.stride : s2.stride;
    const int k0 = (first ? kt : kt - kt1) * 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t a[4];
      ldmatrix_x4(a, a_base + (i * 16 + arow) * stride + k0 + acol);
#pragma unroll
      for (int t = 0; t < NT; ++t) mma_bf16(acc[i][t], a, b[t][0], b[t][1]);
    }
#ifndef TRUNK_FWD_NO_WEIGHT_LOADS
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      b[t][0] = bn[t][0];
      b[t][1] = bn[t][1];
    }
#endif
  }
}

// A backward's dX product, g · Wᵀ (warp_gemm over the packed Wᵀ).
template <int NT>
__device__ __forceinline__ void dx_gemm(float (&acc)[4][NT][4], const Seg& s1,
                                        const Seg& s2, const uint2* w, int nt0,
                                        int lane) {
#ifdef TRUNK_BWD_NO_DX
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
#else
  warp_gemm<NT>(acc, s1, s2, w, nt0, lane);
#endif
}

// Hidden-layer epilogue: + bias (+ the row's latent contribution), ReLU,
// round to bf16 into the next shared activation buffer.
template <int NT>
__device__ __forceinline__ void store_hidden(const float (&acc)[4][NT][4],
                                             bf16* out, const float* bias,
                                             const float* lat, int rows_per_img,
                                             int n_img, int row0, int nt0,
                                             int lane) {
#ifdef TRUNK_FWD_NO_EPILOGUE
  return;
#endif
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 16 + g + h * 8;
      const float* lat_row = nullptr;
      if (lat != nullptr) {
        const int img = min((row0 + r) / rows_per_img, n_img - 1);
        lat_row = lat + (size_t)img * kHidden;
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int col = (nt0 + t) * 8 + 2 * q;
        float v0 = acc[i][t][2 * h] + __ldg(bias + col);
        float v1 = acc[i][t][2 * h + 1] + __ldg(bias + col + 1);
        if (lat_row != nullptr) {
          v0 += __ldg(lat_row + col);
          v1 += __ldg(lat_row + col + 1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + r * kActStride + col) =
            __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
}

// Output-layer epilogue (one n8 tile): + bias, no activation, f32 to global.
__device__ __forceinline__ void store_out(const float (&acc)[4][1][4],
                                          float* out, int ncols,
                                          const float* bias, int row0, int M,
                                          int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + i * 16 + g + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * q + e;
        if (col < ncols)
          out[(size_t)row * ncols + col] = acc[i][0][2 * h + e] + __ldg(bias + col);
      }
    }
  }
}

// Copy a shared [64][stride] activation tile (256 columns) to rows row0..
// of a global [M, 256] bf16 buffer (16-byte vectors; rows past M are not
// stored).
__device__ __forceinline__ void store_tile(bf16* dst, const bf16* src,
                                           int row0, int M,
                                           int stride = kActStride) {
  constexpr int kVec = kHidden / 8;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = i - r * kVec;
    if (row0 + r < M)
      reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * kHidden)[c] =
          *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
  }
}

// A forward's residual tile (store_tile), compiled out in the measurement
// build TRUNK_FWD_NO_RES_STORES.
__device__ __forceinline__ void store_residual(bf16* dst, const bf16* src,
                                               int row0, int M) {
#ifndef TRUNK_FWD_NO_RES_STORES
  store_tile(dst, src, row0, M);
#endif
}

// The split backwards' narrow gradient plane [M, 16] bf16 (the output and
// density layers' gradients, read by dw_gemm.cu): columns col0..col0+7 of
// the tile's rows get bf16(g[r][c]) for c < ncols, zero beyond; g is the
// tile's f32 [rows, ncols] gradient (row r at g[r*ncols]).
constexpr int kNarrowCols = 16;
__device__ __forceinline__ void store_narrow(bf16* gn, int col0,
                                             const float* g, int ncols,
                                             int row0, int M) {
  for (int i = threadIdx.x; i < kTile * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    if (row0 + r < M)
      gn[(size_t)(row0 + r) * kNarrowCols + col0 + c] =
          __float2bfloat16_rn(c < ncols ? g[(size_t)r * ncols + c] : 0.f);
  }
}

// Stage rows row0.. of a global [M, width] bf16 buffer (width a multiple of
// 8) into shared rows of `stride`; rows past M are zero.
__device__ __forceinline__ void load_rows(bf16* dst, int stride,
                                          const bf16* src, int width,
                                          int row0, int M) {
  const int vec = width / 8;
  for (int i = threadIdx.x; i < kTile * vec; i += kThreads) {
    const int r = i / vec, c = i - r * vec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
#ifndef TRUNK_BWD_NO_LOADS
    if (row0 + r < M)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * width) + c);
#endif
    *reinterpret_cast<uint4*>(dst + r * stride + c * 8) = v;
  }
}

// The trunk on a staged tile.  Layer li reads act[cur] (xext at layer 0;
// skip layers also read xext), writes act[(cur+1)%3]; the last layer's
// column 0 (packed as its own n8 tile after the 256 feature columns) is the
// raw density, stored to dens [M,1].  With `res`, every layer's bf16 ReLU
// output is also stored to res + li·M·256 (the backward's residuals).
// Returns the index of the buffer holding the features.
__device__ __forceinline__ int trunk_forward(
    const Seg& xseg, const Seg& none, bf16* const (&act)[3], const uint2* w,
    const float* b, int n_trunk, unsigned skip_mask, float* dens, bf16* res,
    int row0, int M, int warp, int lane) {
  const int nt0 = warp * kTilesPerWarp;
  int cur = -1;
  for (int li = 0; li < n_trunk; ++li) {
    const Seg a1 = li == 0 ? xseg : Seg{act[cur], kActStride, kHidden};
    const Seg a2 = (li > 0 && ((skip_mask >> li) & 1u)) ? xseg : none;
    const int kt_total = (a1.k + a2.k) >> 4;
    const int nxt = (cur + 1) % 3;
    {
      float acc[4][kTilesPerWarp][4];
      warp_gemm<kTilesPerWarp>(acc, a1, a2, w, nt0, lane);
      store_hidden<kTilesPerWarp>(acc, act[nxt], b, nullptr, 1, 1, row0, nt0,
                                  lane);
    }
    w += (size_t)kt_total * (kHidden / 8) * 32;
    b += kHidden;
    if (li == n_trunk - 1 && warp == 0) {
      float acc[4][1][4];
      warp_gemm<1>(acc, a1, a2, w, 0, lane);
      store_out(acc, dens, 1, b, row0, M, lane);
    }
    __syncthreads();
    if (res != nullptr)
      store_residual(res + (size_t)li * M * kHidden, act[nxt], row0, M);
    cur = nxt;
  }
  return cur;
}

// dW[i0+.., n0+..] += Hᵀ·G over the 64 tile rows: H [64][sh] shared (the
// layer input, columns i), G [64][sg] shared (the layer's output gradient,
// columns n).  MT m16 tiles of i (mt_valid of them in range), NT n8 tiles.
template <int MT, int NT>
__device__ __forceinline__ void warp_dw(const bf16* H, int sh, int i0,
                                        int mt_valid, const bf16* G, int sg,
                                        int n0, float* dW, int ldw,
                                        int lane) {
#ifdef TRUNK_BWD_NO_DW
  return;
#endif
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
  const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int ks = 0; ks < kTile / 16; ++ks) {
    const int k0 = ks * 16;
    uint32_t b[NT][2];
    if constexpr (NT == 1) {
      uint32_t r[2];
      ldmatrix_x2_trans(r, G + (k0 + r8 + ((mat & 1) << 3)) * sg + n0);
      b[0][0] = r[0];
      b[0][1] = r[1];
    } else {
#pragma unroll
      for (int t = 0; t + 1 < NT; t += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, G + (k0 + r8 + ((mat & 1) << 3)) * sg + n0 +
                                 t * 8 + ((mat >> 1) << 3));
        b[t][0] = r[0];
        b[t][1] = r[1];
        b[t + 1][0] = r[2];
        b[t + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < mt_valid) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, H + (k0 + r8 + ((mat >> 1) << 3)) * sh + i0 +
                                 i * 16 + ((mat & 1) << 3));
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_bf16(acc[i][t], a, b[t][0], b[t][1]);
      }
    }
  }
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= mt_valid) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i0 + i * 16 + g + ((e >> 1) << 3);
        const int col = n0 + t * 8 + 2 * q + (e & 1);
#ifdef TRUNK_DW_PLAIN_STORES
        dW[(size_t)row * ldw + col] = acc[i][t][e];
#else
        atomicAdd(dW + (size_t)row * ldw + col, acc[i][t][e]);
#endif
      }
  }
}

// A kernel's dynamic shared-memory limit as already set on each device
// (0 = not yet).  Function attributes persist, so they are set on the first
// launch that needs a larger limit and not on every launch.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, int smem, int* limits) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > limits[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
    if (e != cudaSuccess) return e;
    limits[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace
