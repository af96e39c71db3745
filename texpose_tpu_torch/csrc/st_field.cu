// Forward of the texture model's static/transient/light field, written by
// hand for Hopper (sm_90a) and bound to PyTorch through ctypes
// (texpose_tpu_torch/kernels/st_field.py).
//
// Replaces: texpose_tpu/kernels/fused_st_field.py::_run_fwd (the forward
// pallas_call, eval half; the JAX op also wrote an [M,256] feature residual
// for its backward, which evaluation does not need and this kernel does not
// write).
//
// Per 64-row tile, entirely in shared memory:
//   xext [64,kx]  -> 8x256 trunk (skip layers re-read xext) -> feat, density
//   feat ⊕ enc⊕pts [64,256+ke] -> RGB head (+ light-latent row) -> rgb_raw
//   feat            [64,256]    -> transient head (+ trans-latent row) -> trans_raw
// Each layer is bf16 x bf16 -> f32 on the tensor cores (mma.sync m16n8k16),
// then bias (+ latent row) in f32, ReLU, and one rounding to bf16 at the next
// layer's input — the arithmetic of the JAX kernel at compute_dtype=bfloat16.
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
// Rows past M are zero-filled on load and never stored, so M needs no
// tiling contract; the latent row of each row is indexed by
// row / rows_per_img.

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

struct Seg {                                      // a K-slice of the A operand
  const bf16* base;                               // shared, [kTile][stride]
  int stride;
  int k;                                          // columns, multiple of 16
};

struct Params {
  const bf16* xe;        // [M, kx+ke] bf16: xext | enc⊕pts, zero padded
  const uint2* wpack;    // every layer in walk order, fragment packed
  const float* bias;     // every layer in walk order, padded to 256 or 8
  const float* lrow;     // [n_img, 256] light latent @ its layer-0 rows
  const float* trow;     // [n_img, 256] trans latent @ its layer-0 rows
  float* rgb;            // [M, 3]
  float* dens;           // [M, 1]
  float* trans;          // [M, 5]
  int M, kx, ke, rows_per_img, n_img, n_trunk, n_rgb, n_trans;
  unsigned skip_mask;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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
    if (kt + 1 < kt_total) load_b<NT>(bn, w, kt_total, nt0, kt + 1, lane);
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
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      b[t][0] = bn[t][0];
      b[t][1] = bn[t][1];
    }
  }
}

// Hidden-layer epilogue: + bias (+ the row's latent contribution), ReLU,
// round to bf16 into the next shared activation buffer.
template <int NT>
__device__ __forceinline__ void store_hidden(const float (&acc)[4][NT][4],
                                             bf16* out, const float* bias,
                                             const float* lat, const Params& p,
                                             int row0, int nt0, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = i * 16 + g + h * 8;
      const float* lat_row = nullptr;
      if (lat != nullptr) {
        const int img = min((row0 + r) / p.rows_per_img, p.n_img - 1);
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
                                  p, row0, nt0, lane);
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

  // stage the tile's xext | enc⊕pts rows (16-byte vectors; rows past M = 0)
  const int vec_per_row = xw / 8;
  for (int i = threadIdx.x; i < kTile * vec_per_row; i += kThreads) {
    const int r = i / vec_per_row, c = i - r * vec_per_row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < p.M)
      v = __ldg(reinterpret_cast<const uint4*>(p.xe + (size_t)(row0 + r) * xw) + c);
    *reinterpret_cast<uint4*>(xe + r * xs + c * 8) = v;
  }
  __syncthreads();

  const Seg none = {xe, xs, 0};
  const Seg xseg = {xe, xs, p.kx};
  const Seg eseg = {xe + p.kx, xs, p.ke};
  const uint2* w = p.wpack;
  const float* b = p.bias;

  // trunk: layer li reads act[cur] (xext at layer 0; skip layers add xext)
  int cur = -1;
  for (int li = 0; li < p.n_trunk; ++li) {
    const Seg a1 = li == 0 ? xseg : Seg{act[cur], kActStride, kHidden};
    const Seg a2 = (li > 0 && ((p.skip_mask >> li) & 1u)) ? xseg : none;
    const int kt_total = (a1.k + a2.k) >> 4;
    const int nxt = (cur + 1) % 3;
    {
      float acc[4][kTilesPerWarp][4];
      warp_gemm<kTilesPerWarp>(acc, a1, a2, w, nt0, lane);
      store_hidden<kTilesPerWarp>(acc, act[nxt], b, nullptr, p, row0, nt0,
                                  lane);
    }
    w += (size_t)kt_total * (kHidden / 8) * 32;
    b += kHidden;
    if (li == p.n_trunk - 1) {
      // density = the last trunk layer's column 0, raw (packed as its own
      // n8 tile after the 256 feature columns)
      if (warp == 0) {
        float acc[4][1][4];
        warp_gemm<1>(acc, a1, a2, w, 0, lane);
        store_out(acc, p.dens, 1, b, row0, p.M, lane);
      }
      w += (size_t)kt_total * 32;
      b += 8;
    }
    __syncthreads();
    cur = nxt;
  }
  const int feat = cur;
  run_head(p.n_rgb, eseg, p.lrow, p.rgb, 3, act, feat, w, b, p, none, row0,
           nt0, warp, lane);
  run_head(p.n_trans, none, p.trow, p.trans, 5, act, feat, w, b, p, none,
           row0, nt0, warp, lane);
}

// The kernel's dynamic shared-memory limit as already set on each device
// (0 = not yet).  Function attributes persist, so they are set on the first
// launch that needs a larger limit and not on every launch.
constexpr int kMaxDevices = 64;
int g_smem_limit[kMaxDevices];

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int st_field_fwd(const void* xe, const void* wpack,
                            const void* bias, const void* lrow,
                            const void* trow, void* rgb, void* dens,
                            void* trans, int M, int kx, int ke,
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
  p.lrow = static_cast<const float*>(lrow);
  p.trow = static_cast<const float*>(trow);
  p.rgb = static_cast<float*>(rgb);
  p.dens = static_cast<float*>(dens);
  p.trans = static_cast<float*>(trans);
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
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > g_smem_limit[dev]) {
    e = cudaFuncSetAttribute(st_field_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(st_field_fwd_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
    if (e != cudaSuccess) return (int)e;
    g_smem_limit[dev] = smem;
  }
  const dim3 grid((M + kTile - 1) / kTile);
  st_field_fwd_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
