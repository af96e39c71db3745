// The field forwards on Hopper's wgmma + TMA, shared by the ST field
// (st_field.cu, row 1), the ST render forward (st_render.cu, row 6f), the
// coarse field's two forwards (coarse_field.cu, rows 7a and 8) and the trunk
// forward (trunk_fwd.cu, row 10).  The kernels' headers say what each
// computes; this file is the tile.
//
// A block is persistent: it walks 128-row tiles blockIdx.x, +gridDim.x, ...
// Its 8 warps are two warpgroups, each owning 64 rows × all 256 columns of
// every layer (wgmma m64n256k16, its f32 accumulator 128 registers a
// thread: 256 threads leave each up to 255).  Thread 0 keeps the loads
// `stages` slices ahead, in program order: per tile, the row input (xext |
// enc⊕pts, 64-column boxes) into each warpgroup's X region, and every
// layer's weights as 64-row K slices (four 64×64 boxes, 128-byte swizzle)
// through a ring of mbarrier'd stages; both warpgroups consume every slice,
// so a tile of 128 rows reads each weight element from L2 once.  A slice is
// refilled when both warpgroups have released it.  The narrow layers (the
// density column and the heads' 3- and 5-column outputs, padded to 8) come
// as one 256×8 slice each and run as m64n8k16.  No warp is set aside to
// produce: a producer warp would cap every thread at 168 registers
// (registers go to warps in fours), which the 128 accumulators and the
// epilogue's batched loads exceed.
//
// A layer's A operand is K-major in shared memory, in the 128-byte swizzled
// layout TMA writes and wgmma reads: 64-column blocks of 64 rows × 128 B.
// The walk, built on the host (kernels/field_fwd.py), says for each layer
// which buffer (A, the warpgroup's activation buffer, or X, its row-input
// region) and which blocks feed its k-steps (whole blocks: 4 k-steps, one
// slice each; the columns past a segment's width are zero), where its
// weights start, where its output goes, which latent row its epilogue adds
// and which residual plane receives it.  Nothing else: the kernel is the
// same for every field.  After a layer's last wgmma group completes, its
// epilogue adds the bias (and the per-image latent row, row /
// rows_per_img) in f32, applies ReLU and rounds to bf16 in one conversion
// and writes the output over its input rows in place with stmatrix, in the
// layout the next layer's descriptors read; a residual plane is stored from
// there by TMA (rows past M are clipped), behind the next layer's products,
// and waited for (bulk wait_group.read) only before the buffer is
// overwritten.  The narrow layers' raw outputs go to device memory in f32.
// A ragged last tile loads zeros past M and stores nothing past M.
//
// With a composite epilogue (kEpi), each warpgroup composites the rays of
// its own rows (N | 64, one warp per ray) from the raw outputs it wrote,
// once its last tile is done: between two tiles the composite's
// warp-divergent code would make ptxas serialize the next tile's wgmma.
// The raw outputs are still in L2 then (36 B a row).
//
// Measurement builds (wrong results; tools/probe_field_fwd.py times each
// against this build): FIELD_FWD_NO_WEIGHT_LOADS completes every weight
// slice's barrier without its copy; FIELD_FWD_NO_WGMMA issues no product;
// FIELD_FWD_NO_EPILOGUE skips the epilogues' arithmetic and stores.

#pragma once

#include "composite_st.cuh"
#include "hopper.cuh"
#include "trunk.cuh"

namespace {

constexpr int kFwdRows = 128;              // rows per tile
constexpr int kFwdThreads = 256;           // two warpgroups
constexpr int kBlock = 64 * 64 * 2;        // one 64-row × 64-column bf16 block
constexpr int kStage = 4 * kBlock;         // a wide slice: 64 K rows × 256
constexpr int kNarrowRows = 256;           // K rows of a narrow slice
constexpr int kNarrowBytes = kNarrowRows * 8 * 2;
constexpr int kMaxStages = 4;
constexpr int kMaxLayers = 32;
constexpr int kLayerInts = 16;
constexpr int kSmemCap = 232448;           // a block's shared memory on sm_90

// One layer of the walk (kernels/field_fwd.py builds the table).
enum LayerField {
  L_WROW,      // first row of its 256-column weights in the wide pack, or -1
  L_NROW,      // first row of its 8-column weights in the narrow pack, or -1
  L_S0BUF, L_S0BLK, L_S0STEPS,   // A segment 0: buffer, first block, k-steps
  L_S1BUF, L_S1BLK, L_S1STEPS,   // A segment 1 (0 steps: none)
  L_OUT,       // buffer its 256 ReLU'd outputs overwrite, or -1
  L_BIAS,      // offset of its 256 biases, or -1
  L_NBIAS,     // offset of its 8 narrow biases, or -1
  L_LAT,       // latent row added in the epilogue: 0 none, 1 lrow, 2 trow
  L_NOUT,      // narrow output: 0 none, 1 dens [M,1], 2 rgb [M,3], 3 trans [M,5]
  L_RES,       // residual plane its output goes to, or -1
  L_XFREE,     // 1: the X region is free once its products are done
};
enum { BUF_A = 0, BUF_X = 1 };
enum { EPI_NONE = 0, EPI_COARSE = 1, EPI_ST = 2 };

// The launchers' flat arguments (kernels/field_fwd.py fills them in this
// order).
enum FwdPtr {
  P_WIDE, P_NARROW, P_BIAS, P_XE, P_LROW, P_TROW, P_RGB, P_DENS, P_TRANS,
  P_RES, P_DIST, P_DEPTH, P_OUT, kFwdPtrs
};
enum FwdInt {
  I_M, I_KX, I_KE, I_WIDE_ROWS, I_NARROW_ROWS, I_LAYERS, I_ROWS_PER_IMG,
  I_N_IMG, I_N_RES, I_N, I_BX, I_XBLOCKS, I_XREGION, kFwdInts
};

struct FwdParams {
  CUtensorMap wide;      // [Rw, 256] bf16, boxes 64 × 64
  CUtensorMap narrow;    // [Rn, 8] bf16, boxes 8 × 256
  CUtensorMap xe;        // [M, kx+ke] bf16, boxes 64 × 64
  CUtensorMap res;       // [n_res, M, 256] bf16, boxes 64 × 64
  const float* bias;
  const float* lat[3];   // -, lrow, trow: [n_img, 256] f32
  float* raw[4];         // -, dens [M,1], rgb [M,3], trans [M,5]
  const float* dist;     // [BR, N]
  const float* depth;    // [BR, N]
  float* out;            // [BR, 8] (coarse) or [BR, 16] (ST)
  int M, kx, bx, xblocks, xregion, rows_per_img, n_img, N, n_layers, stages;
  int tiles;
  float min_uncert;
  int table[kMaxLayers][kLayerInts];
};

// The shared-memory regions and barriers of a block.
struct Smem {
  unsigned char* ring;     // stages × kStage
  unsigned char* act;      // per warpgroup 4 blocks
  unsigned char* xr;       // per warpgroup xregion blocks
  uint64_t* full;          // per stage: its slice has landed
  uint64_t* empty;         // per stage: both warpgroups are done with it
  uint64_t* xfull;         // the X regions hold the tile's row input
  uint64_t* xempty;        // both warpgroups are done with their X region
};

// Number of ring slices of layer L: its 256-column weights in 4-step slices,
// then its narrow tile.
__device__ __forceinline__ int layer_slices(const int* L) {
  return (L[L_WROW] >= 0 ? (L[L_S0STEPS] + L[L_S1STEPS]) >> 2 : 0) +
         (L[L_NROW] >= 0 ? 1 : 0);
}

// The loads, in the consumers' order: where the next slice to load lies
// (tile, layer, slice in the layer) and how many were loaded.  Every
// consumer thread runs the same walk (so no thread-dependent branch sits
// between a wgmma and its wait); only thread 0's copies and arrivals are
// on.
struct Loader {
  int tile, l, j, n;

  // The X regions of `tile` (both warpgroups), completing xfull.
  __device__ __forceinline__ void load_x(const FwdParams& p, const Smem& s,
                                         int tile, bool on) {
    mbar_expect_tx(s.xfull, 2 * p.xblocks * kBlock, on);
    for (int wg = 0; wg < 2; ++wg)
      for (int b = 0; b < p.xblocks; ++b)
        tma_load(s.xr + (wg * p.xregion + b) * kBlock, &p.xe,
                 b < p.bx ? 64 * b : p.kx + 64 * (b - p.bx),
                 tile * kFwdRows + 64 * wg, 0, s.xfull, on);
  }

  // The next slice into its stage, once both warpgroups released the
  // slice that stage held; nothing past the last tile.
  __device__ __forceinline__ void load_slice(const FwdParams& p,
                                             const Smem& s, bool on) {
    if (tile >= p.tiles) return;
    const int* L = p.table[l];
    const int st = n % p.stages;
    if (n >= p.stages) mbar_wait(&s.empty[st], (n / p.stages - 1) & 1);
    unsigned char* const dst = s.ring + st * kStage;
#ifdef FIELD_FWD_NO_WEIGHT_LOADS
    mbar_arrive(&s.full[st], on);
#else
    if (L[L_WROW] >= 0 && 4 * j < L[L_S0STEPS] + L[L_S1STEPS]) {
      mbar_expect_tx(&s.full[st], kStage, on);
      for (int b = 0; b < 4; ++b)
        tma_load(dst + b * kBlock, &p.wide, 64 * b, L[L_WROW] + 64 * j, 0,
                 &s.full[st], on);
    } else {
      mbar_expect_tx(&s.full[st], kNarrowBytes, on);
      tma_load(dst, &p.narrow, 0, L[L_NROW], 0, &s.full[st], on);
    }
#endif
    ++n;
    if (++j == layer_slices(L)) {
      j = 0;
      if (++l == p.n_layers) {
        l = 0;
        tile += gridDim.x;
      }
    }
  }
};

// ------------------------------------------------------------------ consumers

// This thread's 64 biases of a 256-column layer (columns 8j + 2q, +1),
// loaded while the layer's last products run.
__device__ __forceinline__ void load_bias(float2 (&bb)[32], const float* bias,
                                          int q) {
#pragma unroll
  for (int j = 0; j < 32; ++j)
    bb[j] = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * q));
}

// Bias (+ latent row) in f32, then ReLU and the bf16 rounding in one
// conversion, into the swizzled blocks of `dst` by stmatrix: thread (w4, g,
// q) holds rows 16·w4 + g (+8), columns 8j + 2q (+1); one stmatrix.x4 takes
// the 8-column blocks j, j+1 of both 8-row halves, lane l addressing row
// l % 8 of block j + l / 16, half (l / 8) % 2.
__device__ __forceinline__ void store_act(const float (&acc)[128],
                                          const float2 (&bb)[32],
                                          unsigned char* dst,
                                          const float* lat,
                                          const FwdParams& p, int row_base,
                                          int w4, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 16 * w4 + g;
  const float* la = nullptr;
  const float* lb = nullptr;
  if (lat != nullptr) {
    la = lat + (size_t)min((row_base + r0) / p.rows_per_img, p.n_img - 1) * kHidden;
    lb = lat + (size_t)min((row_base + r0 + 8) / p.rows_per_img, p.n_img - 1) * kHidden;
  }
  // this lane's stmatrix row: 16·w4 + 8·((l / 8) % 2) + l % 8
  const int srow = 16 * w4 + (((lane >> 3) & 1) << 3) + (lane & 7);
  const uint32_t row_addr = smem_u32(dst) + srow * 128;
  const int sub = lane >> 4;                      // block j or j + 1
  // 8 column blocks at a time: their latent loads (the heads' layer 0)
  // are issued together, ahead of the stores
#pragma unroll
  for (int jc = 0; jc < 32; jc += 8) {
    float2 xa[8], xb[8];
    if (lat != nullptr) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int col = 8 * (jc + u) + 2 * q;
        xa[u] = __ldg(reinterpret_cast<const float2*>(la + col));
        xb[u] = __ldg(reinterpret_cast<const float2*>(lb + col));
      }
    }
#pragma unroll
    for (int u = 0; u < 8; u += 2) {
      uint32_t r[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = jc + u + h;
        float v0 = acc[4 * j] + bb[j].x, v1 = acc[4 * j + 1] + bb[j].y;
        float v2 = acc[4 * j + 2] + bb[j].x, v3 = acc[4 * j + 3] + bb[j].y;
        if (lat != nullptr) {
          v0 += xa[u + h].x;
          v1 += xa[u + h].y;
          v2 += xb[u + h].x;
          v3 += xb[u + h].y;
        }
        r[2 * h] = relu_bf16x2(v0, v1);
        r[2 * h + 1] = relu_bf16x2(v2, v3);
      }
      const int cb = jc + u + sub;                // this lane's 8-column block
      stmatrix_x4(row_addr + (cb >> 3) * kBlock + (((cb & 7) ^ (lane & 7)) << 4),
                  r[0], r[1], r[2], r[3]);
    }
  }
}

// A narrow layer's raw outputs (+ bias, f32) to device memory.
__device__ __forceinline__ void store_raw(const float (&acc)[4], float* out,
                                          int ncols, const float* bias,
                                          int M, int row_base, int w4, int g,
                                          int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + 16 * w4 + g + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 2 * q + e;
      if (col < ncols)
        out[(size_t)row * ncols + col] = acc[2 * h + e] + __ldg(bias + col);
    }
  }
}

// Releases the stage of ring slice `c` for this warpgroup, then refills the
// ring (which waits for the other warpgroup's release of the same slice).
__device__ __forceinline__ void release(const FwdParams& p, const Smem& s,
                                        Loader& ld, int c, int t) {
  mbar_arrive(&s.empty[c % p.stages], t == 0);
  ld.load_slice(p, s, threadIdx.x == 0);
}

template <int kEpi>
__device__ __forceinline__ void consume(const FwdParams& p, const Smem& s) {
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int w4 = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  unsigned char* const buf[2] = {s.act + wg * 4 * kBlock,
                                 s.xr + wg * p.xregion * kBlock};
  const int bar_id = 1 + wg;
  Loader ld = {(int)blockIdx.x, 0, 0, 0};
  ld.load_x(p, s, blockIdx.x, threadIdx.x == 0);
  for (int i = 0; i < p.stages; ++i) ld.load_slice(p, s, threadIdx.x == 0);
  float acc[128];
  float nacc[4];
  int c = 0, it = 0;
  bool stores = false;               // a residual store may still read a buffer
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++it) {
    const int row_base = tile * kFwdRows + 64 * wg;
    mbar_wait(s.xfull, it & 1);
    for (int l = 0; l < p.n_layers; ++l) {
      int L[kLayerInts];             // the layer's row, in registers
#pragma unroll
      for (int f = 0; f < kLayerInts; ++f) L[f] = p.table[l][f];
      const int s0 = L[L_S0STEPS];
      const int steps = s0 + L[L_S1STEPS];
      // the A segments' first blocks; a slice's 4 k-steps lie in one
      // 64-column block (K-major, 128-byte swizzle: 8-row groups 1024 B
      // apart, a k-step 32 B into the block)
      const uint32_t a0 =
          smem_u32((L[L_S0BUF] ? buf[1] : buf[0]) + L[L_S0BLK] * kBlock);
      const uint32_t a1 =
          smem_u32((L[L_S1BUF] ? buf[1] : buf[0]) + L[L_S1BLK] * kBlock);
      int held = -1;                 // the slice whose stage awaits release
      if (L[L_WROW] >= 0) {
        // the first k-step writes the accumulators without reading them, so
        // they hold no registers between two layers
        for (int k = 0; k < steps; k += 4, ++c) {
          const int st = c % p.stages;
          mbar_wait(&s.full[st], (c / p.stages) & 1);
          const uint32_t b = smem_u32(s.ring + st * kStage);
          const uint32_t a =
              k < s0 ? a0 + (k >> 2) * kBlock : a1 + ((k - s0) >> 2) * kBlock;
          if (k > 0) fence_acc(acc);
          wgmma_fence();
#ifndef FIELD_FWD_NO_WGMMA
          if (k == 0)
            wgmma_n256_first<0>(acc, desc(a, 16, 1024, 1),
                                desc(b, kBlock, 1024, 1));
          else
            wgmma_n256<0>(acc, desc(a, 16, 1024, 1),
                          desc(b, kBlock, 1024, 1));
#pragma unroll
          for (int i = 1; i < 4; ++i)
            wgmma_n256<0>(acc, desc(a + 32 * i, 16, 1024, 1),
                          desc(b + 2048 * i, kBlock, 1024, 1));
#endif
          wgmma_commit();
          fence_acc(acc);
          wgmma_wait<1>();
          if (held >= 0) release(p, s, ld, held, t);
          held = c;
        }
      }
      if (L[L_NROW] >= 0) {
        const int st = c % p.stages;
        mbar_wait(&s.full[st], (c / p.stages) & 1);
        const uint32_t b = smem_u32(s.ring + st * kStage);
        wgmma_fence();
#ifndef FIELD_FWD_NO_WGMMA
        wgmma_n8_first<0>(nacc, desc(a0, 16, 1024, 1), desc(b, 128, 128, 0));
#pragma unroll
        for (int i = 1; i < kNarrowRows / 16; ++i)
          wgmma_n8<0>(nacc,
                      desc(a0 + (i >> 2) * kBlock + (i & 3) * 32, 16, 1024, 1),
                      desc(b + i * 256, 128, 128, 0));
#endif
        wgmma_commit();
        fence_acc(nacc);
        wgmma_wait<1>();
        if (held >= 0) release(p, s, ld, held, t);
        held = c++;
      }
      float2 bb[32];
      if (L[L_OUT] >= 0) load_bias(bb, p.bias + L[L_BIAS], q);
      wgmma_wait<0>();
      if (L[L_WROW] >= 0) fence_acc(acc);
      if (L[L_NROW] >= 0) fence_acc(nacc);
      release(p, s, ld, held, t);
      if (L[L_XFREE]) {
        // the X region is free: the next tile's row input goes there once
        // the other warpgroup is done with its own
        mbar_arrive(s.xempty, t == 0);
        if (tile + (int)gridDim.x < p.tiles) {
          mbar_wait(s.xempty, it & 1);
          ld.load_x(p, s, tile + gridDim.x, threadIdx.x == 0);
        }
      }

#ifndef FIELD_FWD_NO_EPILOGUE
      if (L[L_OUT] >= 0) {
        if (stores) {                // the buffer may still be read by TMA
          if (t == 0) bulk_wait_read();
          named_bar(bar_id, 128);
          stores = false;
        }
        store_act(acc, bb, L[L_OUT] ? buf[1] : buf[0],
                  L[L_LAT] == 0 ? nullptr : L[L_LAT] == 1 ? p.lat[1] : p.lat[2],
                  p, row_base, w4, lane);
      }
      if (L[L_NOUT] > 0)
        store_raw(nacc,
                  L[L_NOUT] == 1 ? p.raw[1] : L[L_NOUT] == 2 ? p.raw[2] : p.raw[3],
                  L[L_NOUT] == 1 ? 1 : L[L_NOUT] == 2 ? 3 : 5,
                  p.bias + L[L_NBIAS], p.M, row_base, w4, g, q);
#endif
      fence_proxy_async();
      named_bar(bar_id, 128);
      if (L[L_RES] >= 0) {
        if (t == 0) {
          for (int b = 0; b < 4; ++b)
            tma_store(&p.res, (L[L_OUT] ? buf[1] : buf[0]) + b * kBlock,
                      64 * b, row_base, L[L_RES]);
          bulk_commit();
        }
        stores = true;
      }
    }
  }

  if constexpr (kEpi != EPI_NONE) {
    // the composite, once every tile's products are done (between two
    // tiles its warp-divergent code would serialize the next tile's
    // wgmma): each warpgroup composites the rays of its own rows (N | 64),
    // one warp per ray, from the raw outputs it wrote (still in L2)
    named_bar(bar_id, 128);
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int row_base = tile * kFwdRows + 64 * wg;
      for (int r = w4; r < 64 / p.N; r += 4) {
        const int ray = row_base / p.N + r;
        const size_t row = (size_t)ray * p.N;
        if (row >= (size_t)p.M) break;             // uniform per warp
        if constexpr (kEpi == EPI_COARSE) {
          if (p.N <= 32)
            composite_coarse_ray<1>(p.raw[2], p.raw[1], p.dist, p.depth, ray,
                                    p.N, lane, p.out);
          else
            composite_coarse_ray<2>(p.raw[2], p.raw[1], p.dist, p.depth, ray,
                                    p.N, lane, p.out);
        } else {
          float* const o = p.out + (size_t)ray * 16;
          if (p.N <= 32)
            composite_st_ray<1>(p.raw[2] + row * 3, p.raw[3] + row * 5,
                                p.raw[1] + row, p.depth + row, p.dist + row,
                                p.N, p.min_uncert, lane, o);
          else
            composite_st_ray<2>(p.raw[2] + row * 3, p.raw[3] + row * 5,
                                p.raw[1] + row, p.depth + row, p.dist + row,
                                p.N, p.min_uncert, lane, o);
        }
      }
    }
  }
  if (t == 0) bulk_wait();
}

template <int kEpi>
__global__ void __launch_bounds__(kFwdThreads, 1)
    field_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  Smem s;
  s.ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  s.act = s.ring + p.stages * kStage;
  s.xr = s.act + 2 * 4 * kBlock;
  s.full = reinterpret_cast<uint64_t*>(s.xr + 2 * p.xregion * kBlock);
  s.empty = s.full + kMaxStages;
  s.xfull = s.empty + kMaxStages;
  s.xempty = s.xfull + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 2);
    }
    mbar_init(s.xfull, 1);
    mbar_init(s.xempty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  consume<kEpi>(p, s);
}

// Shared memory of a block with `stages` ring stages and an X region of
// `xregion` blocks per warpgroup (the ring and the activations 1024-aligned).
int fwd_smem(int stages, int xregion) {
  return 1024 + stages * kStage + 2 * (4 + xregion) * kBlock +
         (2 * kMaxStages + 2) * 8;
}

// Checks the walk against the buffers and packs it addresses; true if bad.
// Segments are whole 64-column blocks (the slice's last k-steps may read
// past a segment's weight rows, into the next segment's or past the pack:
// the A columns there are zero).  Exactly one layer frees the X region,
// and no later layer touches it.
bool bad_walk(const int* table, int n, int xregion, int n_res,
              int wide_rows, int narrow_rows) {
  if (n < 1 || n > kMaxLayers) return true;
  int freed = 0;
  for (int l = 0; l < n; ++l) {
    const int* L = table + l * kLayerInts;
    const int size[2] = {4, xregion};
    for (int sg = 0; sg < 2; ++sg) {
      const int buf = L[L_S0BUF + 3 * sg], blk = L[L_S0BLK + 3 * sg];
      const int steps = L[L_S0STEPS + 3 * sg];
      if (steps < 0 || steps % 4 || (sg == 0 && steps == 0)) return true;
      if (steps == 0) continue;
      if (buf < 0 || buf > 1 || blk < 0 || blk + steps / 4 > size[buf])
        return true;
    }
    const int steps = L[L_S0STEPS] + L[L_S1STEPS];
    if (L[L_WROW] < 0 && L[L_NROW] < 0) return true;
    if (L[L_WROW] >= 0 &&
        (L[L_BIAS] < 0 || L[L_OUT] < 0 || L[L_OUT] > 1 ||
         L[L_WROW] + 16 * steps > wide_rows + 48))
      return true;
    if (L[L_WROW] < 0 && (L[L_OUT] >= 0 || L[L_RES] >= 0)) return true;
    if (L[L_NROW] >= 0 &&
        (L[L_S0STEPS] != kNarrowRows / 16 || L[L_S1STEPS] != 0 ||
         L[L_NBIAS] < 0 || L[L_NOUT] < 1 || L[L_NOUT] > 3 ||
         L[L_NROW] + kNarrowRows > narrow_rows))
      return true;
    if (L[L_LAT] < 0 || L[L_LAT] > 2 || L[L_RES] >= n_res) return true;
    if (L[L_OUT] == BUF_X && xregion < 4) return true;
    const bool uses_x = L[L_S0BUF] == BUF_X || L[L_OUT] == BUF_X ||
                        (L[L_S1STEPS] > 0 && L[L_S1BUF] == BUF_X);
    if ((freed && uses_x) || (L[L_XFREE] && L[L_OUT] == BUF_X)) return true;
    freed += L[L_XFREE] != 0;
  }
  return freed != 1;
}

// The forward launch shared by the entry points: checks, encodes the maps,
// sizes the ring to the shared memory left and launches one persistent block
// per SM (fewer for fewer tiles) on `stream`.  ke may be 0 (the trunk
// kernel's walk: no enc⊕pts columns, xblocks == bx).  Returns a cudaError_t.
template <int kEpi>
int launch_field_fwd(const long long* ptrs, const int* ints, const int* table,
                     float min_uncert, void* stream, int* limits) {
  const int M = ints[I_M], kx = ints[I_KX], ke = ints[I_KE];
  if (M <= 0) return 0;
  const int bx = ints[I_BX], xblocks = ints[I_XBLOCKS];
  const int xregion = ints[I_XREGION], n = ints[I_LAYERS];
  if (kx <= 0 || ke < 0 || kx % 16 || ke % 16 || bx != (kx + 63) / 64 ||
      xblocks != bx + (ke + 63) / 64 || xregion < xblocks ||
      ints[I_ROWS_PER_IMG] <= 0 || ints[I_N_IMG] <= 0 || ints[I_N_RES] < 0 ||
      bad_walk(table, n, xregion, ints[I_N_RES], ints[I_WIDE_ROWS],
               ints[I_NARROW_ROWS]))
    return (int)cudaErrorInvalidValue;
  if (kEpi != EPI_NONE &&
      (ints[I_N] <= 0 || 64 % ints[I_N] || M % ints[I_N]))
    return (int)cudaErrorInvalidValue;
  const int fixed = fwd_smem(0, xregion);
  const int stages = min(kMaxStages, (kSmemCap - fixed) / kStage);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  FwdParams p = {};
  const int n_res = ints[I_N_RES];
  if (!encode_bf16(encode, &p.wide, reinterpret_cast<void*>(ptrs[P_WIDE]),
                   kHidden, ints[I_WIDE_ROWS], 1, 64, 64) ||
      !encode_bf16(encode, &p.narrow, reinterpret_cast<void*>(ptrs[P_NARROW]),
                   8, ints[I_NARROW_ROWS], 1, 8, kNarrowRows) ||
      !encode_bf16(encode, &p.xe, reinterpret_cast<void*>(ptrs[P_XE]),
                   kx + ke, M, 1, 64, 64) ||
      (n_res > 0 &&
       !encode_bf16(encode, &p.res, reinterpret_cast<void*>(ptrs[P_RES]),
                    kHidden, M, n_res, 64, 64)))
    return (int)cudaErrorInvalidValue;
  p.bias = reinterpret_cast<const float*>(ptrs[P_BIAS]);
  p.lat[1] = reinterpret_cast<const float*>(ptrs[P_LROW]);
  p.lat[2] = reinterpret_cast<const float*>(ptrs[P_TROW]);
  p.raw[1] = reinterpret_cast<float*>(ptrs[P_DENS]);
  p.raw[2] = reinterpret_cast<float*>(ptrs[P_RGB]);
  p.raw[3] = reinterpret_cast<float*>(ptrs[P_TRANS]);
  p.dist = reinterpret_cast<const float*>(ptrs[P_DIST]);
  p.depth = reinterpret_cast<const float*>(ptrs[P_DEPTH]);
  p.out = reinterpret_cast<float*>(ptrs[P_OUT]);
  p.M = M;
  p.kx = kx;
  p.bx = bx;
  p.xblocks = xblocks;
  p.xregion = xregion;
  p.rows_per_img = ints[I_ROWS_PER_IMG];
  p.n_img = ints[I_N_IMG];
  p.N = ints[I_N];
  p.n_layers = n;
  p.stages = stages;
  p.tiles = (M + kFwdRows - 1) / kFwdRows;
  p.min_uncert = min_uncert;
  for (int l = 0; l < n; ++l)
    for (int f = 0; f < kLayerInts; ++f) p.table[l][f] = table[l * kLayerInts + f];

  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int smem = fwd_smem(stages, xregion);
  e = ensure_smem(field_fwd_kernel<kEpi>, smem, limits);
  if (e != cudaSuccess) return (int)e;
  field_fwd_kernel<kEpi><<<min(p.tiles, sms), kFwdThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
