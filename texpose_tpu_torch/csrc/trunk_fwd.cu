// The NeRF trunk's forward on its own (posenc'd points → features and raw
// density, no head, no gradient), written by hand for Hopper (sm_90a) and
// bound to PyTorch through ctypes (texpose_tpu_torch/kernels/trunk.py).
//
// Replaces: texpose_tpu/kernels/fused_trunk.py::_pallas_forward (the
// posenc + trunk forward pallas_call, _kernel), which the JAX package's
// run_trunk takes where the trunk is not trained in the call: evaluation of
// a field whose heads run outside a kernel (the texture model with
// nerf.density_noise_reg, the coarse field with kernels.fused_coarse off,
// the density-only field).
//
// Kernel: field_fwd_kernel<EPI_NONE> (field_fwd.cuh, the wgmma + TMA tile of
// rows 1, 6f, 7a and 8; entry trunk_fwd) over the trunk's walk alone
// (kernels/field_fwd.py trunk_walk_layers): per 128-row tile the staged
// xext [128,kx] (pts ⊕ c2f-weighted sin/cos bands, bf16, formed by the
// wrapper as for the field kernels) in the X region, which holds nothing
// else (no enc⊕pts: ke = 0) and is freed after the last layer that reads it
// (the last skip layer), so the next tile's xext loads under the layers
// after it; the 8×256 trunk (skip layers re-read xext) in place in the A
// buffer; the last layer's column 0, the raw density, as its narrow output
// (f32 to dens [M]); its 256 ReLU'd features stored as residual plane 0 by
// TMA (bf16 [M,256] rows).  The TPU kernel returns f32 features; every
// consumer of this kernel rounds them to bf16 before its next matmul (the
// heads run with compute_dtype bfloat16, the only dtype the kernel takes),
// so the bf16 store is that rounding done once, here, and halves the
// output bytes.  The weight tiles are the field walk's where the weights
// carry one (kernels/st_field.py TrunkWeights.trunk_walk), else the trunk's
// own.
//
// What bounds it: ~0.98 MFLOP per row on the tensor cores (129 GFLOP at the
// 131,072 rows of one 2048-ray × 64-sample chunk, 0.130 ms at 989 TFLOP/s)
// against 128 B of staged xext in and 516 B out per row (84 MB, 0.025 ms).
// The mma.sync form it replaced (trunk.cuh's trunk_forward on 64-row
// tiles, fragment-packed weights read by every warp from L2, 110,592 B of
// shared memory, two blocks per SM; 0.57 ms at 131,072 rows on the H100)
// lost its time as the field forwards of that form did: the epilogues (bias,
// ReLU, bf16 stores behind block barriers) and the weight re-reads (the
// whole trunk, ≈ 0.98 MB, per 64 rows: 2.0 GB per chunk).  The wgmma tile
// reads the weights once per 128 rows (≈ 1.0 GB per chunk) and folds the
// epilogue into one conversion and stmatrix stores.  The mma.sync form
// (trunk_fwd_mma_kernel, entry trunk_fwd_mma) is compiled only in the
// measurement build -DFIELD_FWD_MMA_SYNC (tools/probe_field_fwd.py,
// chip_smoke.py's in-call comparison).

#include "field_fwd.cuh"

namespace {

int g_smem_limit[kMaxDevices];

#ifdef FIELD_FWD_MMA_SYNC
// The mma.sync form (measurement build only).
struct TrunkParams {
  const bf16* x;           // [M, kx] bf16: xext, zero padded to kx
  const uint2* wpack;      // trunk layers in walk order, fragment packed
  const float* bias;
  bf16* feat;              // [M, 256]
  float* dens;             // [M] raw density
  int M, kx, n_trunk;
  unsigned skip_mask;
};

__global__ void __launch_bounds__(kThreads, 2)
    trunk_fwd_mma_kernel(const TrunkParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const act[3] = {
      reinterpret_cast<bf16*>(smem),
      reinterpret_cast<bf16*>(smem) + kTile * kActStride,
      reinterpret_cast<bf16*>(smem) + 2 * kTile * kActStride};
  bf16* const xt = act[2] + kTile * kActStride;
  const int xs = p.kx + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kTile;

  load_rows(xt, xs, p.x, p.kx, row0, p.M);
  __syncthreads();
  const Seg none = {xt, xs, 0};
  const Seg xseg = {xt, xs, p.kx};
  const int feat = trunk_forward(xseg, none, act, p.wpack, p.bias, p.n_trunk,
                                 p.skip_mask, p.dens, nullptr, row0, p.M,
                                 warp, lane);
  store_tile(p.feat, act[feat], row0, p.M);   // trunk_forward synced last
}

int g_smem_limit_mma[kMaxDevices];
#endif  // FIELD_FWD_MMA_SYNC

}  // namespace

// Launches the trunk forward on `stream`: the flat pointer and int
// arguments of field_fwd.cuh (FwdPtr, FwdInt: xe the staged xext [M, kx]
// bf16, ke 0; dens receives the raw density [M,1] f32, res the [1, M, 256]
// bf16 features) and the walk's table.  Returns a cudaError_t (0 =
// launched).
extern "C" int trunk_fwd(const long long* ptrs, const int* ints,
                         const int* table, float min_uncert, void* stream) {
  return launch_field_fwd<EPI_NONE>(ptrs, ints, table, min_uncert, stream,
                                    g_smem_limit);
}

#ifdef FIELD_FWD_MMA_SYNC
// Measurement build only.  Launches the mma.sync trunk forward on `stream`:
// x [M,kx] bf16 → feat [M,256] bf16, dens [M] f32, from the trunk's
// fragment pack.  Returns cudaGetLastError() (0 = launched).
extern "C" int trunk_fwd_mma(const void* x, const void* wpack,
                             const void* bias, void* feat, void* dens, int M,
                             int kx, int n_trunk, int skip_mask,
                             void* stream) {
  if (M <= 0) return 0;
  if (kx % 16 || kx <= 0 || n_trunk < 1) return (int)cudaErrorInvalidValue;
  TrunkParams p;
  p.x = static_cast<const bf16*>(x);
  p.wpack = static_cast<const uint2*>(wpack);
  p.bias = static_cast<const float*>(bias);
  p.feat = static_cast<bf16*>(feat);
  p.dens = static_cast<float*>(dens);
  p.M = M;
  p.kx = kx;
  p.n_trunk = n_trunk;
  p.skip_mask = static_cast<unsigned>(skip_mask);
  const int smem =
      (3 * kTile * kActStride + kTile * (kx + 8)) * (int)sizeof(bf16);
  cudaError_t e = ensure_smem(trunk_fwd_mma_kernel, smem, g_smem_limit_mma);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTile - 1) / kTile);
  trunk_fwd_mma_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
#endif  // FIELD_FWD_MMA_SYNC
