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
// Per 64-row tile, in shared memory: the staged xext [64,kx] (pts ⊕ c2f-
// weighted sin/cos bands, bf16, formed by the wrapper as for the field
// kernels) → the 8×256 trunk of trunk.cuh (skip layers re-read xext; the last
// layer's column 0 is the raw density, stored f32 to dens [M]) → the
// features, written as bf16 [M,256] rows.  The TPU kernel returns f32
// features; every consumer of this kernel rounds them to bf16 before its
// next matmul (the heads run with compute_dtype bfloat16, the only dtype the
// kernel takes), so the bf16 store is that rounding done once, here, and
// halves the output bytes.
//
// What bounds it: ~0.98 MFLOP per row on the tensor cores (129 GFLOP at the
// 131,072 rows of one 2048-ray × 64-sample chunk, 0.130 ms at 989 TFLOP/s)
// against 128 B of staged xext in and 516 B out per row (84 MB, 0.025 ms).
// Design: trunk.cuh's (weights fragment-packed on the host, each warp all 64
// rows × 32 columns of every layer, activations in three shared buffers);
// 110,592 B of shared memory, so two blocks share an SM.

#include "trunk.cuh"

namespace {

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
    trunk_fwd_kernel(const TrunkParams p) {
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

int g_smem_limit[kMaxDevices];

}  // namespace

// Launches the trunk forward on `stream`: x [M,kx] bf16 → feat [M,256] bf16,
// dens [M] f32.  Returns cudaGetLastError() (0 = launched).
extern "C" int trunk_fwd(const void* x, const void* wpack, const void* bias,
                         void* feat, void* dens, int M, int kx, int n_trunk,
                         int skip_mask, void* stream) {
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
  cudaError_t e = ensure_smem(trunk_fwd_kernel, smem, g_smem_limit);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTile - 1) / kTile);
  trunk_fwd_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
