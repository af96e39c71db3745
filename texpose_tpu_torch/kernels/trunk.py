"""The NeRF trunk's forward without a head and without a gradient: the CUDA
kernel's wrapper and its plain-PyTorch twin.

Replaces texpose_tpu/kernels/fused_trunk.py (``fused_trunk_forward``'s
``_pallas_forward``), which the JAX package's ``run_trunk`` takes wherever
the trunk is not trained in the call (nn/fields.py ``run_trunk``).  The
kernel is in ``csrc/trunk_fwd.cu``; its header says what bounds it on the
card and how its design answers that.

Contract:
  xext [M, 3+6L] f32  pts ⊕ c2f-weighted sin/cos bands (``make_xext``)
  → feat [M, F] in compute_dtype (ReLU'd), dens_raw [M] f32 (no
  activation).
The JAX kernel returns f32 features.  Here they come rounded to
compute_dtype: every consumer (the heads of ``apply_nerf`` and
``apply_nerf_st`` on the plain route, at the same compute_dtype) rounds
them so before its first matmul, so the rounding moves into the kernel's
store.  The kernel computes in bfloat16 only.

``trunk_forward_plain`` is also the trunk of the coarse field's twin
(kernels/coarse_field.py): one set of rounding points for both — xext
rounded once, every layer's input rounded, f32 accumulation, bias in f32,
ReLU after every layer.
"""

from __future__ import annotations

import torch

from ..nn.mlp import relu, round_to
from . import _build, field_fwd
from .st_field import HIDDEN


def trunk_forward_plain(xext, trunk, skip, compute_dtype=torch.bfloat16,
                        want_acts=False):
    """The kernel's twin: xext [M, X] → (feat [M,F] rounded to
    compute_dtype and held in f32, dens_raw [M,1] f32); with want_acts also
    every layer's rounded ReLU output (the coarse field's residuals)."""
    def c(x):
        return round_to(x, compute_dtype)

    xc = c(xext.float())
    h, acts = None, []
    nf = len(trunk)
    for li, layer in enumerate(trunk):
        x = xc if li == 0 else (torch.cat([h, xc], -1) if li in skip else h)
        z = x @ c(layer.w) + layer.b
        if li == nf - 1:
            dens = z[:, :1]
            z = z[:, 1:]
        h = c(relu(z))
        acts.append(h)
    return (h, dens, acts) if want_acts else (h, dens)


_ARGTYPES = {"trunk_fwd": field_fwd.ARGTYPES}


def trunk_fwd(xext, weights, compute_dtype=torch.bfloat16):
    """(feat [M,F], dens_raw [M]) of the trunk, no gradient.  ``weights``
    is any field's ``TrunkWeights`` (kernels/st_field.py): the kernel reads
    its trunk walk (``trunk_walk``).

    CPU tensors take ``trunk_forward_plain`` (feat in f32 holding
    compute_dtype values), without autograd as the kernel; CUDA tensors
    launch the kernel (bf16 compute only; feat comes as a bf16 tensor) or
    raise."""
    if xext.device.type == "cpu":
        with torch.no_grad():
            feat, dens = trunk_forward_plain(xext, weights.trunk,
                                             weights.skip, compute_dtype)
        return feat, dens[:, 0]
    if xext.device.type != "cuda":
        raise ValueError(f"trunk_fwd: no kernel for {xext.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("trunk CUDA kernel computes in bfloat16 only, got "
                         f"compute_dtype={compute_dtype}")
    M, xw = xext.shape
    dev = xext.device
    walk = weights.trunk_walk(xw)
    if walk.tiles.wide.device != dev:
        raise ValueError(f"trunk_fwd: input and weights must lie on {dev}")
    x = torch.zeros((M, walk.kx), dtype=torch.bfloat16, device=dev)
    x[:, :xw] = xext
    feat = torch.empty((M, HIDDEN), dtype=torch.bfloat16, device=dev)
    dens = torch.empty((M, 1), dtype=torch.float32, device=dev)
    lib = _build.load("trunk_fwd", _ARGTYPES)
    err = field_fwd.launch(lib.trunk_fwd, walk, x,
                           {len(weights.trunk) - 1: 0}, n_res=1,
                           stream=_build.stream_ptr(dev), dens=dens, res=feat)
    _build.check(err, "trunk_fwd")
    trunk_fwd.launches += 1
    return feat, dens[:, 0]


trunk_fwd.launches = 0
