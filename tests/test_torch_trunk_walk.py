"""The trunk kernel's walk (row 10: kernels/st_field.py
``TrunkWeights.trunk_walk`` over kernels/field_fwd.py's tiles) on the CPU:
what the wgmma + TMA trunk forward reads on the card.

* ``walk_plain`` of the trunk walk equals the kernel's twin
  (``trunk_forward_plain``) bit for bit, features and raw density, for the
  ST field's, the coarse field's and the density-only field's weights,
  with its own tiles and with the tiles it shares with a field's forward
  walk.  The weights and inputs are small integers (each weight column two
  entries of ±1), so every f32 sum is exact in any order and the two
  agree bit for bit wherever they compute the same function.
* The tiles it shares with a field's forward walk (the trunk's layers come
  first there) read back the JAX package's trunk weights, rounded to bf16,
  exactly; the density-only field's own tiles too.
* On the JAX package's parameters and numpy points, the walk matches JAX's
  ``fused_trunk_forward`` in interpret mode at bf16 compute, within
  tests/test_torch_trunk.py's bound for the twin (2e-2 of max(|ref|, 1)
  per element, 1e-3 in the mean; the features after rounding JAX's f32
  output to bf16, as every consumer does).
* The walk refuses a last skip layer, as the field walks do.

Every field here is 256 wide (the kernel's only width).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_field_fwd import (_bridge, _coarse_cfg, _layer, _st_cfg,
                                  _trunk, _weights)
from texpose_tpu.kernels.fused_trunk import fused_trunk_forward
from texpose_tpu.nn import fields as jfields
from texpose_tpu_torch.kernels import field_fwd as ff
from texpose_tpu_torch.kernels.st_field import (STFieldWeights, TrunkWeights,
                                                make_xext)
from texpose_tpu_torch.kernels.trunk import trunk_forward_plain
from texpose_tpu_torch.nn import fields as tfields
from texpose_tpu_torch.nn.mlp import round_to

BF16 = torch.bfloat16
FIELDS = ("st", "coarse", "density")
M = 300                                  # two full 128-row tiles + a ragged one


def _field(field):
    """(weights, xw, e3) of a seeded 256-wide field at the shipped configs'
    trunk (8 layers, skip at 4, L_3D 10)."""
    if field == "density":
        g = torch.Generator().manual_seed(4)
        return TrunkWeights(_trunk(g, 8, (4,), 63), (4,)), 63, None
    w, xw, e3, _ = _weights(field, "full")
    return w, xw, e3


def _integers(w, seed=0):
    """Make every trunk weight column two entries of ±1 at random rows and
    every bias an integer in [-2, 2], in place."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in w.trunk:
            k, n = layer.w.shape
            new = torch.zeros(k, n)
            cols = torch.arange(n)
            for _ in range(2):
                rows = torch.randint(0, k, (n,), generator=g)
                sign = torch.randint(0, 2, (n,), generator=g) * 2.0 - 1.0
                new[rows, cols] += sign
            layer.w.copy_(new)
            layer.b.copy_(torch.randint(-2, 3, (n,), generator=g).float())


def _walk(w, xw, e3, shared):
    """The trunk walk; with ``shared`` after the field's forward walk, whose
    tiles it must then read."""
    if shared:
        fwd = w.fwd_walk(xw, e3)
        walk = w.trunk_walk(xw)
        assert walk.tiles.wide is fwd.tiles.wide
        assert walk.tiles.offs == fwd.tiles.offs[:len(w.trunk)]
        return walk
    walk = w.trunk_walk(xw)
    with torch.no_grad():
        assert walk.tiles.offs == ff.build_tiles(walk.layers, "cpu").offs
    return walk


def _run(walk, w, xext):
    x = torch.zeros((xext.shape[0], walk.kx))
    x[:, :xext.shape[1]] = xext
    raw, res = ff.walk_plain(walk, x, res_planes={len(w.trunk) - 1: 0})
    assert sorted(raw) == [ff.NOUT_DENS] and sorted(res) == [0]
    return res[0], raw[ff.NOUT_DENS]


CASES = [("st", False), ("st", True), ("coarse", False), ("coarse", True),
         ("density", False)]


@pytest.mark.parametrize("field,shared", CASES,
                         ids=[f"{f}-{'shared' if s else 'own'}"
                              for f, s in CASES])
def test_trunk_walk_plain_equals_twin_bit_for_bit(field, shared):
    w, xw, e3 = _field(field)
    _integers(w)
    walk = _walk(w, xw, e3, shared)
    # the table: xext only (ke 0), X freed after the last skip layer
    assert (walk.ke, walk.xblocks, walk.xregion) == (0, 1, 1)
    assert [layer.xfree for layer in walk.layers] == [
        li == max(w.skip) for li in range(len(w.trunk))]
    assert ff.ring_stages(walk.xregion) == 4
    g = torch.Generator().manual_seed(1)
    xext = torch.randint(-4, 5, (M, xw), generator=g).float()
    with torch.no_grad():
        feat, dens = _run(walk, w, xext)
        feat_ref, dens_ref = trunk_forward_plain(xext, w.trunk, w.skip)
    assert float((feat_ref > 0).float().mean()) > 0.1    # not a dead trunk
    assert torch.equal(feat, feat_ref)
    assert torch.equal(dens, dens_ref)


@pytest.mark.parametrize("field", FIELDS)
def test_trunk_walk_tiles_read_back_jax_weights(field):
    """JAX's trunk parameters through the npz bridge: the trunk walk's
    tiles (an ST or coarse field's shared with its forward walk, built
    first; the density field's its own) give every trunk layer back, the
    last one's density column from its narrow tile."""
    jparams, nerf, cfg = _jax_field(field)
    w = nerf.kernel_weights()
    xw = 3 + 6 * cfg.arch.posenc.L_3D
    fwd = None
    if field != "density":
        e3 = 3 + 6 * cfg.arch.posenc.L_view + 3 if field == "st" else 3
        fwd = w.fwd_walk(xw, e3)
    walk = w.trunk_walk(xw)
    if fwd is not None:
        assert walk.tiles.wide is fwd.tiles.wide
    read = ff.read_walk(walk)
    n = len(w.trunk)
    assert len(read) == n
    for li, (lp, (segs, wb, nw, nb)) in enumerate(zip(jparams["mlp_feat"],
                                                      read)):
        jw = torch.from_numpy(np.array(lp["w"], np.float32))
        jb = torch.from_numpy(np.array(lp["b"], np.float32))
        true = [xw] if li == 0 else [256, xw] if li in w.skip else [256]
        rows = torch.cat([s[:k] for s, k in zip(segs, true)])
        if li == n - 1:
            rows = torch.cat([nw[:, :1], rows], 1)
            wb = torch.cat([nb[:1], wb])
        assert torch.equal(rows, round_to(jw, BF16))
        assert torch.equal(wb, jb)


def _jax_field(field):
    """(JAX params, the port's field holding them, cfg) at a 256-wide
    config with a skip layer: the ST field of tests/test_torch_field_fwd.py
    (3 layers, skip at 1), the coarse and the density field on its coarse
    config (4 layers, skip at 2)."""
    if field == "st":
        cfg = _st_cfg()
        jparams = jfields.init_nerf_st(jax.random.PRNGKey(0), cfg)
        return jparams, _bridge(jparams,
                                lambda: tfields.init_nerf_st(cfg)), cfg
    cfg = _coarse_cfg(False)
    init = {"coarse": (jfields.init_nerf, tfields.init_nerf),
            "density": (jfields.init_nerf_density,
                        tfields.init_nerf_density)}[field]
    jparams = init[0](jax.random.PRNGKey(2), cfg)
    return jparams, _bridge(jparams, lambda: init[1](cfg)), cfg


@pytest.mark.parametrize("field", FIELDS)
def test_trunk_walk_matches_jax_fused_trunk_interpret(field):
    jparams, nerf, cfg = _jax_field(field)
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(M, 3)) * 0.5).astype(np.float32)
    L = cfg.arch.posenc.L_3D
    c2f = tfields._c2f_band_weights(cfg, L, 0.4)
    assert float(c2f.min()) < 1.0            # a partial window
    j_feat, j_dens = fused_trunk_forward(
        jnp.asarray(pts), jnp.asarray(c2f.numpy()),
        [lp["w"] for lp in jparams["mlp_feat"]],
        [lp["b"] for lp in jparams["mlp_feat"]], tuple(cfg.arch.skip), L,
        compute_dtype=jnp.bfloat16, tile=128, interpret=True)
    w = nerf.kernel_weights()
    xext = make_xext(torch.from_numpy(pts), L, c2f)
    with torch.no_grad():
        feat, dens = _run(w.trunk_walk(xext.shape[1]), w, xext)
    j_feat = torch.from_numpy(np.asarray(j_feat, np.float32)).bfloat16()
    for a, b in ((feat, j_feat.float()),
                 (dens[:, 0], torch.from_numpy(np.asarray(j_dens)))):
        err = (a - b).abs()
        assert float((err / b.abs().clamp(min=1.0)).max()) <= 2e-2
        assert float(err.mean()) <= 1e-3


def test_trunk_walk_refuses_a_last_skip_layer():
    """The last trunk layer's density column is its narrow part, which
    reads only A: a last skip layer raises on the host, for the trunk walk
    as for the field walks."""
    g = torch.Generator().manual_seed(3)
    xw = 15
    trunk = [_layer(g, xw, 256), _layer(g, 256, 256),
             _layer(g, 256 + xw, 257, "first")]
    with pytest.raises(ValueError, match="skip"):
        TrunkWeights(trunk, (2,)).trunk_walk(xw)
    heads = ([_layer(g, 256 + 12 + 4, 256), _layer(g, 256, 3, "all")],
             [_layer(g, 256 + 2, 256), _layer(g, 256, 5, "all")])
    with pytest.raises(ValueError, match="skip"):
        STFieldWeights(trunk, *heads, (2,)).trunk_walk(xw)
