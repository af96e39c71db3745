"""The segmented composite kernels (rows 3, 4, 9a and 9b,
csrc/composite_seg.cuh) walked in plain torch as the kernels run them, on
the CPU: a segment of L = 32 lanes per ray and S consecutive samples per
lane as ``segment_plan`` picks them (S = 2 up to 64 samples, 4 up to 128,
8 up to 256), padded samples weighing nothing when N ∤ S·L (zero loads,
so a zero interval; only row 3's column 14 masks them), the lane totals'
segmented scans (shfl_up steps for the exclusive prefix, shfl_down steps
for the strict suffix, neither taken as inclusive minus own: a ray's last
interval is 1e10 long), the transmittances as products inside the lane,
and the forwards' columns reduced by recursive halving, each lane left
holding the columns it stores.

The walks are held against the JAX package's ``fused_composite_st`` and
``fused_composite_coarse``, forward and VJP (Pallas in interpret mode, as
``test_torch_composite*.py`` run them), and against the port's twins
(``composite_st_plain``, ``composite_st_bwd_plain``,
``composite_coarse_plain``, ``composite_coarse_bwd_plain``) for N ∈ {16,
48, 64, 100, 192, 256} and BR ∈ {1, 5, 37}: 1e-5 of each output's
largest magnitude, float32 on every side (the summation order and the
transmittance products differ).  The JAX kernels take a multiple of 8
rays: they run on the rays padded to one (zero cotangent on the extra
rays) and only the first BR are compared.

``segment_plan``, the wrapper's choice of S, of vector or scalar loads and
of the launch geometry, is tested as the pure function it is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texpose_tpu.kernels.fused_composite import fused_composite_st as jst
from texpose_tpu.kernels.fused_composite_coarse import (
    fused_composite_coarse as jcoarse)
from texpose_tpu_torch.kernels.composite import (SEG_THREADS,
                                                 composite_coarse_bwd_plain,
                                                 composite_coarse_plain,
                                                 composite_st_bwd_plain,
                                                 composite_st_plain,
                                                 packed_to_dict,
                                                 segment_plan)
from texpose_tpu_torch.nn.mlp import softplus
from texpose_tpu_torch.ops.render import _dists

REL = 1e-5
NS = [16, 48, 64, 100, 192, 256]
BRS = [1, 5, 37]
ST_KEYS = ["rgb", "rgb_static", "rgb_transient", "depth", "opacity",
           "opacity_static", "opacity_transient", "uncert",
           "trans_density_mean"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inputs(BR, N, seed):
    """Raw field outputs, sorted depths and rays for BR rays padded to a
    multiple of 8 (the JAX kernels' tile), numpy float32."""
    rng = np.random.default_rng(seed)
    BRp = -(-BR // 8) * 8
    M = BRp * N
    return dict(
        rgb=rng.normal(size=(M, 3)).astype(np.float32),
        tr=rng.normal(size=(M, 5)).astype(np.float32),
        dens=(rng.normal(size=(M, 1)) * 2).astype(np.float32),
        depth=np.sort(rng.uniform(2, 6, size=(1, BRp, N, 1)),
                      axis=2).astype(np.float32),
        ray=rng.normal(size=(1, BRp, 3)).astype(np.float32))


# ------------------------------------------------------- the walk

def _lay(x, BR, N, S, L):
    """Rows of BR rays × N samples ([BR·N, C] or [BR, N]) → [BR, L, S, C]
    lane slots, zero past the ray's last sample (the kernels' loads)."""
    C = x.numel() // (BR * N)
    x = x.reshape(BR, N, C)
    pad = torch.zeros(BR, L * S - N, C, dtype=x.dtype)
    return torch.cat([x, pad], 1).reshape(BR, L, S, C)


def _valid(N, S, L):
    return (torch.arange(L * S) < N).reshape(L, S)


def seg_exclusive(tot):
    """The kernels' segmented exclusive sum over dim 1 (lanes): shfl_up
    steps 1, 2, 4, …; a lane adds the partial it receives from below both
    to its inclusive sum and to its exclusive sum, so the exclusive sum
    never holds (and never subtracts) the lane's own total."""
    x, e, o, L = tot.clone(), torch.zeros_like(tot), 1, tot.shape[1]
    while o < L:
        y = torch.zeros_like(x)
        y[:, o:] = x[:, :-o]
        e = e + y
        x = x + y
        o *= 2
    return e


def seg_strict_suffix(v):
    """Σ over the lanes above: the same scan by shfl_down steps."""
    x, e, o, L = v.clone(), torch.zeros_like(v), 1, v.shape[1]
    while o < L:
        y = torch.zeros_like(x)
        y[:, :L - o] = x[:, o:]
        e = e + y
        x = x + y
        o *= 2
    return e


def seg_halve(acc, H):
    """seg_halve<L, C, H> on acc [BR, L, C] → (held [BR, L, W], W, R): step
    i < H (offset L >> (i+1)) keeps the lower half of a lane's columns
    where its offset bit is clear, the upper half where it is set, and
    adds the partner's copy; then plain butterflies on the W = C >> H
    columns left.  Lane ℓ then holds columns (ℓ >> R)·W .. + W − 1, R =
    log2 L − H."""
    L, C = acc.shape[1], acc.shape[2]
    log = L.bit_length() - 1
    lane = torch.arange(L)
    cur = acc
    for i in range(H):
        o, half = L >> (i + 1), (C // 2) >> i
        up = ((lane & o) != 0)[:, None]
        lo, hi = cur[..., :half], cur[..., half:2 * half]
        send = torch.where(up, lo, hi)
        keep = torch.where(up, hi, lo)
        cur = keep + send[:, lane ^ o]
    o = (L >> H) >> 1
    while o > 0:
        cur = cur + cur[:, lane ^ o]
        o >>= 1
    return cur, C >> H, log - H


def stored_cols(acc, H):
    """What seg_halve + seg_store_cols leave in the row: [BR, C]."""
    held, W, R = seg_halve(acc, H)
    out = torch.empty(acc.shape[0], acc.shape[2])
    for lane in range(0, acc.shape[1], 1 << R):   # the lanes that store
        c0 = (lane >> R) * W
        out[:, c0:c0 + W] = held[:, lane]
    return out


def st_seg_walk(rgb_raw, trans_raw, dens_raw, depth, dist, min_uncert):
    """composite_st_seg in plain torch → packed [BR, 16]."""
    BR, N = depth.shape
    S, L = segment_plan(BR, N, ())[:2]
    r, t = _lay(rgb_raw, BR, N, S, L), _lay(trans_raw, BR, N, S, L)
    dn = _lay(dens_raw, BR, N, S, L)[..., 0]
    dp = _lay(depth, BR, N, S, L)[..., 0]
    ds = _lay(dist, BR, N, S, L)[..., 0]
    cs = torch.sigmoid(r)                     # no mask: δ = 0 past N
    ct = torch.sigmoid(t[..., :3])
    dt = softplus(t[..., 3])
    u = softplus(t[..., 4])
    sds = softplus(dn) * ds
    sdt = dt * ds
    tot = torch.zeros(BR, L, 2)
    for s in range(S):                        # the lane's totals, in order
        tot[..., 0] += sds[..., s]
        tot[..., 1] += sdt[..., s]
    run = seg_exclusive(tot)
    # the transmittances at the lane's first sample, then by products
    Ts, Tt = torch.exp(-run[..., 0]), torch.exp(-run[..., 1])
    valid = _valid(N, S, L)
    acc = torch.zeros(BR, L, 16)
    for s in range(S):
        e_s, e_t = torch.exp(-sds[..., s]), torch.exp(-sdt[..., s])
        T = Ts * Tt
        a_s, a_t, a = 1 - e_s, 1 - e_t, 1 - e_s * e_t
        ps, pt, pj = T * a_s, T * a_t, T * a
        ws, wt = Ts * a_s, Tt * a_t
        for c in range(3):
            acc[..., c] += ps * cs[..., s, c] + pt * ct[..., s, c]
            acc[..., 3 + c] += ws * cs[..., s, c]
            acc[..., 6 + c] += wt * ct[..., s, c]
        acc[..., 9] += ws * dp[..., s]
        acc[..., 10] += pj
        acc[..., 11] += ws
        acc[..., 12] += wt
        acc[..., 13] += u[..., s] * pt
        acc[..., 14] += torch.where(valid[:, s], dt[..., s], 0.0)
        Ts, Tt = Ts * e_s, Tt * e_t
    out = stored_cols(acc, min(L.bit_length() - 1, 4))
    out[:, 13] += min_uncert
    return out


def st_bwd_seg_walk(rgb_raw, trans_raw, dens_raw, dist, g):
    """composite_st_bwd_seg in plain torch → (d rgb_raw [BR·N, 3],
    d trans_raw [BR·N, 5])."""
    BR, N = dist.shape
    S, L = segment_plan(BR, N, ())[:2]
    r, t = _lay(rgb_raw, BR, N, S, L), _lay(trans_raw, BR, N, S, L)
    dn = _lay(dens_raw, BR, N, S, L)[..., 0]
    dd = _lay(dist, BR, N, S, L)[..., 0]
    cs = torch.sigmoid(r)                     # no mask: δ = 0 past N
    ct = torch.sigmoid(t[..., :3])
    u = softplus(t[..., 4])
    sg3, sg4 = torch.sigmoid(t[..., 3]), torch.sigmoid(t[..., 4])
    sds = softplus(dn) * dd
    sdt = softplus(t[..., 3]) * dd
    tot = torch.zeros(BR, L, 2)
    for s in range(S):
        tot[..., 0] += sds[..., s]
        tot[..., 1] += sdt[..., s]
    run = seg_exclusive(tot)
    Ts, Tt = torch.exp(-run[..., 0]), torch.exp(-run[..., 1])
    gg = g[:, None, :]                        # every lane reads the row
    ps, pt, ws, wt, loc, v = ([] for _ in range(6))
    vtot = torch.zeros(BR, L)
    for s in range(S):
        e_s, e_t = torch.exp(-sds[..., s]), torch.exp(-sdt[..., s])
        e = e_s * e_t
        T = Ts * Tt
        ps.append(T * (1 - e_s))
        pt.append(T * (1 - e_t))
        ws.append(Ts * (1 - e_s))
        wt.append(Tt * (1 - e_t))
        pj = T * (1 - e)
        F_ps = torch.zeros(BR, L)
        F_pt = u[..., s] * gg[..., 13]
        F_wt = gg[..., 12]
        for c in range(3):
            F_ps = F_ps + cs[..., s, c] * gg[..., c]
            F_pt = F_pt + ct[..., s, c] * gg[..., c]
            F_wt = F_wt + ct[..., s, c] * gg[..., 6 + c]
        loc.append(F_pt * T * e_t + F_wt * Tt * e_t + gg[..., 10] * T * e)
        v.append(F_ps * ps[s] + F_pt * pt[s] + gg[..., 10] * pj
                 + F_wt * wt[s])
        vtot = vtot + v[s]
        Ts, Tt = Ts * e_s, Tt * e_t
    suf = seg_strict_suffix(vtot)
    d_rgb = torch.zeros(BR, L, S, 3)
    d_tr = torch.zeros(BR, L, S, 5)
    for s in reversed(range(S)):
        strict = suf
        suf = suf + v[s]
        for c in range(3):
            d_rgb[..., s, c] = ((ps[s] * gg[..., c] + ws[s] * gg[..., 3 + c])
                                * cs[..., s, c] * (1 - cs[..., s, c]))
            d_tr[..., s, c] = ((pt[s] * gg[..., c] + wt[s] * gg[..., 6 + c])
                               * ct[..., s, c] * (1 - ct[..., s, c]))
        d_tr[..., s, 3] = (((loc[s] - strict) * dd[..., s] + gg[..., 14])
                           * sg3[..., s])
        d_tr[..., s, 4] = pt[s] * gg[..., 13] * sg4[..., s]
    d_rgb = d_rgb.reshape(BR, L * S, 3)[:, :N].reshape(BR * N, 3)
    d_tr = d_tr.reshape(BR, L * S, 5)[:, :N].reshape(BR * N, 5)
    return d_rgb, d_tr


def coarse_fwd_seg_walk(rgb_raw, dens_raw, depth, dist):
    """composite_coarse_seg in plain torch → packed [BR, 8]."""
    BR, N = depth.shape
    S, L = segment_plan(BR, N, ())[:2]
    r = _lay(rgb_raw, BR, N, S, L)
    x = _lay(dens_raw, BR, N, S, L)[..., 0]
    dd = _lay(dist, BR, N, S, L)[..., 0]
    dp = _lay(depth, BR, N, S, L)[..., 0]
    cs = torch.sigmoid(r)                     # no mask: δ = 0 past N
    sd = softplus(x) * dd
    tot = torch.zeros(BR, L)
    for s in range(S):
        tot += sd[..., s]
    T = torch.exp(-seg_exclusive(tot))
    acc = torch.zeros(BR, L, 8)
    for s in range(S):
        e = torch.exp(-sd[..., s])
        w = T * (1 - e)
        for c in range(3):
            acc[..., c] += w * cs[..., s, c]
        acc[..., 3] += w * dp[..., s]
        acc[..., 4] += w
        T = T * e
    return stored_cols(acc, min(L.bit_length() - 1, 3))


def coarse_bwd_seg_walk(rgb_raw, dens_raw, dist, depth, g):
    """composite_coarse_bwd_seg in plain torch → (d rgb_raw [BR·N, 3],
    d dens_raw [BR·N, 1])."""
    BR, N = dist.shape
    S, L = segment_plan(BR, N, ())[:2]
    r = _lay(rgb_raw, BR, N, S, L)
    x = _lay(dens_raw, BR, N, S, L)[..., 0]
    dd = _lay(dist, BR, N, S, L)[..., 0]
    dp = _lay(depth, BR, N, S, L)[..., 0]
    cs = torch.sigmoid(r)                     # no mask: δ = 0 past N
    sg = torch.sigmoid(x)
    sd = softplus(x) * dd
    tot = torch.zeros(BR, L)
    for s in range(S):
        tot += sd[..., s]
    run = seg_exclusive(tot)
    gg = g[:, None, :5]                       # broadcast to the segment
    w, loc, v = [], [], []
    vtot = torch.zeros(BR, L)
    for s in range(S):
        T, e = torch.exp(-run), torch.exp(-sd[..., s])
        w.append(T * (1 - e))
        G = (cs[..., s, 0] * gg[..., 0] + cs[..., s, 1] * gg[..., 1]
             + cs[..., s, 2] * gg[..., 2] + dp[..., s] * gg[..., 3]
             + gg[..., 4])
        loc.append(G * T * e)
        v.append(G * w[s])
        vtot = vtot + v[s]
        run = run + sd[..., s]
    suf = seg_strict_suffix(vtot)
    d_rgb = torch.zeros(BR, L, S, 3)
    d_dens = torch.zeros(BR, L, S)
    for s in reversed(range(S)):
        strict = suf
        suf = suf + v[s]
        for c in range(3):
            d_rgb[..., s, c] = (w[s] * gg[..., c] * cs[..., s, c]
                                * (1 - cs[..., s, c]))
        d_dens[..., s] = (loc[s] - strict) * dd[..., s] * sg[..., s]
    d_rgb = d_rgb.reshape(BR, L * S, 3)[:, :N].reshape(BR * N, 3)
    d_dens = d_dens.reshape(BR, L * S)[:, :N].reshape(BR * N, 1)
    return d_rgb, d_dens


# ------------------------------------------------------- the tests

@pytest.mark.parametrize("BR", BRS)
@pytest.mark.parametrize("N", NS)
def test_st_walk_matches_jax_and_twin(N, BR):
    x = _inputs(BR, N, seed=N + BR)
    ref = jst(*(jnp.asarray(x[k]) for k in ("rgb", "tr", "dens", "depth",
                                            "ray")),
              min_uncert=0.05, tile_rays=8, interpret=True, flat=False)
    M = BR * N
    t = {k: torch.from_numpy(x[k]) for k in x}
    args = (t["rgb"][:M], t["tr"][:M], t["dens"][:M],
            t["depth"][0, :BR, :, 0],
            _dists(t["depth"][:, :BR], t["ray"][:, :BR]).reshape(BR, N))
    walk = st_seg_walk(*args, 0.05)
    twin = composite_st_plain(*args, 0.05)
    assert _rel(walk, twin) <= REL
    out = packed_to_dict(walk, 1, BR, N)
    for k in ST_KEYS[:-1]:
        assert _rel(out[k], np.asarray(ref[k])[:, :BR]) <= REL, k
    # the transient-reg mean over the real rays only
    want = float(softplus(t["tr"][:M, 3]).mean())
    assert abs(float(out["trans_density_mean"]) - want) <= REL * abs(want)


@pytest.mark.parametrize("BR", BRS)
@pytest.mark.parametrize("N", NS)
def test_coarse_bwd_walk_matches_jax_and_twin(N, BR):
    x = _inputs(BR, N, seed=2 * N + BR)
    BRp = x["depth"].shape[1]
    rng = np.random.default_rng(N * BR)
    cot = np.zeros((1, BRp, 5), np.float32)
    cot[:, :BR] = rng.normal(size=(1, BR, 5))

    def f(a, b):
        out = jcoarse(a, b, jnp.asarray(x["depth"]), jnp.asarray(x["ray"]),
                      tile_rays=8, interpret=True, flat=False)
        return jnp.concatenate([out["rgb"], out["depth"], out["opacity"]],
                               -1)

    _, vjp = jax.vjp(f, jnp.asarray(x["rgb"]), jnp.asarray(x["dens"]))
    j_rgb, j_dens = vjp(jnp.asarray(cot))
    M = BR * N
    t = {k: torch.from_numpy(x[k]) for k in x}
    g = torch.zeros(BR, 8)
    g[:, :5] = torch.from_numpy(cot[0, :BR])
    args = (t["rgb"][:M], t["dens"][:M],
            _dists(t["depth"][:, :BR], t["ray"][:, :BR]).reshape(BR, N),
            t["depth"][0, :BR, :, 0], g)
    walk = coarse_bwd_seg_walk(*args)
    twin = composite_coarse_bwd_plain(*args)
    for got, want, ref in zip(walk, twin, (j_rgb, j_dens)):
        assert _rel(got, want) <= REL
        assert _rel(got, np.asarray(ref)[:M]) <= REL


@pytest.mark.parametrize("BR", BRS)
@pytest.mark.parametrize("N", NS)
def test_st_bwd_walk_matches_jax_and_twin(N, BR):
    """Row 4: the walk's gradients from a packed cotangent against the
    VJP of JAX's fused_composite_st and against composite_st_bwd_plain.
    Column 14's cotangent is the trans_density_mean one spread over the
    padded rays' samples (JAX's mean counts them)."""
    x = _inputs(BR, N, seed=3 * N + BR)
    BRp = x["depth"].shape[1]
    rng = np.random.default_rng(N * BR + 1)
    cot = np.zeros((BRp, 16), np.float32)
    cot[:BR, :14] = rng.normal(size=(BR, 14))
    c_mean = np.float32(rng.normal())
    cot[:BR, 14] = c_mean / (BRp * N)
    fixed = [jnp.asarray(x[k]) for k in ("dens", "depth", "ray")]

    def f(a, b):
        return jst(a, b, *fixed, min_uncert=0.05, tile_rays=8,
                   interpret=True, flat=False)

    out, vjp = jax.vjp(f, jnp.asarray(x["rgb"]), jnp.asarray(x["tr"]))
    cols = dict(rgb=(0, 3), rgb_static=(3, 6), rgb_transient=(6, 9),
                depth=(9, 10), opacity=(10, 11), opacity_static=(11, 12),
                opacity_transient=(12, 13), uncert=(13, 14))
    ct = {k: (jnp.asarray(cot[None, :, cols[k][0]:cols[k][1]])
              if k in cols else
              jnp.asarray(c_mean) if k == "trans_density_mean" else
              jnp.zeros_like(v)) for k, v in out.items()}
    j_rgb, j_tr = vjp(ct)
    M = BR * N
    t = {k: torch.from_numpy(x[k]) for k in x}
    args = (t["rgb"][:M], t["tr"][:M], t["dens"][:M],
            _dists(t["depth"][:, :BR], t["ray"][:, :BR]).reshape(BR, N),
            torch.from_numpy(cot[:BR]))
    walk = st_bwd_seg_walk(*args)
    twin = composite_st_bwd_plain(*args)
    for got, want, ref in zip(walk, twin, (j_rgb, j_tr)):
        assert _rel(got, want) <= REL
        assert _rel(got, np.asarray(ref)[:M]) <= REL


@pytest.mark.parametrize("BR", BRS)
@pytest.mark.parametrize("N", NS)
def test_coarse_fwd_walk_matches_jax_and_twin(N, BR):
    """Row 9a: the walk's packed row against JAX's fused_composite_coarse
    forward and composite_coarse_plain; columns 5-7 are zero."""
    x = _inputs(BR, N, seed=4 * N + BR)
    ref = jcoarse(*(jnp.asarray(x[k]) for k in ("rgb", "dens", "depth",
                                                "ray")),
                  tile_rays=8, interpret=True, flat=False)
    M = BR * N
    t = {k: torch.from_numpy(x[k]) for k in x}
    args = (t["rgb"][:M], t["dens"][:M], t["depth"][0, :BR, :, 0],
            _dists(t["depth"][:, :BR], t["ray"][:, :BR]).reshape(BR, N))
    walk = coarse_fwd_seg_walk(*args)
    assert _rel(walk, composite_coarse_plain(*args)) <= REL
    assert torch.equal(walk[:, 5:], torch.zeros(BR, 3))
    for k, (lo, hi) in (("rgb", (0, 3)), ("depth", (3, 4)),
                        ("opacity", (4, 5))):
        assert _rel(walk[:, lo:hi], np.asarray(ref[k])[0, :BR]) <= REL, k


@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32])
def test_halving_leaves_each_lane_its_columns(L):
    """Column c of lane ℓ starts as 1000·c + ℓ: after H halving steps
    (row 3's 16 columns: min(log2 L, 4); row 9a's 8: every H ≤ min(log2
    L, 3)), lane ℓ holds columns (ℓ >> R)·W + j, each the sum over the L
    lanes, and the stored row holds every column's sum."""
    lane = torch.arange(L, dtype=torch.float32)
    log = L.bit_length() - 1
    for C, Hs in ((16, [min(log, 4)]), (8, range(min(log, 3) + 1))):
        acc = (1000 * torch.arange(float(C))[None, :] + lane[:, None])[None]
        for H in Hs:
            held, W, R = seg_halve(acc, H)
            assert W * (L >> R) == C and W == C >> H
            for ell in range(L):
                cols = (ell >> R) * W + torch.arange(W)
                want = L * 1000 * cols + L * (L - 1) / 2
                assert torch.equal(held[0, ell], want.float())
            assert torch.equal(stored_cols(acc, H)[0], acc[0].sum(0))


@pytest.mark.parametrize("BR,N,ptrs,plan", [
    (2048, 64, (0, 1024, 4096), (2, 32, True, 256)),  # the main paths
    (2048, 192, (0, 256), (8, 32, True, 256)),        # the fine field
    (5, 256, (16,), (8, 32, True, 1)),
    (37, 100, (0,), (4, 32, True, 5)),
    (37, 99, (0,), (4, 32, False, 5)),                # N % S != 0
    (2048, 64, (0, 1028), (2, 32, False, 256)),       # an offset view
    (1, 16, (0,), (2, 32, True, 1)),
    (7, 2, (0,), (2, 32, True, 1)),
    (129, 9, (0,), (2, 32, False, 17)),
    (3, 7, (0,), (2, 32, False, 1)),
    (9, 130, (0,), (8, 32, False, 2)),
])
def test_segment_plan(BR, N, ptrs, plan):
    assert segment_plan(BR, N, ptrs) == plan
    S, L, _, blocks = plan
    assert L == 32 and S * L >= N and (S == 2 or (S // 2) * L < N)
    assert blocks * SEG_THREADS >= BR * L > (blocks - 1) * SEG_THREADS
