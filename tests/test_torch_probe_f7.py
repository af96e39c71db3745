"""``tools/probe_f7.py`` (F7's two platform hypotheses on the card) and
its branch-(b) emulation ``tools/tpu_precision.py`` on the CPU:

  * the emulated convolution at the discriminator's shapes (4x4 stride 2
    pad 1, the 4x4 valid conv, the 1x1 head) equals JAX's
    ``conv_general_dilated`` of bf16-cast operands with
    ``preferred_element_type=f32``; its input and weight gradients equal
    ``jax.vjp`` of the f32 convolution at the bf16-rounded operands
    applied to the bf16-rounded cotangent; each within rtol 1e-5, and
    1e-5 of the tensor's largest magnitude where a sum cancels to near
    zero (the two sides sum in different orders); its output differs
    from the plain f32 convolution's.  The same three checks for the Lab
    contraction (``einsum("ij,bjhw->bihw")``);
  * the second derivative (an R1 penalty's parameter gradient through two
    emulated convolutions) is the f32 autograd's with the rounding taken
    out, and a few bf16 roundings from the f64 one with it;
  * ``tpu_default_precision`` swaps the three call sites in and counts
    them through the discriminator, its R1 double backward and
    ``lab_loss``, and restores them and the TF32 switches;
  * the decision rule (``decide``) on made-up six-seed tables;
  * the probe end to end at a tiny width: the four branches from one
    state draw the same draws, a and a2 end equal on the CPU, b ran the
    emulated sites, c ran under ``cudnn.deterministic``, both restored.
"""

import importlib.util
import json
import os
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
TINY = ["--arch.layers_feat=[null,32,32,32]", "--arch.layers_rgb=[null,32,3]",
        "--arch.layers_trans=[null,32,5]", "--arch.skip=[1]",
        "--arch.posenc.L_3D=4", "--nerf.sample_intvs=16",
        "--nerf.rand_rays=256", "--data.image_size=[32,32]",
        "--batch_size=2", "--compute_dtype=float32"]


def _tool(name):
    tools = os.path.join(REPO, "tools")
    for p in (REPO, tools):
        if p not in sys.path:
            sys.path.insert(0, p)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(a, b):
    """rtol 1e-5 elementwise, and 1e-5 of the tensor's largest magnitude
    where the sums cancel to near zero (f32 sums in two orders)."""
    np.testing.assert_allclose(a, b, rtol=RTOL,
                               atol=RTOL * float(np.abs(b).max()))


def _bf16(x):
    import jax.numpy as jnp
    return jnp.asarray(x).astype(jnp.bfloat16)


def _round(x):
    return np.asarray(_bf16(x).astype(np.float32))


# (C_in, C_out, H, kernel, stride, pad): the shipped discriminator's
# convolutions at patch 16 (ndf 64, 9 input channels + the posenc's), a
# batch of 2
CONVS = {"main0_s2": (9, 256, 16, 4, 2, 1),
         "main1_s2": (256, 512, 8, 4, 2, 1),
         "main2_valid": (512, 64, 4, 4, 1, 0),
         "head_1x1": (81, 64, 1, 1, 1, 0)}


@pytest.fixture(scope="module", params=sorted(CONVS))
def conv_case(request):
    """(port: y, gx, gw, plain y; JAX: y, gx, gw) on seeded inputs."""
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F
    tp = _tool("tpu_precision")
    cin, cout, h, k, s, p = CONVS[request.param]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, cin, h, h)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.05).astype(np.float32)
    ho = (h + 2 * p - k) // s + 1
    g = rng.normal(size=(2, cout, ho, ho)).astype(np.float32)
    dn = ("NCHW", "HWIO", "NCHW")
    pad = [(p, p)] * 2
    j_y = jax.lax.conv_general_dilated(
        _bf16(x), _bf16(w), (s, s), pad, dimension_numbers=dn,
        preferred_element_type=jnp.float32)

    def f32(a, b):
        return jax.lax.conv_general_dilated(
            a, b, (s, s), pad, dimension_numbers=dn,
            precision=jax.lax.Precision.HIGHEST)
    _, vjp = jax.vjp(f32, jnp.asarray(_round(x)), jnp.asarray(_round(w)))
    j_gx, j_gw = vjp(jnp.asarray(_round(g)))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = tp.conv_hwio(tx, tw, s, p)
    y.backward(torch.from_numpy(g))
    plain = F.conv2d(torch.from_numpy(x),
                     torch.from_numpy(w).permute(3, 2, 0, 1), stride=s,
                     padding=p)
    return ((y.detach().numpy(), tx.grad.numpy(), tw.grad.numpy(),
             plain.numpy()),
            tuple(np.asarray(a) for a in (j_y, j_gx, j_gw)))


def test_conv_forward_matches_jax_bf16_operands(conv_case):
    (y, _, _, _), (j_y, _, _) = conv_case
    _close(y, j_y)


def test_conv_gradients_match_jax_vjp_at_rounded_operands(conv_case):
    (_, gx, gw, _), (_, j_gx, j_gw) = conv_case
    _close(gx, j_gx)
    _close(gw, j_gw)


def test_conv_is_not_the_f32_conv(conv_case):
    (y, _, _, plain), _ = conv_case
    diff = np.abs(y - plain).max() / np.abs(plain).max()
    assert 1e-5 < diff < 2 ** -6


@pytest.fixture(scope="module")
def lab_case():
    """The Lab contraction, port and JAX, on seeded linear RGB."""
    import jax
    import jax.numpy as jnp
    import torch
    tp = _tool("tpu_precision")
    from texpose_tpu_torch.ops import color
    m = np.asarray(color._RGB2XYZ, np.float32)
    rng = np.random.default_rng(5)
    lin = rng.uniform(0, 1, size=(4, 3, 16, 16)).astype(np.float32)
    g = rng.normal(size=(4, 3, 16, 16)).astype(np.float32)
    eq = "ij,bjhw->bihw"
    j_y = jnp.einsum(eq, _bf16(m), _bf16(lin),
                     preferred_element_type=jnp.float32)
    _, vjp = jax.vjp(lambda a, b: jnp.einsum(
        eq, a, b, precision=jax.lax.Precision.HIGHEST),
        jnp.asarray(_round(m)), jnp.asarray(_round(lin)))
    j_gm, j_gl = vjp(jnp.asarray(_round(g)))
    tm = torch.from_numpy(m).requires_grad_()
    tl = torch.from_numpy(lin).requires_grad_()
    y = tp.lab_contract(tm, tl)
    y.backward(torch.from_numpy(g))
    plain = torch.einsum(eq, torch.from_numpy(m), torch.from_numpy(lin))
    return ((y.detach().numpy(), tm.grad.numpy(), tl.grad.numpy(),
             plain.numpy()),
            tuple(np.asarray(a) for a in (j_y, j_gm, j_gl)))


def test_lab_contraction_matches_jax(lab_case):
    (y, gm, gl, plain), (j_y, j_gm, j_gl) = lab_case
    _close(y, j_y)
    _close(gm, j_gm)
    _close(gl, j_gl)
    diff = np.abs(y - plain).max() / np.abs(plain).max()
    assert 1e-5 < diff < 2 ** -6


def test_second_derivative_runs_the_transposes(monkeypatch):
    """An R1 penalty (‖∂/∂x Σ c·conv(lrelu(conv(x, w1)), w2)‖²) and its
    gradient in (w1, w2), which the double backward takes through the
    Functions' transposes: with the rounding taken out the emulation is
    the f32 convolution's autograd (a wrong transpose errs by O(1)); with
    it, the result lies a few bf16 roundings from the f64 one."""
    import torch
    import torch.nn.functional as F
    tp = _tool("tpu_precision")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 16, 16, generator=g)
    w1 = torch.randn(4, 4, 9, 32, generator=g) * 0.1
    w2 = torch.randn(4, 4, 32, 16, generator=g) * 0.1
    c = torch.randn(2, 16, 4, 4, generator=g)

    def grads(conv, dtype):
        xs, a, b = (t.to(dtype).clone().requires_grad_()
                    for t in (x, w1, w2))
        y = conv(F.leaky_relu(conv(xs, a, 2, 1), 0.2), b, 2, 1)
        gx, = torch.autograd.grad((y * c.to(dtype)).sum(), xs,
                                  create_graph=True)
        return torch.autograd.grad((gx ** 2).sum(), (a, b))

    def plain(xs, w, s, p):
        return F.conv2d(xs, w.permute(3, 2, 0, 1), stride=s, padding=p)

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())
    exact = grads(plain, torch.float64)
    emulated = grads(tp.conv_hwio, torch.float32)
    monkeypatch.setattr(tp, "bf16_round", lambda t: t)
    unrounded = grads(tp.conv_hwio, torch.float32)
    for e, u, r in zip(emulated, unrounded, exact):
        assert rel(u, r) < 1e-5
        assert 1e-3 < rel(e, r) < 0.1


def test_context_swaps_counts_and_restores():
    import torch
    from texpose_tpu_torch.models import losses
    from texpose_tpu_torch.nn import discriminator as disc
    from texpose_tpu_torch.utils.config import load_yaml, process_options
    tp = _tool("tpu_precision")
    cfg = process_options(load_yaml(os.path.join(
        REPO, "configs", "nerf_lm_adapt_gan.yaml")))
    before = (disc._conv, disc.sn_apply, losses.rgb_to_lab)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    g = torch.Generator().manual_seed(0)
    params, state = disc.init_discriminator(g, cfg, ndf=8)
    x = torch.rand(4, 9, 16, 16, generator=g)
    scales = torch.rand(4, 1, 1, 1, generator=g)

    def r1_grads():
        xs = x.clone().requires_grad_()
        ps = {k: [w.clone().requires_grad_() for w in v]
              for k, v in params.items()}
        d, _ = disc.apply_discriminator(ps, state, cfg, xs, scales,
                                        progress=torch.tensor(1.0))
        gx, = torch.autograd.grad(d.sum(), xs, create_graph=True)
        (gx ** 2).sum().backward()
        return torch.cat([w.grad.flatten() for v in ps.values() for w in v])

    ref = r1_grads()
    with tp.tpu_default_precision() as calls:
        assert disc._conv is not before[0]
        assert not torch.backends.cudnn.allow_tf32
        got = r1_grads()
        losses.lab_loss(x[:, :3], x[:, 3:6])
    n_conv = len(params["main"]) + len(params["final"])
    assert calls == {"conv": n_conv, "sn_matvec": n_conv, "lab": 2}
    assert (disc._conv, disc.sn_apply, losses.rgb_to_lab) == before
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == tf32
    rel = float((got - ref).norm() / ref.norm())
    assert 1e-6 < rel < 2 ** -5


# ------------------------------------------------------ the decision rule

def _recs(d_b, d_c, noise, delta_a=-1.5):
    """Six made-up seeds: trunk 36 at 10k, branch a at 36 + delta_a at
    20k, a2 `noise` away from a, b and c `d` above a."""
    def rows(v):
        return [{"step": 15000, "psnr_mean": 36.0, "psnr_topk8": 36.0},
                {"step": 20000, "psnr_mean": v, "psnr_topk8": v}]
    return {s: {"seed": s, "end": 20000,
                "trunk": [{"step": 10000, "psnr_mean": 36.0,
                           "psnr_topk8": 36.0}],
                "a": rows(36 + delta_a), "a2": rows(36 + delta_a + n),
                "b": rows(36 + delta_a + db), "c": rows(36 + delta_a + dc)}
            for s, (db, dc, n) in enumerate(zip(d_b, d_c, noise))}


NOISE = [0.1, -0.2, 0.15, -0.05, 0.1, -0.1]      # mean |.| 0.1167


@pytest.mark.parametrize("d_b,d_c,want", [
    # b: mean 1.0, SE 0.0365, above the noise, Δ_b −0.5 holds the gate
    ([1.0, 0.9, 1.1, 1.0, 0.95, 1.05], [0.1, -0.2, 0.0, 0.1, -0.1, 0.0],
     "b"),
    ([0.1, -0.2, 0.0, 0.1, -0.1, 0.0], [1.0, 0.9, 1.1, 1.0, 0.95, 1.05],
     "c"),
    # mean 0.1 < the noise's 0.1167
    ([0.1] * 6, [0.05] * 6, "neither"),
    # mean 0.5 but SE 0.76 (2 SE = 1.52)
    ([2.5, -1.5, 2.4, -1.4, 1.5, -0.5], [0.0] * 6, "neither"),
    # mean 0.4, tight, above the noise, but Δ_b = −1.1: the gate fails
    ([0.4, 0.38, 0.42, 0.4, 0.41, 0.39], [0.0] * 6, "neither"),
    ([1.0, 0.9, 1.1, 1.0, 0.95, 1.05], [1.0, 0.9, 1.1, 1.0, 0.95, 1.05],
     "both"),
])
def test_decide_on_made_up_tables(d_b, d_c, want):
    f7 = _tool("probe_f7")
    recs = _recs(d_b, d_c, NOISE)
    rule = f7.decide(f7.delta_table(recs))
    assert f7.outcome(rule) == want
    assert rule["b"]["d"] == {s: pytest.approx(v) for s, v in
                              enumerate(d_b)}
    assert rule["b"]["mean_noise"] == pytest.approx(np.mean(np.abs(NOISE)))
    assert rule["b"]["se_d"] == pytest.approx(
        np.std(d_b, ddof=1) / np.sqrt(6))
    assert rule["b"]["mean_delta"] == pytest.approx(-1.5 + np.mean(d_b))


def test_decide_skips_unfinished_branches():
    f7 = _tool("probe_f7")
    recs = _recs([1.0] * 6, [1.0] * 6, NOISE)
    recs[5]["c"] = recs[5]["c"][:1]          # stopped at 15k
    rule = f7.decide(f7.delta_table(recs))
    assert rule["b"]["seeds"] == list(range(6))
    assert rule["c"]["seeds"] == list(range(5))


# ------------------------------------------------------- end to end

def test_probe_runs_four_branches_at_a_tiny_width(tmp_path, monkeypatch):
    import torch
    from texpose_tpu_torch.tools import quality_check as qc
    f7 = _tool("probe_f7")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setitem(qc.FIXTURE, "image_scale", 0.25)
    monkeypatch.setitem(qc.FIXTURE, "crop_res", 32)
    monkeypatch.setattr(qc, "PRETRAIN_MIN_PSNR", 0.0)
    for k, v in (("F7_PRETRAIN_ITERS", "3"), ("F7_SPLIT", "4"),
                 ("F7_END", "8"), ("F7_BRANCH_MARKS", "6,8")):
        monkeypatch.setenv(k, v)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    out_dir = tmp_path / "f7"
    try:
        out = f7.main(["--device=cpu", "--seeds=0", f"--out={out_dir}",
                       "--scan_steps=2", *TINY])
    finally:
        torch.set_num_threads(threads)
    rec = out["seeds"][0]
    assert [r["step"] for r in rec["trunk"]] == [4]
    assert all([r["step"] for r in rec[br]] == [6, 8] == [
        r["step_actual"] for r in rec[br]] for br in f7.BRANCHES)
    assert len(set(rec["gen_digest"].values())) == 1
    assert rec["a"] == rec["a2"]               # the CPU is deterministic
    st = rec["settings"]
    assert st["b"]["site_calls"]["conv"] > 0
    assert st["b"]["site_calls"]["sn_matvec"] > 0
    assert st["c"]["cudnn_deterministic"] is True
    assert st["a"]["cudnn_deterministic"] is False
    assert all(s["restored"] for s in st.values())
    assert rec["b"] != rec["a"]
    assert set(out["delta"][0]) == set(f7.BRANCHES)
    assert out["outcome"] in ("b", "c", "both", "neither")
    doc = json.load(open(out_dir / "F7_H100.json"))
    assert doc["outcome"] == out["outcome"]
    assert os.path.exists(out_dir / "pretrain_model.ckpt")
    assert os.path.exists(out_dir / "f7_s0.json")
    again = f7.main(["--report", str(out_dir)])
    assert json.loads(json.dumps(again["rule"])) == \
        json.loads(json.dumps(out["rule"]))
