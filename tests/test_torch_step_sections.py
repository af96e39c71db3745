"""The port's step and frame decomposition tools on the CPU:
``texpose_tpu_torch/tools/step_sections.py`` (the JAX package's
tools/bench_scan_sections.py, bench_decompose.py and, as its device
split, hlo_dump.py) and ``texpose_tpu_torch/tools/eval_stages.py``
(tools/probe_eval_stages.py).

  * each section body computes what the JAX function it times computes,
    on seeded numpy inputs at a narrow width (the texture step test's
    config): S1 against ``fused_st_field`` in interpret mode, S2 against
    ``jax.grad`` of bench_scan_sections.py:214-216's loss, S0 against
    ``render_patch``'s rgb, S3 against the gradient of :554-564's loss,
    S8 / S9 against the fused composite's forward and VJP, Sa / Sb against
    ``get_rays`` + ``get_bounds`` and ``sample_depth`` on given draws;
    tolerances of tests/test_torch_train_step.py (losses rtol 1e-4,
    tensors and gradients 2e-3 of max);
  * a depth-d chain equals d sequential applications; ``marginal``'s
    arithmetic under an injected clock;
  * every section body and the frame's device stages read nothing from
    the host (tests/torch_host_audit.py), as a capture demands;
  * the kernel-group classifier puts every chip_smoke.py KERNEL_SYMBOLS
    symbol in its row's group and typical library names in exactly one
    group; the split's stage attribution and alignment on a synthetic
    trace; the staged eager step equals the plain one bit for bit;
  * the frame stages of a narrow 96x128 engine give the frame's metrics;
  * both tools' ``main`` raise where no card is visible.
Whether a card is visible is decided inside the tests.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train_step import step_cfg  # noqa: E402
from torch_host_audit import host_reads  # noqa: E402

LOSS_RTOL = 1e-4
GRAD_REL = 2e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The texture step test's narrow config (batch 2 of 16x16 patches, 16
    samples: R·N = 4096), the port's engine, its field's parameters and
    train split as JAX arrays (the Dense layers are [in, out] both sides),
    the seeded inputs, the port's ``Sections`` over them."""
    from texpose_tpu.data.fixture import generate_fixture
    from texpose_tpu.sampling.patch import flex_patch_coords
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    from texpose_tpu_torch.tools.step_sections import Sections
    tmp = tmp_path_factory.mktemp("sections")
    root = generate_fixture(str(tmp / "bop"), n_train=6, n_test=1,
                            scene="scene_all", image_scale=0.25, crop_res=32)
    cfg = step_cfg(root, tmp)
    peng = TextureGANEngine(copy.deepcopy(cfg), "cpu")
    peng.load_dataset()
    peng.upload_train_split()
    peng.build_networks()
    peng.setup_optimizer()
    nerf = {name: [{"w": jnp.asarray(layer.w.detach().numpy()),
                    "b": jnp.asarray(layer.b.detach().numpy())}
                   for layer in getattr(peng.nerf, name)]
            for name in ("mlp_feat", "mlp_rgb", "mlp_trans")}
    batch = {k: jnp.asarray(v.numpy()) for k, v in peng.train_batch.items()}
    B, p = int(cfg.batch_size), int(cfg.patch_size)
    R, N = p * p, int(cfg.nerf.sample_intvs)
    M = B * R * N
    E = 3 + 6 * int(cfg.arch.posenc.L_view)
    key = jax.random.PRNGKey(7)
    coords, _ = flex_patch_coords(key, B, p)
    rng = np.random.default_rng(3)
    x = {"pts": rng.standard_normal((M, 3)),
         "enc": rng.standard_normal((M, E)),
         "light": rng.standard_normal((B, int(cfg.nerf.N_latent_light))),
         "trans": rng.standard_normal((B, int(cfg.nerf.N_latent_trans))),
         "rgb_raw": rng.standard_normal((M, 3)),
         "trans_raw": rng.standard_normal((M, 5)),
         "dens_raw": rng.standard_normal((M, 1)),
         "depth": np.sort(rng.uniform(0.5, 3.0, (B, R, N, 1)), axis=2),
         "ray": rng.standard_normal((B, R, 3)),
         "coords": np.asarray(coords),
         "depth_rand": np.asarray(jax.random.uniform(
             jax.random.split(key)[0], (B, R, N, 1)))}
    x = {k: np.asarray(v, np.float32) for k, v in x.items()}
    return {"cfg": cfg, "nerf": nerf, "batch": batch, "peng": peng, "x": x,
            "key": key, "sec": Sections(peng, inputs=x), "B": B, "R": R,
            "N": N}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jheads(b):
    return {k: v for k, v in b["nerf"].items() if k != "mlp_feat"}


def _jflat(heads):
    """JAX head leaves in the port's ``head_params`` order."""
    return [layer[k] for name in ("mlp_rgb", "mlp_trans")
            for layer in heads[name] for k in ("w", "b")]


def _jfield(b, heads, pts):
    from texpose_tpu.kernels.fused_st_field import fused_st_field
    cfg, x = b["cfg"], b["x"]
    L3 = int(cfg.arch.posenc.L_3D)
    aux3 = jnp.stack([jnp.asarray((2.0 ** np.arange(L3)) * np.pi,
                                  jnp.float32), jnp.ones((L3,))])
    trunk = b["nerf"]["mlp_feat"]
    return fused_st_field(pts, jnp.asarray(x["enc"]), jnp.asarray(x["light"]),
                          jnp.asarray(x["trans"]), trunk, heads, aux3,
                          tuple(cfg.arch.skip), L3, b["R"] * b["N"],
                          compute_dtype=jnp.float32, interpret=True)


def _jrender(b, heads):
    from texpose_tpu.models.texture_gan import render_patch
    x, B = b["x"], b["B"]
    batch = {k: v[:B] for k, v in b["batch"].items()}
    nerf = dict(heads, mlp_feat=b["nerf"]["mlp_feat"])
    return render_patch(nerf, b["cfg"], batch["pose_init"], batch["intr"],
                        jnp.asarray(x["coords"]), batch["z_near"],
                        batch["z_far"], jnp.asarray(x["trans"]),
                        jnp.asarray(x["light"]), b["key"], jnp.asarray(0.5),
                        "train", compute_dtype=jnp.float32), batch


@pytest.fixture(scope="module")
def jax_field(bench):
    """JAX's S2 loss, its gradient to the heads and ``fused_st_field``'s
    outputs (S1's) from one interpret-mode forward."""
    x = bench["x"]

    def loss2(h):
        out = _jfield(bench, h, jnp.asarray(x["pts"]))
        return (out[0] ** 2).mean() + (out[2] ** 2).mean(), out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss2, has_aux=True))(
        _jheads(bench))
    return loss, out, grads


def test_s1_field_forward_matches_fused_st_field(bench, jax_field):
    sec = bench["sec"]
    with torch.no_grad():
        got = sec.field(sec.x["pts"])
    for g, w in zip(got, jax_field[1]):
        assert _rel(g.numpy(), w) <= GRAD_REL
    body, carry, _ = sec.s1()
    torch.testing.assert_close(body(carry), carry + 1e-6 * got[0])


def test_s2_gradient_matches_jax_grad(bench, jax_field):
    sec = bench["sec"]
    jl, _, jg = jax_field
    loss = sec.loss2()
    grads = torch.autograd.grad(loss, sec.heads)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    for g, w in zip(grads, _jflat(jg)):
        assert _rel(g.numpy(), w) <= GRAD_REL


@pytest.fixture(scope="module")
def jax_render(bench):
    """JAX's S3 loss, its gradient to the heads and render_patch's rgb
    (S0's) from one traced forward."""
    from texpose_tpu.models.texture_gan import sample_patch_images
    B = bench["B"]
    hw = int(bench["cfg"].patch_size)

    def rloss(h):
        out, batch = _jrender(bench, h)
        sup = sample_patch_images(bench["cfg"], batch,
                                  jnp.asarray(bench["x"]["coords"]))
        rgb = out["rgb"].reshape(B, hw, hw, 3).transpose(0, 3, 1, 2)
        unc = out["uncert"].reshape(B, hw, hw, 1).transpose(0, 3, 1, 2)
        m = sup["mask"]
        return ((m * ((sup["image"] - rgb) ** 2 / unc ** 2)).sum()
                / (m.sum() + 1e-5) + out["trans_density_mean"]), out["rgb"]

    (loss, rgb), grads = jax.jit(jax.value_and_grad(rloss, has_aux=True))(
        _jheads(bench))
    return loss, rgb, grads


def test_s0_render_matches_render_patch(bench, jax_render):
    sec = bench["sec"]
    with torch.no_grad():
        got = sec.render(sec.x["light"])
    assert _rel(got["rgb"].numpy(), jax_render[1]) <= GRAD_REL


def test_s3_gradient_matches_the_render_loss(bench, jax_render):
    sec = bench["sec"]
    jl, _, jg = jax_render
    loss = sec.rloss(sec.render(sec.x["light"]))
    grads = torch.autograd.grad(loss, sec.heads)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    for g, w in zip(grads, _jflat(jg)):
        assert _rel(g.numpy(), w) <= GRAD_REL


def test_s8_s9_composite_forward_and_vjp(bench):
    from texpose_tpu.kernels.fused_composite import fused_composite_st
    sec, x = bench["sec"], bench["x"]
    args = [jnp.asarray(x[k]) for k in ("rgb_raw", "trans_raw", "dens_raw",
                                         "depth", "ray")]

    def closs(rr, tr):
        out = fused_composite_st(rr, tr, *args[2:], interpret=True)
        return ((out["rgb"] ** 2).mean() + (out["uncert"] ** 2).mean()
                + out["trans_density_mean"]), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(closs, argnums=(0, 1),
                                                has_aux=True))(*args[:2])
    rr, tr = (sec.x[k].clone().requires_grad_(True)
              for k in ("rgb_raw", "trans_raw"))
    out = sec.composite(rr, tr)
    for k in ("rgb", "rgb_static", "uncert", "opacity", "depth"):
        assert _rel(out[k].detach().numpy(), jout[k]) <= GRAD_REL, k
    loss = sec.closs(out)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    for g, w in zip(torch.autograd.grad(loss, (rr, tr)), jg):
        assert _rel(g.numpy(), w) <= GRAD_REL


def test_sa_sb_rays_bounds_and_depths(bench):
    from texpose_tpu.ops.render import sample_depth as jsd
    from texpose_tpu.sampling.ray_sampler import get_bounds, get_rays
    from texpose_tpu_torch.ops.render import sample_depth
    sec, cfg, B, R, N = (bench[k] for k in ("sec", "cfg", "B", "R", "N"))
    batch = {k: v[:B] for k, v in bench["batch"].items()}
    c = jnp.asarray(bench["x"]["coords"])
    want = (*get_rays(batch["intr"], c, batch["pose_init"], cfg.H, cfg.W),
            *get_bounds(c, batch["z_near"], batch["z_far"], cfg.H, cfg.W))
    for g, w in zip(sec.rays(sec.x["coords"]), want):
        assert _rel(g.numpy(), w) <= LOSS_RTOL
    near = np.full((B, R), 0.5, np.float32)
    far = np.full((B, R), 3.0, np.float32)
    k = jax.random.PRNGKey(5)
    jd = jsd(k, jnp.asarray(near), jnp.asarray(far), N, stratified=True,
             param=cfg.nerf.depth.param)
    rand = torch.as_tensor(np.array(jax.random.uniform(k, (B, R, N, 1))))
    got = sample_depth(torch.as_tensor(near), torch.as_tensor(far), N,
                       param=cfg.nerf.depth.param, rand=rand)
    assert _rel(got.numpy(), jd) <= LOSS_RTOL


@pytest.mark.parametrize("tag", ["1", "2"])
def test_a_chain_is_its_bodies_in_sequence(bench, tag):
    from texpose_tpu_torch.tools.step_sections import chain, section_body
    sec = bench["sec"]
    body, carry, in_place = section_body(sec, tag)
    start = [t.detach().clone() for t in (carry if in_place else [carry])]

    def reset():
        with torch.no_grad():
            for t, s in zip(sec.heads if in_place else [], start):
                t.copy_(s)

    got = chain(body, carry if in_place else carry.clone(), 3)
    got = [t.detach().clone() for t in (got if in_place else [got])]
    reset()
    c = carry if in_place else carry.clone()
    for _ in range(3):
        c = body(c)
    want = c if in_place else [c]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.detach())
    assert not all(torch.equal(g, s) for g, s in zip(got, start))
    reset()


def test_marginal_under_an_injected_clock():
    from texpose_tpu_torch.tools.step_sections import marginal
    runs = []

    def make_run(d):
        def run():
            run.calls += 1
        run.calls, run.d = 0, d
        runs.append(run)
        return run

    times = iter([5.0, 4.0, 4.5, 6.0, 4.2,               # depth 4
                  12.0, 12.5, 13.0, 12.1, 15.0])         # depth 20

    def clock(run):
        run()
        return next(times)

    out = marginal(make_run, 4, 20, 5, clock=clock)
    assert [r.d for r in runs] == [4, 20]
    assert [r.calls for r in runs] == [6, 6]              # warm + 5
    assert out["best_ms"] == {"4": 4.0, "20": 12.0}
    assert out["median_ms"] == {"4": 4.5, "20": 12.5}
    assert out["marginal_ms"] == pytest.approx((12.0 - 4.0) / 16)
    assert out["marginal_median_ms"] == pytest.approx((12.5 - 4.5) / 16)


def test_section_bodies_read_nothing_from_the_host(bench):
    from texpose_tpu_torch.tools.step_sections import (SECTIONS, ablation,
                                                       chain, section_body)
    sec = bench["sec"]
    hits = {}
    for tag in SECTIONS:
        with ablation(tag):
            body, carry, in_place = section_body(sec, tag)
            c = carry if in_place else (
                tuple(t.clone() for t in carry) if isinstance(carry, tuple)
                else carry.clone())
            chain(body, c, 1)                     # constants cached first
            found = host_reads(lambda: chain(body, c, 1))
        if found:
            hits[tag] = found
    assert not hits, hits


def test_every_kernel_lands_in_one_group():
    import importlib.util
    from texpose_tpu_torch.tools import step_sections as ss
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_m", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rows = cs.WRAPPER_ROWS
    assert set(rows) == set(cs.KERNEL_SYMBOLS)
    for wrapper, syms in cs.KERNEL_SYMBOLS.items():
        for sym, epi in syms:
            name = (f"void {sym}<{epi}>(Params)" if epi is not None
                    else f"void {sym}<4, 32, true>(float const*, int)")
            for stage in (None, "render", "step/gen_backward", "pack"):
                got = ss.groups_of(name, stage, rows[wrapper])
                assert got == [rows[wrapper]], (wrapper, stage, got)
    typical = {
        ("void cudnn::cnn::conv2d_grouped_direct_kernel<float>(int)",
         "vgg"): "VGG",
        ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw",
         "vgg"): "VGG",
        ("sm80_xmma_dgrad_implicit_gemm_indexed_tf32f32_tf32f32_f32_"
         "nhwckrsc_nchw", "step/disc_backward"): "discriminator + R1",
        ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
         "<at::native::(anonymous namespace)::TensorListMetadata<4>, "
         "FusedAdamMathFunctor>(int)", "step/gen_update"):
            "updates (optimizers, EMA)",
        ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<2>, "
         "BinaryOpListAlphaFunctor<float, 2, 2, 0>>(int)",
         "step/update"): "updates (optimizers, EMA)",
        ("Memcpy DtoD (Device -> Device)", "pack"): "weight packs",
        ("Memcpy DtoD (Device -> Device)", "io"): "slot copies + clones",
        ("void at::native::unrolled_elementwise_kernel<CopyFunctor>(int)",
         "pack"): "weight packs",
        ("void at::cuda::(anonymous namespace)::distribution_elementwise_"
         "grid_stride_kernel<float, 4>(int)", "draws"): "draws",
        ("void at::native::vectorized_elementwise_kernel<4, "
         "FillFunctor<float>>(int)", "render"): "render glue",
        ("void at::native::reduce_kernel<512, 1>(int)", "metrics"):
            "metrics (SSIM, LPIPS)",
        ("void at::native::index_elementwise_kernel<128, 4>(int)",
         "frame"): "scatter + PNG payload",
        ("void at::native::vectorized_elementwise_kernel<4>(int)",
         "step/gen_forward"): "losses + batch",
        ("void at::native::vectorized_elementwise_kernel<4>(int)",
         "step/backward"): "loss backward",
        ("void at::native::vectorized_elementwise_kernel<4>(int)",
         None): ss.OTHER,
        ("void at::native::vectorized_elementwise_kernel<4>(int)",
         "unknown"): ss.OTHER,
    }
    for (name, stage), group in typical.items():
        assert ss.groups_of(name, stage, "row 1") == [group], (name, stage)
    # a field forward of no known epilogue is flagged, never guessed
    assert len(ss.groups_of("void field_fwd_kernel<7>(Params)", "render",
                            "row 1")) == 2


def test_split_on_a_synthetic_trace():
    """Stages from an eager run's ranges (the launch's host time inside the
    innermost range, a backward bracketed by its markers), carried to a
    replay's kernels by alignment; the group sums against the busy union."""
    from texpose_tpu_torch.tools import step_sections as ss
    C, G = "DeviceType.CPU", "DeviceType.CUDA"
    ms = 1_000_000
    eager = [
        (C, 0, "step/gen_forward", 0, 100 * ms, True),
        (C, 0, "section/render", 10 * ms, 40 * ms, True),
        (C, 0, "section/pack", 11 * ms, 12 * ms, True),
        (C, 0, "step/gen_backward", 100 * ms, 200 * ms, True),
        (C, 0, "section/bwd<render#1", 150 * ms, 150 * ms, True),
        (C, 0, "section/bwd>render#1", 190 * ms, 190 * ms, True),
        (C, 1, "cudaLaunchKernel", 11 * ms + 5, 11 * ms + 9, False),
        (C, 2, "cudaLaunchKernel", 20 * ms, 20 * ms + 9, False),
        (C, 3, "cudaLaunchKernel", 50 * ms, 50 * ms + 9, False),
        (C, 4, "cuLaunchKernel", 120 * ms, 120 * ms + 9, False),
        (C, 5, "cudaLaunchKernel", 160 * ms, 160 * ms + 9, False),
        (C, 6, "cudaLaunchKernel", 170 * ms, 170 * ms + 9, False),
        (G, 1, "Memcpy DtoD (Device -> Device)", 1, 2, False),
        (G, 2, "void field_fwd_kernel<0>(Params)", 3, 4, False),
        (G, 3, "void at::native::elementwise_kernel<1>(int)", 5, 6, False),
        (G, 4, "void at::native::elementwise_kernel<2>(int)", 7, 8, False),
        (G, 5, "void st_field_bwd_kernel<true>(Params)", 9, 10, False),
        (G, 6, "void at::native::elementwise_kernel<3>(int)", 11, 12, False),
        (G, 0, "step/gen_forward", 0, 20, True),         # a GPU span
    ]
    stages = ss.kernel_stages(eager)
    assert [s for _, s in stages] == ["pack", "render", "step/gen_forward",
                                      "step/gen_backward", "render",
                                      "render"]
    names = [n for n, _ in stages]
    window = [(C, 100, "cudaGraphLaunch", 0, 1, False),
              (C, 101, "cudaGraphLaunch", 0, 1, False)]
    t = 0
    for corr in (100, 101):
        # the second replay lacks the eager run's copy (not aligned there)
        for n in (names if corr == 100 else names[1:]) + ["void extra<1>(x)"]:
            window.append((G, corr, n, t, t + ms, False))
            t += ms
    window.append((G, 7, "Memcpy DtoD (Device -> Device)", t, t + ms, False))
    r = ss.split(eager, window, "row 1", 2)
    assert r["replays"] == 2 and r["n_misgrouped"] == 0
    g = r["groups_ms"]
    assert g["row 1"] == 1.0 and g["row 2 (dX)"] == 1.0
    assert g["weight packs"] == 0.5 and g["render glue"] == 1.0
    assert g["losses + batch"] == 1.0 and g["loss backward"] == 1.0
    assert g["other"] == 1.0 and g["slot copies + clones"] == 0.5
    assert r["sum_ms"] == pytest.approx(r["busy_ms"])
    assert r["other_top"][0][0].startswith("void extra")
    assert r["aligned"] == pytest.approx(5 / 6)


def test_the_staged_step_is_the_step(bench):
    """The split's eager step in its stages gives the step's losses bit
    for bit, and its trace holds the stages' ranges."""
    from texpose_tpu_torch.tools import step_sections as ss
    a, b = bench["peng"], None
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    b = TextureGANEngine(copy.deepcopy(bench["cfg"]), "cpu")
    b.load_dataset()
    b.upload_train_split()
    b.build_networks()
    b.setup_optimizer()
    b.vgg = a.vgg
    b.load_train_state_flat(a.train_state_flat(a.it))
    b.draw_gen.set_state(a.draw_gen.get_state())
    with ss.staged(), ss.device_trace() as ev:
        with torch.profiler.record_function("section/draws"):
            draws = a.make_draws(a.it)
        la = a.train_step(draws)
    lb = b.train_step(b.make_draws(b.it))
    assert {k: float(v) for k, v in la.items()} == \
        {k: float(v) for k, v in lb.items()}
    seen = {s for _, _, s in ss.stage_ranges(ev["events"])}
    assert {"render", "vgg", "disc", "draws", "step/gen_backward",
            "step/disc_backward"} <= seen
    # the patched functions are restored
    from texpose_tpu_torch.models import texture_gan
    assert texture_gan.render_patch.__module__.endswith("texture_gan")
    assert not hasattr(texture_gan.render_patch, "__wrapped__")


@pytest.fixture(scope="module")
def stages_engine(tmp_path_factory):
    """A 96x128 evaluation engine over a 3-frame cycled split of a
    quarter-scale fixture, at the narrow width."""
    import tempfile
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    from texpose_tpu_torch.tools import eval_envelope as ee
    tmp = str(tmp_path_factory.mktemp("stages"))
    was, fix = tempfile.tempdir, dict(ee.FIXTURE)
    tempfile.tempdir = tmp
    ee.FIXTURE.update(n_train=4, image_scale=0.25)
    try:
        cache = ee.fixture()
        scene = ee.long_split(cache, 3)
        cfg = ee.envelope_cfg(cache, scene, (96, 128), tmp + "/out", [
            "--arch.layers_feat=[null,32,32,32]",
            "--arch.layers_rgb=[null,32,3]", "--arch.layers_trans=[null,32,5]",
            "--arch.skip=[1]", "--arch.posenc.L_3D=4",
            "--nerf.sample_intvs=16", "--nerf.rand_rays=512",
            "--compute_dtype=float32"])
        eng = TextureGANEngine(cfg, torch.device("cpu"))
        eng.load_dataset(eval_split="test")
        eng.build_networks()
        eng.setup_optimizer()
        yield eng
    finally:
        tempfile.tempdir = was
        ee.FIXTURE.clear()
        ee.FIXTURE.update(fix)


def test_frame_stages_give_the_frames_metrics(stages_engine, tmp_path):
    import numpy as np
    from texpose_tpu_torch.tools import eval_stages as es
    from texpose_tpu_torch.utils.pipeline import to_device
    eng = stages_engine
    res = es.run_stages(eng, 2, str(tmp_path))
    assert list(res["host_ms"]) == list(es.STAGES)
    assert res["frames"] == 2 and res["device_ms"] == {}
    assert res["sync_loop_ms"] > 0 and res["pipe_loop_ms"] > 0
    tab = eng._host_latents_table()
    seed = int(eng.cfg.render.get("eval_seed", 0) or 0)
    _, _, got = es.stage_frame(eng, 0, tab, np.random.default_rng(seed),
                               str(tmp_path))
    sample = eng.eval_data[0]
    lt, ll = eng._frame_latents(np.asarray(sample["pose"]), tab,
                                np.random.default_rng(seed))
    frame = to_device(eng._eval_compact_transform()(sample), eng.device,
                      batch=False)
    with torch.inference_mode():
        want = eng._eval_compact(frame, lt, ll,
                                 getattr(eng.eval_data, "raw_hw", None))
    assert got == tuple(float(v) for v in want[:3])


def test_frame_device_stages_read_nothing_from_the_host(stages_engine):
    from texpose_tpu_torch.models.frame_graph import _map
    from texpose_tpu_torch.models.step_graph import follow_route
    eng = stages_engine
    eng.warm_eval(0)
    runner = eng.frame_runner()
    unit = next(u for k, u in runner.units.items() if k[0] == "evalcompact")

    def stages():
        follow_route(runner)
        with torch.inference_mode():
            _map(torch.clone, unit.body(**unit.slots))

    assert host_reads(stages) == []


def test_the_tools_raise_without_a_card(monkeypatch):
    from texpose_tpu_torch.tools import eval_stages, step_sections
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        step_sections.main(["--sections=1"])
    with pytest.raises(RuntimeError, match="CUDA card"):
        eval_stages.main(["--frames=2"])
    with pytest.raises(ValueError, match="card only"):
        step_sections.main(["--device=cpu"])
