"""The port's per-frame evaluation programs (models/frame_graph.py
``FrameRunner``, the counterpart of the JAX engines' per-frame jit cache)
on the CPU, where every frame runs eagerly through the runner's slots
(the captured CUDA graphs run on the card: chip_smoke.py's
``frame_graph`` phase):

  * each frame body against the JAX engine's jitted body on the same
    inputs and bridged weights: the texture GAN's compact, masked, full
    and metrics bodies (with and without the raw_hw resize), the
    pretrain's frame, compact and metrics bodies;
  * the runner through its slots equals a direct body call bit for bit,
    and a split whose frames fall in two P buckets plus one whole frame
    makes exactly the JAX engine's keys;
  * two frames dispatched before the first result is read each return
    their own values (a replay overwrites its static outputs);
  * evaluation after a training dispatch equals the evaluation of a
    fresh engine loaded from that state (the weights follow training);
  * after one warm call no body builds a tensor from host data or reads
    one back, on every route of the eval frames (what a capture refuses);
  * a capture that fails raises, naming the engine and the key, and no
    frame is evaluated eagerly instead.

Tolerances as tests/test_torch_render_metrics.py and the slice test:
rendered leaves 1e-4 (depth up to ~6 here), PSNR 0.01 dB, SSIM 1e-4,
LPIPS rtol 1e-4 on converted weights, PNG payloads 1 LSB (float32
summation order may round a pixel the other way)."""

import contextlib
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.data.fixture import generate_fixture
from test_texture_gan_e2e import tiny_gan_cfg
from torch_host_audit import host_reads

CHUNK = 128                # 391 object pixels → P = 512; thinned → 256
LEAF_TOL = 1e-4
PSNR_TOL = 0.01
SSIM_TOL = 1e-4
LPIPS_RTOL = 1e-4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")),
                            n_train=4, n_test=2, scene="scene_all",
                            image_scale=0.25, crop_res=32)


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU frames: one torch thread beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gan_cfg(root, out):
    cfg = tiny_gan_cfg(root, out)
    cfg.syn2real = True
    cfg.data.image_size = [60, 80]
    cfg.data.raw_size = [120, 160]
    cfg.H, cfg.W = 60, 80
    cfg.nerf.rand_rays = CHUNK
    cfg.kernels = {}
    cfg.render.drift_monitor = False
    return cfg


@pytest.fixture(scope="module")
def gan(root, tmp_path_factory):
    """The JAX texture engine with a seeded state and the port's engine
    restored from its checkpoint, LPIPS bridged → (jeng, teng)."""
    from texpose_tpu.models.texture_gan import TextureGANEngine as JaxEngine
    from texpose_tpu.nn.fields import init_nerf_st
    from texpose_tpu.utils.checkpoint import save_checkpoint
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    from texpose_tpu_torch.nn.lpips import from_jax

    tmp = tmp_path_factory.mktemp("gan")
    jcfg = _gan_cfg(root, tmp / "jax")
    jeng = JaxEngine(jcfg)
    jeng.load_dataset(eval_split="test", prefetch_train=False)
    k_nerf, k_lt, k_ll = jax.random.split(jax.random.PRNGKey(0), 3)
    n = len(jeng.train_data)
    jeng.state = {"params": {"nerf": init_nerf_st(k_nerf, jcfg)},
                  "latents": {"trans": jax.random.normal(k_lt, (n, 8)),
                              "light": jax.random.normal(k_ll, (n, 12))}}
    tcfg = _gan_cfg(root, tmp / "torch")
    tcfg.resume = True
    save_checkpoint(tcfg.output_path, jeng.state)
    teng = TextureGANEngine(tcfg, "cpu")
    teng.load_dataset(eval_split="test")
    teng.build_networks()
    assert teng.restore_checkpoint()
    teng._lpips_params = from_jax(jeng._ensure_lpips()[0])
    teng.lpips_key = jeng.lpips_key
    return jeng, teng


def _latents(jeng, row):
    lt = np.asarray(jeng.state["latents"]["trans"][row:row + 1])
    ll = np.asarray(jeng.state["latents"]["light"][row:row + 1])
    return lt, ll


def _close_metrics(got, ref):
    """(psnr, ssim, lpips, png...) of the port against JAX's."""
    got = [np.asarray(g) for g in got]
    ref = [np.asarray(r) for r in ref]
    assert abs(float(got[0]) - float(ref[0])) < PSNR_TOL
    assert abs(float(got[1]) - float(ref[1])) < SSIM_TOL
    np.testing.assert_allclose(float(got[2]), float(ref[2]),
                               rtol=LPIPS_RTOL, atol=1e-7)
    for g, r in zip(got[3:], ref[3:]):
        assert g.shape == r.shape and g.dtype == np.uint8
        assert np.abs(g.astype(int) - r.astype(int)).max() <= 1


def _close_leaves(got, ref):
    assert set(ref) <= set(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=LEAF_TOL, err_msg=k)


def _compact_payload(teng, i):
    """Frame i's compact payload as tensors (the port's transform)."""
    sample = teng.eval_data[i]
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in teng._eval_compact_transform()(sample).items()}


@pytest.mark.parametrize("unit", ["compact", "compact_raw", "masked", "full",
                                  "metrics", "metrics_raw"])
def test_gan_body_matches_jax(gan, unit):
    from texpose_tpu.models import render as jrender
    from texpose_tpu_torch.models import texture_gan as tg
    jeng, teng = gan
    cfg = teng.cfg
    params = jeng.state["params"]["nerf"]
    lp_t = teng._ensure_lpips()[0]
    raw_hw = teng.eval_data.raw_hw if unit.endswith("raw") else None
    lt, ll = _latents(jeng, 1)
    key = jax.random.PRNGKey(0)
    one = jnp.asarray(1.0)
    sample = teng.eval_data[0]
    obj = np.asarray(sample["obj_mask"], np.float32).reshape(1, -1)
    args = dict(pose=_t(sample["pose"])[None], intr=_t(sample["intr"])[None],
                z_near=_t(sample["z_near"])[None],
                z_far=_t(sample["z_far"])[None])
    jargs = [jnp.asarray(np.asarray(v)) for v in args.values()]
    with torch.inference_mode():
        if unit.startswith("compact"):
            f = _compact_payload(teng, 0)
            P = f["idx"].shape[0]
            ref = jeng._eval_compact_fn(raw_hw, P)(
                params, *[jnp.asarray(f[k].numpy()) for k in (
                    "pose", "intr", "z_near_pre", "z_far_pre")],
                jnp.asarray(lt), jnp.asarray(ll), jnp.asarray(f["idx"]),
                jnp.asarray(f["image_sparse_u8"].numpy()))
            got = tg.eval_compact_body(
                teng.nerf, cfg, lp_t, raw_hw, f["pose"], f["intr"],
                f["z_near_pre"], f["z_far_pre"], _t(lt), _t(ll), f["idx"],
                f["image_sparse_u8"])
            _close_metrics(got, ref)
            return
        if unit == "masked":
            idx_p, n = jrender.masked_ray_indices(obj[0], CHUNK)
            out = jrender.render_rays_masked_st(
                params, cfg, *jargs[:2], jnp.asarray(idx_p), *jargs[2:],
                jnp.asarray(lt), jnp.asarray(ll), key, progress=one,
                chunk=CHUNK)
            ref = jrender.scatter_masked_st(cfg, out, jnp.asarray(idx_p), n,
                                            jnp.asarray(obj))
            got = tg.render_masked_body(teng.nerf, cfg, **args, lt=_t(lt),
                                        ll=_t(ll), idx=_t(idx_p),
                                        obj_mask=_t(obj))
            _close_leaves(got, ref)
            return
        ref = jrender.render_full_nerf_st(
            params, cfg, *jargs, jnp.asarray(lt), jnp.asarray(ll), key,
            progress=one, obj_mask=jnp.asarray(obj))
        if unit == "full":
            got = tg.render_full_body(teng.nerf, cfg, **args, lt=_t(lt),
                                      ll=_t(ll), obj_mask=_t(obj))
            _close_leaves(got, ref)
            return
        rgb = np.asarray(ref["rgb_static"])
        image = np.asarray(sample["image"], np.float32)[None]
        want = jeng._eval_metrics_fn(raw_hw)(
            jnp.asarray(rgb), jnp.asarray(image),
            jnp.asarray(np.asarray(sample["obj_mask"])[None]))
        got = tg.eval_metrics_body(cfg, lp_t, raw_hw, _t(rgb), _t(image),
                                   _t(sample["obj_mask"])[None])
        _close_metrics(got, want)


@pytest.fixture(scope="module")
def pre(root, tmp_path_factory):
    """The JAX pretrain engine (c2f on, so the progress input matters) and
    the port's engine holding its state, LPIPS bridged."""
    from test_torch_pretrain_step import jax_engine, port_engine, step_cfg
    from texpose_tpu_torch.nn.lpips import from_jax
    cfg = step_cfg(root, tmp_path_factory.mktemp("pre"), c2f=[0.1, 0.5])
    jeng = jax_engine(cfg)
    peng = port_engine(cfg, jeng)
    peng._lpips_params = from_jax(jeng._ensure_lpips()[0])
    peng.lpips_key = jeng.lpips_key
    return jeng, peng


@pytest.mark.parametrize("unit", ["frame", "compact", "metrics"])
def test_pretrain_body_matches_jax(pre, unit):
    from texpose_tpu_torch.models import pretrain as pt
    jeng, peng = pre
    cfg = peng.cfg
    params = jeng.state["params"]["nerf"]
    lp_t = peng._ensure_lpips()[0]
    sample = peng.eval_data[0]
    frame = {k: _t(v)[None] for k, v in sample.items()}
    jframe = {k: jnp.asarray(np.asarray(v)[None]) for k, v in sample.items()}
    geo = dict(pose=frame["pose"], intr=frame["intr"],
               z_near=frame["z_near"], z_far=frame["z_far"])
    with torch.inference_mode():
        if unit == "frame":
            ref = jeng._render_frame(params, jframe, 0.3)
            got = pt.render_frame_body(peng.nerf, cfg, **geo,
                                       progress=torch.tensor(0.3))
            _close_leaves(got, ref)
            return
        if unit == "compact":
            f = {k: _t(v) for k, v in
                 peng._eval_compact_transform()(sample).items()}
            ref = jeng._eval_compact_fn()(
                params, *[jnp.asarray(f[k].numpy()) for k in (
                    "pose", "intr", "z_near", "z_far", "image_u8",
                    "obj_mask_u8")])
            got = pt.eval_compact_body(
                peng.nerf, cfg, lp_t, f["pose"], f["intr"], f["z_near"],
                f["z_far"], f["image_u8"], f["obj_mask_u8"])
            _close_metrics(got, ref)
            return
        out = jeng._render_frame(params, jframe)
        rgb, opac = np.asarray(out["rgb"]), np.asarray(out["opacity"])
        ref = jeng._eval_metrics_fn()(jnp.asarray(rgb), jnp.asarray(opac),
                                      jframe["image"], jframe["obj_mask"])
        got = pt.eval_metrics_body(cfg, lp_t, _t(rgb), _t(opac),
                                   frame["image"], frame["obj_mask"])
        _close_metrics(got, ref)


class _Split:
    """An eval split whose frame 1 keeps every other object pixel (the
    next smaller P bucket) and whose frame 2 is frame 0 with a whole-frame
    mask (the whole-frame route)."""

    def __init__(self, data):
        self.data, self.raw_hw = data, data.raw_hw

    def __len__(self):
        return 3

    def __getitem__(self, i):
        s = dict(self.data[0])
        if i == 1:
            m = np.asarray(s["obj_mask"]).copy().reshape(-1)
            on = np.nonzero(m > 0)[0]
            m[on[::2]] = 0
            s["obj_mask"] = m.reshape(np.shape(s["obj_mask"]))
        elif i == 2:
            s["obj_mask"] = np.ones_like(np.asarray(s["obj_mask"]))
        s["frame_index"] = np.asarray(i)
        return s


@contextlib.contextmanager
def _split(*engines):
    olds = [e.eval_data for e in engines]
    try:
        for e in engines:
            e.eval_data = _Split(e.eval_data)
            e._eval_cache = (None, None)
        yield
    finally:
        for e, d in zip(engines, olds):
            e.eval_data = d
            e._eval_cache = (None, None)


def test_runner_keys_equal_jax_keys(gan):
    """Frames in two P buckets plus one whole frame: the port's units are
    the JAX engine's ``_render_jits`` keys plus its ``_render_jit`` as
    ("full", H, W), and both sweeps agree."""
    jeng, teng = gan
    cfg = teng.cfg
    jeng._render_jits = {}
    if hasattr(jeng, "_render_jit"):
        del jeng._render_jit
    teng.frame_runner().drop()
    with _split(jeng, teng):
        jres = jeng.evaluate_full()
        tres = teng.evaluate_full()
    raw = teng.eval_data.raw_hw
    keys = set(teng.frame_runner().units)
    assert keys - {("full", cfg.H, cfg.W)} == set(jeng._render_jits)
    assert ("full", cfg.H, cfg.W) in keys and hasattr(jeng, "_render_jit")
    assert keys == {("evalcompact", raw, 512), ("evalcompact", raw, 256),
                    ("full", cfg.H, cfg.W), ("evalmetrics", raw)}
    assert abs(jres["psnr"] - tres["psnr"]) < PSNR_TOL
    assert abs(jres["ssim"] - tres["ssim"]) < SSIM_TOL


def test_runner_equals_direct_body_calls(gan):
    """Through the runner's slots, each key's outputs equal the body
    called directly on the same inputs, bit for bit."""
    from texpose_tpu_torch.models import texture_gan as tg
    jeng, teng = gan
    cfg = teng.cfg
    raw = teng.eval_data.raw_hw
    lt, ll = _latents(jeng, 2)
    lp = teng._ensure_lpips()[0]
    f = _compact_payload(teng, 0)
    frame = teng.eval_frame(0)
    with torch.inference_mode():
        got = teng._eval_compact(f, lt, ll, raw)
        want = tg.eval_compact_body(
            teng.nerf, cfg, lp, raw, f["pose"], f["intr"], f["z_near_pre"],
            f["z_far_pre"], _t(lt), _t(ll), f["idx"], f["image_sparse_u8"])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        out = teng._render_frame_st(frame, lt, ll)
        idx_p, _ = tg.masked_ray_indices(
            frame["obj_mask"].numpy().reshape(-1), CHUNK)
        direct = tg.render_masked_body(
            teng.nerf, cfg, frame["pose"], frame["intr"], frame["z_near"],
            frame["z_far"], _t(lt), _t(ll), _t(idx_p), frame["obj_mask"])
        assert set(out) == set(direct)
        assert all(torch.equal(out[k], direct[k]) for k in out)
        got = teng._eval_metrics(out["rgb_static"], frame["image"],
                                 frame["obj_mask"], raw)
        want = tg.eval_metrics_body(cfg, lp, raw, out["rgb_static"],
                                    frame["image"], frame["obj_mask"])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert ("masked", len(idx_p)) in teng.frame_runner().units


def test_results_outlive_the_next_dispatch(gan):
    """Two frames of one key dispatched before either result is read
    (evaluate_full pulls one frame behind): each holds its own values."""
    from texpose_tpu_torch.models import texture_gan as tg
    jeng, teng = gan
    raw = teng.eval_data.raw_hw
    lp = teng._ensure_lpips()[0]
    f = _compact_payload(teng, 0)
    (lt0, ll0), (lt1, ll1) = _latents(jeng, 0), _latents(jeng, 3)
    with torch.inference_mode():
        first = teng._eval_compact(f, lt0, ll0, raw)
        second = teng._eval_compact(f, lt1, ll1, raw)
        for got, (lt, ll) in ((first, (lt0, ll0)), (second, (lt1, ll1))):
            want = tg.eval_compact_body(
                teng.nerf, teng.cfg, lp, raw, f["pose"], f["intr"],
                f["z_near_pre"], f["z_far_pre"], _t(lt), _t(ll), f["idx"],
                f["image_sparse_u8"])
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    assert not torch.equal(first[3], second[3])


def test_a_switch_drops_the_frames_and_the_step(gan):
    """A switch the captured programs read (here cfg.nerf) drops the frame
    units and restarts the step runner's warm-up alike
    (step_graph.follow_route), so neither replays another route."""
    from texpose_tpu_torch.models.step_graph import follow_route
    _, teng = gan
    runner, steps = teng.frame_runner(), teng.step_runner()
    teng.warm_eval(0)
    follow_route(steps)
    steps.warm = 2
    units = set(runner.units)
    assert units
    follow_route(runner)
    follow_route(steps)
    assert set(runner.units) == units and steps.warm == 2
    was = teng.cfg.nerf.get("density_noise_reg")
    teng.cfg.nerf.density_noise_reg = 1
    try:
        follow_route(runner)
        follow_route(steps)
        assert runner.units == {} and steps.warm == 0
    finally:
        teng.cfg.nerf.density_noise_reg = was


def _train_engine(kind, root, tmp_path):
    if kind == "gan":
        from test_torch_scan_steps import _gan_engine
        return _gan_engine(root, tmp_path, 300)
    from test_torch_pretrain_step import step_cfg
    from test_torch_scan_steps import port_pretrain
    return port_pretrain(step_cfg(root, tmp_path))


@pytest.mark.parametrize("kind", ["gan", "pretrain"])
def test_eval_follows_a_training_dispatch(kind, root, tmp_path):
    """evaluate_full, one training dispatch, evaluate_full through the same
    units: the second equals a fresh engine's evaluation of that state."""
    eng = _train_engine(kind, root, tmp_path / "a")
    before = eng.evaluate_full()
    units = set(eng.frame_runner().units)
    eng.step_runner().dispatch(1)
    after = eng.evaluate_full()
    assert set(eng.frame_runner().units) == units
    fresh = _train_engine(kind, root, tmp_path / "b")
    fresh.load_train_state_flat(eng.train_state_flat(eng.it))
    assert after == fresh.evaluate_full()
    assert after != before


def _audit_engine(route, gan, pre):
    """(engine, [(name, body, inputs)]) of a route's frame bodies."""
    from texpose_tpu_torch.models import pretrain as pt
    from texpose_tpu_torch.models import texture_gan as tg
    if route.startswith("pretrain"):
        eng = pre[1]
        eng.cfg.kernels = ({"coarse_mega": False}
                           if route == "pretrain_two_kernel" else {})
        cfg, lp = eng.cfg, eng._ensure_lpips()[0]
        sample = eng.eval_data[0]
        frame = {k: _t(v)[None] for k, v in sample.items()}
        geo = dict(pose=frame["pose"], intr=frame["intr"],
                   z_near=frame["z_near"], z_far=frame["z_far"])
        c = {k: _t(v) for k, v in eng._eval_compact_transform()(
            sample).items()}
        HW = cfg.H * cfg.W
        return eng, [
            ("frame", partial(pt.render_frame_body, eng.nerf, cfg),
             dict(geo, progress=torch.tensor(0.7))),
            ("evalcompact", partial(pt.eval_compact_body, eng.nerf, cfg, lp),
             dict(pose=c["pose"], intr=c["intr"], z_near=c["z_near"],
                  z_far=c["z_far"], image_u8=c["image_u8"],
                  mask_u8=c["obj_mask_u8"])),
            ("evalmetrics", partial(pt.eval_metrics_body, cfg, lp),
             dict(rgb_flat=torch.rand(1, HW, 3), opac_flat=torch.rand(1, HW),
                  image=frame["image"], obj_mask=frame["obj_mask"]))]
    jeng, eng = gan
    eng.cfg.kernels = {"st_mega": True} if route == "gan_st_mega" else {}
    eng.cfg.nerf.density_noise_reg = 1 if route == "gan_noisy" else None
    cfg, lp = eng.cfg, eng._ensure_lpips()[0]
    raw = eng.eval_data.raw_hw
    lt, ll = (_t(x) for x in _latents(jeng, 0))
    frame = eng.eval_frame(0)
    geo = dict(pose=frame["pose"], intr=frame["intr"],
               z_near=frame["z_near"], z_far=frame["z_far"], lt=lt, ll=ll,
               obj_mask=frame["obj_mask"])
    idx = _t(tg.masked_ray_indices(frame["obj_mask"].numpy(), CHUNK)[0])
    c = _compact_payload(eng, 0)
    return eng, [
        ("masked", partial(tg.render_masked_body, eng.nerf, cfg),
         dict(geo, idx=idx)),
        ("full", partial(tg.render_full_body, eng.nerf, cfg), geo),
        ("evalcompact", partial(tg.eval_compact_body, eng.nerf, cfg, lp,
                                raw),
         dict(pose=c["pose"], intr=c["intr"], zn=c["z_near_pre"],
              zf=c["z_far_pre"], lt=lt, ll=ll, idx=c["idx"],
              img_sparse_u8=c["image_sparse_u8"])),
        ("evalmetrics", partial(tg.eval_metrics_body, cfg, lp, raw),
         dict(rgb_flat=torch.rand(1, cfg.H * cfg.W, 3),
              image=frame["image"], obj_mask=frame["obj_mask"]))]


@pytest.mark.parametrize("route", ["gan", "gan_st_mega", "gan_noisy",
                                   "pretrain", "pretrain_two_kernel"])
def test_bodies_read_nothing_from_host(gan, pre, route):
    """After one warm call, each frame body of the route (rows 1 + 3, 6f,
    10, 8, 7a + 9a on the card) builds no tensor from host data and reads
    none back, with the field's versions bumped as the capture bumps
    them."""
    from texpose_tpu_torch.models.frame_graph import field_params
    from texpose_tpu_torch.models.step_graph import bump_versions
    eng, units = _audit_engine(route, gan, pre)
    try:
        with torch.inference_mode():
            for name, body, inputs in units:
                body(**inputs)
                bump_versions(field_params(eng))
                assert host_reads(lambda: body(**inputs)) == [], name
    finally:
        eng.cfg.kernels = {}
        eng.cfg.nerf.density_noise_reg = None


class _CaptureFails:
    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    def __exit__(self, *exc):
        return False


def test_capture_failure_raises_without_eager_frames(gan, monkeypatch):
    """With the capture stubbed to fail, evaluate_full raises naming the
    engine and the key; only the warm call ran the body, and no frame was
    written."""
    from texpose_tpu_torch.models import texture_gan as tg
    jeng, teng = gan
    calls = []
    body = tg.eval_compact_body
    monkeypatch.setattr(tg, "eval_compact_body",
                        lambda *a, **k: calls.append(1) or body(*a, **k))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", _CaptureFails)
    runner = teng.frame_runner()
    runner.drop()
    monkeypatch.setattr(runner, "capturable", True)
    out = teng.cfg.render.get("save_path") or os.path.join(
        teng.cfg.output_path, "test_view_last")
    quant = os.path.join(teng.cfg.output_path, "quant.txt")
    for path in [quant] + [os.path.join(out, p) for p in (
            os.listdir(out) if os.path.isdir(out) else ())]:
        if os.path.exists(path):
            os.remove(path)
    with pytest.raises(RuntimeError, match="TextureGANEngine.*'evalcompact'"
                       ".*cannot be captured"):
        teng.evaluate_full()
    assert calls == [1]
    assert not os.path.exists(quant)
    assert not os.path.isdir(out) or os.listdir(out) == []
    monkeypatch.undo()
    runner.drop()
    assert not runner.capturable
