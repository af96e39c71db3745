"""Port parity, data parallelism (texpose_tpu_torch/parallel/mesh.py and the
engines under ``mesh``), on the CPU: two gloo ranks spawned with a
``file://`` rendezvous under the test's tmp directory.

  * ``_pad_rays`` and ``masked_ray_indices_sharded`` equal JAX's, on the
    adversarial masks of tests/test_parallel.py (padding that wraps the
    shard unit, coverage just under the 0.5 routing threshold, single
    pixels);
  * the three sharded renders equal the port's single-rank renders
    (rtol/atol 2e-5, JAX's tolerance for its sharded renders), and the GAN
    engine's whole-frame render takes the sharded masked and full routes;
  * the pretrain and GAN steps at world size 2 against world size 1 from
    one state and one set of global draws: losses rtol 1e-5, gradients
    1e-4 of each tensor's largest magnitude (only the order of the f32
    sums differs); and against the JAX engine's step with ``mesh.dp`` on
    conftest's faked CPU mesh (2 devices), fed the draws rebuilt from the
    JAX key splits, at the tolerances of test_torch_pretrain_step.py and
    test_torch_train_step.py;
  * the masked losses are the GLOBAL masked means although the two shards
    hold different mask counts (asserted unequal), not the mean of the
    shards' means;
  * parameters, optimizer states, the latent EMA and the spectral-norm
    state stay bit-identical on both ranks over 3 steps;
  * through the CLIs (train, validate, visualize, checkpoints, evaluate)
    rank 1 writes no file;
  * the entry points' worker gate, ``make_mesh``'s refusals, and a worker
    that dies failing the launch with its exit code.
"""

import datetime
import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

WORLD = 2
RENDER_TOL = 2e-5
LOSS_RTOL_1 = 1e-5
GRAD_REL_1 = 1e-4
MASK_CASES = ("wrap", "just_under_half", "single_pixel", "last_pixel")


# ------------------------------------------------------------ the ranks

def _rank_main(rank, world, init, name, args):
    import torch.distributed as dist
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        globals()[name](rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(name, tmp_path, *args, timeout=300):
    """Run ``name(rank, *args)`` in WORLD spawned gloo ranks; a rank's
    error fails the test, and so does the deadline."""
    import torch.multiprocessing as mp
    init = f"file://{tmp_path / 'rendezvous'}"
    ctx = mp.start_processes(_rank_main, args=(WORLD, init, name, args),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{name}: the ranks did not finish in {timeout} s")


def _load(path):
    return torch.load(path, weights_only=False)


def _small_cfg(st):
    """tests/test_parallel.py's small fields, on a 12x20 frame (240 rays:
    the shards pad)."""
    from texpose_tpu_torch.utils.config import Config, process_options
    arch = {"layers_feat": [None, 32, 32, 32], "layers_rgb": [None, 32, 3],
            "skip": [1], "posenc": {"L_3D": 4, "L_view": 2 if st else None},
            "density_activ": "softplus", "tf_init": True}
    nerf = {"view_dep": st, "depth": {"param": "metric", "range": [0, 3],
                                      "scale": 10},
            "sample_intvs": 8, "sample_stratified": False, "rand_rays": 64,
            "density_noise_reg": None, "setbg_opaque": None,
            "mask_obj": True}
    if st:
        arch["layers_trans"] = [None, 32, 5]
        nerf.update(N_latent_trans=8, N_latent_light=12, min_uncert=0.05)
    return process_options(Config({
        "arch": arch, "nerf": nerf, "camera": {"ndc": False},
        "data": {"image_size": [12, 20] if st else [16, 16]},
        "kernels": {"fused_trunk": False}}))


def _scene(cfg):
    HW = cfg.H * cfg.W
    pose = torch.cat([torch.eye(3), torch.tensor([[0.], [0.], [4.]])],
                     dim=-1)[None]
    f = 20.0
    intr = torch.tensor([[[f, 0, cfg.W / 2], [0, f, cfg.H / 2],
                          [0, 0, 1.0]]])
    return pose, intr, torch.full((1, HW), 2.0), torch.full((1, HW), 6.0)


def _mask(case, HW, unit):
    m = np.zeros((HW,), np.float32)
    if case == "wrap":
        m[3:3 + unit + 1] = 1.0
    elif case == "just_under_half":
        m[:HW // 2 - 1] = 1.0
    elif case == "single_pixel":
        m[HW // 3] = 1.0
    else:
        m[HW - 1] = 1.0
    return m


def render_cases(mesh=None):
    """The renders of every case: sharded with ``mesh``, single-rank
    without → {case: dict of [1,HW,C]}."""
    from texpose_tpu_torch.models import render as R
    from texpose_tpu_torch.nn.fields import init_nerf, init_nerf_st
    from texpose_tpu_torch.parallel import mesh as M
    out = {}
    with torch.no_grad():
        cfg = _small_cfg(False)
        nerf = init_nerf(cfg, torch.Generator().manual_seed(0))
        scene = _scene(cfg)
        out["full_nerf"] = (
            R.render_full_nerf(nerf, cfg, *scene, chunk=32) if mesh is None
            else M.render_full_nerf_sharded(mesh, nerf, cfg, *scene,
                                            chunk=32))
        cfg = _small_cfg(True)
        gen = torch.Generator().manual_seed(1)
        nerf = init_nerf_st(cfg, gen)
        lt = torch.randn((1, 8), generator=gen) * 0.1
        ll = torch.randn((1, 12), generator=gen) * 0.1
        pose, intr, zn, zf = _scene(cfg)
        HW = cfg.H * cfg.W
        half = torch.zeros((1, HW))
        half[:, HW // 4:3 * HW // 4] = 1.0
        for case, obj in (("full_st", None), ("full_st_masked", half)):
            out[case] = (
                R.render_full_nerf_st(nerf, cfg, pose, intr, zn, zf, lt, ll,
                                      chunk=32, obj_mask=obj)
                if mesh is None else M.render_full_nerf_st_sharded(
                    mesh, nerf, cfg, pose, intr, zn, zf, lt, ll, chunk=32,
                    obj_mask=obj))
        chunk = 8
        for case in MASK_CASES:
            m = _mask(case, HW, chunk * WORLD)
            obj = torch.as_tensor(m[None])
            if mesh is None:
                idx_p, _ = R.masked_ray_indices(m, chunk)
                idx = torch.as_tensor(idx_p)
                o = R.render_rays_masked_st_pre(
                    nerf, cfg, pose, intr, idx, zn[:, idx], zf[:, idx], lt,
                    ll, chunk=chunk)
            else:
                idx_p, _ = M.masked_ray_indices_sharded(m, chunk, mesh.size)
                idx = torch.as_tensor(idx_p)
                o = M.render_masked_nerf_st_sharded(
                    mesh, nerf, cfg, pose, intr, zn, zf, lt, ll, idx,
                    chunk=chunk)
            out["masked_" + case] = R.scatter_masked_st(cfg, o, idx, obj)
    return out


def _grads(eng):
    """{keypath: gradient} of every trained leaf."""
    if hasattr(eng, "opt_nerf"):
        out = {path: p.grad.clone()
               for named in eng._adam_params().values()
               for path, p in named}
        out.update({f"disc/{g}/{i}": w.grad.clone()
                    for g, i, w in eng._disc_leaves()})
        return out
    return {path: p.grad.clone() for path, p in eng._all_params()}


def _engine(spec, mesh, device="cpu"):
    """A port engine holding the spec's state (the JAX init) and VGG."""
    from texpose_tpu_torch.models import get_engine
    from texpose_tpu_torch.utils.config import Config
    cfg = Config(spec["cfg"])
    eng = get_engine(cfg.model)(cfg, device, mesh=mesh)
    eng.load_dataset()
    eng.upload_train_split()
    eng.build_networks()
    eng.setup_optimizer()
    eng.load_train_state_flat(spec["flat"])
    if spec.get("vgg") is not None:
        eng.vgg = spec["vgg"]
    return eng


def _rank_step(mesh, spec):
    """One DP step from the spec's state and global draws (the masked
    means' numerators and denominators recorded), then two more on the
    engine's own draws."""
    from texpose_tpu_torch.models import losses
    eng = _engine(spec, mesh)
    ratios, real = [], losses.global_ratio

    def spy(num, den, mesh, eps=0.0):
        ratios.append((float(num), float(den), eps))
        return real(num, den, mesh, eps)

    losses.global_ratio = spy
    try:
        loss = eng.train_step(spec["draws"])
    finally:
        losses.global_ratio = real
    res = {"loss": {k: float(v) for k, v in loss.items()},
           "grads": _grads(eng), "after": eng.train_state_flat(1),
           "ratios": ratios}
    for _ in range(2):
        eng.train_step(eng.make_draws(eng.it))
    res["state3"] = eng.train_state_flat(3)
    return res


def _rank_frames(mesh, spec):
    """The GAN engine's whole-frame render of eval frame 0 under the mesh
    and alone: the masked route (the frame's mask) and the full route (an
    all-object host mask) → max |err| per route."""
    from texpose_tpu_torch.models import texture_gan as T
    from texpose_tpu_torch.utils.config import Config
    err = {}
    engs = []
    for m in (mesh, None):
        eng = T.TextureGANEngine(Config(spec["cfg"]), "cpu", mesh=m)
        eng.load_dataset()
        eng.build_networks()
        engs.append(eng)
    frame = engs[0].eval_frame(0)
    obj = frame["obj_mask"].numpy().reshape(-1)
    if not 0 < float((obj > 0).mean()) < 0.5:
        obj = np.zeros_like(obj)
        obj[:len(obj) // 4] = 1.0
    lt, ll = (engs[0].latents[k][0:1] for k in ("trans", "light"))
    calls = {"masked": 0, "full": 0}
    real = {r: getattr(T, f"render_{r}_nerf_st_sharded") for r in calls}

    def counting(route):
        def fn(*a, **k):
            calls[route] += 1
            return real[route](*a, **k)
        return fn

    with torch.no_grad():
        for route, host in (("masked", obj), ("full", np.ones_like(obj))):
            setattr(T, f"render_{route}_nerf_st_sharded", counting(route))
            try:
                a, b = (e._render_frame_st(frame, lt, ll, obj_host=host)
                        for e in engs)
            finally:
                setattr(T, f"render_{route}_nerf_st_sharded", real[route])
            err[route] = max(float((a[k] - b[k]).abs().max()) for k in b)
    err["coverage"] = float((obj > 0).mean())
    err["calls"] = calls
    return err


def _rank_cli(rank, work, clis):
    """The CLIs under the group, each rank with its own output root."""
    import torch.distributed as dist
    from texpose_tpu_torch import evaluate, train
    out_root = os.path.join(work, f"cli_rank{rank}")
    for yml, train_extra, eval_extra in clis:
        argv = [f"--yaml={yml}", "--device=cpu", "--mesh.dp=true",
                f"--output_root={out_root}"]
        eng = train.main(argv + train_extra)
        ckpt = os.path.join(work, "cli_rank0", str(eng.cfg.group),
                            str(eng.cfg.name), "model.ckpt")
        dist.barrier()               # rank 0's checkpoint is on disk
        evaluate.main(argv + eval_extra + [f"--init_weights={ckpt}"])


def _scenarios(rank, work):
    from texpose_tpu_torch.parallel import (dp_constrain_batch, make_mesh,
                                            replicate, shard_leading_axis)
    mesh = make_mesh(device="cpu")
    batch = {"a": torch.arange(8.).reshape(4, 2), "b": torch.arange(4)}
    mine = torch.full((3,), float(rank))
    res = {"mesh": (mesh.rank, mesh.size, str(mesh.device)),
           "shards": [shard_leading_axis(batch, mesh),
                      dp_constrain_batch(batch, mesh)],
           "replicated": replicate([mine], mesh)[0],
           "renders": render_cases(mesh)}
    for kind in ("pretrain", "gan"):
        res[kind] = _rank_step(mesh, _load(os.path.join(work,
                                                         f"{kind}.pt")))
    res["frames"] = _rank_frames(mesh, _load(os.path.join(work, "gan.pt")))
    _rank_cli(rank, work, _load(os.path.join(work, "cli.pt")))
    torch.save(res, os.path.join(work, f"rank{rank}.pt"))


# ----------------------------------------------------------- the parent

def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _host_flat(state):
    import jax
    from texpose_tpu.utils.checkpoint import tree_to_flat_dict
    st = dict(state)
    st["step"] = np.int32(0)
    return {k: np.array(v) for k, v in
            tree_to_flat_dict(jax.device_get(st)).items()}


def _prepare(kind, root, tmp):
    """The JAX engine's DP step on the faked mesh, the port's one-rank
    step, and the ranks' spec (config, JAX init state, global draws)."""
    import copy
    import jax
    from texpose_tpu.utils.checkpoint import tree_to_flat_dict
    if kind == "pretrain":
        import test_torch_pretrain_step as T
        cfg = T.step_cfg(root, tmp)
        n_draw = None
    else:
        import test_torch_train_step as T
        cfg = T.step_cfg(root, tmp, batch_size=4, **T.BRANCHES["branches"])
    cfg.mesh = {"dp": True, "n_devices": WORLD}
    jeng = T.jax_engine(cfg)
    assert jeng.mesh is not None and jeng.mesh.shape["dp"] == WORLD
    n = len(jeng.train_data)
    if kind == "pretrain":
        _, draws = T.jax_draws(cfg, jeng.state["key"], n)
    else:
        _, draws = T.jax_draws(cfg, jeng.state["key"], n, 0)
    flat = _host_flat(jeng.state)
    spec = {"cfg": copy.deepcopy(cfg).to_dict(), "flat": flat,
            "draws": draws}
    one = _engine(spec, None)
    if kind == "gan":
        from texpose_tpu_torch.nn.vgg import vgg_from_jax
        spec["vgg"] = one.vgg = vgg_from_jax(jeng.vgg_params)
    loss1 = {k: float(v) for k, v in one.train_step(draws).items()}
    state, jloss = jeng.step_fn(jeng.state, jeng.train_batch)
    return spec, {"cfg": cfg, "one_loss": loss1, "one_grads": _grads(one),
                  "jax_loss": {k: float(v) for k, v in jloss.items()},
                  "jax_after": tree_to_flat_dict(
                      jax.tree_util.tree_map(np.array, state))}


def _cli_specs(pre_root, gan_root, work):
    """(yaml, train flags, evaluate flags) of the pretrain and GAN CLIs: 2
    steps with validate, visualize and a checkpoint at step 2."""
    import yaml
    from test_pretrain_e2e import tiny_pretrain_cfg
    from test_texture_gan_e2e import tiny_gan_cfg
    from pathlib import Path
    pre = tiny_pretrain_cfg(pre_root, Path(work))
    pre.data.scene = "scene_all"
    pre.nerf.rand_rays = 64
    pre.nerf.sample_intvs = 16
    gan = tiny_gan_cfg(gan_root, Path(work))
    out = []
    steps = ["--max_iter=2", "--freq.scalar=1", "--freq.vis=2",
             "--freq.val=2", "--freq.ckpt=2"]
    for name, cfg, extra in (("pre", pre, []),
                             ("gan", gan, ["--batch_size=2"])):
        yml = os.path.join(work, f"{name}.yaml")
        with open(yml, "w") as f:
            yaml.safe_dump({k: v for k, v in cfg.to_dict().items()
                            if k not in ("H", "W", "output_path",
                                         "output_root")}, f)
        out.append((yml, steps + extra, []))
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Everything the two ranks computed, beside the one-rank and JAX
    references."""
    from texpose_tpu.data.fixture import generate_fixture
    work = tmp_path_factory.mktemp("dp")
    pre_root = generate_fixture(str(work / "bop_pre"), n_train=4, n_test=2,
                                scene="scene_all", image_scale=0.25,
                                crop_res=32)
    gan_root = generate_fixture(str(work / "bop_gan"), n_train=6, n_test=1,
                                scene="scene_all", image_scale=0.25,
                                crop_res=32)
    ref = {}
    for kind, root in (("pretrain", pre_root), ("gan", gan_root)):
        spec, ref[kind] = _prepare(kind, root, work / kind)
        torch.save(spec, work / f"{kind}.pt")
    torch.save(_cli_specs(pre_root, gan_root, str(work)), work / "cli.pt")
    run_ranks("_scenarios", work, str(work))
    ranks = [_load(work / f"rank{r}.pt") for r in range(WORLD)]
    return {"ref": ref, "ranks": ranks, "work": work,
            "single": render_cases(None)}


def test_ranks_form_one_mesh(dp):
    """make_mesh in an initialized group; each rank's slice of a batch's
    leading axis; replicate broadcasts rank 0's tensor in place."""
    assert [r["mesh"] for r in dp["ranks"]] == [
        (r, WORLD, "cpu") for r in range(WORLD)]
    for rank, res in enumerate(dp["ranks"]):
        for shard in res["shards"]:
            np.testing.assert_array_equal(
                shard["a"], np.arange(8.).reshape(4, 2)[2 * rank:2 * rank + 2])
            np.testing.assert_array_equal(shard["b"],
                                          [2 * rank, 2 * rank + 1])
        np.testing.assert_array_equal(res["replicated"], [0.0] * 3)


def test_pad_rays_matches_jax():
    from texpose_tpu.parallel.mesh import _pad_rays as jax_pad
    from texpose_tpu_torch.parallel.mesh import _pad_rays
    for HW in (1, 7, 240, 256, 307200):
        for n in (1, 2, 3, 8):
            for chunk in (1, 8, 2048):
                assert _pad_rays(HW, n, chunk) == jax_pad(HW, n, chunk)


@pytest.mark.parametrize("case", MASK_CASES)
def test_masked_ray_indices_sharded_equals_jax(case):
    from texpose_tpu.parallel import masked_ray_indices_sharded as jax_idx
    from texpose_tpu_torch.parallel import masked_ray_indices_sharded
    HW = 256
    for n, chunk in ((2, 8), (8, 8), (2, 2048)):
        m = _mask(case, HW, chunk * n)
        idx, n_valid = masked_ray_indices_sharded(m, chunk, n)
        jidx, jn = jax_idx(m, chunk, n)
        assert n_valid == jn
        assert len(idx) % (chunk * n) == 0
        np.testing.assert_array_equal(idx, np.asarray(jidx))


@pytest.mark.parametrize("case", ["full_nerf", "full_st", "full_st_masked"]
                         + ["masked_" + c for c in MASK_CASES])
def test_sharded_render_matches_single_rank(dp, case):
    single = dp["single"][case]
    for rank in dp["ranks"]:
        out = rank["renders"][case]
        assert set(out) == set(single)
        for k in single:
            assert out[k].shape == single[k].shape, k
            np.testing.assert_allclose(out[k].numpy(), single[k].numpy(),
                                       rtol=RENDER_TOL, atol=RENDER_TOL,
                                       err_msg=f"{case}: {k}")


@pytest.mark.parametrize("route", ["masked", "full"])
def test_gan_engine_frame_routes_under_dp(dp, route):
    """The GAN engine's whole-frame render takes the sharded masked route
    for coverage in (0, 0.5) and the sharded full route otherwise, and
    equals the single-rank engine's."""
    for rank in dp["ranks"]:
        assert 0 < rank["frames"]["coverage"] < 0.5
        assert rank["frames"]["calls"] == {"masked": 1, "full": 1}
        assert rank["frames"][route] <= RENDER_TOL


@pytest.mark.parametrize("kind", ["pretrain", "gan"])
def test_dp_step_matches_one_rank(dp, kind):
    ref = dp["ref"][kind]
    for rank in dp["ranks"]:
        res = rank[kind]
        assert sorted(res["loss"]) == sorted(ref["one_loss"])
        for k, v in ref["one_loss"].items():
            np.testing.assert_allclose(res["loss"][k], v, rtol=LOSS_RTOL_1,
                                       err_msg=k)
        assert sorted(res["grads"]) == sorted(ref["one_grads"])
        for k, g in ref["one_grads"].items():
            assert _rel(res["grads"][k].numpy(), g.numpy()) <= GRAD_REL_1, k


@pytest.mark.parametrize("kind", ["pretrain", "gan"])
def test_dp_step_matches_jax_dp_step(dp, kind):
    """The 2-rank step against the JAX engine's step on a 2-device mesh:
    losses rtol 1e-4, gradients (JAX's from its first Adam moment, and
    RMSprop's ν for D) 2e-3 of the largest magnitude, updated parameters
    atol 2·lr (20·lr_D for D), spectral-norm vectors 1e-5."""
    ref = dp["ref"][kind]
    cfg, after = ref["cfg"], ref["jax_after"]
    lr = cfg.optim.lr
    res = dp["ranks"][0][kind]
    for k, v in ref["jax_loss"].items():
        np.testing.assert_allclose(res["loss"][k], v, rtol=1e-4, err_msg=k)
    if kind == "pretrain":
        mu = {k[len("opt_state/0/mu/"):]: v for k, v in after.items()
              if k.startswith("opt_state/0/mu/")}
        for path, g in res["grads"].items():
            assert _rel(g.numpy(), mu[path] / 0.1) <= 2e-3, path
    else:
        from texpose_tpu_torch.utils.checkpoint import adam_keys
        keys = adam_keys(cfg.optim.get("lr_latent"))
        mus = [m for _, m, _, _ in keys.values()]
        for path, g in res["grads"].items():
            if path.startswith("disc/"):
                nu = after[f"opt_disc/0/nu/{path[5:]}/w"]
                assert _rel(g.numpy() ** 2, nu / 0.01) <= 4e-3, path
            else:
                jg = next(after[m + path] for m in mus if m + path in after)
                assert _rel(g.numpy(), jg / 0.1) <= 2e-3, path
    flat = res["after"]
    assert sorted(flat) == sorted(list(after) + ["step"])
    for k, v in after.items():
        if k.startswith(("params/nerf/mlp_rgb", "params/nerf/mlp_trans",
                         "latents/", "latents_ema/")):
            np.testing.assert_allclose(flat[k], v, rtol=0, atol=2 * lr,
                                       err_msg=k)
        elif k.startswith("params/disc/"):
            np.testing.assert_allclose(flat[k], v, rtol=0,
                                       atol=20 * cfg.optim_disc.lr,
                                       err_msg=k)
        elif k.startswith(("params/nerf/mlp_feat", "sn_state/")):
            if kind == "pretrain":
                np.testing.assert_allclose(flat[k], v, rtol=0, atol=2 * lr,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(flat[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=k)


@pytest.mark.parametrize("kind", ["pretrain", "gan"])
def test_dp_loss_is_the_global_masked_mean(dp, kind):
    """The shards hold different mask counts; each masked loss is
    Σ_ranks num / (Σ_ranks den + ε) — the one-rank loss — and not the mean
    of the shards' own masked means, which differs."""
    r0, r1 = (r[kind]["ratios"] for r in dp["ranks"])
    assert len(r0) == len(r1) > 0
    terms = ["depth", "render"] if kind == "pretrain" else ["render", "lab"]
    assert len(r0) == len(terms)
    lw = dp["ref"][kind]["cfg"].loss_weight
    for name, (n0, d0, eps), (n1, d1, _) in zip(terms, r0, r1):
        assert d0 != d1, (name, d0, d1)
        global_mean = (n0 + n1) / (d0 + d1 + eps)
        shard_means = (n0 / (d0 + eps) + n1 / (d1 + eps)) / 2
        one = dp["ref"][kind]["one_loss"][name]
        np.testing.assert_allclose(global_mean, one, rtol=LOSS_RTOL_1)
        np.testing.assert_allclose(dp["ranks"][0][kind]["loss"][name], one,
                                   rtol=LOSS_RTOL_1)
        # ten times farther from the global mean than the bound it meets
        assert abs(shard_means - one) > 10 * LOSS_RTOL_1 * abs(one), name
        assert lw.get(name) is not None


@pytest.mark.parametrize("kind", ["pretrain", "gan"])
def test_ranks_stay_identical_over_three_steps(dp, kind):
    """Parameters, Adam / RMSprop moments and counts, the latent EMA and
    the spectral-norm state, bit for bit on both ranks after 3 steps."""
    s0, s1 = (r[kind]["state3"] for r in dp["ranks"])
    assert sorted(s0) == sorted(s1)
    if kind == "gan":
        assert any(k.startswith("latents_ema/") for k in s0)
        assert any(k.startswith("sn_state/") for k in s0)
        assert any(k.startswith("opt_disc/") for k in s0)
    assert int(s0["it"]) == 3
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)


def test_rank_one_writes_no_file(dp):
    """The train and evaluate CLIs of both engines under the group, with
    validate, visualize and a checkpoint firing: rank 0 writes every file,
    rank 1 none."""
    work = dp["work"]
    assert not os.path.exists(work / "cli_rank1")
    for name, panels in (("e2e", "000002_rgb.png"),
                         ("gan_e2e", "000002_rgb_static.png")):
        run = work / "cli_rank0" / "test" / name
        files = set(os.listdir(run))
        assert {"model.ckpt", "options.yaml", "metrics.jsonl", "quant.txt",
                "vis"} <= files, files
        assert panels in os.listdir(run / "vis")


@pytest.mark.parametrize("count,dp_set,env,want", [
    (2, True, {}, 2), (1, True, {}, 0), (2, False, {}, 0),
    (2, True, {"WORLD_SIZE": "2"}, 0), (4, True, {"n_devices": 2}, 2)])
def test_worker_count(monkeypatch, count, dp_set, env, want):
    from texpose_tpu_torch.parallel.mesh import worker_count
    from texpose_tpu_torch.utils.config import Config
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    if "WORLD_SIZE" in env:
        monkeypatch.setenv("WORLD_SIZE", env["WORLD_SIZE"])
    cfg = Config({"mesh": {"dp": dp_set,
                           "n_devices": env.get("n_devices")}})
    assert worker_count(cfg) == want
    if want:
        cfg.mesh.n_devices = count + 1
        with pytest.raises(ValueError, match="visible"):
            worker_count(cfg)


def test_make_mesh_refuses_without_a_group_or_a_card(monkeypatch):
    from texpose_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="no visible card"):
        make_mesh(device="cuda")


def main(argv):
    """A worker for test_a_dead_worker_fails_the_launch: rank 1 exits with
    argv[0], rank 0 would wait forever."""
    if os.environ["RANK"] == "1":
        sys.exit(int(argv[0]))
    time.sleep(600)


def test_a_dead_worker_fails_the_launch():
    """launch_workers starts the workers under torchrun's environment; one
    that exits with 3 ends the other and fails the launch with 3."""
    from texpose_tpu_torch.parallel.mesh import launch_workers
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as err:
        launch_workers("test_torch_parallel", ["3"], 2)
    assert err.value.code == 3
    assert time.monotonic() - t0 < 120
