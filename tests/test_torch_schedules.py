"""F7 (a): the learning rates over the whole horizon.  For the ``base``
GAN config of tools/gan_ablate.py (64 views, 20k steps), its ``latlr``
(a latent-table group) and ``dlr`` (a discriminator staircase) variants
and the shipped configs/nerf_lm_adapt_gan.yaml, each engine is built from
its own tool's config on the 64-view fixture, so each derives
steps_per_epoch and max_iter itself.  At every step 0 … max_iter − 1 the
rate the port's ``train_step`` reads for each parameter group (its
``lr_table`` entry at the device count ``it``) equals, to rtol 1e-6, the value of JAX's optax
schedule (texpose_tpu/models/optim.py) at that optimizer's own count,
the number of its updates so far (one a step).  After
``load_train_state_flat`` of a 10k-step snapshot (JAX's, and the port's
own as tools/probe_f6.py's route swap loads it) the port steps on at the
count JAX's state holds.

optax evaluates exponential_decay in float32: the float32 rate's rounding
raised to ~2500 epochs parts from a float64 product by ~4e-5 of the rate,
so the port computes its schedules as optax does
(``texpose_tpu_torch.models.optim._exp_decay``)."""

import importlib.util
import os
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
# narrow networks: the schedules read only optim, optim_disc, batch_size,
# max_iter / max_epoch and the train split's size
NARROW = {"arch.layers_feat": [None, 32, 32, 32],
          "arch.layers_rgb": [None, 32, 3],
          "arch.layers_trans": [None, 32, 5], "arch.skip": [1],
          "arch.posenc.L_3D": 4, "nerf.sample_intvs": 8,
          "data.image_size": [32, 32], "compute_dtype": "float32"}
SNAPSHOT = 10000
# the shipped yaml on the fixture's scene (max_iter left null: the engines
# derive it from max_epoch)
ON_FIXTURE = {"data.scene": "scene_qual",
              "nerf.depth.box_source": "pred_box_init_calib"}


def _jax_tool(name):
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def _jax_cfg(monkeypatch, what, cache):
    """The config JAX's tool builds for ``what`` (a variant of
    tools/gan_ablate.py, or "shipped": tools/tpu_quality_check.py's
    ``_base`` of the yaml), narrowed."""
    import texpose_tpu.models.texture_gan as jt
    from texpose_tpu.utils.config import process_options
    jga = _jax_tool("gan_ablate")
    if what == "shipped":
        cfg = jga._base("nerf_lm_adapt_gan.yaml", cache)
    else:
        class Stub:
            def __init__(self, cfg, *a, **k):
                raise _Captured(cfg)
        monkeypatch.setattr(jt, "TextureGANEngine", Stub)
        with pytest.raises(_Captured) as got:
            jga.run_variant(cache, what, jga.VARIANTS[what], 20000,
                            [2000, 10000, 20000])
        monkeypatch.undo()
        cfg = got.value.args[0]
    over = dict(NARROW, **(ON_FIXTURE if what == "shipped" else {}))
    for k, v in over.items():
        jga._set_dotted(cfg, k, v)
    return process_options(cfg)


def _port_cfg(what, cache):
    from texpose_tpu_torch.tools import gan_ablate as ga
    from texpose_tpu_torch.tools import quality_check as qc
    over = dict(NARROW, **(ON_FIXTURE if what == "shipped" else {}))
    extra = [f"--{k}={v}".replace("None", "null").replace(" ", "")
             for k, v in over.items()]
    if what == "shipped":
        return qc.finish(qc.base("nerf_lm_adapt_gan.yaml", cache), extra)
    return ga.variant_cfg(cache, what, ga.VARIANTS[what], 20000, 0,
                          ga.out_root(True, 64), extra)


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    from texpose_tpu_torch.tools import quality_check as qc
    tmp = tmp_path_factory.mktemp("sched")
    mp = pytest.MonkeyPatch()
    mp.setattr(tempfile, "tempdir", str(tmp))
    mp.setitem(qc.FIXTURE, "image_scale", 0.25)
    mp.setitem(qc.FIXTURE, "crop_res", 32)
    try:
        yield qc.fixture(64, True)
    finally:
        mp.undo()


def _engines(monkeypatch, what, cache):
    """(JAX engine with its train split, port engine set up for
    training) of ``what``."""
    from texpose_tpu.models.texture_gan import TextureGANEngine as J
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine as T
    from texpose_tpu_torch.tools import quality_check as qc
    jeng = J(_jax_cfg(monkeypatch, what, cache))
    jeng.load_dataset()
    return jeng, qc.start(T, _port_cfg(what, cache), "cpu")


def _jax_schedules(jeng):
    """{port group: optax schedule value at each count 0 … max_iter − 1}
    from texpose_tpu/models/optim.py's functions, with max_iter and
    steps_per_epoch as the JAX engine's ``max_iter`` and
    ``setup_optimizer`` (texpose_tpu/models/texture_gan.py:217-227)
    derive them."""
    import jax
    import jax.numpy as jnp
    from texpose_tpu.models import optim as jo
    cfg = jeng.cfg
    max_iter = jeng.max_iter()
    spe = max(len(jeng.train_data) // cfg.batch_size, 1)
    counts = jnp.arange(max_iter, dtype=jnp.int32)

    def values(sched):
        if not callable(sched):
            return np.full(max_iter, float(sched))
        return np.asarray(jax.jit(jax.vmap(sched))(counts), np.float64)

    gen = values(jo.generator_schedule(cfg, max_iter, spe))
    out = {"disc": values(jo.disc_schedule(cfg, max_iter, spe))}
    if cfg.optim.get("lr_latent"):
        out["heads"] = gen
        out["latents"] = values(jo.latent_schedule(cfg, max_iter, spe))
    else:
        out["all"] = gen
    return out, max_iter, spe


def _port_rates(peng, its):
    """{group: the rate train_step reads at each step in ``its``}."""
    its = list(its)
    out = {g: pg["lr_table"].numpy()[its].astype(np.float64)
           for g, pg in zip(peng._adam_params(), peng.opt_nerf.param_groups)}
    out["disc"] = peng.opt_disc.param_groups[0]["lr_table"].numpy()[
        its].astype(np.float64)
    return out


CONFIGS = ("base", "latlr", "dlr", "shipped")


@pytest.mark.parametrize("what", CONFIGS)
def test_rates_match_optax_over_the_horizon(what, tmp_root, monkeypatch):
    jeng, peng = _engines(monkeypatch, what, tmp_root)
    want, max_iter, spe = _jax_schedules(jeng)
    assert peng.max_iter() == max_iter
    assert spe == 64 // int(peng.cfg.batch_size)
    if what != "shipped":
        assert max_iter == 20000
    got = _port_rates(peng, range(max_iter))
    assert sorted(got) == sorted(want)
    for g in want:
        np.testing.assert_allclose(got[g], want[g], rtol=RTOL, atol=0,
                                   err_msg=f"{what}: {g}")
    # the staircase decays: a rate that stood still would match a
    # constant reference too
    decaying = {"latlr": "latents", "dlr": "disc"}.get(what, "all")
    assert want[decaying][-1] < 0.5 * want[decaying][0]


@pytest.mark.parametrize("what", ("base", "latlr"))
def test_snapshot_load_keeps_the_count(what, tmp_root, monkeypatch):
    """A train state at 10k steps under JAX's keypaths (the optimizers'
    counts and ``it`` at 10k) loaded into the port; then the port's own 10k
    snapshot loaded into a fresh engine, as tools/probe_f6.py's route swap
    does: both step on at count 10k, at JAX's rate there, with Adam's
    count (its bias correction) at 10k."""
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine as T
    from texpose_tpu_torch.tools import quality_check as qc
    from texpose_tpu_torch.utils.checkpoint import adam_keys
    jeng, peng = _engines(monkeypatch, what, tmp_root)
    want, _, _ = _jax_schedules(jeng)
    flat = peng.train_state_flat(SNAPSHOT)
    keys = adam_keys(peng.cfg.optim.get("lr_latent"))
    for count_key, _, _, sched_key in keys.values():
        flat[count_key] = flat[sched_key] = np.int32(SNAPSHOT)
    flat["it"] = np.int32(SNAPSHOT)
    assert peng.load_train_state_flat(flat) == SNAPSHOT
    fresh = qc.start(T, _port_cfg(what, tmp_root), "cpu")
    assert fresh.load_train_state_flat(peng.train_state_flat(SNAPSHOT)) \
        == SNAPSHOT
    for eng in (peng, fresh):
        assert eng.it == SNAPSHOT
        steps = {float(st["step"]) for st in eng.opt_nerf.state.values()}
        assert steps == {float(SNAPSHOT)}
        got = _port_rates(eng, [eng.it])
        for g in want:
            np.testing.assert_allclose(got[g][0], want[g][SNAPSHOT],
                                       rtol=RTOL, atol=0, err_msg=g)
    back = fresh.train_state_flat(SNAPSHOT)
    for count_key, _, _, sched_key in keys.values():
        assert int(back[count_key]) == int(back[sched_key]) == SNAPSHOT
