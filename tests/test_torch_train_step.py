"""Port parity, the texture-GAN training step: texpose_tpu_torch's
``train_step`` against the JAX engine's jitted step, from one state (the
JAX init carried over by the checkpoint bridge, VGG included) and one set
of random draws (made with the JAX step's own key splits and handed to the
port).  The JAX step runs plain and with its Pallas kernels in interpret
mode (TEXPOSE_FUSED_INTERPRET=1); the port runs its kernel route, whose
CPU side is the kernels' plain twins.  Float32 compute throughout.

Tolerances:
  * losses: rtol 1e-4 — only the order of f32 sums differs;
  * gradients: JAX's are read off its first Adam moment (mu = 0.1·g) and
    the RMSprop ν (= 0.01·g², so D is compared through g²); heads,
    latents and D agree to 2e-3 of each tensor's largest magnitude (the
    kernel route splits the heads' layer 0 into feat/enc⊕pts/latent-row
    products, the plain route concatenates, so sums run in other orders,
    and a summation-order sign flip at a ReLU boundary moves one term);
  * updated parameters: Adam's first step moves every element by ≈ ±lr
    whatever |g|, so an element whose g is near zero can move the other
    way: atol 2·lr for the heads and latents; RMSprop's first step moves
    by ≈ ±lr_D/√(1−0.99) = ±10·lr_D: atol 20·lr_D for D;
  * spectral-norm vectors: 1e-5.
Three chained steps agree in every loss to rtol 2e-2: after the first
Adam step the states differ by up to 2·lr per element.
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

from texpose_tpu.data.fixture import generate_fixture
from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from test_texture_gan_e2e import tiny_gan_cfg

LOSS_RTOL = 1e-4
GRAD_REL = 2e-3
CHAIN_RTOL = 2e-2


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")), n_train=6,
                            n_test=1, scene="scene_all", image_scale=0.25,
                            crop_res=32)


def step_cfg(root, tmp_path, **over):
    """The e2e test's tiny config, cut to 2 patches x 16 samples (R·N =
    4096 keeps the JAX kernels' layout contract)."""
    cfg = tiny_gan_cfg(root, tmp_path)
    cfg.batch_size = 2
    for k, v in over.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    return cfg


def jax_engine(cfg):
    from texpose_tpu.models.texture_gan import TextureGANEngine
    eng = TextureGANEngine(cfg)
    eng.load_dataset()
    eng.build_networks()
    eng.setup_optimizer()
    return eng


def port_engine(cfg, jeng):
    """The port's engine holding the JAX engine's state and VGG."""
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    from texpose_tpu_torch.nn.vgg import vgg_from_jax
    eng = TextureGANEngine(copy.deepcopy(cfg), "cpu")
    eng.load_dataset()
    eng.upload_train_split()
    eng.build_networks()
    eng.setup_optimizer()
    st = dict(jeng.state)
    st["step"] = np.int32(0)
    eng.load_train_state_flat(tree_to_flat_dict(st))
    eng.vgg = vgg_from_jax(jeng.vgg_params)
    return eng


def jax_draws(cfg, key, n_train, it):
    """Step ``it``'s draws as the JAX step makes them from state['key']
    (texture_gan.py step(), patch.py, render.py) → (next key, draws)."""
    B = int(cfg.batch_size)
    R = int(cfg.patch_size) ** 2
    N = int(cfg.nerf.sample_intvs)
    key, k_batch, k_patch, k_render, k_gp = jax.random.split(key, 5)
    idx = jax.random.choice(k_batch, n_train, (B,), replace=B > n_train)
    k_scale, k_h, k_w = jax.random.split(k_patch, 3)
    patch = np.stack([np.asarray(jax.random.uniform(k, (B, 1, 1, 1)))
                      for k in (k_scale, k_h, k_w)])
    k_depth, k_density = jax.random.split(k_render)
    draws = {
        "idx": torch.as_tensor(np.asarray(idx), dtype=torch.long),
        "patch": torch.as_tensor(patch),
        "depth": torch.as_tensor(np.asarray(jax.random.uniform(
            k_depth, (B, R, N, 1)))),
        "density_noise": torch.as_tensor(np.asarray(jax.random.normal(
            k_density, (B, R, N)))),
        "gp_eps": torch.as_tensor(np.asarray(jax.random.uniform(
            k_gp, (B, 1, 1, 1))))}
    return key, draws


def _host(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _run_one(cfg, monkeypatch, interpret):
    if interpret:
        monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    else:
        monkeypatch.delenv("TEXPOSE_FUSED_INTERPRET", raising=False)
    jeng = jax_engine(cfg)
    peng = port_engine(cfg, jeng)
    before = _host(jeng.state)
    _, draws = jax_draws(cfg, jeng.state["key"], len(jeng.train_data), 0)
    state, jloss = jeng.step_fn(jeng.state, jeng.train_batch)
    ploss = peng.train_step(draws)
    return jeng, peng, before, _host(state), jloss, ploss


BRANCHES = {
    # every optional generator term, R1 on the fake half, the latent EMA
    # and a separate latent learning rate (optax multi_transform state)
    "branches": {"loss_weight.latent_reg": -2,
                 "loss_weight.latent_nbr_reg": -2, "loss_weight.lab": -1,
                 "loss_weight.mask": -1, "loss_weight.gan_reg_fake": 0,
                 "render.latent_ema": 0.9, "optim.lr_latent": 3e-4},
    "wgan_gp": {"gan.type": "wgan", "loss_weight.gan_gp": 1,
                "loss_weight.gan_reg_real": None},
}


@pytest.mark.parametrize("interpret,variant", [
    (False, None), (True, None), (False, "branches"), (False, "wgan_gp")],
    ids=["jax_plain", "jax_interpret", "jax_plain_branches",
         "jax_plain_wgan_gp"])
def test_one_step_matches_jax(root, tmp_path, monkeypatch, interpret,
                              variant):
    from texpose_tpu_torch.utils.checkpoint import adam_keys
    cfg = step_cfg(root, tmp_path, **BRANCHES.get(variant, {}))
    jeng, peng, before, after, jloss, ploss = _run_one(cfg, monkeypatch,
                                                       interpret)
    # losses, G and D
    assert sorted(jloss) == sorted(ploss)
    for k in jloss:
        np.testing.assert_allclose(float(ploss[k]), float(jloss[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    # generator gradients: JAX mu = 0.1·g after the first Adam step
    jflat = tree_to_flat_dict(after)
    keys = adam_keys(cfg.optim.get("lr_latent"))
    for (grp, named), (_, mu, _, _) in zip(peng._adam_params().items(),
                                           keys.values()):
        for path, p in named:
            g_jax = jflat[mu + path] / 0.1
            assert _rel(p.grad.numpy(), g_jax) <= GRAD_REL, path
    # discriminator gradients through RMSprop's ν = 0.01·g²
    nu = tree_to_flat_dict(after["opt_disc"][0].nu)
    for grp, i, w in peng._disc_leaves():
        g2 = w.grad.numpy() ** 2
        assert _rel(g2, nu[f"{grp}/{i}/w"] / 0.01) <= 2 * GRAD_REL, (grp, i)
    # updated parameters and spectral-norm state
    lr, lr_d = cfg.optim.lr, cfg.optim_disc.lr
    flat = peng.train_state_flat(1)
    assert sorted(flat) == sorted(list(jflat) + ["step"])
    for k, v in jflat.items():
        if k.startswith(("params/nerf/mlp_rgb", "params/nerf/mlp_trans",
                         "latents/", "latents_ema/")):
            np.testing.assert_allclose(flat[k], v, rtol=0, atol=2 * lr,
                                       err_msg=k)
        elif k.startswith("params/disc/"):
            np.testing.assert_allclose(flat[k], v, rtol=0, atol=20 * lr_d,
                                       err_msg=k)
        elif k.startswith(("params/nerf/mlp_feat", "sn_state/")):
            np.testing.assert_allclose(flat[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    # the trunk did not move
    bflat = tree_to_flat_dict(before)
    for k in bflat:
        if k.startswith("params/nerf/mlp_feat"):
            np.testing.assert_array_equal(jflat[k], bflat[k])
            np.testing.assert_array_equal(flat[k], bflat[k])


def test_three_chained_steps_match_jax(root, tmp_path, monkeypatch):
    monkeypatch.delenv("TEXPOSE_FUSED_INTERPRET", raising=False)
    cfg = step_cfg(root, tmp_path)
    jeng = jax_engine(cfg)
    peng = port_engine(cfg, jeng)
    key = jeng.state["key"]
    state = jeng.state
    for it in range(3):
        key, draws = jax_draws(cfg, key, len(jeng.train_data), it)
        state, jloss = jeng.step_fn(state, jeng.train_batch)
        ploss = peng.train_step(draws)
        for k in jloss:
            np.testing.assert_allclose(float(ploss[k]), float(jloss[k]),
                                       rtol=CHAIN_RTOL,
                                       err_msg=f"step {it}: {k}")
    assert peng.it == int(state["it"]) == 3


def test_density_noise_takes_plain_route_and_matches_jax(root, tmp_path):
    """With nerf.density_noise_reg set, the port's render gate refuses the
    kernel route (as the JAX gate does) and the plain trunk adds
    density_noise_reg × the same standard-normal draw before the
    softplus."""
    from texpose_tpu.nn import fields as jfields
    from texpose_tpu_torch.nn import fields as tfields
    from test_torch_field import _bridge
    cfg = step_cfg(root, tmp_path)
    nerf = tfields.init_nerf_st(cfg)
    assert tfields.use_fused_render(cfg, nerf)
    cfg.nerf.density_noise_reg = 0.7
    assert not tfields.use_fused_render(cfg, nerf)

    jparams = jfields.init_nerf_st(jax.random.PRNGKey(3), cfg)
    tnerf = _bridge(jparams, cfg)
    rng = np.random.default_rng(5)
    enc = rng.normal(size=(2, 4, 8, 3 + 6 * cfg.arch.posenc.L_3D)
                     ).astype(np.float32)
    k = jax.random.PRNGKey(11)
    feat_j, dens_j = jfields.apply_trunk(jparams["mlp_feat"], cfg,
                                         jnp.asarray(enc), mode="train",
                                         density_key=k)
    noise = np.asarray(jax.random.normal(k, dens_j.shape, dens_j.dtype))
    with torch.no_grad():
        feat_t, dens_t = tfields.apply_trunk(tnerf.mlp_feat, cfg,
                                             torch.from_numpy(enc),
                                             density_noise=torch.from_numpy(
                                                 noise))
        _, dens_clean = tfields.apply_trunk(tnerf.mlp_feat, cfg,
                                            torch.from_numpy(enc))
    np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j),
                               rtol=1e-5, atol=1e-6)
    assert float((dens_t - dens_clean).abs().max()) > 1e-2


def test_density_noise_step_matches_jax(root, tmp_path, monkeypatch):
    """The whole step with the density noise on: both packages take the
    plain route with the same noise draw."""
    cfg = step_cfg(root, tmp_path, **{"nerf.density_noise_reg": 0.5})
    _, _, _, _, jloss, ploss = _run_one(cfg, monkeypatch, False)
    for k in jloss:
        np.testing.assert_allclose(float(ploss[k]), float(jloss[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
