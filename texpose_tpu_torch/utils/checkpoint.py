"""Checkpoint bridge between the JAX package's npz format and the port.

The JAX package saves one .npz of flattened state leaves keyed by their
key path (texpose_tpu/utils/checkpoint.py), e.g.
``params/nerf/mlp_feat/0/w``, ``latents/light``.  A texture model's
``model.ckpt`` also holds optimizer, discriminator and spectral-norm
leaves; evaluation reads only the field and the latent tables:

  params/nerf/{mlp_feat,mlp_rgb,mlp_trans}/<i>/{w,b}
      ↔ nerf.{mlp_feat,mlp_rgb,mlp_trans}.<i>.{w,b}
  latents/{light,trans}, latents_ema/{light,trans}
      ↔ latents.{light,trans}, latents_ema.{light,trans}

Weights keep the JAX [in, out] layout on both sides, so the mapping is a
rename; ``torch_state_to_jax`` is its inverse, so both packages compute the
same thing from one parameter set.

A training run's state adds, under the JAX package's keypaths (the texture
engine maps its torch objects onto them, models/texture_gan.py):

  params/disc/{main,final}/<i>/w     discriminator kernels (HWIO, as JAX)
  sn_state/{main,final}/<i>          spectral-norm power-iteration vectors
  opt_nerf/...                       optax adam: ScaleByAdamState count /
                                     mu / nu over {heads, latents} and the
                                     schedule's count (``adam_keys``)
  opt_disc/0/nu/{main,final}/<i>/w   optax rmsprop's nu (+ opt_disc/1/count
                                     with a D schedule)
  key, it, step                      PRNG key, iteration, checkpoint step
The VGG parameters are not checkpointed by either package: both read the
same torchvision npz (nn/vgg.py).

A pretrain run's state (models/pretrain.py maps its field and torch Adam
onto it; ``pretrain_opt_keys``):

  params/nerf/{mlp_feat,mlp_rgb}/<i>/{w,b}   the coarse field
  opt_state/0/{count,mu/nerf/...,nu/nerf/...} optax adam's ScaleByAdamState
  opt_state/1/count                  the schedule's count (only with a
                                     schedule: optim.sched.gamma or lr_end)
  key, it, step
Its trunk leaves are what ``--resume_pretrain`` reads from the group's
pretrain_model.ckpt.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_JAX_KEY = re.compile(
    r"^(?:params/(nerf/mlp_(?:feat|rgb|trans)/\d+/[wb])"
    r"|(latents(?:_ema)?/(?:light|trans)))$")


def load_checkpoint_flat(fname):
    """npz → {keypath: np.ndarray} (no pickles)."""
    with np.load(fname, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def save_checkpoint_flat(fname, flat):
    with open(fname, "wb") as f:
        np.savez(f, **flat)
    return fname


def jax_state_to_torch(flat):
    """The eval leaves of a JAX flat state → {state_dict key: tensor}.
    Every other leaf (optimizer, discriminator, sn_state, step, …) is
    ignored."""
    out = {}
    for key, arr in flat.items():
        m = _JAX_KEY.match(key)
        if m:
            out[(m.group(1) or m.group(2)).replace("/", ".")] = \
                torch.from_numpy(np.asarray(arr, np.float32).copy())
    return out


def torch_state_to_jax(state):
    """Inverse of jax_state_to_torch: {state_dict key: tensor} → JAX flat
    keypaths with numpy values."""
    out = {}
    for key, t in state.items():
        path = key.replace(".", "/")
        if path.startswith("nerf/"):
            path = "params/" + path
        out[path] = t.detach().cpu().numpy()
    return out


def adam_keys(lr_latent):
    """The optax keypaths of the generator's Adam state → {group: (adam
    count key, mu prefix, nu prefix, schedule count key)}.  One group
    ("all", the parameter tree {heads, latents}) for optax.adam; with
    optim.lr_latent, multi_transform's "heads" and "latents" groups."""
    if not lr_latent:
        return {"all": ("opt_nerf/0/count", "opt_nerf/0/mu/",
                        "opt_nerf/0/nu/", "opt_nerf/1/count")}
    out = {}
    for grp in ("heads", "latents"):
        base = f"opt_nerf/inner_states/{grp}/inner_state/"
        out[grp] = (base + "0/count", base + "0/mu/", base + "0/nu/",
                    base + "1/count")
    return out


def pretrain_opt_keys(has_schedule):
    """The optax keypaths of the pretrain's Adam state → (count key, mu
    prefix, nu prefix, schedule count key or None)."""
    return ("opt_state/0/count", "opt_state/0/mu/nerf/",
            "opt_state/0/nu/nerf/",
            "opt_state/1/count" if has_schedule else None)


def jax_key(seed):
    """jax.random.PRNGKey(seed)'s raw uint32[2] for 0 ≤ seed < 2**32."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)
