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
