"""Weight initializers (port of texpose_tpu/nn/init.py): TF-style Xavier
uniform with ReLU gain √2 for hidden layers, gain 1 for output layers, and
the split 'first' mode for the trunk's last layer (density unit gain 1,
feature units gain √2).  Biases are zero.  ``conv_init`` draws an HWIO
conv kernel as the JAX package's does.  Weights are stored [in, out]
like the JAX package, so the checkpoint bridge copies them unchanged.

Draws come from an explicit ``torch.Generator``; they differ from
``jax.random``'s, so parity with the JAX package goes through the
checkpoint bridge (utils/checkpoint.py), never through the seed.
"""

from __future__ import annotations

import math

import torch

RELU_GAIN = math.sqrt(2.0)


def xavier_uniform(generator, in_dim, out_dim, gain=1.0):
    bound = gain * math.sqrt(6.0 / (in_dim + out_dim))
    u = torch.rand((in_dim, out_dim), generator=generator,
                   dtype=torch.float32)
    return (2.0 * u - 1.0) * bound


def dense_init(generator, in_dim, out_dim, out_mode=None):
    """(w [in,out], b [out]).  out_mode: None → hidden (gain √2); 'all' →
    output (gain 1); 'first' → first output unit gain 1, rest gain √2."""
    if out_mode is None:
        w = xavier_uniform(generator, in_dim, out_dim, RELU_GAIN)
    elif out_mode == "all":
        w = xavier_uniform(generator, in_dim, out_dim, 1.0)
    elif out_mode == "first":
        w = torch.cat([xavier_uniform(generator, in_dim, 1, 1.0),
                       xavier_uniform(generator, in_dim, out_dim - 1,
                                      RELU_GAIN)], dim=1)
    else:
        raise ValueError(out_mode)
    return w, torch.zeros((out_dim,), dtype=torch.float32)


def conv_init(generator, kh, kw, in_ch, out_ch, gain=None):
    """{"w": [kh,kw,in,out]} (HWIO): N(0, 0.02) when gain is None, else
    uniform in ±gain·√(6/(fan_in + fan_out)) with fan = kh·kw·channels."""
    shape = (kh, kw, in_ch, out_ch)
    if gain is None:
        w = torch.randn(shape, generator=generator, dtype=torch.float32) \
            * 0.02
    else:
        bound = gain * math.sqrt(6.0 / (kh * kw * (in_ch + out_ch)))
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        w = (2.0 * u - 1.0) * bound
    return {"w": w}
