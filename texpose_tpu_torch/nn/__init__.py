"""Networks (port of texpose_tpu.nn).  The fields are ``nn.Module``s
(``init_nerf``, ``init_nerf_st`` and ``init_trunk`` build them from a
seeded generator); ``apply_*`` take the module where JAX's take a
parameter tree.

The public names resolve at first access: the kernels import ``nn.mlp``,
and ``nn.fields`` imports the kernels, so importing every submodule here
would be circular."""

import importlib

_EXPORTS = {
    "init": ("xavier_uniform", "dense_init", "conv_init"),
    "mlp": ("dense", "relu", "leaky_relu", "softplus",
            "DENSITY_ACTIVATIONS"),
    "fields": ("get_layer_dims", "init_nerf", "apply_nerf",
               "forward_samples_nerf", "init_nerf_st", "apply_nerf_st",
               "forward_samples_nerf_st", "init_trunk", "apply_trunk"),
    "discriminator": ("init_discriminator", "apply_discriminator",
                      "sn_apply", "instance_norm", "sn_normalize_disc"),
    "vgg": ("init_vgg19", "load_vgg19_npz", "vgg19_features",
            "perceptual_loss", "perceptual_loss_pairs"),
    "lpips": ("init_lpips", "load_lpips_npz", "lpips_distance"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f".{_MODULE_OF[name]}", __name__),
                   name)
