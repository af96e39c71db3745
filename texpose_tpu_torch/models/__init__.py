"""Engines (port of texpose_tpu.models: the texture model's evaluation)."""


def get_engine(name):
    """Engine class for a ``model:`` config value."""
    if name == "nerf_adapt_st_gan":
        from .texture_gan import TextureGANEngine
        return TextureGANEngine
    if name in ("nerf_pretrain", "nerf_pretrain_env"):
        raise NotImplementedError(
            f"model {name!r} is not ported to texpose_tpu_torch yet "
            f"(the pretrain engines are a later slice of the port)")
    raise KeyError(f"unknown model/engine: {name!r}")
