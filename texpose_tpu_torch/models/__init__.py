"""Engines (port of texpose_tpu.models): the geometry pretrain, the
env-lit pretrain and the texture GAN, training and evaluation."""


def get_engine(name):
    """Engine class for a ``model:`` config value."""
    if name == "nerf_pretrain":
        from .pretrain import PretrainEngine
        return PretrainEngine
    if name == "nerf_pretrain_env":
        from .pretrain import PretrainEnvEngine
        return PretrainEnvEngine
    if name == "nerf_adapt_st_gan":
        from .texture_gan import TextureGANEngine
        return TextureGANEngine
    raise KeyError(f"unknown model/engine: {name!r}")
