"""The benchmark's weights, made on the device from the seed in a few large
draws, in float32 (the type the port keeps its parameters in).

The shapes follow from the configuration's widths alone; the
distributions are those the port's initialisers draw from (TF-style
Xavier uniform with ReLU gain on the hidden Dense layers, gain 1 on the
output layers and on the trunk's density unit, N(0, 1) latent tables,
N(0, 0.02) discriminator kernels, He-normal VGG19 and AlexNet filters,
zero biases).  The program and the reference are handed the same tensors.
Keys: ``trunk.<i>.w|b``, ``rgb.<i>.w|b``, ``trans.<i>.w|b`` (w [in, out]),
``latent.trans|light``, ``disc.main|final.<i>`` (HWIO), ``vgg.<i>.w|b``
(OIHW), ``lpips.<i>.w|b``, ``lpips.lin.<i>``.
"""

from __future__ import annotations

import math

import torch

RELU_GAIN = math.sqrt(2.0)
VGG19_CONVS = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
               (256, 256), (256, 256)]
ALEX_CONVS = [(11, 3, 64), (5, 64, 192), (3, 192, 384), (3, 384, 256),
              (3, 256, 256)]


def field_dims(cfg):
    """{"trunk"|"rgb"|"trans": [(in, out, mode)]}: the Dense layers of the
    configuration's field; mode None (hidden), "all" (output), "first"
    (the trunk's last layer: the density unit at gain 1)."""
    arch, nerf = cfg["arch"], cfg["nerf"]
    L3 = arch["posenc"]["L_3D"]
    in3d = 3 + 6 * L3
    feat = arch["layers_feat"]
    trunk = []
    for li, (k_in, k_out) in enumerate(zip(feat[:-1], feat[1:])):
        k_in = in3d if li == 0 else k_in
        if li in arch["skip"]:
            k_in += in3d
        last = li == len(feat) - 2
        trunk.append((k_in, k_out + (1 if last else 0),
                      "first" if last and arch["tf_init"] else None))
    out = {"trunk": trunk}
    last_mode = "all" if arch["tf_init"] else None
    view = 3 + 6 * arch["posenc"]["L_view"] if nerf.get("view_dep") else 0
    heads = {"rgb": (arch["layers_rgb"], feat[-1] + view + 3
                     + (nerf.get("N_latent_light") or 0))}
    if arch.get("layers_trans"):
        heads["trans"] = (arch["layers_trans"],
                          feat[-1] + nerf["N_latent_trans"])
    for name, (layers, first_in) in heads.items():
        dims = list(zip(layers[:-1], layers[1:]))
        out[name] = [(first_in if li == 0 else k_in, k_out,
                      last_mode if li == len(dims) - 1 else None)
                     for li, (k_in, k_out) in enumerate(dims)]
    return out


def disc_shapes(cfg, ndf=64):
    """{"main": [HWIO], "final": [HWIO]}: the patch discriminator's kernels
    at the configuration's patch size and conditioning."""
    gan = cfg["gan"]
    nc = 3 + (6 if gan.get("geo_conditional") else 0)
    final_dim = ndf if gan.get("scale_conditional") else 1
    size = int(cfg["patch_size"])
    if size != 16:
        raise NotImplementedError(f"patch size {size}")
    main = [(4, 4, nc, ndf * 4), (4, 4, ndf * 4, ndf * 8),
            (4, 4, ndf * 8, final_dim)]
    final = []
    if gan.get("scale_conditional"):
        head_in = ndf + gan["L_scale"] * 2 + 1
        final = [(1, 1, c_in, c_out)
                 for c_in, c_out in [(head_in, ndf), (ndf, ndf), (ndf, 1)]]
    return {"main": main, "final": final}


def _split(flat, shapes):
    out, at = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(flat[at:at + n].reshape(s))
        at += n
    return out


def make_weights(cfg, seed, device, n_images=None, lpips=False):
    """The seeded weights of ``cfg``'s engine → {key: float32 tensor on
    device}; ``n_images`` sizes the latent tables (the GAN's), ``lpips``
    adds the LPIPS AlexNet backbone and heads."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    dims = field_dims(cfg)
    dense = [(f"{name}.{li}", k_in, k_out, mode)
             for name, layers in dims.items()
             for li, (k_in, k_out, mode) in enumerate(layers)]
    uni = torch.rand(sum(a * b for _, a, b, _ in dense), generator=gen,
                     device=device)
    out = {}
    for (key, k_in, k_out, mode), u in zip(
            dense, _split(uni, [(a, b) for _, a, b, _ in dense])):
        gains = torch.full((k_out,), 1.0 if mode == "all" else RELU_GAIN,
                           device=device)
        if mode == "first":
            gains[0] = 1.0
        out[f"{key}.w"] = (2.0 * u - 1.0) * gains * math.sqrt(
            6.0 / (k_in + k_out))
        out[f"{key}.b"] = torch.zeros(k_out, device=device)
    normal = []                     # (key, shape, std)
    if n_images:
        normal += [("latent.trans", (n_images, cfg["nerf"]["N_latent_trans"]),
                    1.0),
                   ("latent.light", (n_images, cfg["nerf"]["N_latent_light"]),
                    1.0)]
    if cfg.get("gan") is not None:
        for grp, shapes in disc_shapes(cfg).items():
            normal += [(f"disc.{grp}.{i}", s, 0.02)
                       for i, s in enumerate(shapes)]
        normal += [(f"vgg.{i}.w", (c_out, c_in, 3, 3),
                    math.sqrt(2.0 / (9 * c_in)))
                   for i, (c_in, c_out) in enumerate(VGG19_CONVS)]
    if lpips:
        normal += [(f"lpips.{i}.w", (c_out, c_in, k, k),
                    math.sqrt(2.0 / (k * k * c_in)))
                   for i, (k, c_in, c_out) in enumerate(ALEX_CONVS)]
    if normal:
        flat = torch.randn(sum(math.prod(s) for _, s, _ in normal),
                           generator=gen, device=device)
        for (key, _, std), t in zip(normal,
                                    _split(flat, [s for _, s, _ in normal])):
            out[key] = t * std
    if cfg.get("gan") is not None:
        for i, (_, c_out) in enumerate(VGG19_CONVS):
            out[f"vgg.{i}.b"] = torch.zeros(c_out, device=device)
    if lpips:
        for i, (_, _, c_out) in enumerate(ALEX_CONVS):
            out[f"lpips.{i}.b"] = torch.zeros(c_out, device=device)
            out[f"lpips.lin.{i}"] = torch.full((c_out,), 1.0 / c_out,
                                               device=device)
    return out
