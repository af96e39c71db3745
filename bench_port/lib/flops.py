"""Operations and bytes of the benchmarked work, from the configuration's
widths and the cell's shapes, and the card's peaks.

Model FLOPs count what the algorithm needs, once: a frozen trunk's forward
only; a trained layer's forward, its input gradient (where something
upstream is trained) and its weight gradient; no recomputation.  Every
FLOP is counted at the bf16 dense peak, so no change of precision lifts a
share past 100 %.  ``shapes`` (the entry's): kind "gan_step" (B patches of
p×p rays, N samples), "pretrain_step" (rays, N) or "pretrain_frame" (H×W
rays, N).
"""

from __future__ import annotations

from .weights import VGG19_CONVS, disc_shapes, field_dims

PEAK_FLOPS = 989e12      # H100 SXM, bf16 dense (NVIDIA data sheet)
PEAK_BYTES = 3.35e12     # H100 SXM HBM3


def mlp_flops(layers, skip_dx_first=0):
    """(forward, input-gradient) FLOPs a row of Dense layers [(in, out,
    mode)]; the first layer's input gradient covers only its last
    ``skip_dx_first`` inputs (None: all of them)."""
    fwd = sum(2 * i * o for i, o, _ in layers)
    i0, o0, _ = layers[0]
    dx = fwd - 2 * i0 * o0 + (2 * (i0 if skip_dx_first is None
                                   else skip_dx_first) * o0)
    return fwd, dx


def trunk_forward_flops(cfg):
    return mlp_flops(field_dims(cfg)["trunk"])[0]


def field_params(cfg, names):
    dims = field_dims(cfg)
    return sum((i + 1) * o for n in names for i, o, _ in dims[n])


def field_work(cfg, shapes):
    """(FLOPs, bytes) a unit of the field rows as stated — the GAN's ST
    field forward and its heads' backward (rows 1 + 2), the pretrain's
    field + composite forward and the field's backward (rows 8 + 7b), the
    frame's field + composite forward (row 8); each input and output byte
    once: f32 rows, bf16 weights, f32 weight gradients."""
    dims = field_dims(cfg)
    N = int(shapes["N"])
    e3 = dims["trunk"][0][0]
    if shapes["kind"] == "gan_step":
        rows = shapes["B"] * shapes["p"] ** 2 * N
        nerf = cfg["nerf"]
        trunk = mlp_flops(dims["trunk"])[0]
        rgb_f, rgb_dx = mlp_flops(dims["rgb"], nerf["N_latent_light"])
        tr_f, tr_dx = mlp_flops(dims["trans"], nerf["N_latent_trans"])
        flops = rows * (trunk + 2 * rgb_f + rgb_dx + 2 * tr_f + tr_dx)
        enc = (dims["rgb"][0][0] - cfg["arch"]["layers_feat"][-1]
               - nerf["N_latent_light"])      # view enc ⊕ points, f32
        heads = field_params(cfg, ("rgb", "trans"))
        w_all = field_params(cfg, ("trunk", "rgb", "trans"))
        nbytes = (rows * 4 * (2 * (e3 + enc) + 9 + 8)
                  + 2 * 2 * w_all + 4 * heads)
        return flops, nbytes
    rows = (shapes["rays"] if shapes["kind"] == "pretrain_step"
            else shapes["H"] * shapes["W"]) * N
    fwd, dx = mlp_flops(dims["trunk"], 0)
    hf, hdx = mlp_flops(dims["rgb"], None)
    w_all = field_params(cfg, ("trunk", "rgb"))
    if shapes["kind"] == "pretrain_step":
        flops = rows * (2 * (fwd + hf) + dx + hdx)
        nbytes = (rows * 4 * (2 * (e3 + 3) + 2 + 4) + rows // N * 4 * 5
                  + 2 * 2 * w_all + 4 * w_all)
    else:
        flops = rows * (fwd + hf)
        nbytes = rows * 4 * (e3 + 3 + 2) + rows // N * 4 * 5 + 2 * w_all
    return flops, nbytes


def conv_flops(shape, hw_out):
    kh, kw, cin, cout = shape
    return 2 * kh * kw * cin * cout * hw_out


def vgg_forward_flops(size):
    """FLOPs of VGG19 to conv3_3 on one size×size image."""
    total, s = 0, size
    for i, (cin, cout) in enumerate(VGG19_CONVS):
        total += conv_flops((3, 3, cin, cout), s * s)
        if i in (1, 3):
            s //= 2
    return total


def disc_forward_flops(cfg):
    """FLOPs of the patch discriminator on one patch."""
    sh = disc_shapes(cfg)
    size = int(cfg["patch_size"])
    outs = [(size // 2) ** 2, (size // 4) ** 2, 1]
    total = sum(conv_flops(s, o) for s, o in zip(sh["main"], outs))
    return total + sum(conv_flops(s, 1) for s in sh["final"])


def model_flops(cfg, shapes):
    """Model FLOPs a unit (a step or a frame): the field rows and, in the
    GAN step, the VGG19 perceptual pass (4B images forward, the input
    gradient of the 2B rendered ones) and the discriminator (the
    generator's pass on B: forward and input gradient; the critic's on 2B:
    forward, the R1 input gradient, the weight gradient and the R1
    penalty's backward, counted as twice an input gradient)."""
    flops, _ = field_work(cfg, shapes)
    if shapes["kind"] == "gan_step":
        B, p = shapes["B"], shapes["p"]
        vgg = vgg_forward_flops(p)
        d = disc_forward_flops(cfg)
        flops += 4 * B * vgg + 2 * B * vgg
        flops += 2 * B * d + 2 * B * d * (1 + 1 + 1 + 2)
    return flops


def least_seconds(flops, nbytes):
    """The roofline's least time of the work: max(operations at the bf16
    peak, bytes at the HBM peak)."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
