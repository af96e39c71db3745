"""Plain PyTorch building blocks of the benchmark's reference: the field
MLPs, positional encoding, rays, depth samples, the composites, patch
sampling, the discriminator, VGG19 features and the image metrics.

Written from the TexPose model as the port's plain paths compute it; it
imports nothing of the program.  Every matmul of a field takes its
operands rounded to the configuration's compute dtype and accumulates in
float32 (``Precision``); the gradients flowing back through the rounded
operands are rounded the same way.  ``Precision("float8")`` is the
control: per-tensor scaled e4m3 operands, one step below the configured
bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


class _Fp8(torch.autograd.Function):
    """Per-tensor scaled e4m3 rounding, forward and backward."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


def fp8_round(x):
    """x rounded to float8 e4m3 under a per-tensor scale, in float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Precision:
    """The operand rounding of the field matmuls and the VGG convolutions:
    "bfloat16" (the configurations' compute dtype), "float8" (the control)
    or "float32"."""

    def __init__(self, name="bfloat16"):
        if name not in ("bfloat16", "float8", "float32"):
            raise ValueError(name)
        self.name = name

    def q(self, x):
        if self.name == "bfloat16":
            return x.to(torch.bfloat16).float()
        if self.name == "float8":
            return _Fp8.apply(x)
        return x


def dense(prec, x, w, b):
    return prec.q(x) @ prec.q(w) + b


def softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def posenc(x, L):
    """[x, sin(2^k π x)…, cos(2^k π x)…] per dimension → [..., D(1+2L)]."""
    freq = (2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)) * math.pi
    spec = x[..., None] * freq
    enc = torch.stack([torch.sin(spec), torch.cos(spec)], dim=-2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * L)],
                     dim=-1)


def trunk(prec, W, x_enc, skip):
    """The 8×256 trunk → (feat [..., F] after ReLU, raw density [...])."""
    n = sum(1 for k in W if k.startswith("trunk.") and k.endswith(".w"))
    h = x_enc
    for li in range(n):
        if li in skip:
            h = torch.cat([h, x_enc], dim=-1)
        h = dense(prec, h, W[f"trunk.{li}.w"], W[f"trunk.{li}.b"])
        if li == n - 1:
            dens, h = h[..., 0], h[..., 1:]
        h = torch.relu(h)
    return h, dens


def head(prec, W, name, x):
    n = sum(1 for k in W if k.startswith(f"{name}.") and k.endswith(".w"))
    for li in range(n):
        x = dense(prec, x, W[f"{name}.{li}.w"], W[f"{name}.{li}.b"])
        if li != n - 1:
            x = torch.relu(x)
    return x


def pose_invert(pose):
    R, t = pose[..., :3], pose[..., 3:]
    Ri = R.transpose(-1, -2)
    return torch.cat([Ri, -(Ri @ t)], dim=-1)


def cam2world(X, pose):
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    return Xh @ pose_invert(pose).transpose(-1, -2)


def rays_from_pixels(xy, intr, pose):
    """Pixel coordinates [B,R,2] → (center, ray) [B,R,3] in the world."""
    xyh = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    cam = xyh @ torch.linalg.inv(intr).transpose(-1, -2)
    center = cam2world(torch.zeros_like(cam), pose)
    return center, cam2world(cam, pose) - center


def sample_depth(near, far, n, rand=None):
    """[B,R] bounds → [B,R,N,1] depths (stratified with rand, else mid-bin)."""
    lo, hi = near[:, :, None, None], far[:, :, None, None]
    grid = torch.arange(n, dtype=lo.dtype, device=lo.device)[None, None, :,
                                                             None]
    return ((0.5 if rand is None else rand) + grid) / n * (hi - lo) + lo


def dists(depth, ray):
    d = depth[..., 0]
    intv = torch.cat([d[..., 1:] - d[..., :-1],
                      torch.full_like(d[..., :1], 1e10)], dim=-1)
    return intv * torch.linalg.norm(ray, dim=-1, keepdim=True)


def transmittance(sd):
    return torch.exp(-torch.cumsum(torch.cat(
        [torch.zeros_like(sd[..., :1]), sd[..., :-1]], dim=-1), dim=-1))


def composite(rgb, density, depth, ray):
    """NeRF compositing → rgb [B,R,3], depth, opacity [B,R,1]."""
    sd = density * dists(depth, ray)
    prob = (transmittance(sd) * (1 - torch.exp(-sd)))[..., None]
    return dict(rgb=(rgb * prob).sum(-2), depth=(depth * prob).sum(-2),
                opacity=prob.sum(-2))


def composite_dual(rgb, density, depth, ray, uncert, min_uncert):
    """NeRF-W static + transient compositing: rgb [B,R,N,3,2], density
    [B,R,N,2], uncert [B,R,N,1] → rgb, uncert [B,R,C]."""
    d = dists(depth, ray)
    sd_s, sd_t = density[..., 0] * d, density[..., 1] * d
    T = transmittance(sd_s + sd_t)
    p_s = (T * (1 - torch.exp(-sd_s)))[..., None]
    p_t = (T * (1 - torch.exp(-sd_t)))[..., None]
    return dict(rgb=(rgb[..., 0] * p_s + rgb[..., 1] * p_t).sum(-2),
                uncert=(uncert * p_t).sum(-2) + min_uncert)


def grid_sample(image, grid, mode="bilinear", align_corners=False):
    return F.grid_sample(image, grid.to(image.dtype), mode=mode,
                         padding_mode="zeros", align_corners=align_corners)


# ------------------------------------------------------------ discriminator

def _unit(v):
    return v / (torch.linalg.norm(v) + 1e-12)


def spectral_norm(w, u):
    """One power iteration → (w / σ, new u); σ's gradient reaches w only."""
    kh, kw, cin, cout = w.shape
    m = w.reshape(kh * kw * cin, cout)
    v = _unit(m.detach() @ u)
    u_new = _unit(m.detach().t() @ v)
    return w / (v @ (m @ u_new)), u_new.detach()


def _conv(x, w, stride, pad):
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, padding=pad)


def _inorm(x, eps=1e-5):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def _img_posenc(x, L):
    B, C, h, w = x.shape
    flat = x.reshape(B, C, h * w).transpose(1, 2)
    enc = posenc(flat, L)[..., C:]
    return enc.transpose(1, 2).reshape(B, 2 * C * L, h, w)


def discriminator(main, final, x, scales, L_scale):
    """The 16×16 patch discriminator on spectrally normalized kernels:
    x [B,9,16,16] (rgb, nocs, normal), scales [B,1,1,1] → logits [B]."""
    spec = [(2, 1, True), (2, 1, True), (1, 0, False)]
    h = x
    for i, (stride, pad, use_in) in enumerate(spec):
        h = _conv(h, main[i], stride, pad)
        if use_in:
            h = _inorm(h)
        if i != len(spec) - 1:
            h = F.leaky_relu(h, 0.2)
    h = F.leaky_relu(torch.cat([h, _img_posenc(scales, L_scale), scales],
                               dim=1), 0.2)
    for j, w in enumerate(final):
        h = _conv(h, w, 1, 0)
        if j != len(final) - 1:
            h = F.leaky_relu(h, 0.2)
    return h.reshape(h.shape[0], -1).squeeze(-1)


def gan_loss(logits, target):
    return (torch.clamp_min(logits, 0) - logits * float(target)
            + torch.log1p(torch.exp(-logits.abs()))).mean()


# --------------------------------------------------------------------- VGG

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_features(prec, W, x):
    """VGG19 features to conv3_3 (pre-activation) of x [B,3,H,W] in [0,1].
    bfloat16: the stack in bf16 (each convolution rounds its output), as
    the configured compute dtype runs it; float8: e4m3 operands and
    float32 sums; float32: float32 throughout."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    x = (x - mean) / std
    dt = torch.bfloat16 if prec.name == "bfloat16" else torch.float32
    x = x.to(dt)
    n = sum(1 for k in W if k.startswith("vgg.") and k.endswith(".w"))
    for i in range(n):
        w, b = W[f"vgg.{i}.w"].to(dt), W[f"vgg.{i}.b"].to(dt)
        if prec.name == "float8":
            x, w = prec.q(x), prec.q(w)
        x = F.conv2d(x, w, padding=1) + b[None, :, None, None]
        if i != n - 1:
            x = torch.clamp_min(x, 0)
        if i in (1, 3):
            x = F.max_pool2d(x, 2, 2)
    return x.float()


# ----------------------------------------------------------- image metrics

def psnr(pred, target):
    return -10.0 * torch.log10(((pred - target) ** 2).mean() + 1e-10)


def ssim(a, b, size=11, sigma=1.5):
    """Gaussian-window SSIM of [B,C,H,W] images (zero SAME padding)."""
    x = torch.arange(size, dtype=a.dtype, device=a.device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()

    def blur(img):
        B, C, H, W = img.shape
        o = img.reshape(B * C, 1, H, W)
        o = F.conv2d(o, g.reshape(1, 1, 1, size), padding=(0, size // 2))
        o = F.conv2d(o, g.reshape(1, 1, size, 1), padding=(size // 2, 0))
        return o.reshape(B, C, H, W)

    m1, m2 = blur(a), blur(b)
    s1 = blur(a * a) - m1 ** 2
    s2 = blur(b * b) - m2 ** 2
    s12 = blur(a * b) - m1 * m2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * m1 * m2 + c1) * (2 * s12 + c2))
            / ((m1 ** 2 + m2 ** 2 + c1) * (s1 + s2 + c2))).mean()


LPIPS_SPEC = [(4, 2), (1, 2), (1, 1), (1, 1), (1, 1)]   # (stride, pad)
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def lpips(W, x, y):
    """LPIPS (AlexNet backbone, linear heads) of [B,3,H,W] images in
    [-1, 1] → [B]."""
    shift = torch.tensor(LPIPS_SHIFT, device=x.device)[:, None, None]
    scale = torch.tensor(LPIPS_SCALE, device=x.device)[:, None, None]

    def feats(z):
        z = (z - shift) / scale
        out = []
        for i, (stride, pad) in enumerate(LPIPS_SPEC):
            if i in (1, 2):
                z = F.max_pool2d(z, 3, 2)
            z = torch.relu(F.conv2d(z, W[f"lpips.{i}.w"], W[f"lpips.{i}.b"],
                                    stride=stride, padding=pad))
            out.append(z)
        return out

    total = 0.0
    for i, (a, b) in enumerate(zip(feats(x), feats(y))):
        na = a / (torch.sqrt((a ** 2).sum(1, keepdim=True)) + 1e-10)
        nb = b / (torch.sqrt((b ** 2).sum(1, keepdim=True)) + 1e-10)
        total = total + (((na - nb) ** 2)
                         * W[f"lpips.lin.{i}"][None, :, None, None]
                         ).sum(1).mean(dim=(1, 2))
    return total
