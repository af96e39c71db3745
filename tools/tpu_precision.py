"""The TPU's default precision for f32 convolutions and contractions,
emulated on the port's texture-GAN step (branch (b) of
tools/probe_f7.py).

XLA on a TPU runs an f32 convolution or dot at DEFAULT precision: each
operand rounded to bf16, the products and their sums in f32.  The JAX
package sets no ``precision=`` outside its kernels, so on the TPU its
discriminator's convolutions, the convolutions of their VJPs (the R1
pullback and that pullback's own derivative), the spectral-norm matvecs
and the Lab conversion's contraction all run so.  Here each such operation
is an ``autograd.Function`` whose forward rounds both operands to bf16 and
computes in f32, and whose backward is built from the same functions, so
every operation of the derivatives (the cotangent included) rounds its
operands too, at any order.

``tpu_default_precision()`` swaps them in for the call sites —
nn/discriminator.py ``_conv`` and ``sn_apply``, and ``rgb_to_lab`` as
models/losses.py calls it — with TF32 off, and restores everything after.
It yields the number of calls of each site.
"""

import contextlib

import torch
import torch.nn.functional as F

SITES = ("conv", "sn_matvec", "lab")


def bf16_round(x):
    """x rounded to bf16 (to nearest even), in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class Conv(torch.autograd.Function):
    """y = conv2d(x, w) (NCHW, OIHW) of bf16-rounded operands."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        return F.conv2d(bf16_round(x), bf16_round(w), stride=stride,
                        padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s, p = ctx.conf
        gx = ConvInput.apply(g, w, x.shape, s, p) \
            if ctx.needs_input_grad[0] else None
        gw = ConvWeight.apply(x, g, w.shape, s, p) \
            if ctx.needs_input_grad[1] else None
        return gx, gw, None, None


class ConvInput(torch.autograd.Function):
    """The convolution's VJP in x: conv2d_input(g, w) of bf16-rounded
    operands."""

    @staticmethod
    def forward(ctx, g, w, x_shape, stride, padding):
        ctx.save_for_backward(g, w)
        ctx.conf = (stride, padding)
        return torch.nn.grad.conv2d_input(x_shape, bf16_round(w),
                                          bf16_round(g), stride=stride,
                                          padding=padding)

    @staticmethod
    def backward(ctx, h):
        g, w = ctx.saved_tensors
        s, p = ctx.conf
        gg = Conv.apply(h, w, s, p) if ctx.needs_input_grad[0] else None
        gw = ConvWeight.apply(h, g, w.shape, s, p) \
            if ctx.needs_input_grad[1] else None
        return gg, gw, None, None, None


class ConvWeight(torch.autograd.Function):
    """The convolution's VJP in w: conv2d_weight(x, g) of bf16-rounded
    operands."""

    @staticmethod
    def forward(ctx, x, g, w_shape, stride, padding):
        ctx.save_for_backward(x, g)
        ctx.conf = (stride, padding)
        return torch.nn.grad.conv2d_weight(bf16_round(x), w_shape,
                                           bf16_round(g), stride=stride,
                                           padding=padding)

    @staticmethod
    def backward(ctx, k):
        x, g = ctx.saved_tensors
        s, p = ctx.conf
        gx = ConvInput.apply(g, k, x.shape, s, p) \
            if ctx.needs_input_grad[0] else None
        gg = Conv.apply(x, k, s, p) if ctx.needs_input_grad[1] else None
        return gx, gg, None, None, None


class Matmul(torch.autograd.Function):
    """a @ b (2-D) of bf16-rounded operands."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return bf16_round(a) @ bf16_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = Matmul.apply(g, b.t()) if ctx.needs_input_grad[0] else None
        gb = Matmul.apply(a.t(), g) if ctx.needs_input_grad[1] else None
        return ga, gb


def conv_hwio(x, w, stride, padding):
    """nn/discriminator.py ``_conv`` (HWIO kernel) at default precision."""
    return Conv.apply(x, w.permute(3, 2, 0, 1), stride, padding)


def sn_apply(w, u, training):
    """nn/discriminator.py ``sn_apply`` with its four matvecs at default
    precision."""
    from texpose_tpu_torch.nn.discriminator import _normalize
    kh, kw, cin, cout = w.shape
    w_mat = w.reshape(kh * kw * cin, cout)
    w_sg = w_mat.detach()
    v = _normalize(Matmul.apply(w_sg, u[:, None])[:, 0])
    u_new = _normalize(Matmul.apply(w_sg.t(), v[:, None])[:, 0])
    sigma = Matmul.apply(v[None, :], Matmul.apply(w_mat, u_new[:, None]))
    return w / sigma[0, 0], (u_new if training else u).detach()


def lab_contract(m, lin):
    """einsum("ij,bjhw->bihw", m, lin) at default precision."""
    B, C, H, W = lin.shape
    flat = lin.permute(1, 0, 2, 3).reshape(C, B * H * W)
    out = Matmul.apply(m, flat)
    return out.reshape(m.shape[0], B, H, W).permute(1, 0, 2, 3)


def rgb_to_lab(rgb):
    """ops/color.py ``rgb_to_lab`` with its contraction at default
    precision."""
    from texpose_tpu_torch.ops import color
    from texpose_tpu_torch.ops.consts import device_const
    lin = color.srgb_to_linear(rgb)
    m = device_const(color._RGB2XYZ, rgb.dtype, rgb.device)
    white = device_const(color._WHITE, rgb.dtype, rgb.device)
    xyz = lab_contract(m, lin) / white[None, :, None, None]
    eps = 0.008856
    kappa = 7.787
    f = torch.where(xyz > eps, torch.clamp(xyz, min=eps) ** (1.0 / 3.0),
                    kappa * xyz + 4.0 / 29.0)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=1)


@contextlib.contextmanager
def tpu_default_precision():
    """The block runs the GAN step's f32 convolutions and contractions at
    the TPU's default precision, TF32 off → {site: calls} (SITES), filled
    as the sites run.  The sites and the TF32 switches are restored after."""
    from texpose_tpu_torch.models import losses
    from texpose_tpu_torch.nn import discriminator as disc
    calls = dict.fromkeys(SITES, 0)

    def counted(site, fn):
        def call(*args, **kwargs):
            calls[site] += 1
            return fn(*args, **kwargs)
        return call

    swaps = ((disc, "_conv", counted("conv", conv_hwio)),
             (disc, "sn_apply", counted("sn_matvec", sn_apply)),
             (losses, "rgb_to_lab", counted("lab", rgb_to_lab)))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
