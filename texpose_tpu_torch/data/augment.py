"""Host-side photometric/geometric training augmentation.

Capability parity with the reference TexPose code, data/base.py:75-100: per-sample
brightness/contrast/saturation/hue jitter (torchvision ColorJitter
semantics), random horizontal flip, random rotation (bicubic).  Like the
reference, augmentation applies to the IMAGE only and is train-only; the
reference's LM dataset asserts it off (data/lm.py:87), so no tracked config
enables it — the capability exists behind ``cfg.data.augment``.

Deliberate deltas (documented): the color ops apply in a fixed order
(torchvision shuffles the order per sample), and with whole-split prefetch
the draw happens once per run rather than once per epoch.
"""

from __future__ import annotations

import numpy as np

# torchvision rgb_to_grayscale coefficients
_GRAY = np.array([0.2989, 0.587, 0.114], np.float32)


def generate_augmentation(aug_cfg, rng=None):
    """Draw per-sample augmentation parameters.

    aug_cfg keys (all optional): brightness/contrast/saturation — jitter
    half-width f, factor ~ U[1-f, 1+f]; hue — shift ~ U[-h, h] in turns;
    hflip — bool gate on a coin flip; rotate — max |angle| in degrees.
    Mirrors reference generate_augmentation (data/base.py:75-90).
    """
    rng = rng or np.random.default_rng()

    def factor(name):
        f = aug_cfg.get(name) or 0.0
        return float(rng.uniform(1 - f, 1 + f)) if f else 1.0

    h = aug_cfg.get("hue") or 0.0
    return dict(
        brightness=factor("brightness"),
        contrast=factor("contrast"),
        saturation=factor("saturation"),
        hue=float(rng.uniform(-h, h)) if h else 0.0,
        flip=bool(rng.standard_normal() > 0) if aug_cfg.get("hflip") else False,
        rot_angle=float((rng.random() * 2 - 1) * aug_cfg.get("rotate"))
        if aug_cfg.get("rotate") else 0.0,
    )


def _blend(img, other, f):
    return np.clip(f * img + (1.0 - f) * other, 0.0, 1.0).astype(np.float32)


def apply_augmentation(image, aug):
    """image [3,H,W] float32 in [0,1] → augmented copy.

    Color math matches torchvision functional ops: brightness = blend with
    black, contrast = blend with the mean gray level, saturation = blend
    with the per-pixel grayscale, hue = HSV hue rotation.
    """
    img = np.asarray(image, np.float32)
    if aug["brightness"] != 1.0:
        img = _blend(img, 0.0, aug["brightness"])
    if aug["contrast"] != 1.0:
        gray_mean = float((_GRAY[:, None, None] * img).sum(0).mean())
        img = _blend(img, gray_mean, aug["contrast"])
    if aug["saturation"] != 1.0:
        gray = (_GRAY[:, None, None] * img).sum(0, keepdims=True)
        img = _blend(img, gray, aug["saturation"])
    if aug["hue"]:
        import cv2
        hsv = cv2.cvtColor(img.transpose(1, 2, 0), cv2.COLOR_RGB2HSV)
        hsv[..., 0] = (hsv[..., 0] + aug["hue"] * 360.0) % 360.0
        img = np.clip(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), 0, 1) \
            .transpose(2, 0, 1).astype(np.float32)
    if aug["flip"]:
        img = img[:, :, ::-1].copy()
    if aug["rot_angle"]:
        import cv2
        H, W = img.shape[1:]
        M = cv2.getRotationMatrix2D((W / 2 - 0.5, H / 2 - 0.5),
                                    aug["rot_angle"], 1.0)
        img = cv2.warpAffine(img.transpose(1, 2, 0), M, (W, H),
                             flags=cv2.INTER_CUBIC) \
            .transpose(2, 0, 1).astype(np.float32)
        img = np.clip(img, 0.0, 1.0)
    return img
