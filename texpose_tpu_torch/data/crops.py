"""CDPN-style square crop pipeline + intrinsics adjustment (host-side numpy/cv2).

Capability parity with the reference TexPose code, data/lm.py:402-521:
  * Crop_by_Pad: crop a (possibly clipped) square window of side `scale`
    around `center` (y,x), aspect-preserving resize so the longer side hits
    `res`, centered zero-padding to res×res
  * get_center_offset: optical-center correction when the window clips the
    frame border
  * preprocess_intrinsics: resize(+0.5 pixel-center convention) then crop
    ("tested faithfully. Results in PnP with 0.02% drop", lm.py:413)
  * get_edge / smooth_geo: median-blur geometry maps along mask edges
"""

from __future__ import annotations

import numpy as np
import cv2

cv2.setNumThreads(0)
cv2.ocl.setUseOpenCL(False)


def bbox_to_crop(bbox, res, box_format=None):
    """BOP bbox → (center [y,x], scale, resize) (reference lm.py:161-180)."""
    if box_format in (None, "hw"):
        x_ul, y_ul, h, w = bbox
    elif box_format == "wh":
        x_ul, y_ul, w, h = bbox
    else:
        raise NotImplementedError(box_format)
    center = np.array([int(y_ul + h / 2), int(x_ul + w / 2)])
    scale = int(1.5 * max(h, w))
    return center, scale, res / scale


def crop_by_pad(img, center, scale, res, channel=3,
                interpolation=cv2.INTER_LINEAR, resize=True):
    """Square crop around center with zero padding (reference lm.py:453-495)."""
    ht, wd = img.shape[0], img.shape[1]
    upper = max(0, int(center[0] - scale / 2.0 + 0.5))
    left = max(0, int(center[1] - scale / 2.0 + 0.5))
    bottom = min(ht, int(center[0] - scale / 2.0 + 0.5) + int(scale))
    right = min(wd, int(center[1] - scale / 2.0 + 0.5) + int(scale))
    crop_ht = float(bottom - upper)
    crop_wd = float(right - left)

    if channel > 3:
        raise NotImplementedError

    tmp = img[upper:bottom, left:right]
    if not resize:
        out = np.zeros((int(scale), int(scale), channel))
        oy = int(scale / 2.0 - crop_ht / 2.0 + 0.5)
        ox = int(scale / 2.0 - crop_wd / 2.0 + 0.5)
        tmp3 = tmp if tmp.ndim == 3 else tmp[..., None]
        out[oy:oy + int(crop_ht), ox:ox + int(crop_wd), :] = tmp3
        return out

    if crop_ht > crop_wd:
        rh, rw = res, int(res / crop_ht * crop_wd + 0.5)
    elif crop_ht < crop_wd:
        rh, rw = int(res / crop_wd * crop_ht + 0.5), res
    else:
        rh = rw = int(res)
    resized = cv2.resize(tmp, (rw, rh), interpolation=interpolation)
    if resized.ndim < 3:
        resized = resized[..., None]
    out = np.zeros((res, res, channel))
    oy = int(res / 2.0 - rh / 2.0 + 0.5)
    ox = int(res / 2.0 - rw / 2.0 + 0.5)
    out[oy:oy + rh, ox:ox + rw, :] = resized
    return out


def get_center_offset(center, scale, ht, wd):
    """Optical-center shift for border-clipped windows
    (reference lm.py:430-451)."""
    upper = max(0, int(center[0] - scale / 2.0 + 0.5))
    left = max(0, int(center[1] - scale / 2.0 + 0.5))
    bottom = min(ht, int(center[0] - scale / 2.0 + 0.5) + int(scale))
    right = min(wd, int(center[1] - scale / 2.0 + 0.5) + int(scale))
    if upper == 0:
        h_offset = -int(center[0] - scale / 2.0 + 0.5) / 2
    elif bottom == ht:
        h_offset = -(int(center[0] - scale / 2.0 + 0.5) + int(scale) - ht) / 2
    else:
        h_offset = 0
    if left == 0:
        w_offset = -int(center[1] - scale / 2.0 + 0.5) / 2
    elif right == wd:
        w_offset = -(int(center[1] - scale / 2.0 + 0.5) + int(scale) - wd) / 2
    else:
        w_offset = 0
    return np.array([h_offset, w_offset])


def preprocess_intrinsics(cam_K, resize, crop_center, res):
    """Adjust K for resize-then-crop; crop_center is (y,x)
    (reference lm.py:411-428)."""
    K = np.array(cam_K, np.float64).copy()
    K[0, 0] *= resize
    K[1, 1] *= resize
    K[0, 2] = (K[0, 2] + 0.5) * resize - 0.5
    K[1, 2] = (K[1, 2] + 0.5) * resize - 0.5
    top_left = np.asarray(crop_center, np.float64) * resize - res / 2
    K[0, 2] -= top_left[1]
    K[1, 2] -= top_left[0]
    return K.astype(np.float32)


def get_edge(mask, bw=1, out_channel=3):
    """Binary mask boundary map (reference lm.py:497-513, GDRN-derived)."""
    if mask.ndim > 2:
        mask = mask[:, :, 0] != 0
    edges = np.zeros(mask.shape[:2])
    edges[:-bw, :] += np.logical_and(mask[:-bw, :] == 1, mask[bw:, :] == 0)
    edges[bw:, :] += np.logical_and(mask[bw:, :] == 1, mask[:-bw, :] == 0)
    edges[:, :-bw] += np.logical_and(mask[:, :-bw] == 1, mask[:, bw:] == 0)
    edges[:, bw:] += np.logical_and(mask[:, bw:] == 1, mask[:, :-bw] == 0)
    if out_channel == 3:
        edges = np.dstack((edges, edges, edges))
    return edges


def smooth_geo(x):
    """Median-blur geometry maps along mask edges (reference lm.py:515-521)."""
    x = np.asarray(x, np.float32).copy()
    x_blur = cv2.medianBlur(x, 3)
    edges = get_edge(x)
    x[edges != 0] = x_blur[edges != 0]
    return x


def erode_mask(mask, ksize=3, iterations=1):
    return cv2.erode(mask.astype(np.float32), np.ones((ksize, ksize)),
                     iterations=iterations)
