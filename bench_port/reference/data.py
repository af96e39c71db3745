"""The cells' inputs as the reference reads them: the fixture's files on
disk through TexPose's LineMOD crop pipeline, so that the reference takes
nothing that the program's loader derived from them.

A copy of the port's LineMOD loader's crop path (``data/lm.py``, with the
``data/crops.py`` and ``data/bop.py`` helpers it calls) for one object a
frame and the options the benchmark's configurations set; an option it
does not cover raises.  ``cfg``: the engine's configuration as plain data.
"""

from __future__ import annotations

import json
import os

import cv2
import numpy as np

from ..lib.fixture import bbox_to_crop, get_center_offset, \
    preprocess_intrinsics


def _crop(img, center, scale, res, channel=3, interpolation=cv2.INTER_LINEAR):
    """Square crop around center (y, x), the longer side resized to res,
    zero padding to res × res."""
    ht, wd = img.shape[0], img.shape[1]
    top = int(center[0] - scale / 2.0 + 0.5)
    lft = int(center[1] - scale / 2.0 + 0.5)
    upper, left = max(0, top), max(0, lft)
    bottom, right = min(ht, top + int(scale)), min(wd, lft + int(scale))
    crop_ht, crop_wd = float(bottom - upper), float(right - left)
    if crop_ht > crop_wd:
        rh, rw = res, int(res / crop_ht * crop_wd + 0.5)
    elif crop_ht < crop_wd:
        rh, rw = int(res / crop_wd * crop_ht + 0.5), res
    else:
        rh = rw = int(res)
    resized = cv2.resize(img[upper:bottom, left:right], (rw, rh),
                         interpolation=interpolation)
    if resized.ndim < 3:
        resized = resized[..., None]
    out = np.zeros((res, res, channel))
    oy = int(res / 2.0 - rh / 2.0 + 0.5)
    ox = int(res / 2.0 - rw / 2.0 + 0.5)
    out[oy:oy + rh, ox:ox + rw, :] = resized
    return out


def _smooth_geo(x):
    """Median-blurred values along the map's edges (where a channel-0
    nonzero pixel meets a zero one)."""
    x = np.asarray(x, np.float32).copy()
    blur = cv2.medianBlur(x, 3)
    m = x[:, :, 0] != 0 if x.ndim > 2 else x
    e = np.zeros(m.shape[:2])
    e[:-1, :] += np.logical_and(m[:-1, :] == 1, m[1:, :] == 0)
    e[1:, :] += np.logical_and(m[1:, :] == 1, m[:-1, :] == 0)
    e[:, :-1] += np.logical_and(m[:, :-1] == 1, m[:, 1:] == 0)
    e[:, 1:] += np.logical_and(m[:, 1:] == 1, m[:, :-1] == 0)
    e = np.dstack((e, e, e))
    x[e != 0] = blur[e != 0]
    return x


def _erode(mask):
    return cv2.erode(mask.astype(np.float32), np.ones((3, 3)), iterations=1)


def _pose(entry, zscale):
    R = np.array(entry["cam_R_m2c"], np.float32).reshape(3, 3)
    t = np.array(entry["cam_t_m2c"], np.float32) / 1000.0 * zscale
    return np.concatenate([R, t[:, None]], axis=1)


def _read(path):
    with open(path) as f:
        return json.load(f)


class Split:
    """One split of the configuration's scene: ``sample(i)`` as the
    program's loader gives it, ``stacked()`` every sample stacked."""

    def __init__(self, cfg, split):
        data = cfg["data"]
        if data.get("box_format") not in (None, "hw", "wh"):
            raise NotImplementedError(f"data.box_format {data['box_format']}")
        for key in ("augment", "raw_size", "multi_obj",
                    "train_sub" if split == "train" else "val_sub"):
            if data.get(key):
                raise NotImplementedError(f"data.{key}")
        if cfg.get("syn2real"):
            raise NotImplementedError("syn2real")
        self.cfg, self.split = cfg, split
        self.H, self.W = int(cfg["H"]), int(cfg["W"])
        self.path = os.path.join(data["root"], data["dataset"])
        with open(os.path.join(data["splits_root"], data["dataset"],
                               str(data["object"]), data["scene"],
                               f"{split}.txt")) as f:
            self.lines = [ln.split() for ln in f if ln.strip()]
        base = os.path.join(self.path, self.lines[0][1])
        predicted = data.get("pose_source") == "predicted"
        info = "scene_pred_info.json" if split != "test" and predicted \
            else "scene_gt_info.json"
        if predicted and data.get("scene_info_source") == "gt":
            info = "scene_gt_info.json"
        self.gt = _read(os.path.join(base, "scene_gt.json"))
        self.cam = _read(os.path.join(base, "scene_camera.json"))
        self.info = _read(os.path.join(base, info))
        self.pred = _read(os.path.join(
            base, f"scene_pred_{data['pose_loop']}.json")) \
            if split == "train" and predicted else None

    def __len__(self):
        return len(self.lines)

    def _file(self, i, sub, name):
        return os.path.join(self.path, self.lines[i][1], sub, name)

    def _mask(self, i, frame, crop, erode=False):
        data, name = self.cfg["data"], f"{frame:06d}_000000.png"
        center, scale, _ = crop
        full = _crop(cv2.imread(self._file(i, "mask", name), -1), center,
                     scale, self.H, 1).astype(np.float32)
        if self.split == "train":
            src = (data.get("mask_visib_source") or "mask_visib") \
                if "adapt_st" in str(self.cfg.get("model", "")) \
                else "mask_visib"
            visib = cv2.imread(self._file(i, src, name), -1)
            if visib.shape[0] != self.H:
                visib = _crop(visib, center, scale, self.H, 1)
            if data.get("erode_mask"):
                visib = _erode(np.squeeze(visib))
            mask = (np.squeeze(visib) > 0).astype(np.float32)
        else:
            mask = (np.squeeze(full) > 0).astype(np.float32)
        if erode:
            mask = _erode(mask)
        return np.squeeze(mask).astype(np.float32)

    def _range(self, i, frame, crop):
        cfg, depth = self.cfg, self.cfg["nerf"]["depth"]
        lo, hi = depth["range"]
        zscale = depth["scale"]
        n = self.H * self.W
        bg_lo = np.full(n, lo * zscale, np.float32)
        bg_hi = np.full(n, hi * zscale, np.float32)
        source = depth.get("range_source")
        if source is None:
            return bg_lo, bg_hi
        if source != "box":
            raise NotImplementedError(f"nerf.depth.range_source {source}")
        box_src = depth["box_source"] if (
            cfg["data"].get("pose_source") == "predicted"
            and self.split in ("train", "val")) else "gt_box"
        box = np.load(self._file(i, box_src, f"{frame:06d}.npz"),
                      allow_pickle=True)["data"].astype(np.float32)
        box = _crop(box.transpose(1, 2, 0), crop[0], crop[1], self.H,
                    2).astype(np.float32)
        if depth.get("box_mask"):
            box = box * self._mask(i, frame, crop)[..., None]
        box = box.transpose(2, 0, 1).reshape(2, n) / 1000.0 * zscale
        return (np.where(box[0] > 0, box[0], bg_lo).astype(np.float32),
                np.where(box[1] > 0, box[1], bg_hi).astype(np.float32))

    def sample(self, i):
        cfg, data = self.cfg, self.cfg["data"]
        frame = int(self.lines[i][2])
        x, y, a, b = self.info[str(frame)][0]["bbox_obj"]
        if self.cfg["data"].get("box_format") == "wh":    # (x, y, w, h)
            a, b = b, a
        crop = bbox_to_crop([x, y, a, b], self.H)
        center, scale, resize = crop
        img = cv2.imread(self._file(i, "rgb", f"{frame:06d}.png"),
                         -1)[:, :, [2, 1, 0]]
        image = _crop(img, center, scale, self.H).astype(np.uint8) \
            .transpose(2, 0, 1).astype(np.float32) / 255.0
        coff = get_center_offset(center, scale, 480, 640)
        intr = preprocess_intrinsics(
            np.array(self.cam[str(frame)]["cam_K"], np.float32).reshape(3, 3),
            resize, center + coff, self.H)
        zscale = cfg["nerf"]["depth"]["scale"]
        pose = _pose(self.gt[str(frame)][0], zscale)
        pose_init = _pose(self.pred[str(frame)][0], zscale) \
            if self.pred is not None else pose
        z_near, z_far = self._range(i, frame, crop)
        mask = self._mask(i, frame, crop)
        if data["scene"] != "scene_all":
            d = cv2.imread(self._file(i, "depth", f"{frame:06d}.png"),
                           -1) / 1000.0
            d = np.squeeze(_crop(d, center, scale, self.H, 1)
                           .astype(np.float32))
            depth_gt = d * zscale * self.cam[str(frame)]["depth_scale"] \
                * mask
        else:
            depth_gt = np.ones_like(mask)
        if data.get("bgcolor") is not None:
            image = np.where(mask[None] > 0, image,
                             np.float32(data["bgcolor"]))
        out = dict(idx=np.int32(i), image=image, intr=intr, pose=pose,
                   pose_init=pose_init, z_near=z_near, z_far=z_far,
                   obj_mask=mask, depth_gt=depth_gt,
                   frame_index=np.int32(frame))
        if data.get("erode_mask_loss") is not None:
            out["erode_mask"] = self._mask(i, frame, crop, erode=True)
        gan = cfg.get("gan") is not None
        if self.split == "train" and (
                gan or (cfg.get("loss_weight") or {}).get("feat") is not None):
            loop = f"_{data['pose_loop']}" \
                if data.get("pose_source") == "predicted" else "_GT"
            rgba = cv2.imread(self._file(i, "rgbsyn" + loop,
                                         f"{frame:06d}.png"), -1)
            out["image_syn"] = rgba[..., :3][..., [2, 1, 0]] \
                .transpose(2, 0, 1).astype(np.float32) / 255.0
            out["mask_syn"] = (rgba[..., 3] > 0).astype(np.float32)
            if gan:
                nocs = cv2.imread(self._file(i, "nocs" + loop,
                                             f"{frame:06d}.png"), -1)
                out["nocs_pred"] = _smooth_geo(
                    nocs.astype(np.float32)[..., [2, 1, 0]] / 255.0) \
                    .transpose(2, 0, 1)
                normal = np.load(self._file(i, "normal" + loop,
                                            f"{frame:06d}.npz"),
                                 allow_pickle=True)["data"]
                out["normal_pred"] = _smooth_geo(normal).transpose(
                    2, 0, 1).astype(np.float32)
        return out

    def stacked(self):
        got = [self.sample(i) for i in range(len(self))]
        return {k: np.stack([s[k] for s in got]) for k in got[0]}
