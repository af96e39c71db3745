"""LineMOD crop dataset: BOP tree → per-frame square crops as numpy pytrees.

Capability parity with the reference TexPose code, data/lm.py (the 128×128 crop pipeline):
  * split txt lines '<obj> <folder> <frame>'
  * bbox → 1.5×-scaled square crop with CDPN Crop_by_Pad + intrinsics fixup
  * GT + predicted pose (meters × nerf.depth.scale)
  * visible/full/eroded masks, predicted-mask source option
  * per-pixel z_near/z_far from box npz / depth render / constant range
  * synthetic RGBA + NOCS + normal maps with edge smoothing
  * whole-split prefetch into one stacked pytree (the reference trains from
    an all-in-memory batch: model/nerf_pretrain.py:91-92)

Samples are plain numpy dicts; `prefetch_all` stacks them once and the
engine uploads the stack in one go — no per-step host→device traffic, no
DataLoader workers (this pipeline is read-once).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import cv2

from . import bop
from .crops import (bbox_to_crop, crop_by_pad, get_center_offset,
                    preprocess_intrinsics, smooth_geo, erode_mask)


class LineMODDataset:
    raw_H, raw_W = 480, 640

    def __init__(self, cfg, split="train", subset=None, multi_obj=False,
                 splits_root="splits"):
        self.cfg = cfg
        self.split = split
        self.multi_obj = multi_obj
        self.H, self.W = cfg.H, cfg.W
        if cfg.data.get("raw_size"):
            self.raw_H, self.raw_W = cfg.data.raw_size
        self.data_path = os.path.join(cfg.data.root, cfg.data.dataset)
        split_path = os.path.join(bop.resolve_splits_root(splits_root),
                                  cfg.data.dataset,
                                  str(cfg.data.object), cfg.data.scene,
                                  f"{split}.txt")
        self.list = bop.readlines(split_path)
        if subset:
            self.list = self.list[:subset]
        folder = bop.split_line(self.list[0])[1]
        self.meta = bop.load_scene_meta(
            self.data_path, folder,
            pose_loop=cfg.data.get("pose_loop"),
            pose_source=cfg.data.get("pose_source", "gt"),
            scene_info_source=cfg.data.get("scene_info_source"),
            split=split, multi_obj=multi_obj)

    def __len__(self):
        return len(self.list)

    # ------------------------------------------------------------- helpers

    def _line(self, idx):
        return bop.split_line(self.list[idx])

    def _obj_scene_id(self, idx):
        model_name, _, frame = self._line(idx)
        if self.multi_obj:
            return int(self.meta["scene_obj"][str(frame)][model_name])
        return 0

    def _crop_params(self, idx, obj_scene_id):
        _, _, frame = self._line(idx)
        assert self.H == self.W, "crop pipeline requires square target"
        bbox = self.meta["scene_info"][str(frame)][obj_scene_id]["bbox_obj"]
        return bbox_to_crop(bbox, self.H, self.cfg.data.get("box_format"))

    def _frame_file(self, idx, obj_scene_id, ext):
        _, _, frame = self._line(idx)
        if self.multi_obj:
            return f"{frame:06d}_{obj_scene_id:06d}{ext}"
        return f"{frame:06d}{ext}"

    # -------------------------------------------------------------- loaders

    def get_image(self, idx, obj_scene_id=0):
        _, folder, frame = self._line(idx)
        fname = os.path.join(self.data_path, folder, "rgb", f"{frame:06d}.png")
        center, scale, _ = self._crop_params(idx, obj_scene_id)
        img = cv2.imread(fname, -1)[:, :, [2, 1, 0]]
        img = crop_by_pad(img, center, scale, self.H, channel=3).astype(np.uint8)
        return img.transpose(2, 0, 1).astype(np.float32) / 255.0       # [3,H,W]

    def get_camera(self, idx, obj_scene_id=0):
        _, folder, frame = self._line(idx)
        center, scale, resize = self._crop_params(idx, obj_scene_id)
        center_offset = get_center_offset(center, scale, self.raw_H, self.raw_W)
        cam_K = bop.parse_intrinsics(self.meta["scene_cam"][str(frame)])
        intr = preprocess_intrinsics(cam_K, resize, center + center_offset,
                                     self.H)
        zscale = self.cfg.nerf.depth.scale
        pose_gt = bop.parse_pose(self.meta["scene_gt"][str(frame)][obj_scene_id],
                                 zscale)
        if self.split == "train" and self.cfg.data.pose_source == "predicted":
            pose_init = bop.parse_pose(
                self.meta["scene_pred"][str(frame)][obj_scene_id], zscale)
        else:
            pose_init = pose_gt
        return cam_K, intr, pose_gt, pose_init

    def get_obj_mask(self, idx, return_visib=True, return_erode=False,
                     obj_scene_id=0):
        _, folder, frame = self._line(idx)
        file = f"{frame:06d}_{obj_scene_id:06d}.png"
        center, scale, _ = self._crop_params(idx, obj_scene_id)
        cfg = self.cfg

        mask_full = cv2.imread(os.path.join(self.data_path, folder, "mask", file), -1)
        mask_full = crop_by_pad(mask_full, center, scale, self.H, 1,
                                cv2.INTER_LINEAR).astype(np.float32)
        if self.split == "train":
            visib_source = (cfg.data.get("mask_visib_source") or "mask_visib") \
                if "adapt_st" in str(cfg.get("model", "")) else "mask_visib"
            mask_visib = cv2.imread(
                os.path.join(self.data_path, folder, visib_source, file), -1)
            if mask_visib.shape[0] != self.H:
                mask_visib = crop_by_pad(mask_visib, center, scale, self.H, 1,
                                         cv2.INTER_LINEAR)
            if cfg.data.get("erode_mask"):
                mask_visib = erode_mask(np.squeeze(mask_visib))
            mask = (np.squeeze(mask_visib) > 0).astype(np.float32)
        else:
            mask = (np.squeeze(mask_full) > 0).astype(np.float32)
        if return_erode:
            mask = erode_mask(mask)
        return np.squeeze(mask).astype(np.float32)                      # [H,W]

    def get_depth(self, idx, obj_scene_id=0):
        _, folder, frame = self._line(idx)
        depth_scale = self.meta["scene_cam"][str(frame)]["depth_scale"]
        center, scale, _ = self._crop_params(idx, obj_scene_id)
        depth = cv2.imread(os.path.join(self.data_path, folder, "depth",
                                        f"{frame:06d}.png"), -1) / 1000.0
        depth = crop_by_pad(depth, center, scale, self.H, channel=1).astype(np.float32)
        depth = np.squeeze(depth)
        mask = self.get_obj_mask(idx, obj_scene_id=obj_scene_id)
        return depth * self.cfg.nerf.depth.scale * depth_scale * mask   # [H,W]

    def get_range(self, idx, obj_scene_id=0):
        cfg = self.cfg
        _, folder, frame = self._line(idx)
        lo, hi = cfg.nerf.depth.range
        zscale = cfg.nerf.depth.scale
        bg_lo = np.full(self.H * self.W, lo * zscale, np.float32)
        bg_hi = np.full(self.H * self.W, hi * zscale, np.float32)
        source = cfg.nerf.depth.get("range_source")
        if source == "box":
            if cfg.data.pose_source == "predicted" and self.split in ("train", "val"):
                box_source = cfg.nerf.depth.box_source
            else:
                box_source = "gt_box"
            fname = os.path.join(self.data_path, folder, box_source,
                                 self._frame_file(idx, obj_scene_id, ".npz"))
            box = np.load(fname, allow_pickle=True)["data"].astype(np.float32)
            box = box.transpose(1, 2, 0)                                 # [H,W,2]
            center, scale, _ = self._crop_params(idx, obj_scene_id)
            box = crop_by_pad(box, center, scale, self.H, channel=2).astype(np.float32)
            if cfg.nerf.depth.get("box_mask"):
                mask = self.get_obj_mask(idx, return_visib=False,
                                         obj_scene_id=obj_scene_id)
                box = box * mask[..., None]
            box = box.transpose(2, 0, 1).reshape(2, self.H * self.W)
            box = box / 1000.0 * zscale
            z_near = np.where(box[0] > 0, box[0], bg_lo)
            z_far = np.where(box[1] > 0, box[1], bg_hi)
        elif source == "render":
            d = self.get_depth(idx, obj_scene_id).reshape(-1)
            z_near = np.where(d > 0, d * 0.8, bg_lo)
            z_far = np.where(d > 0, d * 1.2, bg_hi)
        elif source is None:
            z_near, z_far = bg_lo, bg_hi
        else:
            raise NotImplementedError(source)
        return z_near.astype(np.float32), z_far.astype(np.float32)

    def _syn_source(self, prefix):
        cfg = self.cfg
        if cfg.data.pose_source == "predicted" and self.split == "train":
            assert cfg.data.get("pose_loop") is not None
            return f"{prefix}_{cfg.data.pose_loop}"
        return f"{prefix}_GT"

    def get_synthetic_image(self, idx, obj_scene_id=0):
        _, folder, _ = self._line(idx)
        fname = os.path.join(self.data_path, folder, self._syn_source("rgbsyn"),
                             self._frame_file(idx, obj_scene_id, ".png"))
        rgba = cv2.imread(fname, -1)
        image = rgba[..., :3][..., [2, 1, 0]].transpose(2, 0, 1).astype(np.float32) / 255.0
        alpha = (rgba[..., 3] > 0).astype(np.float32)
        return image, alpha

    def get_nocs(self, idx, obj_scene_id=0):
        _, folder, _ = self._line(idx)
        fname = os.path.join(self.data_path, folder, self._syn_source("nocs"),
                             self._frame_file(idx, obj_scene_id, ".png"))
        nocs = cv2.imread(fname, -1).astype(np.float32)[..., [2, 1, 0]]
        nocs = smooth_geo(nocs / 255.0)
        return nocs.transpose(2, 0, 1)

    def get_normal(self, idx, obj_scene_id=0):
        _, folder, _ = self._line(idx)
        fname = os.path.join(self.data_path, folder, self._syn_source("normal"),
                             self._frame_file(idx, obj_scene_id, ".npz"))
        normal = np.load(fname, allow_pickle=True)["data"]
        normal = smooth_geo(normal)
        return normal.transpose(2, 0, 1).astype(np.float32)

    # ------------------------------------------------------------- assembly

    def __getitem__(self, idx):
        cfg = self.cfg
        obj_scene_id = self._obj_scene_id(idx)
        _, _, frame = self._line(idx)
        image = self.get_image(idx, obj_scene_id)
        aug_cfg = cfg.data.get("augment")
        if aug_cfg and self.split == "train":
            # image-only, train-only, like the reference base dataset
            # (data/base.py:75-100; its LM path asserts augment off,
            # data/lm.py:87).  Seeded per (run seed, frame) so threaded
            # prefetch stays deterministic.
            from .augment import generate_augmentation, apply_augmentation
            rng = np.random.default_rng(
                (int(cfg.get("seed") or 0) + 1) * 100003 + idx)
            image = apply_augmentation(image,
                                       generate_augmentation(aug_cfg, rng))
        _, intr, pose_gt, pose_init = self.get_camera(idx, obj_scene_id)
        z_near, z_far = self.get_range(idx, obj_scene_id)
        obj_mask = self.get_obj_mask(idx, obj_scene_id=obj_scene_id)
        if cfg.data.scene != "scene_all":
            depth_gt = self.get_depth(idx, obj_scene_id)
        else:
            depth_gt = np.ones_like(obj_mask)
        if cfg.data.get("bgcolor") is not None:
            image = np.where(obj_mask[None] > 0, image,
                             np.float32(cfg.data.bgcolor))
        sample = dict(idx=np.int32(idx), image=image, intr=intr, pose=pose_gt,
                      pose_init=pose_init, z_near=z_near, z_far=z_far,
                      obj_mask=obj_mask, depth_gt=depth_gt,
                      frame_index=np.int32(frame))
        if cfg.data.get("erode_mask_loss") is not None:
            sample["erode_mask"] = self.get_obj_mask(idx, return_erode=True,
                                                     obj_scene_id=obj_scene_id)
        want_syn = (cfg.get("loss_weight", {}).get("feat") is not None
                    or cfg.get("gan") is not None)
        if want_syn and self.split == "train":
            image_syn, mask_syn = self.get_synthetic_image(idx, obj_scene_id)
            sample.update(image_syn=image_syn, mask_syn=mask_syn)
        if self.split == "train" and cfg.get("gan") is not None:
            sample.update(nocs_pred=self.get_nocs(idx, obj_scene_id),
                          normal_pred=self.get_normal(idx, obj_scene_id))
        return sample

    def get_all_camera_poses(self, source="gt"):
        scene = self.meta["scene_gt"] if source == "gt" else self.meta["scene_pred"]
        poses = []
        for idx in range(len(self)):
            _, _, frame = self._line(idx)
            obj_scene_id = self._obj_scene_id(idx)
            poses.append(bop.parse_pose(scene[str(frame)][obj_scene_id],
                                        self.cfg.nerf.depth.scale))
        return np.stack(poses, axis=0)

    def prefetch_all(self, num_threads=4):
        """Load & stack the whole split into one numpy pytree."""
        with ThreadPoolExecutor(max_workers=num_threads) as ex:
            samples = list(ex.map(self.__getitem__, range(len(self))))
        keys = samples[0].keys()
        return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}
