"""LineMOD syn2real full-frame dataset: the evaluation/export path that
serves 480×640 (resizable) frames instead of crops.

Capability parity with the reference TexPose code, data/lmsyn2real.py:
  * full-frame image resize to (W,H) (:133-145)
  * intrinsics simple rescale with +0.5 pixel-center convention (:328-338)
  * masks: visible (train) / full (test) with the scene_vis depth-mask mode
    (:165-237)
  * z_near/z_far: box npz resized full-frame / render / constant (:239-290)
  * GT pose always; predicted pose for train (:307-326)
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import cv2

from . import bop


class LineMODSyn2RealDataset:
    raw_H, raw_W = 480, 640

    def __init__(self, cfg, split="test", subset=None, multi_obj=False,
                 splits_root="splits"):
        self.cfg = cfg
        self.split = split
        self.multi_obj = multi_obj
        self.H, self.W = cfg.H, cfg.W
        if cfg.data.get("raw_size"):
            self.raw_H, self.raw_W = cfg.data.raw_size
        self.raw_hw = (self.raw_H, self.raw_W)
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

    def _line(self, idx):
        return bop.split_line(self.list[idx])

    def _obj_scene_id(self, idx):
        model_name, _, frame = self._line(idx)
        if self.multi_obj:
            return int(self.meta["scene_obj"][str(frame)][model_name])
        return 0

    def get_image(self, idx, obj_scene_id=0):
        _, folder, frame = self._line(idx)
        fname = os.path.join(self.data_path, folder, "rgb", f"{frame:06d}.png")
        img = cv2.imread(fname, -1)[:, :, [2, 1, 0]]
        img = cv2.resize(img, (self.W, self.H))
        return img.transpose(2, 0, 1).astype(np.float32) / 255.0

    def get_obj_mask(self, idx, return_visib=True, obj_scene_id=0):
        cfg = self.cfg
        _, folder, frame = self._line(idx)
        file = f"{frame:06d}_{obj_scene_id:06d}.png"
        if cfg.data.scene == "scene_vis":
            depth = cv2.imread(os.path.join(self.data_path, folder, "depth",
                                            f"{frame:06d}.png"), -1) / 1000.0
            depth = cv2.resize(depth, (self.W, self.H))
            mask_full = (depth > 0).astype(np.float32)
        else:
            mask_full = cv2.imread(
                os.path.join(self.data_path, folder, "mask_visib", file), -1)
            mask_full = cv2.resize(mask_full, (self.W, self.H)).astype(np.float32)
        if self.split == "train":
            mask_visib = cv2.imread(
                os.path.join(self.data_path, folder, "mask_visib", file), -1)
            mask_visib = cv2.resize(mask_visib, (self.W, self.H)).astype(np.float32)
            mask = mask_visib > 0
        else:
            mask = mask_full > 0
        return mask.astype(np.float32)

    def get_depth(self, idx, obj_scene_id=0):
        _, folder, frame = self._line(idx)
        depth = cv2.imread(os.path.join(self.data_path, folder, "depth",
                                        f"{frame:06d}.png"), -1) / 1000.0
        depth = cv2.resize(depth, (self.W, self.H)).astype(np.float32)
        mask = self.get_obj_mask(idx, obj_scene_id=obj_scene_id)
        return depth * self.cfg.nerf.depth.scale * mask

    def get_range(self, idx, obj_scene_id=0):
        cfg = self.cfg
        _, folder, frame = self._line(idx)
        lo, hi = cfg.nerf.depth.range
        zscale = cfg.nerf.depth.scale
        bg_lo = np.full(self.H * self.W, lo * zscale, np.float32)
        bg_hi = np.full(self.H * self.W, hi * zscale, np.float32)
        source = cfg.nerf.depth.get("range_source")
        if source == "box":
            if cfg.data.pose_source == "predicted" and self.split == "train":
                box_source = cfg.nerf.depth.box_source
            else:
                box_source = "gt_box"
            if self.multi_obj:
                file = f"{frame:06d}_{obj_scene_id:06d}.npz"
            else:
                file = f"{frame:06d}.npz"
            box = np.load(os.path.join(self.data_path, folder, box_source,
                                       file))["data"].astype(np.float32)
            box = cv2.resize(box.transpose(1, 2, 0), (self.W, self.H))
            if cfg.nerf.depth.get("box_mask"):
                mask = self.get_obj_mask(idx, return_visib=False,
                                         obj_scene_id=obj_scene_id)
                box = box * mask[..., None]
            box = box.transpose(2, 0, 1).reshape(2, -1) / 1000.0 * zscale
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

    def get_camera(self, idx, obj_scene_id=0):
        cfg = self.cfg
        _, folder, frame = self._line(idx)
        K = bop.parse_intrinsics(self.meta["scene_cam"][str(frame)]).copy()
        resize = self.H / self.raw_H
        # "+0.5 pixel-center" rescale (reference lmsyn2real.py:328-338)
        K[0, 0] *= resize
        K[1, 1] *= resize
        K[0, 2] = (K[0, 2] + 0.5) * resize - 0.5
        K[1, 2] = (K[1, 2] + 0.5) * resize - 0.5
        zscale = cfg.nerf.depth.scale
        pose_gt = bop.parse_pose(self.meta["scene_gt"][str(frame)][obj_scene_id],
                                 zscale)
        if self.split == "train" and cfg.data.pose_source == "predicted" \
                and "scene_pred" in self.meta and idx != 0:
            # idx 0 stays on its GT pose — the reference pins image 0 as
            # the gauge anchor for pose-noisy syn2real training
            # (data/lmsyn2real.py:322 `... if idx != 0 else pose_gt`)
            pose_init = bop.parse_pose(
                self.meta["scene_pred"][str(frame)][obj_scene_id], zscale)
        else:
            pose_init = pose_gt
        return K, pose_gt, pose_init

    def __getitem__(self, idx):
        obj_scene_id = self._obj_scene_id(idx)
        _, _, frame = self._line(idx)
        intr, pose_gt, pose_init = self.get_camera(idx, obj_scene_id)
        z_near, z_far = self.get_range(idx, obj_scene_id)
        return dict(idx=np.int32(idx),
                    image=self.get_image(idx, obj_scene_id),
                    intr=intr.astype(np.float32), pose=pose_gt,
                    pose_init=pose_init, z_near=z_near, z_far=z_far,
                    obj_mask=self.get_obj_mask(idx, obj_scene_id=obj_scene_id),
                    frame_index=np.int32(frame))

    def get_all_camera_poses(self, source="gt"):
        scene = self.meta["scene_gt"] if source == "gt" \
            else self.meta["scene_pred"]
        poses = []
        for idx in range(len(self)):
            _, _, frame = self._line(idx)
            poses.append(bop.parse_pose(scene[str(frame)][self._obj_scene_id(idx)],
                                        self.cfg.nerf.depth.scale))
        return np.stack(poses, axis=0)

    def prefetch_all(self, num_threads=4):
        with ThreadPoolExecutor(max_workers=num_threads) as ex:
            samples = list(ex.map(self.__getitem__, range(len(self))))
        keys = samples[0].keys()
        return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}
