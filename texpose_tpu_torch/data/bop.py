"""BOP-format scene metadata parsing (host-side).

Capability parity with the json handling in the reference TexPose code, data/lm.py:38-110:
scene_gt / scene_camera / scene_gt_info / scene_pred_<loop> / scene_object
files, pose parsing (mm → m → ×depth scale), per-frame camera intrinsics.
"""

from __future__ import annotations

import json
import os

import numpy as np


def read_json(path):
    with open(path) as f:
        return json.load(f)


def readlines(path):
    with open(path) as f:
        return [ln.strip() for ln in f.readlines() if ln.strip()]


def resolve_splits_root(splits_root):
    """Resolve a splits tree: the configured path if it exists, else the
    split assets shipped at the repo root (imported from the reference's
    splits/lm/** — dataset index files, 13 LineMOD objects x 3 scenes).
    An EXPLICITLY configured but missing path is loud: silently training on
    the shipped lists instead of the user's would be wrong data."""
    if splits_root and os.path.isdir(str(splits_root)):
        return str(splits_root)
    shipped = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "splits")
    if splits_root and os.path.isdir(shipped):
        from ..utils.log import log
        log.warn(f"data.splits_root={splits_root} does not exist — "
                 f"falling back to the shipped split assets at {shipped}")
    return shipped if os.path.isdir(shipped) else str(splits_root)


def load_scene_meta(data_path, folder, pose_loop=None, pose_source="gt",
                    scene_info_source=None, split="train", multi_obj=False):
    """Load every scene json the reference reads (data/lm.py:38-80).

    Returns dict with keys scene_gt, scene_cam, scene_info, scene_pred (opt),
    scene_obj (opt).
    """
    base = os.path.join(data_path, folder)
    meta = {
        "scene_gt": read_json(os.path.join(base, "scene_gt.json")),
        "scene_cam": read_json(os.path.join(base, "scene_camera.json")),
    }
    if split != "test" and pose_source == "predicted":
        if scene_info_source is None:
            info_name = "scene_pred_info.json"
        else:
            info_name = {"gt": "scene_gt_info.json",
                         "predicted": "scene_pred_info.json"}[scene_info_source]
    else:
        info_name = "scene_gt_info.json"
    meta["scene_info"] = read_json(os.path.join(base, info_name))
    if split == "train" and pose_source == "predicted":
        meta["scene_pred"] = read_json(
            os.path.join(base, f"scene_pred_{pose_loop}.json"))
    if multi_obj:
        meta["scene_obj"] = read_json(os.path.join(base, "scene_object.json"))
    return meta


def parse_pose(entry, depth_scale=1.0):
    """BOP pose entry {cam_R_m2c, cam_t_m2c[mm]} → [3,4] world→cam with
    translation in meters × depth_scale (reference lm.py:381-409)."""
    R = np.array(entry["cam_R_m2c"], np.float32).reshape(3, 3)
    t = np.array(entry["cam_t_m2c"], np.float32) / 1000.0 * depth_scale
    return np.concatenate([R, t[:, None]], axis=1)


def parse_intrinsics(cam_entry):
    return np.array(cam_entry["cam_K"], np.float32).reshape(3, 3)


def split_line(line):
    """'<obj> <folder> <frame>' → (obj, folder, frame_index)."""
    tok = line.split()
    return tok[0], tok[1], int(tok[2])
