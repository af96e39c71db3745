"""Ray-box calibration preprocessing CLI of the PyTorch port (port of the
JAX package's top-level ``compute_box.py``).

For every frame of a split, intersect the per-pixel camera rays with the
square-ified, enlarged CAD AABB on the device and save the (t_near, t_far)
bounds as <target_folder>/<box_dir>/<frame>.npz, float32 [2,H,W] in mm
ray-parameter units (0 where the ray misses the box).  Box construction:
the AABB expanded by model.scale/6 along each axis on both sides, then
inflated 25% along its diagonal.

Usage:
    python -m texpose_tpu_torch.compute_box --data_root dataset/lm \\
        --folder 000009 --split_file splits/lm/duck/scene_all/train.txt \\
        --cad_path dataset/lm/models/obj_000009.ply \\
        --pred_loop init_calib [--use_gt_pose] [--vis] [--device=cpu]

``--device`` defaults to cuda; with no card visible the run raises unless
``--device=cpu`` is given.  ``--vis`` needs matplotlib and raises before
any frame is processed when it is missing.
"""

import argparse
import json
import os

import numpy as np
import torch

from .data import bop
from .data.cad import CADModel
from .geometry.rays import (aabb_ray_intersection, enlarge_diagonal,
                            get_center_and_ray)
from .models.base import resolve_device


def squareify_aabb(model, device, scale_factor=6.0, enlarge=0.25):
    """±scale/6 per axis, then 25% along the diagonal → (min [3], max [3])
    float32 tensors on ``device``."""
    mn, mx = model.aabb
    mn = torch.as_tensor(mn - model.scale / scale_factor, device=device)
    mx = torch.as_tensor(mx + model.scale / scale_factor, device=device)
    return enlarge_diagonal(mn, mx, enlarge)


def frame_box(aabb_min, aabb_max, pose, K, H, W):
    """One frame's bounds: pose [3,4], K [3,3] (numpy, mm) → [2,H,W]
    float32 numpy (t_near, t_far; 0 where the ray misses)."""
    dev = aabb_min.device
    ray_o, ray_d = get_center_and_ray(torch.as_tensor(pose[None], device=dev),
                                      torch.as_tensor(K[None], device=dev),
                                      H, W)
    t_near, t_far, valid = aabb_ray_intersection(aabb_min, aabb_max, ray_o,
                                                 ray_d)
    box = torch.stack([torch.where(valid, t_near, 0.0).reshape(H, W),
                       torch.where(valid, t_far, 0.0).reshape(H, W)])
    return box.float().cpu().numpy()


def parse_options(argv=None):
    p = argparse.ArgumentParser(description="ray-box calibration")
    p.add_argument("--data_root", required=True,
                   help="BOP dataset root (contains the scene folder)")
    p.add_argument("--folder", required=True, help="scene folder, e.g. 000009")
    p.add_argument("--split_file", required=True)
    p.add_argument("--cad_path", required=True)
    p.add_argument("--pred_loop", default="init")
    p.add_argument("--use_gt_pose", action="store_true",
                   help="use GT poses (writes gt_box/) instead of predicted")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--target_folder", default=None,
                   help="output root (default: <data_root>/<folder>)")
    p.add_argument("--multi_obj", action="store_true")
    p.add_argument("--vis", action="store_true",
                   help="dump a QA overlay PNG for the last frame: CAD depth "
                        "rendered at the same pose vs the ray-box bounds")
    p.add_argument("--device", default="cuda",
                   help="torch device of the ray-box work and the --vis "
                        "render (default cuda)")
    return p.parse_args(argv)


def render_depth(model, pose, K, H, W, device):
    """CAD depth [H,W] (mm, 0 off the object) at pose [1,3,4], K [1,3,3]
    through the port's MeshRenderer (torch rasterizer on a CUDA device,
    the native one on the CPU)."""
    from .raster import MeshRenderer
    mr = MeshRenderer(model.vertices, model.faces, H=H, W=W, device=device)
    _, depth = mr.render(pose, K, mode="mask", return_depth=True)
    return np.asarray(depth)[0]


def box_violations(depth, box):
    """Object pixels (depth > 0) whose depth falls outside their ray-box
    interval (or whose ray misses the box) → (violation fraction, object
    mask, violation mask)."""
    t_near, t_far = box[0], box[1]
    obj = depth > 0
    bad = obj & ((depth < t_near - 1e-3) | (depth > t_far + 1e-3)
                 | (t_far <= 0))
    return float(bad.sum()) / max(int(obj.sum()), 1), obj, bad


def dump_box_vis(out_png, model, pose, K, box, H, W, device="cpu"):
    """Render CAD depth and overlay it against the computed (t_near,
    t_far): every object pixel's depth must fall inside its ray-box
    interval.  Writes a 4-panel PNG and returns the violation fraction."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    depth = render_depth(model, pose, K, H, W, device)
    frac, obj, bad = box_violations(depth, box)
    t_near, t_far = box[0], box[1]
    fig, axes = plt.subplots(1, 4, figsize=(16, 4))
    for ax, (img, title) in zip(axes, [
            (np.where(obj, depth, np.nan), "CAD depth (mm)"),
            (np.where(t_far > 0, t_near, np.nan), "box t_near"),
            (np.where(t_far > 0, t_far, np.nan), "box t_far"),
            (bad.astype(np.float32), f"violations ({frac:.2%})")]):
        im = ax.imshow(img)
        ax.set_title(title)
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.04)
    fig.tight_layout()
    fig.savefig(out_png, dpi=80)
    plt.close(fig)
    return frac


def main(argv=None):
    opt = parse_options(argv)
    device = resolve_device({"device": opt.device})
    if opt.vis:
        import matplotlib  # noqa: F401  (--vis needs it: fail up front)
    scene_dir = os.path.join(opt.data_root, opt.folder)
    target = opt.target_folder or scene_dir
    model = CADModel(opt.cad_path)
    aabb_min, aabb_max = squareify_aabb(model, device)

    with open(os.path.join(scene_dir, "scene_camera.json")) as f:
        scene_cam = json.load(f)
    with open(os.path.join(scene_dir, "scene_gt.json")) as f:
        scene_gt = json.load(f)
    pred_file = os.path.join(scene_dir, f"scene_pred_{opt.pred_loop}.json")
    scene_pred = None
    if os.path.exists(pred_file):
        with open(pred_file) as f:
            scene_pred = json.load(f)
    scene_obj = None
    if opt.multi_obj:
        with open(os.path.join(scene_dir, "scene_object.json")) as f:
            scene_obj = json.load(f)

    box_dir = "gt_box" if opt.use_gt_pose else f"pred_box_{opt.pred_loop}"
    out_dir = os.path.join(target, box_dir)
    os.makedirs(out_dir, exist_ok=True)

    lines = bop.readlines(opt.split_file)
    last_vis = None
    for line in lines:
        model_name, _, frame = bop.split_line(line)
        obj_scene_id = (int(scene_obj[str(frame)][model_name])
                        if opt.multi_obj else 0)
        source = scene_gt if opt.use_gt_pose else scene_pred
        if source is None:
            raise FileNotFoundError(f"missing {pred_file}")
        rec = source[str(frame)][obj_scene_id]
        R = np.array(rec["cam_R_m2c"], np.float32).reshape(3, 3)
        t = np.array(rec["cam_t_m2c"], np.float32)
        pose = np.concatenate([R, t[:, None]], axis=1)             # mm
        K = np.array(scene_cam[str(frame)]["cam_K"],
                     np.float32).reshape(3, 3)
        box = frame_box(aabb_min, aabb_max, pose, K, opt.height, opt.width)
        if opt.multi_obj:
            fname = f"{frame:06d}_{obj_scene_id:06d}.npz"
        else:
            fname = f"{frame:06d}.npz"
        np.savez_compressed(os.path.join(out_dir, fname), data=box)
        last_vis = (pose[None], K[None], box)
    print(f"wrote {len(lines)} box files to {out_dir}")

    if opt.vis:
        if last_vis is None:
            print("box QA overlay skipped: no frames processed")
            return
        pose, K, box = last_vis
        png = os.path.join(out_dir, "box_vis.png")
        frac = dump_box_vis(png, model, pose, K, box, opt.height, opt.width,
                            device)
        print(f"box QA overlay → {png} (violation fraction {frac:.2%})")


if __name__ == "__main__":
    main()
