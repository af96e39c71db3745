"""The benchmark's data: a fake-BOP tree of an analytically ray-traced
textured sphere, in the on-disk layout the port's LineMOD loaders read.

A copy of ``texpose_tpu_torch/data/fixture.py``'s ``generate_fixture`` (and
of the crop helpers it calls), so that the yardstick does not move with the
program.  What differs: every seed places the cameras on its own orbit (a
seeded phase and elevation offset) and lights each view on its own, so a
seed changes the data but not its sizes; the CAD model, which no loader of
a benchmarked path reads, is not written; the frames are rendered and
written on a few threads (every draw made first, in one order), and the
box maps saved compressed.  ``cycle_test_split`` is
``tools/eval_envelope.py``'s ``long_split``: the test lines cycled to n.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np

RAW_H, RAW_W = 480, 640
THREADS = 4                     # frames rendered and written at a time
CAM_K = np.array([[572.4114, 0.0, 325.2611],
                  [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]], np.float64)


def _orbit_pose(theta, phi, dist_mm):
    """Camera on a sphere of radius dist_mm looking at the origin → [3,4]
    world→cam in mm."""
    cz = np.array([np.cos(phi) * np.cos(theta),
                   np.cos(phi) * np.sin(theta),
                   np.sin(phi)])
    cam_pos = cz * dist_mm
    z_axis = -cz
    up = np.array([0.0, 0.0, 1.0])
    if abs(z_axis @ up) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    x_axis = np.cross(up, z_axis)
    x_axis /= np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    R = np.stack([x_axis, y_axis, z_axis], axis=0)
    t = -R @ cam_pos
    return np.concatenate([R, t[:, None]], axis=1)


def sphere_albedo(p_unit):
    """Procedural RGB texture on the unit sphere [..,3] → [..,3] in [0,1]."""
    x, y, z = p_unit[..., 0], p_unit[..., 1], p_unit[..., 2]
    r = 0.5 + 0.45 * np.sin(6.0 * x) * np.cos(3.0 * y)
    g = 0.5 + 0.45 * np.sin(5.0 * y + 1.3)
    b = 0.5 + 0.45 * np.cos(4.0 * z + 0.7) * np.sin(2.0 * x)
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def _render_sphere(pose, K, H, W, radius_mm, light_dir=None, light_gain=1.0,
                   flat=False):
    """Analytic ray-trace of a sphere at the origin → dict of [H,W,*] maps
    (mm)."""
    R, t = pose[:, :3], pose[:, 3]
    cam_pos = -R.T @ t
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], axis=-1)
    d_cam = pix @ np.linalg.inv(K).T
    d_world = d_cam @ R
    b = 2 * (d_world @ cam_pos)
    c = cam_pos @ cam_pos - radius_mm ** 2
    a = (d_world ** 2).sum(-1)
    disc = b ** 2 - 4 * a * c
    hit = disc > 0
    s = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    p_unit = (cam_pos + s[..., None] * d_world) / radius_mm
    normal_cam = p_unit @ R.T
    depth_mm = np.where(hit, s * d_cam[..., 2], 0.0)
    albedo = sphere_albedo(p_unit)
    if flat:
        shade = np.ones_like(depth_mm)
    else:
        if light_dir is None:
            light_dir = -cam_pos / np.linalg.norm(cam_pos)
        lam = np.clip(-(p_unit @ light_dir), 0.0, 1.0)
        shade = (0.4 + 0.6 * lam) * light_gain
    rgb = np.clip(albedo * shade[..., None], 0.0, 1.0) * hit[..., None]
    nocs = np.clip((p_unit + 1) / 2, 0, 1) * hit[..., None]
    inv = np.where(np.abs(d_world) > 1e-12, 1.0 / d_world, 1e12)
    t0 = (-radius_mm - cam_pos) * inv
    t1 = (radius_mm - cam_pos) * inv
    t_near = np.minimum(t0, t1).max(-1)
    t_far = np.maximum(t0, t1).min(-1)
    box_valid = (t_far > 0) & (t_far > t_near)
    return dict(hit=hit, depth_mm=depth_mm, rgb=rgb, nocs=nocs,
                normal_cam=normal_cam * hit[..., None],
                box_near=np.where(box_valid, t_near * d_cam[..., 2], 0.0),
                box_far=np.where(box_valid, t_far * d_cam[..., 2], 0.0))


def bbox_to_crop(bbox, res):
    """BOP bbox (x, y, h, w) → (center [y,x], scale, resize)."""
    x_ul, y_ul, h, w = bbox
    center = np.array([int(y_ul + h / 2), int(x_ul + w / 2)])
    scale = int(1.5 * max(h, w))
    return center, scale, res / scale


def get_center_offset(center, scale, ht, wd):
    """Optical-center shift for border-clipped crop windows."""
    top = int(center[0] - scale / 2.0 + 0.5)
    lft = int(center[1] - scale / 2.0 + 0.5)
    if max(0, top) == 0:
        h_offset = -top / 2
    elif min(ht, top + int(scale)) == ht:
        h_offset = -(top + int(scale) - ht) / 2
    else:
        h_offset = 0
    if max(0, lft) == 0:
        w_offset = -lft / 2
    elif min(wd, lft + int(scale)) == wd:
        w_offset = -(lft + int(scale) - wd) / 2
    else:
        w_offset = 0
    return np.array([h_offset, w_offset])


def preprocess_intrinsics(cam_K, resize, crop_center, res):
    """K after resize-then-crop; crop_center is (y, x)."""
    K = np.array(cam_K, np.float64).copy()
    K[0, 0] *= resize
    K[1, 1] *= resize
    K[0, 2] = (K[0, 2] + 0.5) * resize - 0.5
    K[1, 2] = (K[1, 2] + 0.5) * resize - 0.5
    top_left = np.asarray(crop_center, np.float64) * resize - res / 2
    K[0, 2] -= top_left[1]
    K[1, 2] -= top_left[0]
    return K.astype(np.float32)


def generate_fixture(root, seed, n_train=16, n_test=1, scene="scene_all",
                     image_scale=1.0, crop_res=128, radius_mm=60.0,
                     dist_mm=400.0, obj="ball", pose_loop="init_calib",
                     pose_noise=0.01):
    """Write the fake BOP tree of seed ``seed`` under ``root`` → root."""
    rng = np.random.default_rng(seed)
    theta0 = 2 * np.pi * rng.random()
    phi0 = 0.2 * rng.random() - 0.1
    H, W = int(RAW_H * image_scale), int(RAW_W * image_scale)
    K = CAM_K.copy()
    K[:2] *= image_scale
    folder = "000001"
    base = os.path.join(root, "lm", folder)
    for sub in ["rgb", "depth", "mask", "mask_visib", "mask_pred_init",
                f"rgbsyn_{pose_loop}", "rgbsyn_GT", f"nocs_{pose_loop}",
                "nocs_GT", f"normal_{pose_loop}", "normal_GT", "gt_box",
                f"pred_box_{pose_loop}"]:
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    n = n_train + n_test
    draws = []                       # every frame's draws, in one order
    for i in range(n):
        light_gain = 0.8 + 0.4 * rng.random()
        light_dir = rng.normal(size=3)
        bg = 0.15 + 0.1 * rng.random(3)
        w = rng.normal(0, pose_noise, 3)
        draws.append((light_gain, light_dir, bg, w,
                      rng.normal(0, pose_noise * dist_mm * 0.05, 3)))

    def frame(i):
        light_gain, light_dir, bg, w, t_noise = draws[i]
        theta = theta0 + 2 * np.pi * i / n
        phi = 0.35 + phi0 + 0.25 * np.sin(3 * theta)
        pose = _orbit_pose(theta, phi, dist_mm)
        light_dir = -np.abs(light_dir) / np.linalg.norm(light_dir)
        r = _render_sphere(pose, K, H, W, radius_mm, light_dir, light_gain)
        rgb = r["rgb"] + (~r["hit"])[..., None] * bg
        cv2.imwrite(os.path.join(base, "rgb", f"{i:06d}.png"),
                    (rgb[..., ::-1] * 255).astype(np.uint8))
        cv2.imwrite(os.path.join(base, "depth", f"{i:06d}.png"),
                    r["depth_mm"].astype(np.uint16))
        mask = (r["hit"] * 255).astype(np.uint8)
        for mdir in ("mask", "mask_visib", "mask_pred_init"):
            cv2.imwrite(os.path.join(base, mdir, f"{i:06d}_000000.png"), mask)
        box = np.stack([r["box_near"], r["box_far"]], 0).astype(np.float32)
        for bdir in ("gt_box", f"pred_box_{pose_loop}"):
            np.savez_compressed(os.path.join(base, bdir, f"{i:06d}.npz"),
                                data=box)

        ys, xs = np.nonzero(r["hit"])
        x0, y0 = int(xs.min()), int(ys.min())
        bw, bh = int(xs.max() - x0 + 1), int(ys.max() - y0 + 1)
        th = np.linalg.norm(w)
        kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        Rn = (np.eye(3) + np.sin(th) / max(th, 1e-8) * kx
              + (1 - np.cos(th)) / max(th, 1e-8) ** 2 * kx @ kx)
        pose_n = pose.copy()
        pose_n[:, :3] = Rn @ pose[:, :3]
        pose_n[:, 3] = pose[:, 3] + t_noise
        center, cscale, resize = bbox_to_crop([x0, y0, bw, bh], crop_res)
        coff = get_center_offset(center, cscale, H, W)
        K_crop = preprocess_intrinsics(K, resize, center + coff, crop_res)
        for pose_render, suffix in [(pose, "GT"), (pose_n, pose_loop)]:
            rc = _render_sphere(pose_render, K_crop.astype(np.float64),
                                crop_res, crop_res, radius_mm, flat=True)
            mask_c = (rc["hit"] * 255).astype(np.uint8)
            rgba = np.concatenate([rc["rgb"][..., ::-1] * 255,
                                   mask_c[..., None]], axis=-1).astype(
                                       np.uint8)
            cv2.imwrite(os.path.join(base, f"rgbsyn_{suffix}",
                                     f"{i:06d}.png"), rgba)
            cv2.imwrite(os.path.join(base, f"nocs_{suffix}", f"{i:06d}.png"),
                        (rc["nocs"][..., ::-1] * 255).astype(np.uint8))
            np.savez(os.path.join(base, f"normal_{suffix}", f"{i:06d}.npz"),
                     data=rc["normal_cam"].astype(np.float32))
        return pose, pose_n, [x0, y0, bw, bh]

    with ThreadPoolExecutor(max_workers=THREADS) as ex:
        frames = list(ex.map(frame, range(n)))
    scene_gt, scene_cam, scene_info, scene_pred = {}, {}, {}, {}
    for i, (pose, pose_n, bbox) in enumerate(frames):
        scene_gt[str(i)] = [{"cam_R_m2c": pose[:, :3].reshape(-1).tolist(),
                             "cam_t_m2c": pose[:, 3].tolist(), "obj_id": 1}]
        scene_cam[str(i)] = {"cam_K": K.reshape(-1).tolist(),
                             "depth_scale": 1.0}
        scene_info[str(i)] = [{"bbox_obj": bbox, "bbox_visib": bbox}]
        scene_pred[str(i)] = [{"cam_R_m2c": pose_n[:, :3].reshape(-1).tolist(),
                               "cam_t_m2c": pose_n[:, 3].tolist(),
                               "obj_id": 1}]

    for name, obj_json in [("scene_gt.json", scene_gt),
                           ("scene_camera.json", scene_cam),
                           ("scene_gt_info.json", scene_info),
                           ("scene_pred_info.json", scene_info),
                           (f"scene_pred_{pose_loop}.json", scene_pred)]:
        with open(os.path.join(base, name), "w") as f:
            json.dump(obj_json, f)

    split_dir = os.path.join(root, "splits", "lm", obj, scene)
    os.makedirs(split_dir, exist_ok=True)
    lines_train = [f"{obj} {folder} {i}" for i in range(n_train)]
    lines_test = [f"{obj} {folder} {i}" for i in range(n_train, n)]
    with open(os.path.join(split_dir, "train.txt"), "w") as f:
        f.write("\n".join(lines_train) + "\n")
    with open(os.path.join(split_dir, "val.txt"), "w") as f:
        f.write(lines_test[0] + "\n")
    with open(os.path.join(split_dir, "test.txt"), "w") as f:
        f.write("\n".join(lines_test) + "\n")
    return root


def cycle_test_split(root, scene, n, obj="ball"):
    """The scene's test lines cycled to n lines as scene ``<scene>_x<n>``
    (the same frames on disk; every index runs the whole per-frame
    pipeline), its train and val splits copied → the new scene's name."""
    src = os.path.join(root, "splits", "lm", obj, scene)
    name = f"{scene}_x{n}"
    dst = os.path.join(root, "splits", "lm", obj, name)
    os.makedirs(dst, exist_ok=True)
    lines = [ln for ln in open(os.path.join(src, "test.txt")) if ln.strip()]
    with open(os.path.join(dst, "test.txt"), "w") as f:
        for i in range(n):
            f.write(lines[i % len(lines)])
    for split in ("train.txt", "val.txt"):
        with open(os.path.join(src, split)) as fi, \
                open(os.path.join(dst, split), "w") as fo:
            fo.write(fi.read())
    return name


def cached_fixture(cache_root, seed, params):
    """The fixture of ``seed`` and ``params`` (generate_fixture's keyword
    arguments) under ``cache_root/<seed>``, generated there on the first
    call and reused after: the directory holds ``params.json`` once it is
    whole (a cut run leaves only ``<seed>.part``, cleared on the next)."""
    root = os.path.join(cache_root, str(int(seed)))
    stamp = os.path.join(root, "params.json")
    want = json.dumps(params, sort_keys=True)
    if os.path.exists(stamp):
        with open(stamp) as f:
            if f.read() == want:
                return root
    part = root + ".part"
    for d in (part, root):
        shutil.rmtree(d, ignore_errors=True)
    generate_fixture(part, seed, **params)
    with open(os.path.join(part, "params.json"), "w") as f:
        f.write(want)
    os.replace(part, root)
    return root


def cell_data(spec, seed, workdir):
    """The cell's fixture for ``seed``: from the cell's cache directory
    (``spec["cache"]``, inside the checkout) where it names one, else
    generated under ``workdir``."""
    params = spec["workload"]["traffic"]["fixture"]
    if spec.get("cache"):
        return cached_fixture(spec["cache"], seed, params)
    return generate_fixture(os.path.join(workdir, "data"), seed, **params)
