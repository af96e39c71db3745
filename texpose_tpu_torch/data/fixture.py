"""Fake-BOP fixture: an analytically ray-traced textured sphere written out
in the exact on-disk layout the reference reads (data/lm.py:38-84,182-314),
so datasets/engines/CLIs can be exercised end-to-end without LineMOD.

The scene is a Lambertian sphere with a procedural RGB texture:
  * rgb/         real images (per-frame lighting variation + background)
  * depth/       uint16 mm
  * mask/, mask_visib/   full + visible masks
  * rgbsyn_<loop>/ RGBA flat-albedo synthetic renders
  * nocs_<loop>/  normalized object coordinates
  * normal_<loop>/ camera-space normals (npz)
  * gt_box/ pred_box_<loop>/  per-pixel ray AABB entry/exit (npz, mm)
  * scene_gt/scene_camera/scene_gt_info/scene_pred_<loop> json
  * models/obj_000001.ply icosphere CAD
  * splits/lm/<object>/<scene>/{train,val,test}.txt

Everything is closed-form, so e2e tests have exact geometry to fit.
"""

from __future__ import annotations

import json
import os

import numpy as np
import cv2

from .ply import save_ply

RAW_H, RAW_W = 480, 640
CAM_K = np.array([[572.4114, 0.0, 325.2611],
                  [0.0, 573.57043, 242.04899],
                  [0.0, 0.0, 1.0]], np.float64)


def _orbit_pose(theta, phi, dist_mm):
    """Camera on a sphere of radius dist_mm looking at the origin; returns
    [3,4] world→cam in mm."""
    cz = np.array([np.cos(phi) * np.cos(theta),
                   np.cos(phi) * np.sin(theta),
                   np.sin(phi)])
    cam_pos = cz * dist_mm
    z_axis = -cz                           # camera looks at origin (+z forward)
    up = np.array([0.0, 0.0, 1.0])
    if abs(z_axis @ up) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    x_axis = np.cross(up, z_axis)
    x_axis /= np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    R = np.stack([x_axis, y_axis, z_axis], axis=0)     # world→cam rows
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
                   flat=False, center_mm=None):
    """Analytic ray-trace of a sphere centered at `center_mm` (world, default
    origin). Returns dict of [H,W,*] maps (mm)."""
    R, t = pose[:, :3], pose[:, 3]
    cam_pos = -R.T @ t                                     # world, mm
    if center_mm is not None:
        # shift the world so the sphere sits at the origin of the trace
        cam_pos = cam_pos - np.asarray(center_mm, np.float64)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], axis=-1)
    d_cam = pix @ np.linalg.inv(K).T
    d_world = d_cam @ R                                    # rows: R.T @ d
    # |o + s d|² = r²  with o = cam_pos
    b = 2 * (d_world @ cam_pos)
    c = cam_pos @ cam_pos - radius_mm ** 2
    a = (d_world ** 2).sum(-1)
    disc = b ** 2 - 4 * a * c
    hit = disc > 0
    s = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    p_world = cam_pos + s[..., None] * d_world             # hit points, mm
    p_unit = p_world / radius_mm
    normal_world = p_unit
    normal_cam = normal_world @ R.T
    depth_mm = np.where(hit, s * d_cam[..., 2], 0.0)       # z-depth in mm
    albedo = sphere_albedo(p_unit)
    if flat:
        shade = np.ones_like(depth_mm)
    else:
        if light_dir is None:
            light_dir = -cam_pos / np.linalg.norm(cam_pos)
        lam = np.clip(-(normal_world @ light_dir), 0.0, 1.0)
        shade = (0.4 + 0.6 * lam) * light_gain
    rgb = np.clip(albedo * shade[..., None], 0.0, 1.0) * hit[..., None]
    nocs = np.clip((p_unit + 1) / 2, 0, 1) * hit[..., None]
    # per-pixel AABB (±radius cube) entry/exit along the ray, in mm depth
    inv = np.where(np.abs(d_world) > 1e-12, 1.0 / d_world, 1e12)
    t0 = (-radius_mm - cam_pos) * inv
    t1 = (radius_mm - cam_pos) * inv
    t_near = np.minimum(t0, t1).max(-1)
    t_far = np.maximum(t0, t1).min(-1)
    box_valid = (t_far > 0) & (t_far > t_near)
    box_near = np.where(box_valid, t_near * d_cam[..., 2], 0.0)
    box_far = np.where(box_valid, t_far * d_cam[..., 2], 0.0)
    return dict(hit=hit, depth_mm=depth_mm, rgb=rgb, nocs=nocs,
                normal_cam=normal_cam * hit[..., None],
                box_near=box_near, box_far=box_far)


def _icosphere(radius, subdiv=2):
    """Icosphere mesh (vertices mm, faces) for the CAD ply."""
    t = (1 + 5 ** 0.5) / 2
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                      [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                      [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [v / np.linalg.norm(v) for v in verts]
    cache = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = (verts[i] + verts[j]) / 2
            verts.append(m / np.linalg.norm(m))
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = new_faces
    v = np.asarray(verts) * radius
    return v.astype(np.float32), np.asarray(faces, np.int32)


def generate_fixture(root, n_train=6, n_test=2, radius_mm=60.0,
                     dist_mm=400.0, obj="ball", scene="scene_all",
                     pose_loop="init_calib", pose_noise=0.01, seed=0,
                     H=RAW_H, W=RAW_W, image_scale=1.0, crop_res=128,
                     fixed_light=False):
    """Write the fake BOP tree under `root`.  Returns the data root path.

    image_scale < 1 shrinks frames (and K) for fast tests.  crop_res is the
    side of the precomputed synthetic crops (rgbsyn/nocs/normal) — in the
    real pipeline these are produced by compute_surfelinfo at the training
    crop size and stored already-cropped (reference
    data/lm.py:196-253 loads them without cropping).
    """
    from .crops import bbox_to_crop, get_center_offset, preprocess_intrinsics
    rng = np.random.default_rng(seed)
    H, W = int(H * image_scale), int(W * image_scale)
    K = CAM_K.copy()
    K[:2] *= image_scale
    folder = "000001"
    base = os.path.join(root, "lm", folder)
    for sub in ["rgb", "depth", "mask", "mask_visib", "mask_pred_init",
                f"rgbsyn_{pose_loop}", "rgbsyn_GT", f"nocs_{pose_loop}",
                "nocs_GT", f"normal_{pose_loop}", "normal_GT", "gt_box",
                f"pred_box_{pose_loop}"]:
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "lm", "models"), exist_ok=True)

    n = n_train + n_test
    scene_gt, scene_cam, scene_info, scene_pred = {}, {}, {}, {}
    for i in range(n):
        theta = 2 * np.pi * i / n
        phi = 0.35 + 0.25 * np.sin(3 * theta)
        pose = _orbit_pose(theta, phi, dist_mm)
        if fixed_light:
            # view-consistent lighting (models the synthetic scene_naive
            # renders a view-independent NeRF can actually fit)
            light_gain = 1.0
            light_dir = np.array([0.5, 0.5, -np.sqrt(0.5)])
        else:
            light_gain = 0.8 + 0.4 * rng.random()
            light_dir = None
        r = _render_sphere(pose, K, H, W, radius_mm, light_dir, light_gain)

        bg = 0.15 + 0.1 * rng.random(3)
        rgb = r["rgb"] + (~r["hit"])[..., None] * bg
        cv2.imwrite(os.path.join(base, "rgb", f"{i:06d}.png"),
                    (rgb[..., ::-1] * 255).astype(np.uint8))
        cv2.imwrite(os.path.join(base, "depth", f"{i:06d}.png"),
                    r["depth_mm"].astype(np.uint16))
        mask = (r["hit"] * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(base, "mask", f"{i:06d}_000000.png"), mask)
        cv2.imwrite(os.path.join(base, "mask_visib", f"{i:06d}_000000.png"), mask)
        cv2.imwrite(os.path.join(base, "mask_pred_init", f"{i:06d}_000000.png"), mask)
        box = np.stack([r["box_near"], r["box_far"]], 0).astype(np.float32)
        np.savez(os.path.join(base, "gt_box", f"{i:06d}.npz"), data=box)
        np.savez(os.path.join(base, f"pred_box_{pose_loop}", f"{i:06d}.npz"),
                 data=box)

        ys, xs = np.nonzero(r["hit"])
        x0, y0 = int(xs.min()), int(ys.min())
        bw, bh = int(xs.max() - x0 + 1), int(ys.max() - y0 + 1)
        scene_gt[str(i)] = [{"cam_R_m2c": pose[:, :3].reshape(-1).tolist(),
                             "cam_t_m2c": pose[:, 3].tolist(), "obj_id": 1}]
        scene_cam[str(i)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}
        scene_info[str(i)] = [{"bbox_obj": [x0, y0, bw, bh],
                               "bbox_visib": [x0, y0, bw, bh]}]
        # noisy predicted pose: rotation perturbation + translation jitter
        w = rng.normal(0, pose_noise, 3)
        theta_n = np.linalg.norm(w)
        kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        Rn = (np.eye(3) + np.sin(theta_n) / max(theta_n, 1e-8) * kx
              + (1 - np.cos(theta_n)) / max(theta_n, 1e-8) ** 2 * kx @ kx)
        pose_n = pose.copy()
        pose_n[:, :3] = Rn @ pose[:, :3]
        pose_n[:, 3] = pose[:, 3] + rng.normal(0, pose_noise * dist_mm * 0.05, 3)
        scene_pred[str(i)] = [{"cam_R_m2c": pose_n[:, :3].reshape(-1).tolist(),
                               "cam_t_m2c": pose_n[:, 3].tolist(), "obj_id": 1}]

        # precomputed synthetic crops (rgbsyn/nocs/normal): rendered at the
        # crop intrinsics, GT pose for *_GT and predicted pose for *_<loop>
        center, cscale, resize = bbox_to_crop([x0, y0, bw, bh], crop_res)
        coff = get_center_offset(center, cscale, H, W)
        K_crop = preprocess_intrinsics(K, resize, center + coff, crop_res)
        for pose_render, suffix in [(pose, "GT"), (pose_n, pose_loop)]:
            rc = _render_sphere(pose_render, K_crop.astype(np.float64),
                                crop_res, crop_res, radius_mm, flat=True)
            mask_c = (rc["hit"] * 255).astype(np.uint8)
            rgba = np.concatenate([rc["rgb"][..., ::-1] * 255,
                                   mask_c[..., None]], axis=-1).astype(np.uint8)
            cv2.imwrite(os.path.join(base, f"rgbsyn_{suffix}", f"{i:06d}.png"), rgba)
            cv2.imwrite(os.path.join(base, f"nocs_{suffix}", f"{i:06d}.png"),
                        (rc["nocs"][..., ::-1] * 255).astype(np.uint8))
            np.savez(os.path.join(base, f"normal_{suffix}", f"{i:06d}.npz"),
                     data=rc["normal_cam"].astype(np.float32))

    for name, obj_json in [("scene_gt.json", scene_gt),
                           ("scene_camera.json", scene_cam),
                           ("scene_gt_info.json", scene_info),
                           ("scene_pred_info.json", scene_info),
                           (f"scene_pred_{pose_loop}.json", scene_pred)]:
        with open(os.path.join(base, name), "w") as f:
            json.dump(obj_json, f)

    verts, faces = _icosphere(radius_mm, subdiv=2)
    colors = sphere_albedo(verts / radius_mm)
    save_ply(os.path.join(root, "lm", "models", "obj_000001.ply"),
             verts, faces, colors)

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
    return os.path.join(root)


def generate_fixture_multi(root, n_train=4, n_test=1, radius_mm=60.0,
                           dist_mm=420.0, objs=("ball", "ball2"),
                           scene="scene_multi", pose_loop="init_calib",
                           seed=0, image_scale=0.25, crop_res=32):
    """Two-object fake BOP tree (occlusion-aware): exercises the multi_obj
    branches of the data layer (reference data/lm.py:67-84,100-110 —
    scene_object.json, per-object mask/box/crop file naming).

    Object 0: radius r at the origin; object 1: radius 0.7r offset +x by
    1.6r (partially occluding/occluded depending on view).
    """
    rng = np.random.default_rng(seed)
    H, W = int(RAW_H * image_scale), int(RAW_W * image_scale)
    K = CAM_K.copy()
    K[:2] *= image_scale
    folder = "000001"
    base = os.path.join(root, "lm", folder)
    for sub in ["rgb", "depth", "mask", "mask_visib", "mask_pred_init",
                f"rgbsyn_{pose_loop}", f"nocs_{pose_loop}",
                f"normal_{pose_loop}", "gt_box", f"pred_box_{pose_loop}"]:
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "lm", "models"), exist_ok=True)

    centers = [np.zeros(3), np.array([1.6 * radius_mm, 0.0, 0.0])]
    radii = [radius_mm, 0.7 * radius_mm]

    n = n_train + n_test
    scene_gt, scene_cam, scene_info, scene_pred, scene_obj = {}, {}, {}, {}, {}
    from .crops import bbox_to_crop, get_center_offset, preprocess_intrinsics
    for i in range(n):
        theta = 2 * np.pi * i / n
        phi = 0.3 + 0.2 * np.sin(2 * theta)
        pose = _orbit_pose(theta, phi, dist_mm)
        rs = [_render_sphere(pose, K, H, W, radii[o], flat=False,
                             center_mm=centers[o]) for o in range(2)]
        # occlusion-aware composite by nearest depth
        d0 = np.where(rs[0]["hit"], rs[0]["depth_mm"], np.inf)
        d1 = np.where(rs[1]["hit"], rs[1]["depth_mm"], np.inf)
        front0 = d0 <= d1
        rgb = np.where(front0[..., None], rs[0]["rgb"], rs[1]["rgb"])
        hit_any = rs[0]["hit"] | rs[1]["hit"]
        bg = 0.15 + 0.1 * rng.random(3)
        rgb = rgb + (~hit_any)[..., None] * bg
        depth = np.where(hit_any, np.minimum(d0, d1), 0.0)
        cv2.imwrite(os.path.join(base, "rgb", f"{i:06d}.png"),
                    (np.clip(rgb, 0, 1)[..., ::-1] * 255).astype(np.uint8))
        cv2.imwrite(os.path.join(base, "depth", f"{i:06d}.png"),
                    depth.astype(np.uint16))

        gt_list, info_list, pred_list = [], [], []
        scene_obj[str(i)] = {objs[0]: 0, objs[1]: 1}
        for o in range(2):
            full = rs[o]["hit"]
            visib = full & (front0 if o == 0 else ~front0)
            cv2.imwrite(os.path.join(base, "mask",
                                     f"{i:06d}_{o:06d}.png"),
                        (full * 255).astype(np.uint8))
            for mdir in ("mask_visib", "mask_pred_init"):
                cv2.imwrite(os.path.join(base, mdir,
                                         f"{i:06d}_{o:06d}.png"),
                            (visib * 255).astype(np.uint8))
            box = np.stack([rs[o]["box_near"], rs[o]["box_far"]],
                           0).astype(np.float32)
            for bdir in ("gt_box", f"pred_box_{pose_loop}"):
                np.savez(os.path.join(base, bdir, f"{i:06d}_{o:06d}.npz"),
                         data=box)
            # object pose: model frame centered at centers[o]
            pose_o = pose.copy()
            pose_o[:, 3] = pose[:, :3] @ centers[o] + pose[:, 3]
            ys, xs = np.nonzero(visib if visib.any() else full)
            x0, y0 = int(xs.min()), int(ys.min())
            bw, bh = int(xs.max() - x0 + 1), int(ys.max() - y0 + 1)
            gt_list.append({"cam_R_m2c": pose_o[:, :3].reshape(-1).tolist(),
                            "cam_t_m2c": pose_o[:, 3].tolist(),
                            "obj_id": o + 1})
            pred_list.append(gt_list[-1])
            info_list.append({"bbox_obj": [x0, y0, bw, bh],
                              "bbox_visib": [x0, y0, bw, bh]})
            # per-object synthetic crop (alone, flat shading)
            center, cscale, resize = bbox_to_crop([x0, y0, bw, bh], crop_res)
            coff = get_center_offset(center, cscale, H, W)
            K_crop = preprocess_intrinsics(K, resize, center + coff, crop_res)
            rc = _render_sphere(pose_o, K_crop.astype(np.float64), crop_res,
                                crop_res, radii[o], flat=True)
            mask_c = (rc["hit"] * 255).astype(np.uint8)
            rgba = np.concatenate([rc["rgb"][..., ::-1] * 255,
                                   mask_c[..., None]], axis=-1).astype(np.uint8)
            cv2.imwrite(os.path.join(base, f"rgbsyn_{pose_loop}",
                                     f"{i:06d}_{o:06d}.png"), rgba)
            cv2.imwrite(os.path.join(base, f"nocs_{pose_loop}",
                                     f"{i:06d}_{o:06d}.png"),
                        (rc["nocs"][..., ::-1] * 255).astype(np.uint8))
            np.savez(os.path.join(base, f"normal_{pose_loop}",
                                  f"{i:06d}_{o:06d}.npz"),
                     data=rc["normal_cam"].astype(np.float32))
        scene_gt[str(i)] = gt_list
        scene_info[str(i)] = info_list
        scene_pred[str(i)] = pred_list
        scene_cam[str(i)] = {"cam_K": K.reshape(-1).tolist(),
                             "depth_scale": 1.0}

    for name, obj_json in [("scene_gt.json", scene_gt),
                           ("scene_camera.json", scene_cam),
                           ("scene_gt_info.json", scene_info),
                           ("scene_pred_info.json", scene_info),
                           (f"scene_pred_{pose_loop}.json", scene_pred),
                           ("scene_object.json", scene_obj)]:
        with open(os.path.join(base, name), "w") as f:
            json.dump(obj_json, f)

    for o in range(2):
        verts, faces = _icosphere(radii[o], subdiv=2)
        save_ply(os.path.join(root, "lm", "models",
                              f"obj_{o + 1:06d}.ply"),
                 verts, faces, sphere_albedo(verts / radii[o]))

    for o, obj in enumerate(objs):
        split_dir = os.path.join(root, "splits", "lm", obj, scene)
        os.makedirs(split_dir, exist_ok=True)
        tr = [f"{obj} {folder} {i}" for i in range(n_train)]
        te = [f"{obj} {folder} {i}" for i in range(n_train, n)]
        open(os.path.join(split_dir, "train.txt"), "w").write(
            "\n".join(tr) + "\n")
        open(os.path.join(split_dir, "val.txt"), "w").write(te[0] + "\n")
        open(os.path.join(split_dir, "test.txt"), "w").write(
            "\n".join(te) + "\n")
    return root
