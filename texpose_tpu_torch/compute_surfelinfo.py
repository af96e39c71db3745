"""Surfel-info preprocessing CLI of the PyTorch port (port of the JAX
package's top-level ``compute_surfelinfo.py``): render per-frame synthetic
RGB (with alpha), NOCS maps and depth-derived normal maps for the training
split.

Per train frame, the CAD mesh is rendered under the predicted pose at the
crop intrinsics by the port's MeshRenderer on ``--device`` (the PyTorch
rasterizer on a CUDA device; ``--device=cpu`` uses the native C++ one) and
written as
    rgbsyn_<loop>/<frame>.png   (RGBA, alpha = depth>0)
    nocs_<loop>/<frame>.png
    normal_<loop>/<frame>.npz   (float32 [H,W,3], normal_from_depth)

Usage (the options system's flags, as the JAX CLI):
    python -m texpose_tpu_torch.compute_surfelinfo \\
        --yaml=configs/nerf_lm_adapt_gan.yaml --data.root=... \\
        --data.object=duck --data.pose_loop=init_calib \\
        --render.geo_save_dir=... [--device=cpu]

``--device`` defaults to cuda; with no card visible the run raises unless
``--device=cpu`` is given.
"""

import os

import cv2
import numpy as np

from .data.lm import LineMODDataset
from .data.ply import load_ply
from .models.base import resolve_device
from .raster import MeshRenderer, normal_from_depth
from .utils.config import set_options
from .utils.log import log

LM_NAME2ID = {
    "ape": 1, "benchvise": 2, "bowl": 3, "camera": 4, "can": 5, "cat": 6,
    "cup": 7, "driller": 8, "duck": 9, "eggbox": 10, "glue": 11,
    "holepuncher": 12, "iron": 13, "lamp": 14, "phone": 15}


def compute_surfelinfo(cfg, backend="auto"):
    """Write the three surfel directories for cfg's train split; returns
    the directory they are under."""
    assert cfg.data.pose_source == "predicted", \
        "surfel info is rendered under predicted poses"
    device = resolve_device(cfg)
    obj = cfg.data.object
    object_id = LM_NAME2ID.get(str(obj), obj)
    cad_path = cfg.get("cad_path") or os.path.join(
        cfg.data.root, cfg.data.dataset, "models",
        f"obj_{int(object_id):06d}.ply")
    mesh = load_ply(cad_path)
    renderer = MeshRenderer(mesh["vertices"], mesh["faces"],
                            colors=mesh["colors"], H=cfg.H, W=cfg.W,
                            backend=backend, device=device)
    log.info(f"rasterizer backend: {renderer.backend} on {device}; mesh "
             f"{len(mesh['vertices'])} verts / {len(mesh['faces'])} faces")

    ds = LineMODDataset(cfg, split="train",
                        subset=cfg.data.get("train_sub"),
                        multi_obj=cfg.data.get("multi_obj", False),
                        splits_root=cfg.data.get("splits_root", "splits"))
    loop = cfg.data.pose_loop
    save_dir = cfg.render.get("geo_save_dir") or os.path.join(
        cfg.data.root, cfg.data.dataset,
        os.path.dirname(ds.list[0].split()[1]) or "")
    for sub in (f"rgbsyn_{loop}", f"nocs_{loop}", f"normal_{loop}"):
        os.makedirs(os.path.join(save_dir, sub), exist_ok=True)

    zscale = cfg.nerf.depth.scale
    for idx in range(len(ds)):
        obj_scene_id = ds._obj_scene_id(idx)
        _, _, frame = ds._line(idx)
        _, intr, _, pose_init = ds.get_camera(idx, obj_scene_id)
        pose_mm = pose_init.copy()
        pose_mm[:, 3] = pose_mm[:, 3] * 1000.0 / zscale       # back to mm
        rgb, depth = renderer.render(pose_mm[None], intr, mode="color")
        nocs, _ = renderer.render(pose_mm[None], intr, mode="nocs")
        normal = normal_from_depth(pose_mm, depth[0], intr, cfg.H, cfg.W)

        alpha = (depth[0] > 0).astype(np.float32)[..., None]
        rgba = np.concatenate([rgb[0][..., ::-1], alpha], axis=-1)
        fname = f"{frame:06d}.png" if not cfg.data.get("multi_obj") else \
            f"{frame:06d}_{obj_scene_id:06d}.png"
        cv2.imwrite(os.path.join(save_dir, f"rgbsyn_{loop}", fname),
                    (rgba * 255).astype(np.uint8))
        cv2.imwrite(os.path.join(save_dir, f"nocs_{loop}", fname),
                    (nocs[0][..., ::-1] * 255).astype(np.uint8))
        np.savez_compressed(
            os.path.join(save_dir, f"normal_{loop}",
                         fname.replace(".png", ".npz")),
            data=normal.astype(np.float32))
    log.info(f"wrote surfel info for {len(ds)} frames to {save_dir}")
    return save_dir


def main(argv=None):
    return compute_surfelinfo(set_options(argv))


if __name__ == "__main__":
    main()
