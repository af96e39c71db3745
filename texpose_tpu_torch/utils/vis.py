"""Visualization (port of texpose_tpu/utils/vis.py): image grids,
colormapped heatmaps, the TensorBoard and PNG panel writers, and the
camera-pose plots.

Host numpy, as the JAX package's: a panel is written once per freq.vis,
and numpy keeps the panels bit-equal to JAX's for equal renders.  The
heatmaps need no matplotlib: ``colormaps.npz`` holds matplotlib's 256-entry
tables of plasma, turbo and viridis (written by ``make_colormaps.py``), and
``apply_colormap`` indexes them as ``matplotlib.colors.Colormap`` does.
Only the camera plots draw with matplotlib, imported when they run; where
it is absent they raise ImportError and the caller decides.
"""

from __future__ import annotations

import os

import numpy as np

_TABLES = {}
_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "colormaps.npz")


def colormap_table(name):
    """[256, 3] float64 RGB table of plasma, turbo or viridis."""
    if not _TABLES:
        with np.load(_TABLE_PATH) as f:
            _TABLES.update({k: f[k] for k in f.files})
    if name not in _TABLES:
        raise ValueError(f"colormap {name!r} not in {sorted(_TABLES)}")
    return _TABLES[name]


def apply_colormap(x, name):
    """x (float, nominally in [0, 1]) → x.shape + (3,) float64 RGB, as
    ``matplotlib.colormaps[name](x)[..., :3]``: x·256 in x's own dtype,
    1.0 onto the last bin, truncation toward zero, below 0 the first color
    and from 256 up the last, NaN black (the maps' "bad" color)."""
    xa = np.array(x, copy=True)
    n = 256
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over] = n - 1
    idx[bad] = 0
    rgb = colormap_table(name)[idx]
    rgb[bad] = 0.0
    return rgb


def make_grid(images, num_rows=None, pad=2, pad_value=0.0):
    """[B,C,H,W] in [0,1] → [C, gh, gw] tiled grid (torchvision-style)."""
    images = np.asarray(images)
    B, C, H, W = images.shape
    num_rows = num_rows or int(np.ceil(np.sqrt(B)))
    num_cols = int(np.ceil(B / num_rows))
    grid = np.full((C, num_rows * (H + pad) + pad,
                    num_cols * (W + pad) + pad), pad_value, images.dtype)
    for i in range(B):
        r, c = divmod(i, num_cols)
        y = r * (H + pad) + pad
        x = c * (W + pad) + pad
        grid[:, y:y + H, x:x + W] = images[i]
    return grid


def center_crop(image, size):
    """Center-crop an [H,W,...] array to size × size with torchvision's
    semantics: an image smaller than the crop is zero-padded symmetrically
    first (the scene_vis export crops 256 px out of smaller frames)."""
    h, w = image.shape[:2]
    if h < size or w < size:
        pl = max((size - w) // 2, 0)
        pr = max((size - w + 1) // 2, 0)
        pt = max((size - h) // 2, 0)
        pb = max((size - h + 1) // 2, 0)
        image = np.pad(image, ((pt, pb), (pl, pr)) +
                       ((0, 0),) * (image.ndim - 2))
        h, w = image.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return image[top:top + size, left:left + size]


def preprocess_vis_image(images, from_range=(0.0, 1.0), cmap=None):
    """Normalize [B,C,H,W] by from_range, clip to [0,1], and colormap
    single-channel images → float32."""
    images = np.asarray(images, np.float32)
    lo, hi = float(from_range[0]), float(from_range[1])
    images = (images - lo) / max(hi - lo, 1e-12)
    images = np.clip(images, 0.0, 1.0)
    if cmap is not None and images.shape[1] == 1:
        mapped = apply_colormap(images[:, 0], cmap)            # [B,H,W,3]
        images = mapped.transpose(0, 3, 1, 2).astype(np.float32)
    return images


def tb_image(writer, step, split, name, images, from_range=(0.0, 1.0),
             cmap=None, num_rows=None):
    """Write a tiled image grid to the MetricsWriter's TensorBoard stream
    (a no-op when TensorBoard is off)."""
    images = preprocess_vis_image(images, from_range, cmap)
    grid = make_grid(images, num_rows=num_rows)
    writer.image(step, f"{name}", grid, split=split)


def dump_image_grid(path, images, from_range=(0.0, 1.0), cmap=None):
    """The same grid written as a PNG."""
    import cv2
    images = preprocess_vis_image(images, from_range, cmap)
    grid = make_grid(images).transpose(1, 2, 0)
    if grid.shape[-1] == 1:
        grid = np.repeat(grid, 3, axis=-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, (grid[..., ::-1] * 255).astype(np.uint8))
    return path


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the camera plots need matplotlib, which is not "
                          "installed here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _camera_wireframe(pose, scale=1.0):
    """[3,4] world→camera pose → (frustum vertices in world coordinates
    [5,3], edges): the canonical pyramid pushed through the inverse pose."""
    verts = np.array([[-0.5, -0.5, 1], [0.5, -0.5, 1], [0.5, 0.5, 1],
                      [-0.5, 0.5, 1], [0, 0, 0]]) * scale
    R, t = pose[:, :3], pose[:, 3]
    cam_pts = (verts - t) @ R
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4), (2, 4), (3, 4)]
    return cam_pts, edges


def plot_cameras(poses, path, poses_ref=None, scale=None):
    """3D camera-frustum plot of [N,3,4] poses (blue) against optional
    reference poses (red), saved as a PNG; needs matplotlib."""
    plt = _pyplot()
    poses = np.asarray(poses)
    if scale is None:
        centers = np.stack([-p[:, :3].T @ p[:, 3] for p in poses])
        scale = 0.1 * float(np.linalg.norm(
            centers - centers.mean(0), axis=1).mean() + 1e-6)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    for group, color in [(poses, "tab:blue"), (poses_ref, "tab:red")]:
        if group is None:
            continue
        for p in np.asarray(group):
            pts, edges = _camera_wireframe(p, scale)
            for a, b in edges:
                ax.plot(*zip(pts[a], pts[b]), color=color, linewidth=0.8)
    ax.set_box_aspect((1, 1, 1))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_pose_trajectory(poses_history, path):
    """Camera-center trajectories over training (a list of [N,3,4] pose
    arrays, oldest first, coloured along viridis), saved as a PNG; needs
    matplotlib."""
    plt = _pyplot()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    n = len(poses_history)
    for i, poses in enumerate(poses_history):
        centers = np.stack([-p[:, :3].T @ p[:, 3] for p in np.asarray(poses)])
        ax.scatter(*centers.T, s=3, color=plt.cm.viridis(i / max(n - 1, 1)))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
