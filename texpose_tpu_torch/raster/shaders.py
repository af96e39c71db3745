"""Shading attributes and the renderer facade (port of
texpose_tpu/raster/shaders.py; the numpy shaders are a copy of the JAX
package's).

  * NOCS: vertices mean-centered, per-axis /max|·|, → [0,1]
  * color: ambient-lit vertex colors = plain interpolation
  * normal: interpolated per-vertex normals (area-weighted face-normal
    accumulation, pytorch3d verts_normals semantics)
  * mask: hard coverage
  * depth: nearest-face camera z (0 at background)
  * normal_from_depth: image-space tangent cross product of the
    back-projected point map

The rasterizers project directly in the OpenCV camera convention (x right,
y down, z forward), so no calibration pose exists.
"""

from __future__ import annotations

import numpy as np
import torch


def nocs_attrs(verts):
    """[V,3] → [V,3] NOCS in [0,1] (mean centroid, per-axis max-abs)."""
    c = verts.mean(axis=0, keepdims=True)
    d = verts - c
    return (d / np.abs(d).max(axis=0, keepdims=True) + 1.0) / 2.0


def vertex_normals(verts, faces):
    """Area-weighted per-vertex normals (pytorch3d verts_normals_packed)."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)                       # area-weighted
    vn = np.zeros_like(verts)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def transform_verts(verts, pose):
    """[V,3] object-frame → camera-frame via [3,4] world→cam pose."""
    return verts @ pose[:, :3].T + pose[:, 3]


def normal_from_depth(pose, depth, intr, H, W):
    """Camera-frame normals from a depth map by central differences of the
    back-projected point map.

    pose [3,4] (world→cam), depth [H,W], intr [3,3] → [H,W,3] with the
    z-component flipped and zeroed outside depth>0, as the reference does
    (including the world-frame cross product).
    """
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], axis=-1)
    d_cam = pix @ np.linalg.inv(intr).T.astype(np.float32)
    R, t = pose[:, :3], pose[:, 3]
    cam_center = -R.T @ t
    d_world = d_cam @ R
    points = cam_center + d_world * depth[..., None]      # [H,W,3] world
    tu = points[1:-1, 2:] - points[1:-1, :-2]
    tv = points[2:, 1:-1] - points[:-2, 1:-1]
    n = np.cross(tu, tv)
    normal = np.zeros((H, W, 3), np.float32)
    normal[1:-1, 1:-1] = n
    norm = np.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / np.maximum(norm, 1e-12)
    normal[..., 2] *= -1
    return normal * (depth[..., None] > 0)


class MeshRenderer:
    """Render nocs/color/mask/normal/feature (+depth) views of a CAD mesh
    under [B,3,4] poses.

    backend: ``"torch"`` (torch_raster, on ``device``), ``"native"`` (the
    C++ z-buffer on the host) or ``"auto"``: torch on a CUDA device, native
    on the CPU.  A native build that fails raises; nothing falls back to
    another backend.  Outputs are numpy arrays, as the JAX package's.
    """

    def __init__(self, verts, faces, colors=None, H=480, W=640,
                 backend="auto", device="cpu"):
        self.verts = np.asarray(verts, np.float32)
        self.faces = np.asarray(faces, np.int32)
        self.colors = None if colors is None else np.asarray(colors,
                                                             np.float32)
        self.H, self.W = H, W
        self.device = torch.device(device)
        self._nocs = nocs_attrs(self.verts)
        self._normals = vertex_normals(self.verts, self.faces)
        if backend == "auto":
            backend = "torch" if self.device.type == "cuda" else "native"
        if backend not in ("torch", "native"):
            raise ValueError(f"unknown rasterizer backend {backend!r}")
        self.backend = backend
        if backend == "native":
            from . import native
            native.load_library()
        else:
            self._faces_t = torch.as_tensor(self.faces, device=self.device)

    def _rasterize(self, verts_cam, K):
        """→ (zbuf [H,W], face_id [H,W]) numpy and the frame's
        interpolation function attrs [V,C] → [H,W,C] numpy."""
        if self.backend == "native":
            from . import native
            zbuf, face_id, bary = native.rasterize(verts_cam, self.faces, K,
                                                   self.H, self.W)
            return zbuf, face_id, lambda attrs: native.interpolate(
                self.faces, face_id, bary, attrs)
        from . import torch_raster
        dev = self.device
        z, f, b = torch_raster.rasterize(
            torch.as_tensor(verts_cam, device=dev), self._faces_t,
            torch.as_tensor(K, device=dev), self.H, self.W)
        return z.cpu().numpy(), f.cpu().numpy(), lambda attrs: \
            torch_raster.interpolate(self._faces_t, f, b, torch.as_tensor(
                attrs, dtype=torch.float32, device=dev)).cpu().numpy()

    def render(self, pose, K, mode="color", return_depth=True,
               features=None):
        """pose [B,3,4] (world→cam, mesh units), K [B,3,3] or [3,3] →
        images [B,H,W,C] (+ depth [B,H,W]).

        mode='feature' interpolates caller-provided per-vertex ``features``
        [V,C]."""
        pose = np.asarray(pose, np.float32)
        K = np.asarray(K, np.float32)
        if K.ndim == 2:
            K = np.repeat(K[None], len(pose), axis=0)
        imgs, depths = [], []
        for b in range(len(pose)):
            verts_cam = transform_verts(self.verts, pose[b])
            zbuf, face_id, interp = self._rasterize(verts_cam, K[b])
            if mode == "nocs":
                img = interp(self._nocs)
            elif mode == "color":
                if self.colors is None:
                    raise ValueError("mesh has no vertex colors")
                img = interp(self.colors)
            elif mode == "normal":
                n = interp(self._normals)
                norm = np.linalg.norm(n, axis=-1, keepdims=True)
                img = n / np.maximum(norm, 1e-12) * (face_id >= 0)[..., None]
            elif mode == "mask":
                img = (face_id >= 0).astype(np.float32)[..., None]
            elif mode == "feature":
                if features is None:
                    raise ValueError("mode='feature' needs per-vertex "
                                     "features")
                img = interp(np.asarray(features, np.float32))
            else:
                raise NotImplementedError(mode)
            imgs.append(img)
            depths.append(zbuf)
        imgs = np.stack(imgs)
        depths = np.stack(depths)
        if return_depth:
            return imgs, depths
        return imgs
