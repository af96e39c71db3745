"""Camera/ray geometry in PyTorch (port of texpose_tpu/geometry/rays.py).

World↔camera↔image transforms, per-pixel rays with +0.5 pixel centers, the
NDC reparameterization, the slab-method ray/AABB intersection and
back-projection.  Poses are [...,3,4] world→camera matrices, as in the JAX
package.
"""

from __future__ import annotations

import torch

from .pose import pose_invert


def to_hom(X):
    """Append a homogeneous 1 to the last axis."""
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def world2cam(X, pose):
    """[...,N,3] world points → camera frame via [...,3,4] pose."""
    return to_hom(X) @ pose.transpose(-1, -2)


def cam2img(X, intr):
    return X @ intr.transpose(-1, -2)


def img2cam(X, intr):
    """Image → camera frame.  ``linalg.inv_ex`` (its result unchecked)
    reads nothing back to the host, so a captured training step holds it;
    ``linalg.inv`` checks its result there."""
    return X @ torch.linalg.inv_ex(intr).inverse.transpose(-1, -2)


def cam2world(X, pose):
    """Camera-frame points → world (pose is world→cam, so invert first)."""
    return to_hom(X) @ pose_invert(pose).transpose(-1, -2)


def pixel_grid(H, W, dtype=torch.float32, device=None, center_offset=0.5):
    """[(H*W), 2] grid of (x, y) pixel centers, x fastest (row-major H×W)."""
    ys = torch.arange(H, dtype=dtype, device=device) + center_offset
    xs = torch.arange(W, dtype=dtype, device=device) + center_offset
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1).reshape(H * W, 2)


def convert_NDC(center, ray, intr, near=1.0):
    """Shift ray origins to the near plane and project to NDC (+z-facing
    convention, as texpose_tpu.geometry.rays.convert_NDC)."""
    center = center + (near - center[..., 2:]) / ray[..., 2:] * ray
    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]
    scale_x = (intr[:, 0, 0] / intr[:, 0, 2])[:, None]
    scale_y = (intr[:, 1, 1] / intr[:, 1, 2])[:, None]
    cnx = scale_x * (cx / cz)
    cny = scale_y * (cy / cz)
    cnz = 1 - 2 * near / cz
    rnx = scale_x * (rx / rz - cx / cz)
    rny = scale_y * (ry / rz - cy / cz)
    rnz = 2 * near / cz
    return (torch.stack([cnx, cny, cnz], dim=-1),
            torch.stack([rnx, rny, rnz], dim=-1))


def _matmul_small(X, M):
    """X [...,K] @ M [...,K,N] for K = 3 or 4 as explicit elementwise
    products summed pairwise, ((x0·m0 + x1·m1) + (x2·m2 + x3·m3)): the
    order XLA's CPU dot sums such products in, and one that rounds the
    same on every device (no FMA, no library kernel)."""
    terms = [X[..., k, None] * M[..., k, :] for k in range(X.shape[-1])]
    out = terms[0] + terms[1]
    return out + (terms[2] + terms[3] if len(terms) == 4 else terms[2])


def _intr_inverse(intr):
    """Inverse of [...,3,3] intrinsics.  A pinhole matrix (zero below the
    diagonal) is inverted by back substitution with reciprocals, as
    LAPACK's triangular solve does (bit-equal to jnp.linalg.inv on the
    CPU, and the same on every device); any other matrix by
    torch.linalg.inv."""
    if bool((intr[..., [1, 2, 2], [0, 0, 1]] != 0).any()):
        return torch.linalg.inv(intr)
    r = 1.0 / torch.diagonal(intr, dim1=-2, dim2=-1)         # [...,3]
    u01, u02, u12 = intr[..., 0, 1], intr[..., 0, 2], intr[..., 1, 2]
    x22 = r[..., 2]
    x12 = (0.0 - u12 * x22) * r[..., 1]
    x01 = (0.0 - u01 * r[..., 1]) * r[..., 0]
    x02 = ((0.0 - u01 * x12) - u02 * x22) * r[..., 0]
    z = torch.zeros_like(x22)
    return torch.stack([torch.stack([r[..., 0], x01, x02], -1),
                        torch.stack([z, r[..., 1], x12], -1),
                        torch.stack([z, z, x22], -1)], -2)


def get_center_and_ray(pose, intr, H, W, center_offset=0.5):
    """Per-pixel camera centers and (unnormalized) ray directions in world.

    pose [B,3,4], intr [B,3,3] → (center [B,HW,3], ray [B,HW,3]); pixel
    centers at +0.5, ray = unproject(pixel, depth=1) - center.  The ray is
    a difference of two points ~|t| from the origin, so it carries their
    rounding, which the slab test divides by the ray's components: every
    product here is an elementwise one, summed in JAX's order
    (``_matmul_small``), which keeps the ray-box bounds within 1e-2 mm of
    the JAX package's and identical across devices.
    """
    B = pose.shape[0]
    xy = pixel_grid(H, W, pose.dtype, pose.device, center_offset)
    xy = xy[None].expand(B, H * W, 2)
    grid_3D = _matmul_small(to_hom(xy),
                            _intr_inverse(intr).transpose(-1, -2)[:, None])
    R_inv = pose[..., :3].transpose(-1, -2)
    t_inv = -_matmul_small(R_inv, pose[:, None, :, 3:])[..., 0]   # [B,3]
    inv = torch.cat([R_inv, t_inv[..., None]], dim=-1)       # [B,3,4]
    center_3D = t_inv[:, None].expand(B, H * W, 3)
    world = _matmul_small(to_hom(grid_3D), inv.transpose(-1, -2)[:, None])
    return center_3D, world - center_3D


def get_3D_points_from_depth(center, ray, depth, multi_samples=False):
    """x = c + d*v.  With multi_samples, center/ray [B,HW,3] broadcast
    against depth [B,HW,N,1] → [B,HW,N,3]."""
    if multi_samples:
        center, ray = center[..., None, :], ray[..., None, :]
    return center + ray * depth


def aabb_ray_intersection(aabb_min, aabb_max, ray_o, ray_d):
    """Slab-method ray/AABB intersection.

    aabb_min/max broadcastable to [B,HW,3] → (t_near, t_far, valid), each
    [B,HW]; valid = t_far > 0 and t_far > t_near.  A zero direction
    component gives ±inf, or NaN where the ray starts on that slab's plane;
    torch.minimum/maximum/amax/amin propagate the NaN as jnp's do, and the
    NaN fails both comparisons.
    """
    inv_d = 1.0 / ray_d
    t_min = (aabb_min - ray_o) * inv_d
    t_max = (aabb_max - ray_o) * inv_d
    t_near = torch.amax(torch.minimum(t_min, t_max), dim=-1)
    t_far = torch.amin(torch.maximum(t_min, t_max), dim=-1)
    valid = (t_far > 0) & (t_far > t_near)
    return t_near, t_far, valid


def enlarge_diagonal(aabb_min, aabb_max, alpha=0.25):
    """Symmetric AABB inflation by a fraction of its extent."""
    direction = aabb_max - aabb_min
    return aabb_min - direction * alpha / 2, aabb_max + direction * alpha / 2


def back_project(pix_coord, depth, intr):
    """Lift homogeneous pixel coords [B,HW,3] at depth [B,HW,1] to the
    camera frame."""
    return (pix_coord * depth) @ torch.linalg.inv(intr).transpose(-1, -2)
