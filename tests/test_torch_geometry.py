"""The port's pose library and ray helpers (texpose_tpu_torch.geometry)
against the JAX package's, function by function, on the same numpy inputs
made from a seed: rtol 1e-5 / atol 1e-6 in float32 (both sides run the
same f32 arithmetic; the Taylor series' powers may round an ulp apart)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyR

from texpose_tpu import geometry as JG
from texpose_tpu_torch import geometry as TG

RTOL, ATOL = 1e-5, 1e-6


def rots(rng, n):
    return ScipyR.random(n, random_state=rng.integers(1 << 30)
                         ).as_matrix().astype(np.float32)


def poses(rng, n):
    return np.concatenate([rots(rng, n), rng.normal(size=(n, 3, 1))
                           .astype(np.float32)], axis=-1)


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def intr(n):
    K = np.array([[120.0, 0, 64], [0, 110.0, 48], [0, 0, 1]], np.float32)
    return np.broadcast_to(K, (n, 3, 3)).copy()


def _both(out_j, out_t):
    """Flatten (nested) outputs of the two sides into matching lists."""
    if isinstance(out_t, dict):
        return [(np.asarray(out_j[k]), out_t[k]) for k in sorted(out_t)]
    if isinstance(out_t, (tuple, list)):
        return [p for a, b in zip(out_j, out_t) for p in _both(a, b)]
    return [(np.asarray(out_j), out_t)]


# name → (function, args from a seeded rng); arrays go to both sides as
# jnp / torch, everything else as is
CASES = {
    "pose_from_Rt": ("pose_from_Rt", lambda r: (rots(r, 4), f32(r, 4, 3))),
    "pose_from_Rt_R_only": ("pose_from_Rt", lambda r: (rots(r, 4), None)),
    "pose_from_Rt_t_only": ("pose_from_Rt", lambda r: (None, f32(r, 4, 3))),
    "pose_invert": ("pose_invert", lambda r: (poses(r, 5),)),
    "pose_compose_pair": ("pose_compose_pair",
                          lambda r: (poses(r, 5), poses(r, 5))),
    "pose_to_hom4": ("pose_to_hom4", lambda r: (poses(r, 3),)),
    "skew_symmetric": ("skew_symmetric", lambda r: (f32(r, 6, 3),)),
    "taylor_A": ("taylor_A", lambda r: (np.linspace(
        0.0, 3.0, 40, dtype=np.float32),)),
    "taylor_B": ("taylor_B", lambda r: (np.linspace(
        0.0, 3.0, 40, dtype=np.float32),)),
    "taylor_C": ("taylor_C", lambda r: (np.linspace(
        0.0, 3.0, 40, dtype=np.float32),)),
    "so3_to_SO3": ("so3_to_SO3", lambda r: (f32(r, 8, 3, scale=0.7),)),
    "SO3_to_so3": ("SO3_to_so3", lambda r: (rots(r, 8),)),
    "se3_to_SE3": ("se3_to_SE3", lambda r: (f32(r, 8, 6, scale=0.5),)),
    "SE3_to_se3": ("SE3_to_se3", lambda r: (poses(r, 8),)),
    "q_to_R": ("q_to_R", lambda r: (ScipyR.random(
        8, random_state=r.integers(1 << 30)).as_quat()[:, [3, 0, 1, 2]]
        .astype(np.float32),)),
    "R_to_q": ("R_to_q", lambda r: (rots(r, 16),)),
    "q_invert": ("q_invert", lambda r: (f32(r, 8, 4),)),
    "q_product": ("q_product", lambda r: (f32(r, 8, 4), f32(r, 8, 4))),
    "rotation_6d_to_matrix": ("rotation_6d_to_matrix",
                              lambda r: (f32(r, 8, 6),)),
    "matrix_to_rotation_6d": ("matrix_to_rotation_6d",
                              lambda r: (rots(r, 8),)),
    "pose_9d_to_matrix": ("pose_9d_to_matrix", lambda r: (f32(r, 8, 9),)),
    "rotation_distance": ("rotation_distance",
                          lambda r: (rots(r, 8), rots(r, 8))),
    "angle_to_rotation_matrix_X": ("angle_to_rotation_matrix",
                                   lambda r: (f32(r, 7), "X")),
    "angle_to_rotation_matrix_Y": ("angle_to_rotation_matrix",
                                   lambda r: (f32(r, 7), "Y")),
    "angle_to_rotation_matrix_Z": ("angle_to_rotation_matrix",
                                   lambda r: (f32(r, 7), "Z")),
    "get_novel_view_poses_gentle": ("get_novel_view_poses",
                                    lambda r: (poses(r, 1)[0], 60, 0.3,
                                               "gentle")),
    "get_novel_view_poses_wild": ("get_novel_view_poses",
                                  lambda r: (poses(r, 1)[0], 12, 1.5,
                                             "wild")),
    "get_novel_view_poses_obj": ("get_novel_view_poses_obj",
                                 lambda r: (poses(r, 1)[0], 10)),
    "get_novel_view_poses_obj_odd": ("get_novel_view_poses_obj",
                                     lambda r: (poses(r, 1)[0], 7)),
    "compose_pose_residual": ("compose_pose_residual",
                              lambda r: (poses(r, 4), poses(r, 4))),
    # rays
    "world2cam": ("world2cam", lambda r: (f32(r, 2, 9, 3), poses(r, 2))),
    "cam2img": ("cam2img", lambda r: (f32(r, 2, 9, 3), intr(2))),
    "get_center_and_ray": ("get_center_and_ray",
                           lambda r: (poses(r, 2), intr(2), 12, 16)),
    "get_3D_points_from_depth": ("get_3D_points_from_depth",
                                 lambda r: (f32(r, 2, 9, 3), f32(r, 2, 9, 3),
                                            f32(r, 2, 9, 1))),
    "get_3D_points_from_depth_multi": (
        "get_3D_points_from_depth",
        lambda r: (f32(r, 2, 9, 3), f32(r, 2, 9, 3), f32(r, 2, 9, 5, 1),
                   True)),
    "aabb_ray_intersection": ("aabb_ray_intersection",
                              lambda r: (np.float32([-0.5, -0.4, -0.6]),
                                         np.float32([0.5, 0.6, 0.4]),
                                         f32(r, 2, 64, 3, scale=2.0),
                                         f32(r, 2, 64, 3))),
    "enlarge_diagonal": ("enlarge_diagonal",
                         lambda r: (f32(r, 3), f32(r, 3) + 4.0, 0.25)),
    "back_project": ("back_project", lambda r: (f32(r, 2, 9, 3),
                                                f32(r, 2, 9, 1), intr(2))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax(case):
    name, make = CASES[case]
    args = make(np.random.default_rng(sorted(CASES).index(case)))
    out_j = getattr(JG, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                else a for a in args])
    out_t = getattr(TG, name)(*[torch.as_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args])
    for j, t in _both(out_j, out_t):
        assert t.dtype in (torch.float32, torch.bool), t.dtype
        np.testing.assert_allclose(t.numpy(), j, rtol=RTOL, atol=ATOL)


def test_pose_compose_sequence():
    rng = np.random.default_rng(7)
    ps = [poses(rng, 3) for _ in range(4)]
    j = JG.pose_compose([jnp.asarray(p) for p in ps])
    t = TG.pose_compose([torch.as_tensor(p) for p in ps])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_procrustes_aligned_points():
    """JAX's SVD runs in f32 (x64 off), the port's in f64: the aligned
    points, not U/V, are compared; a reflection case (negated X1) takes
    the row-2 flip on both sides."""
    rng = np.random.default_rng(3)
    X0 = f32(rng, 50, 3)
    R, s, t = rots(rng, 1)[0], 2.3, np.float32([0.5, -1.0, 2.0])
    for X1 in ((X0 @ R.T) * s + t, -((X0 @ R.T) * s + t)):
        X1 = X1.astype(np.float32)
        sj = JG.procrustes_analysis(jnp.asarray(X0), jnp.asarray(X1))
        st = TG.procrustes_analysis(torch.as_tensor(X0), torch.as_tensor(X1))

        def align(d):
            d = {k: np.asarray(v) for k, v in d.items()}
            return (X1 - d["t1"]) / d["s1"] @ d["R"].T * d["s0"] + d["t0"]

        np.testing.assert_allclose(align(st), align(sj), rtol=1e-4,
                                   atol=1e-4)
        for k in ("t0", "t1", "s0", "s1"):
            np.testing.assert_allclose(np.asarray(st[k]), np.asarray(sj[k]),
                                       rtol=RTOL, atol=ATOL)
        assert np.linalg.det(st["R"].numpy()) > 0


def test_aabb_zero_direction_nan_propagates():
    """A zero direction component with the origin on a slab plane gives
    0·inf = NaN: t_near/t_far are NaN and the ray is invalid, as in JAX;
    a zero component off the plane gives ±inf and a finite answer."""
    mn, mx = np.float32([-1, -1, -1]), np.float32([1, 1, 1])
    o = np.float32([[[1.0, 0.2, -5.0], [0.3, 0.2, -5.0], [3.0, 0.0, -5.0]]])
    d = np.float32([[[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]])
    outj = JG.aabb_ray_intersection(*map(jnp.asarray, (mn, mx, o, d)))
    outt = TG.aabb_ray_intersection(*map(torch.as_tensor, (mn, mx, o, d)))
    for j, t in zip(outj, outt):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert np.isnan(outt[0][0, 0].item()) and not outt[2][0, 0]
    assert outt[2][0, 1] and not outt[2][0, 2]


def test_rays_import_pose_invert_from_pose():
    from texpose_tpu_torch.geometry import pose, rays
    assert rays.pose_invert is pose.pose_invert
