"""Pose algebra on [..., 3, 4] camera poses [R|t] in PyTorch (port of
texpose_tpu/geometry/pose.py).

Pure functions over tensors, on whatever device their inputs live.
Conventions, as the JAX package's:
  * a pose maps world → camera:  x_cam = R @ x_world + t
  * compose([p1, p2]) applies p1 first:  pose_new(x) = p2(p1(x))
  * so3/se3 exp/log use the Taylor expansions of sin(x)/x, (1-cos x)/x^2,
    (x-sin x)/x^3 rather than trig (stable near 0, branch-free).
"""

from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


# ----------------------------------------------------------------- pose [R|t]

def pose_from_Rt(R=None, t=None):
    """Construct a [...,3,4] float32 pose from R [...,3,3] and/or t [...,3]."""
    assert R is not None or t is not None
    if R is None:
        t = _f32(t)
        R = torch.eye(3, dtype=t.dtype, device=t.device).expand(
            *t.shape[:-1], 3, 3)
    elif t is None:
        R = _f32(R)
        t = torch.zeros(R.shape[:-1], dtype=R.dtype, device=R.device)
    else:
        R, t = _f32(R), _f32(t)
    return torch.cat([R, t[..., None]], dim=-1)


def pose_invert(pose):
    """Invert a [...,3,4] rigid pose (R assumed orthonormal)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    t_inv = -(R_inv @ t)[..., 0]
    return pose_from_Rt(R_inv, t_inv)


def pose_compose_pair(pose_a, pose_b):
    """pose_new(x) = pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return pose_from_Rt(R_b @ R_a, (R_b @ t_a + t_b)[..., 0])


def pose_compose(pose_list):
    """Compose a sequence; first element applied first."""
    out = pose_list[0]
    for p in pose_list[1:]:
        out = pose_compose_pair(out, p)
    return out


def pose_to_hom4(pose):
    """[...,3,4] → [...,4,4] homogeneous."""
    bottom = torch.zeros((*pose.shape[:-2], 1, 4), dtype=pose.dtype,
                         device=pose.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], dim=-2)


# ------------------------------------------------------------- Lie SO3 / SE3

def skew_symmetric(w):
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    O = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([O, -w2, w1], dim=-1),
        torch.stack([w2, O, -w0], dim=-1),
        torch.stack([-w1, w0, O], dim=-1),
    ], dim=-2)


def _taylor(x, nth, denom_step):
    """Alternating series Σ (-1)^i x^(2i) / denom_i, with denom_i the
    running product of denom_step(0..i)."""
    ans = torch.zeros_like(x)
    denom = 1.0
    for i in range(nth + 1):
        denom *= denom_step(i)
        ans = ans + (-1.0) ** i * x ** (2 * i) / denom
    return ans


def taylor_A(x, nth=10):
    """sin(x)/x (the denominator starts at 1 for i = 0)."""
    return _taylor(x, nth, lambda i: (2 * i) * (2 * i + 1) if i else 1)


def taylor_B(x, nth=10):
    """(1 - cos(x)) / x^2."""
    return _taylor(x, nth, lambda i: (2 * i + 1) * (2 * i + 2))


def taylor_C(x, nth=10):
    """(x - sin(x)) / x^3."""
    return _taylor(x, nth, lambda i: (2 * i + 2) * (2 * i + 3))


def _eye(x):
    return torch.eye(3, dtype=x.dtype, device=x.device)


def so3_to_SO3(w):
    """Exponential map so(3) → SO(3) via Rodrigues w/ Taylor coefficients."""
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    return _eye(w) + taylor_A(theta) * wx + taylor_B(theta) * (wx @ wx)


def SO3_to_so3(R, eps=1e-7):
    """Log map SO(3) → so(3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))
    # floor modulo (sign of the divisor), as jnp's %
    theta = torch.remainder(theta, math.pi)[..., None, None]
    lnR = 1 / (2 * taylor_A(theta) + 1e-8) * (R - R.transpose(-2, -1))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]],
                       dim=-1)


def se3_to_SE3(wu):
    """Exponential map se(3) → SE(3): wu = [w(3), u(3)] → [...,3,4]."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    I = _eye(wu)
    R = I + taylor_A(theta) * wx + taylor_B(theta) * (wx @ wx)
    V = I + taylor_B(theta) * wx + taylor_C(theta) * (wx @ wx)
    return torch.cat([R, V @ u[..., None]], dim=-1)


def SE3_to_se3(Rt, eps=1e-8):
    """Log map SE(3) → se(3)."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    A, B = taylor_A(theta), taylor_B(theta)
    invV = (_eye(Rt) - 0.5 * wx
            + (1 - A / (2 * B)) / (theta ** 2 + eps) * (wx @ wx))
    u = (invV @ t)[..., 0]
    return torch.cat([w, u], dim=-1)


# --------------------------------------------------------------- quaternions

def q_to_R(q):
    """Unit quaternion [w,x,y,z] → rotation matrix [...,3,3]."""
    qa, qb, qc, qd = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (qc ** 2 + qd ** 2), 2 * (qb * qc - qa * qd),
                     2 * (qa * qc + qb * qd)], dim=-1),
        torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb ** 2 + qd ** 2),
                     2 * (qc * qd - qa * qb)], dim=-1),
        torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd),
                     1 - 2 * (qb ** 2 + qc ** 2)], dim=-1),
    ], dim=-2)


def R_to_q(R, eps=1e-8):
    """Rotation matrix → quaternion, branch-free: the four candidates
    normalized by each dominant component, the largest magnitude picked
    (the first of ties), sign canonicalized to w ≥ 0."""
    R00, R01, R02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    R10, R11, R12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    R20, R21, R22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qa2 = torch.clamp(1 + R00 + R11 + R22, min=0.0) / 4
    qb2 = torch.clamp(1 + R00 - R11 - R22, min=0.0) / 4
    qc2 = torch.clamp(1 - R00 + R11 - R22, min=0.0) / 4
    qd2 = torch.clamp(1 - R00 - R11 + R22, min=0.0) / 4

    def cand(comps, m2):
        return torch.stack(comps, dim=-1) / (
            4 * torch.sqrt(torch.clamp(m2, min=eps)))[..., None]

    qa = cand([4 * qa2, R21 - R12, R02 - R20, R10 - R01], qa2)
    qb = cand([R21 - R12, 4 * qb2, R01 + R10, R02 + R20], qb2)
    qc = cand([R02 - R20, R01 + R10, 4 * qc2, R12 + R21], qc2)
    qd = cand([R10 - R01, R02 + R20, R12 + R21, 4 * qd2], qd2)
    mags = torch.stack([qa2, qb2, qc2, qd2], dim=-1)
    cands = torch.stack([qa, qb, qc, qd], dim=-2)               # [...,4,4]
    idx = torch.argmax(mags, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        *idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def q_invert(q):
    qa, qb, qc, qd = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    norm2 = torch.sum(q ** 2, dim=-1, keepdim=True)
    return torch.stack([qa, -qb, -qc, -qd], dim=-1) / norm2


def q_product(q1, q2):
    a1, b1, c1, d1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    a2, b2, c2, d2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
        a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
        a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
        a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
    ], dim=-1)


# --------------------------------------------------- continuous 6D / 9D pose

def rotation_6d_to_matrix(d6):
    """Zhou et al. continuous 6D → rotation matrix via Gram-Schmidt."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(R):
    return R[..., :2, :].reshape(*R.shape[:-2], 6)


def pose_9d_to_matrix(d9):
    """[...,9] = [6d rot, 3d trans] → [...,3,4]."""
    R = rotation_6d_to_matrix(d9[..., :6])
    return torch.cat([R, d9[..., 6:, None]], dim=-1)


# --------------------------------------------------------- metrics & fitting

def rotation_distance(R1, R2, eps=1e-7):
    """Geodesic angle between rotations (broadcasts)."""
    R_diff = R1 @ R2.transpose(-2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))


def procrustes_analysis(X0, X1):
    """Similarity (sim3) aligning point set X1 [N,3] to X0 [N,3].

    Returns dict(t0, t1, s0, s1, R) such that
    X1to0 = (X1 - t1)/s1 @ R.T * s0 + t0.  The SVD runs in float64.  A
    reflection is undone by negating row 2 of R (not a column), as the JAX
    package does.
    """
    t0 = X0.mean(dim=0, keepdim=True)
    t1 = X1.mean(dim=0, keepdim=True)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = torch.sqrt((X0c ** 2).sum(dim=-1).mean())
    s1 = torch.sqrt((X1c ** 2).sum(dim=-1).mean())
    M = (X0c / s0).T @ (X1c / s1)
    U, _, Vt = torch.linalg.svd(M.double(), full_matrices=False)
    R = (U @ Vt).to(X0.dtype)
    sign = torch.where(torch.linalg.det(R) < 0, -1.0, 1.0).to(R.dtype)
    R = torch.cat([R[:2], R[2:] * sign], dim=0)
    return dict(t0=t0[0], t1=t1[0], s0=s0, s1=s1, R=R)


def angle_to_rotation_matrix(a, axis):
    """Rotation about one of X/Y/Z by angle(s) a."""
    roll = dict(X=1, Y=2, Z=0)[axis]
    O, I = torch.zeros_like(a), torch.ones_like(a)
    M = torch.stack([
        torch.stack([torch.cos(a), -torch.sin(a), O], dim=-1),
        torch.stack([torch.sin(a), torch.cos(a), O], dim=-1),
        torch.stack([O, O, I], dim=-1),
    ], dim=-2)
    return torch.roll(M, shifts=(roll, roll), dims=(-2, -1))


def get_novel_view_poses(pose_anchor, N=60, scale=1.0, motion="wild"):
    """Circular novel-view poses [N,3,4] around an anchor pose [3,4]."""
    dev = pose_anchor.device
    theta = torch.arange(N, dtype=torch.float32, device=dev) / N * 2 * math.pi
    if motion == "wild":
        amp, z1, z2 = 0.3, 3 * scale, -1 * scale
    elif motion == "gentle":
        amp, z1, z2 = 0.05, -4 * scale, 4 * scale
    else:
        raise NotImplementedError(motion)
    R_x = angle_to_rotation_matrix(torch.arcsin(torch.sin(theta) * amp), "X")
    R_y = angle_to_rotation_matrix(torch.arcsin(torch.cos(theta) * amp), "Y")
    shift1 = pose_from_Rt(t=torch.tensor([0.0, 0, z1], device=dev))
    shift2 = pose_from_Rt(t=torch.tensor([0.0, 0, z2], device=dev))
    pose_rot = pose_from_Rt(R=R_y @ R_x)
    shape = (*pose_rot.shape[:-2], 3, 4)
    pose_oscil = pose_compose([shift1.expand(shape), pose_rot,
                               shift2.expand(shape)])
    return pose_compose([pose_oscil, pose_anchor[None].expand(shape)])


def get_novel_view_poses_obj(pose_anchor, N=10):
    """Z-axis orbit of ±45° about an anchor pose."""
    theta = torch.arange(-N / 2, N / 2, dtype=torch.float32,
                         device=pose_anchor.device) / N * 0.5 * math.pi
    pose_rot = pose_from_Rt(R=angle_to_rotation_matrix(theta, "Z"))
    return pose_compose([pose_rot, pose_anchor.expand(pose_rot.shape)])


def compose_pose_residual(pose_refine, pose_source):
    """Apply a residual refinement in the source pose's rotation frame."""
    rot = pose_source[..., :3, :3]
    pose_rot = pose_from_Rt(R=rot)
    pose_rot_T = pose_from_Rt(R=rot.transpose(-1, -2))
    return pose_compose([pose_rot, pose_refine, pose_rot_T, pose_source])
