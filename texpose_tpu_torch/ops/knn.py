"""Brute-force k-nearest neighbours and the point-to-point (chamfer)
distance (port of texpose_tpu/ops/knn.py), in plain torch on whatever
device the points are on.  At this workload's ~1e4 points the whole
pairwise distance matrix fits; no spatial index.

Ties keep JAX's order: ``jax.lax.top_k`` puts the lower index first among
equal distances, so the neighbours come from a stable ascending sort, not
``torch.topk`` (which promises no order among ties), and the distances use
JAX's ‖x‖² − 2x·y + ‖y‖² (clamped at 0) rather than ``torch.cdist``.  The
dot products are summed over D in elementwise ops, left to right, not by a
matmul: a close pair's distance is a small difference of O(‖x‖²) terms, so
one ulp of a BLAS's summation order moves it by ~1e-4 of itself and can
reorder near neighbours; this way the card and the CPU give the same bits.
"""

from __future__ import annotations

import torch


def _dot(a, b):
    """Σ_d a[..., d]·b[..., d] (broadcast), summed left to right."""
    out = a[..., 0] * b[..., 0]
    for d in range(1, a.shape[-1]):
        out = out + a[..., d] * b[..., d]
    return out


def pairwise_sqdist(x, y):
    """x [...,P1,D], y [...,P2,D] → [...,P1,P2] squared distances."""
    x2 = _dot(x, x)[..., :, None]                            # [...,P1,1]
    y2 = _dot(y, y)[..., None, :]                            # [...,1,P2]
    xy = _dot(x[..., :, None, :], y[..., None, :, :])
    return torch.clamp_min(x2 - 2 * xy + y2, 0.0)


def knn_points(x, y, K=1, x_mask=None, y_mask=None):
    """The K nearest y points of each x point.  x [B,P1,D], y [B,P2,D];
    masks [B,P] mark the valid points (False: padding).  Returns (dists
    [B,P1,K], idx [B,P1,K]); a padded x point's distances are 0."""
    d = pairwise_sqdist(x, y)
    if y_mask is not None:
        d = torch.where(y_mask[:, None, :], d,
                        torch.full_like(d, float("inf")))
    dists, idx = torch.sort(d, dim=-1, stable=True)
    dists, idx = dists[..., :K], idx[..., :K]
    if x_mask is not None:
        dists = torch.where(x_mask[..., None], dists,
                            torch.zeros_like(dists))
    return dists, idx


def knn_gather(feats, idx):
    """feats [B,P2,C], idx [B,P1,K] → [B,P1,K,C]."""
    B, P1, K = idx.shape
    flat = idx.reshape(B, P1 * K, 1).expand(-1, -1, feats.shape[-1])
    return torch.gather(feats, 1, flat).reshape(B, P1, K, feats.shape[-1])


def p2p_distance(x, y, x_mask=None, y_mask=None,
                 batch_reduction="mean", point_reduction="mean"):
    """One-directional chamfer: the mean (or sum) over x points of the
    squared distance to the nearest y point → (dist, None), the (distance,
    normals) pair of the reference's signature."""
    dists, _ = knn_points(x, y, K=1, x_mask=x_mask, y_mask=y_mask)
    cham_x = dists[..., 0]                                   # [B,P1]
    if x_mask is not None:
        cham_x = torch.where(x_mask, cham_x, torch.zeros_like(cham_x))
        counts = x_mask.sum(dim=-1)
    else:
        counts = torch.full(cham_x.shape[:-1], cham_x.shape[-1],
                            dtype=cham_x.dtype, device=cham_x.device)
    cham_x = cham_x.sum(dim=-1)
    if point_reduction == "mean":
        cham_x = cham_x / torch.clamp_min(counts, 1)
    if batch_reduction == "mean":
        cham_x = cham_x.mean()
    elif batch_reduction == "sum":
        cham_x = cham_x.sum()
    return cham_x, None


def chamfer_distance(x, y, x_mask=None, y_mask=None):
    """Symmetric chamfer distance: the sum of both directions' means."""
    cx, _ = p2p_distance(x, y, x_mask, y_mask)
    cy, _ = p2p_distance(y, x, y_mask, x_mask)
    return cx + cy
