"""Mesh rasterizer in plain PyTorch (port of texpose_tpu/raster/jax_raster.py).

Z-buffer triangle rasterization as a face-chunked reduction: for each chunk
of faces, every pixel evaluates the edge functions against the whole chunk
([pixels, chunk] elementwise work), keeps its nearest hit (``argmin`` on z,
the first of tied minima, as JAX's), and the chunks combine by z-min, an
earlier chunk winning a tie (JAX's argmin over the chunk axis).  No
backface culling, screen-space barycentrics, pixel centers at +0.5, as the
native rasterizer (csrc/raster.cpp) and JAX's.

Memory stays bounded: a chunk's pixels are only those of the chunk's
screen rectangle (its faces' projected bounds, widened by a margin; every
pixel outside it fails the inside test, so the result is the dense one),
walked in bands of at most ``max_elems`` pixel × face pairs.  At 480×640 a
dense [HW, 512] f32 temporary would be 0.63 GB and a chunk needs ≈ 10.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-8
BIG = 1e30
MARGIN = 2               # pixels added around a chunk's screen rectangle


def project_verts(verts_cam, K):
    """[V,3] camera-frame → (u [V], v [V], z [V]) pixel coords."""
    z = verts_cam[:, 2]
    iz = torch.where(z > EPS, 1.0 / torch.clamp(z, min=EPS),
                     torch.zeros_like(z))
    u = K[0, 0] * verts_cam[:, 0] * iz + K[0, 2]
    v = K[1, 1] * verts_cam[:, 1] * iz + K[1, 2]
    return u, v, z


def _pixel_centers(y0, y1, x0, x1, device):
    py = torch.arange(y0, y1, dtype=torch.float32, device=device) + 0.5
    px = torch.arange(x0, x1, dtype=torch.float32, device=device) + 0.5
    py, px = torch.meshgrid(py, px, indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def _face_setup(verts_cam, faces, K, chunk):
    """Per-face screen coordinates, padded to whole chunks: (fu, fv, fz
    [F',3], area [F'], ok [F'])."""
    u, v, z = project_verts(verts_cam, K)
    F = faces.shape[0]
    pad = (-F) % chunk
    faces_p = torch.cat([faces.long(), faces.new_zeros((pad, 3)).long()])
    valid = torch.arange(F + pad, device=faces.device) < F
    fu, fv, fz = u[faces_p], v[faces_p], z[faces_p]
    area = ((fu[:, 1] - fu[:, 0]) * (fv[:, 2] - fv[:, 0])
            - (fu[:, 2] - fu[:, 0]) * (fv[:, 1] - fv[:, 0]))
    ok = valid & (area.abs() > EPS) & (fz > EPS).all(dim=1)
    return fu, fv, fz, area, ok


def _chunk_rects(fu, fv, ok, chunk, H, W):
    """Each chunk's screen rectangle [y0, y1) × [x0, x1) over its
    rasterizable faces, widened by MARGIN and clipped to the image (None
    when the chunk has none) → host list of (y0, y1, x0, x1)."""
    n = fu.shape[0] // chunk
    okc = ok.reshape(n, chunk)

    def over_chunk(a, fill, fn):
        return fn(torch.where(okc, a.reshape(n, chunk), fill), dim=1)

    bounds = torch.stack([
        over_chunk(fv.amin(1), BIG, torch.amin),
        over_chunk(fv.amax(1), -BIG, torch.amax),
        over_chunk(fu.amin(1), BIG, torch.amin),
        over_chunk(fu.amax(1), -BIG, torch.amax)], dim=1).tolist()
    rects = []
    for vmin, vmax, umin, umax in bounds:
        y0 = max(math.floor(vmin - 0.5) - MARGIN, 0)
        y1 = min(math.ceil(vmax - 0.5) + MARGIN + 1, H)
        x0 = max(math.floor(umin - 0.5) - MARGIN, 0)
        x1 = min(math.ceil(umax - 0.5) + MARGIN + 1, W)
        ok_rect = vmin <= vmax and y0 < y1 and x0 < x1
        rects.append((y0, y1, x0, x1) if ok_rect else None)
    return rects


def _bands(rect, chunk, max_elems):
    """Row bands of a rectangle with at most max_elems pixel × face pairs
    each (at least one row)."""
    y0, y1, x0, x1 = rect
    rows = max(1, max_elems // ((x1 - x0) * chunk))
    for ya in range(y0, y1, rows):
        yield ya, min(ya + rows, y1), x0, x1


def rasterize(verts_cam, faces, K, H, W, chunk=512, max_elems=1 << 24):
    """→ (zbuf [H,W] (0=bg), face_id [H,W] int32 (-1=bg), bary [H,W,3]),
    on the device of ``verts_cam``."""
    dev = verts_cam.device
    fu, fv, fz, area, ok = _face_setup(verts_cam, faces, K, chunk)
    inv_area = torch.where(area.abs() > EPS, 1.0 / area,
                           torch.zeros_like(area))
    best_z = torch.full((H, W), BIG, dtype=torch.float32, device=dev)
    best_f = torch.zeros((H, W), dtype=torch.int64, device=dev)
    best_b = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    for ci, rect in enumerate(_chunk_rects(fu, fv, ok, chunk, H, W)):
        if rect is None:
            continue
        sl = slice(ci * chunk, (ci + 1) * chunk)
        cu, cv, cz = fu[sl][None], fv[sl][None], fz[sl][None]   # [1,c,3]
        cia, cok = inv_area[sl][None], ok[sl][None]
        for ya, yb, xa, xb in _bands(rect, chunk, max_elems):
            px, py = _pixel_centers(ya, yb, xa, xb, dev)
            px, py = px[:, None], py[:, None]                    # [P,1]
            w0 = ((cu[..., 1] - px) * (cv[..., 2] - py)
                  - (cu[..., 2] - px) * (cv[..., 1] - py)) * cia
            w1 = ((cu[..., 2] - px) * (cv[..., 0] - py)
                  - (cu[..., 0] - px) * (cv[..., 2] - py)) * cia
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & cok
            zp = w0 * cz[..., 0] + w1 * cz[..., 1] + w2 * cz[..., 2]
            zp = torch.where(inside, zp, BIG)
            best = zp.argmin(dim=1, keepdim=True)                # [P,1]
            zc = zp.gather(1, best)[:, 0]
            bc = torch.stack([w0.gather(1, best)[:, 0],
                              w1.gather(1, best)[:, 0],
                              w2.gather(1, best)[:, 0]], dim=-1)
            zv, fv_, bv = (best_z[ya:yb, xa:xb], best_f[ya:yb, xa:xb],
                           best_b[ya:yb, xa:xb])
            upd = zc.reshape(zv.shape) < zv                 # earlier wins ties
            zv.copy_(torch.where(upd, zc.reshape(zv.shape), zv))
            fv_.copy_(torch.where(upd, (best[:, 0] + ci * chunk)
                                  .reshape(zv.shape), fv_))
            bv.copy_(torch.where(upd[..., None], bc.reshape(bv.shape), bv))
    hit = best_z < BIG
    return (torch.where(hit, best_z, 0.0),
            torch.where(hit, best_f, -1).to(torch.int32),
            torch.where(hit[..., None], best_b, 0.0))


def interpolate(faces, face_id, bary, attrs):
    """Barycentric attribute interpolation: attrs [V,C] → [H,W,C]
    (0 at background)."""
    H, W = face_id.shape
    fid = torch.clamp(face_id.reshape(-1), min=0).long()
    vals = attrs[faces.long()[fid]]                          # [HW,3,C]
    out = (vals * bary.reshape(-1, 3)[..., None]).sum(dim=1)
    out = torch.where(face_id.reshape(-1, 1) >= 0, out, 0.0)
    return out.reshape(H, W, attrs.shape[-1])


def _seg_dist2(pux, puy, ax, ay, bx, by):
    abx, aby = bx - ax, by - ay
    t = ((pux - ax) * abx + (puy - ay) * aby) / (abx ** 2 + aby ** 2 + EPS)
    t = torch.clamp(t, 0.0, 1.0)
    dx, dy = pux - (ax + t * abx), puy - (ay + t * aby)
    return dx ** 2 + dy ** 2


def soft_silhouette(verts_cam, faces, K, H, W, sigma=1e-4, chunk=512,
                    max_elems=1 << 24):
    """Differentiable mask: alpha = 1 − Π_f (1 − sigmoid(d_f/σ)), d_f the
    signed squared pixel distance to face f in NDC-scaled units (pytorch3d
    SoftSilhouetteShader semantics, sigma=1e-4).  Every face reaches every
    pixel here (a far face's factor is ≈ 1, not 1), so the pixels are
    walked in bands of at most max_elems pixel × face pairs."""
    dev = verts_cam.device
    fu, fv, fz, area, ok = _face_setup(verts_cam, faces, K, chunk)
    scale = 2.0 / min(H, W)                                 # px → NDC units
    log_keep = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for ci in range(fu.shape[0] // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        cu, cv = fu[sl][None], fv[sl][None]
        cok, cia = ok[sl][None], area[sl][None]
        for ya, yb, xa, xb in _bands((0, H, 0, W), chunk, max_elems):
            px, py = _pixel_centers(ya, yb, xa, xb, dev)
            px, py = px[:, None], py[:, None]
            w0 = ((cu[..., 1] - px) * (cv[..., 2] - py)
                  - (cu[..., 2] - px) * (cv[..., 1] - py))
            w1 = ((cu[..., 2] - px) * (cv[..., 0] - py)
                  - (cu[..., 0] - px) * (cv[..., 2] - py))
            w2 = cia - w0 - w1
            inside = (w0 * cia >= 0) & (w1 * cia >= 0) & (w2 * cia >= 0)
            d2 = torch.minimum(
                _seg_dist2(px, py, cu[..., 0], cv[..., 0], cu[..., 1],
                           cv[..., 1]),
                torch.minimum(
                    _seg_dist2(px, py, cu[..., 1], cv[..., 1], cu[..., 2],
                               cv[..., 2]),
                    _seg_dist2(px, py, cu[..., 2], cv[..., 2], cu[..., 0],
                               cv[..., 0])))
            d2 = d2 * scale ** 2
            sgn = torch.where(inside, 1.0, -1.0)
            p = torch.sigmoid(sgn * d2 / sigma)
            p = torch.where(cok, p, 0.0)
            keep = torch.log1p(-torch.clamp(p, 0.0, 1.0 - 1e-6)).sum(dim=1)
            log_keep[ya:yb, xa:xb] += keep.reshape(yb - ya, xb - xa)
    return 1.0 - torch.exp(log_keep)
