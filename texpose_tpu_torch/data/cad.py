"""CAD model container: vertices, 8-corner bbox, diameter, max-axis scale.

Capability parity with the reference TexPose code, data/cad_model.py:26-50 (corner
ordering preserved: x-major, then y, then z).
"""

from __future__ import annotations

import numpy as np

from .ply import load_ply


class CADModel:
    def __init__(self, path=None):
        self.vertices = None
        self.faces = None
        self.colors = None
        self.normals = None
        self.bb = None
        self.diameter = None
        self.scale = None
        if path is not None:
            self.load(path)

    def load(self, path):
        mesh = load_ply(path)
        self.vertices = mesh["vertices"].astype(np.float64)
        self.faces = mesh["faces"]
        self.colors = mesh["colors"]
        self.normals = mesh["normals"]
        mn = self.vertices.min(axis=0)
        mx = self.vertices.max(axis=0)
        self.minx, self.miny, self.minz = mn
        self.maxx, self.maxy, self.maxz = mx
        corners = []
        for x in (self.minx, self.maxx):
            for y in (self.miny, self.maxy):
                for z in (self.minz, self.maxz):
                    corners.append([x, y, z])
        # reference ordering: [(mnx,mny,mnz),(mnx,mxy,mnz),(mnx,mny,mxz),
        # (mnx,mxy,mxz),(mxx,...)] — z fastest after y; reorder to match
        corners = np.asarray(corners, np.float32)
        order = [0, 2, 1, 3, 4, 6, 5, 7]
        self.bb = corners[order]
        d = self.bb[None, :, :] - self.bb[:, None, :]
        self.diameter = float(np.sqrt((d ** 2).sum(-1)).max())
        self.scale = float(max(self.maxx - self.minx, self.maxy - self.miny,
                               self.maxz - self.minz))
        return self

    @property
    def aabb(self):
        """(min [3], max [3])."""
        return self.bb[0].copy(), self.bb[-1].copy()
