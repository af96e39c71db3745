"""Minimal PLY mesh IO (ascii + binary little-endian), zero dependencies.

Replaces the reference's plyfile/pytorch3d.io usage
(the reference TexPose code, data/cad_model.py:26-31, compute_box.py ply loads).
Supports the BOP model format: vertex x/y/z (+nx/ny/nz, +rgb colors) and
triangular faces.
"""

from __future__ import annotations

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "int8": "i1", "uint8": "u1",
    "int16": "i2", "uint16": "u2", "int32": "i4", "uint32": "u4",
    "float": "f4", "double": "f8", "float32": "f4", "float64": "f8",
}


def load_ply(path):
    """Returns dict(vertices [V,3] f32, faces [F,3] i32 or None,
    colors [V,3] f32 in [0,1] or None, normals [V,3] f32 or None)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = None
    elements = []       # (name, count, [(prop_name, dtype, is_list, list_count_dtype)])
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append([tok[1], int(tok[2]), []])
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[4], _PLY_DTYPES[tok[3]], True,
                                        _PLY_DTYPES[tok[2]]))
            else:
                elements[-1][2].append((tok[2], _PLY_DTYPES[tok[1]], False, None))

    out = {}
    if fmt == "ascii":
        lines = body.decode("ascii").splitlines()
        cursor = 0
        for name, count, props in elements:
            rows = [lines[cursor + i].split() for i in range(count)]
            cursor += count
            parsed = {}
            if any(p[2] for p in props):
                # list property (faces)
                idx_rows = []
                for r in rows:
                    n = int(r[0])
                    idx_rows.append([int(v) for v in r[1:1 + n]])
                parsed["vertex_indices"] = idx_rows
            else:
                arr = np.asarray(rows, dtype=np.float64)
                for j, (pname, _, _, _) in enumerate(props):
                    parsed[pname] = arr[:, j]
            out[name] = parsed
    else:
        endian = "<" if "little" in fmt else ">"
        offset = 0
        for name, count, props in elements:
            if any(p[2] for p in props):
                idx_rows = []
                # assume a single list property per element (BOP faces)
                pname, item_dt, _, count_dt = props[0]
                item = np.dtype(endian + item_dt)
                cnt = np.dtype(endian + count_dt)
                for _ in range(count):
                    n = int(np.frombuffer(body, cnt, 1, offset)[0])
                    offset += cnt.itemsize
                    idx_rows.append(np.frombuffer(body, item, n, offset).tolist())
                    offset += item.itemsize * n
                out[name] = {"vertex_indices": idx_rows}
            else:
                dt = np.dtype([(p[0], endian + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, offset)
                offset += dt.itemsize * count
                out[name] = {p[0]: arr[p[0]] for p in props}

    v = out["vertex"]
    vertices = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    faces = None
    if "face" in out:
        faces = np.asarray(out["face"]["vertex_indices"], dtype=np.int32)
    colors = None
    if "red" in v:
        colors = np.stack([v["red"], v["green"], v["blue"]], axis=-1).astype(np.float32)
        if colors.max() > 1.0:
            colors = colors / 255.0
    normals = None
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=-1).astype(np.float32)
    return dict(vertices=vertices, faces=faces, colors=colors, normals=normals)


def save_ply(path, vertices, faces=None, colors=None):
    """ASCII PLY writer (fixtures/tests)."""
    vertices = np.asarray(vertices, np.float32)
    lines = ["ply", "format ascii 1.0", f"element vertex {len(vertices)}",
             "property float x", "property float y", "property float z"]
    if colors is not None:
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        lines += [f"element face {len(faces)}",
                  "property list uchar int vertex_indices"]
    lines.append("end_header")
    for i, v in enumerate(vertices):
        row = f"{v[0]} {v[1]} {v[2]}"
        if colors is not None:
            c = (np.clip(colors[i], 0, 1) * 255).astype(np.uint8)
            row += f" {c[0]} {c[1]} {c[2]}"
        lines.append(row)
    if faces is not None:
        for fc in faces:
            lines.append("3 " + " ".join(str(int(x)) for x in fc))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
