"""Wavefront OBJ reader -> fan-triangulated TriangleMesh (counterpart of
``rayito_tpu/models/obj.py``, same parser and the same native-or-Python
rule).

Handles ``v`` and ``vn``, parses and drops ``vt``; ``f`` accepts the four
index forms, 1-based and negative indices; out-of-range indices warn and
drop the vertex; returns None when no vertices were read. Polygon faces are
fan-triangulated, with ``face_ids`` pointing back to the polygon.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

from .scene import Material, TriangleMesh


def load_obj(path: str, material: Material) -> Optional[TriangleMesh]:
    # fast path: native C++ parser (utils/native.py); falls back to Python
    from ..utils.native import parse_obj as native_parse

    parsed = native_parse(path) if os.path.exists(path) else None
    if parsed is not None:
        vertices_a, normals_a, tri_idx, tri_nidx, face_ids = parsed
        return TriangleMesh(
            vertices=vertices_a,
            indices=tri_idx,
            material=material,
            normals=normals_a,
            normal_indices=tri_nidx if normals_a is not None else None,
            face_ids=face_ids,
        )
    return load_obj_python(path, material)


def load_obj_python(path: str, material: Material) -> Optional[TriangleMesh]:
    """Pure-Python reference implementation (also the no-native fallback)."""
    vertices: list = []
    normals: list = []
    # per-face lists of (vertex_idx, normal_idx) pairs
    faces: list = []

    def resolve(idx: int, count: int, what: str, line_no: int) -> Optional[int]:
        # 1-based; negative = from the end
        out = idx - 1 if idx > 0 else count + idx
        if out < 0 or out >= count:
            print(
                f"obj: {what} index {idx} out of range at line {line_no}",
                file=sys.stderr,
            )
            return None
        return out

    with open(path, "r") as f:
        for line_no, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            cmd = parts[0]
            if cmd == "v" and len(parts) >= 4:
                vertices.append(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
            elif cmd == "vn" and len(parts) >= 4:
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif cmd == "vt":
                pass  # parsed-but-dropped, like the reference
            elif cmd == "f":
                fv = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = resolve(int(comps[0]), len(vertices), "vertex", line_no)
                    if vi is None:
                        continue
                    ni = -1
                    if len(comps) >= 3 and comps[2]:
                        r = resolve(int(comps[2]), len(normals), "normal", line_no)
                        ni = r if r is not None else -1
                    fv.append((vi, ni))
                if len(fv) >= 3:
                    faces.append(fv)
            # '#', 'o', 's', 'g', 'usemtl', 'mtllib' and anything else: ignored

    if not vertices:
        return None

    tri_idx = []
    tri_nidx = []
    face_ids = []
    for fid, fv in enumerate(faces):
        # fan triangulation rooted at vertex 0 (same decomposition the
        # reference walks per-intersect, RMesh.h:71-76)
        for k in range(1, len(fv) - 1):
            tri_idx.append((fv[0][0], fv[k][0], fv[k + 1][0]))
            tri_nidx.append((fv[0][1], fv[k][1], fv[k + 1][1]))
            face_ids.append(fid)

    return TriangleMesh(
        vertices=np.asarray(vertices, np.float32),
        indices=np.asarray(tri_idx, np.int32).reshape(-1, 3),
        material=material,
        normals=np.asarray(normals, np.float32).reshape(-1, 3)
        if normals
        else None,
        normal_indices=np.asarray(tri_nidx, np.int32).reshape(-1, 3)
        if normals
        else None,
        face_ids=np.asarray(face_ids, np.int32),
    )
