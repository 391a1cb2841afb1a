"""The stand-in for the demo scenes' absent ``bumpy.obj``, frozen here so
that the benchmark's input cannot move with the program: a bumpy
cube-sphere with the published topology (6 n^2 + 2 vertices with ``vn``
normals, 6 n^2 quads; at n=64 24,578 vertices and 49,152 triangles).

The file is a pure function of (n, radius). ``cached`` writes it once
into the checkout's build directory and returns its path; the program
and the reference both read that file.
"""

from __future__ import annotations

import os

import numpy as np


def write_bumpy_standin(path: str, n: int = 64, radius: float = 1.5) -> None:
    """Vertex positions are the cube lattice projected onto a sphere of
    ``radius``, displaced radially by 8% sinusoidal bumps; normals are
    area-weighted face normals."""
    g = np.arange(n + 1)
    ii, jj, kk = np.meshgrid(g, g, g, indexing="ij")
    lat = np.stack([ii, jj, kk], -1).reshape(-1, 3)
    surf = (lat.min(1) == 0) | (lat.max(1) == n)
    ids = np.full(lat.shape[0], -1, np.int64)
    ids[surf] = np.arange(int(surf.sum()))
    ids = ids.reshape(n + 1, n + 1, n + 1)

    p = lat[surf].astype(np.float64) * (2.0 / n) - 1.0
    u = p / np.linalg.norm(p, axis=1, keepdims=True)
    bump = 1.0 + 0.08 * (np.sin(7.0 * u[:, 0]) * np.sin(7.0 * u[:, 1])
                         * np.sin(7.0 * u[:, 2]))
    verts = u * (radius * bump)[:, None]

    quads = []
    q = np.arange(n)
    qa, qb = np.meshgrid(q, q, indexing="ij")
    qa, qb = qa.ravel(), qb.ravel()
    for axis in range(3):
        ax1, ax2 = (axis + 1) % 3, (axis + 2) % 3
        for side in (0, n):
            def vid(a1, a2):
                c = [None, None, None]
                c[axis] = np.full_like(a1, side)
                c[ax1], c[ax2] = a1, a2
                return ids[c[0], c[1], c[2]]

            corners = [vid(qa, qb), vid(qa + 1, qb), vid(qa + 1, qb + 1),
                       vid(qa, qb + 1)]
            if side == 0:  # (ax1, ax2) winds +axis; reverse on the - side
                corners = corners[::-1]
            quads.append(np.stack(corners, 1))
    quads = np.concatenate(quads, 0)

    tris = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], 0)
    fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                  verts[tris[:, 2]] - verts[tris[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)

    lines = [f"# bumpy cube-sphere stand-in, n={n}, radius={radius}"]
    lines += ["v %.7f %.7f %.7f" % tuple(v) for v in verts]
    lines += ["vn %.7f %.7f %.7f" % tuple(v) for v in vn]
    lines += ["f " + " ".join(f"{i + 1}//{i + 1}" for i in quad)
              for quad in quads]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def cached(cache_dir: str, spec: dict) -> str:
    """The path of the stand-in OBJ of ``spec`` ({"generator":
    "bumpy_standin", "n", "radius"}) under ``cache_dir``, written there
    (through a temporary name, then renamed) if it is not there yet."""
    if spec.get("generator") != "bumpy_standin":
        raise ValueError(f"unknown mesh generator {spec.get('generator')!r}")
    n, radius = int(spec["n"]), float(spec["radius"])
    path = os.path.join(cache_dir, f"bumpy_standin_n{n}_r{radius:g}.obj")
    if not os.path.exists(path):
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".partial"
        write_bumpy_standin(tmp, n, radius)
        os.replace(tmp, path)
    return path
