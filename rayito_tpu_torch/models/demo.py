"""The stage-6 demo scene, the big five-instance scene, and a procedural
stand-in for their mesh asset (counterpart of ``rayito_tpu/models/demo.py``).

``write_bumpy_standin`` writes an OBJ file with the published topology of
the reference's ``bumpy.obj`` (24,578 vertices, 24,576 quads at n=64): a
cube-sphere with n x n quads per face and a deterministic sinusoidal bump.
Both packages load it through their own ``stage6_scene(obj_path)``.
"""

from __future__ import annotations

import numpy as np

from .scene import (
    DiffuseMaterial,
    GlossyMaterial,
    Plane,
    RectangleLight,
    Scene,
    ShapeLight,
    Sphere,
    TriangleMesh,
)

STAGE6_CAMERA = ((-2.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))


def inline_box_mesh(material) -> TriangleMesh:
    """The hand-built 8-vertex open box of the stage-6/7 scenes: 6 quad
    faces (one duplicated, as in the reference), no normals."""
    verts = np.array(
        [[0.0, -2.0, -2.0], [1.0, -2.0, -2.0], [1.0, -1.0, -2.0],
         [0.0, -1.0, -2.0], [0.0, -2.0, -1.0], [1.0, -2.0, -1.0],
         [1.0, -1.0, -1.0], [0.0, -1.0, -1.0]],
        np.float32,
    )
    quads = [(0, 1, 2, 3), (1, 5, 6, 2), (5, 4, 7, 6), (4, 0, 3, 7),
             (3, 2, 6, 7), (3, 2, 6, 7)]
    tris, fids = [], []
    for fid, (a, b, c, d) in enumerate(quads):
        tris += [(a, b, c), (a, c, d)]
        fids += [fid, fid]
    return TriangleMesh(
        vertices=verts, indices=np.array(tris, np.int32), material=material,
        face_ids=np.array(fids, np.int32),
    )


def stage6_scene(obj_path: str) -> Scene:
    """Stage-6 demo scene: bullseye plane, 4 spheres, the inline box, the
    OBJ mesh at ``obj_path`` (glossy red), a rect light and a sphere
    ShapeLight at (1, 0.5, 2)."""
    from .obj import load_obj

    s = Scene()
    blueish = DiffuseMaterial((0.7, 0.7, 0.9))
    purplish = DiffuseMaterial((0.8, 0.3, 0.7))
    yellowish = DiffuseMaterial((0.7, 0.7, 0.2))
    bluish_glossy = GlossyMaterial((0.5, 0.3, 0.8), 0.3)
    greenish_glossy = GlossyMaterial((0.3, 0.9, 0.3), 0.1)
    reddish_lambert = DiffuseMaterial((0.8, 0.3, 0.1))
    reddish_glossy = GlossyMaterial((0.8, 0.1, 0.1), 0.3)
    s.add(Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0), blueish, bullseye=True))
    s.add(Sphere((3.0, -1.0, 0.0), 1.0, purplish))
    s.add(Sphere((-3.0, 0.0, -2.0), 2.0, greenish_glossy))
    s.add(Sphere((1.5, -1.5, 2.5), 0.5, bluish_glossy))
    s.add(Sphere((-2.0, -1.5, 1.0), 0.5, yellowish))
    s.add(inline_box_mesh(reddish_lambert))
    obj = load_obj(obj_path, reddish_glossy)
    if obj is not None:
        s.add(obj)
    s.add(RectangleLight((-1.5, 4.0, -1.5), (3.0, 0.0, 0.0), (0.0, 0.0, 3.0),
                         (1.0, 1.0, 1.0), 5.0))
    s.add(ShapeLight(Sphere((1.0, 0.5, 2.0), 0.5, blueish),
                     color=(1.0, 1.0, 0.3), power=10.0))
    return s


def big_streamed_scene(obj_path: str) -> Scene:
    """The scale stressor: five shifted instances of the OBJ mesh at
    ``obj_path`` (about 245k triangles for ``bumpy.obj`` or the n=64
    stand-in, ~1,920 clusters in one merged world-space traversal domain)
    over a ground plane under one area light. Instance normals come from
    the OBJ."""
    from .obj import load_obj

    mesh0 = load_obj(obj_path, DiffuseMaterial((0.5, 0.5, 0.5)))
    if mesh0 is None:
        raise FileNotFoundError(obj_path)
    verts = np.asarray(mesh0.vertices, np.float32)
    idx = np.asarray(mesh0.indices, np.int32)
    s = Scene()
    s.add(Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                DiffuseMaterial((0.7, 0.7, 0.7))))
    mats = [DiffuseMaterial((0.8, 0.3, 0.2)),
            GlossyMaterial((0.3, 0.7, 0.3), 0.25),
            DiffuseMaterial((0.3, 0.3, 0.8)),
            GlossyMaterial((0.8, 0.8, 0.2), 0.15),
            DiffuseMaterial((0.7, 0.4, 0.7))]
    offs = [(-5.0, 0, 0), (-2.5, 1.0, -2.0), (0.0, 0, 0),
            (2.5, 1.0, -2.0), (5.0, 0, 0)]
    for off, mat in zip(offs, mats):
        s.add(TriangleMesh(
            vertices=verts + np.asarray(off, np.float32),
            indices=idx, material=mat,
            normals=mesh0.normals, normal_indices=mesh0.normal_indices,
        ))
    s.add(RectangleLight((-4, 10, -4), (8, 0, 0), (0, 0, 8),
                         (1.0, 1.0, 1.0), 3.0))
    return s


def write_bumpy_standin(path: str, n: int = 64, radius: float = 1.5) -> None:
    """Write a bumpy cube-sphere OBJ: 6 n^2 + 2 vertices with ``vn``
    normals and 6 n^2 outward-wound quads. Vertex positions are the cube
    lattice projected onto a sphere of ``radius``, displaced radially by
    8% sinusoidal bumps; normals are area-weighted face normals. The file
    is a pure function of (n, radius)."""
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
