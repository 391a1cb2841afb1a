"""A scene configuration (``portbench/configs/<name>.json``) flattened for
the reference: plain float32 numpy tables per shape kind, read from the
configuration's own data and from the OBJ file it names. Nothing here
touches the renderer under test.

Shape order is the configuration's, kind by kind: planes, spheres, rects
(the rectangle lights) and meshes each keep the order in which they are
listed, and so do the lights (rectangle lights and sphere lights as
listed). A sphere light is a sphere whose material is its emission.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

f32 = np.float32

KIND = {"diffuse": 0, "glossy": 1, "reflection": 2, "emitter": 3,
        "phong": 4}
LIGHT_RECT = 0
LIGHT_SPHERE = 1


@dataclasses.dataclass
class Keys:
    """A keyed scale-rotate-translate track: times [K], translate [K, 3],
    scale [K, 3], rotate [K, 4] (w, x, y, z), each rotation normalised."""

    times: np.ndarray
    translate: np.ndarray
    scale: np.ndarray
    rotate: np.ndarray


@dataclasses.dataclass
class Material:
    kind: int
    color: np.ndarray  # [3]
    param: float  # roughness (glossy), power (emitter)


@dataclasses.dataclass
class Mesh:
    v0: np.ndarray  # [T, 3]
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray  # vertex normals [T, 3] (zeros where absent)
    n1: np.ndarray
    n2: np.ndarray
    has_n: np.ndarray  # [T] bool
    gnormal: np.ndarray  # unit geometric normals [T, 3]
    material: Material
    keys: Optional[Keys]


@dataclasses.dataclass
class FlatScene:
    planes: List[dict]
    spheres: List[dict]
    rects: List[dict]
    meshes: List[Mesh]
    lights: List[dict]  # kind, index within the kind, color, power
    moving: bool  # any shape has a transform


def read_obj(path: str):
    """(vertices [V, 3], normals [Vn, 3] or None, triangles [T, 3],
    normal indices [T, 3] or None) of a Wavefront OBJ: ``v``, ``vn`` and
    ``f`` in its four index forms, 1-based or negative; polygons are
    fanned from their first vertex."""
    verts, norms, tris, ntris = [], [], [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "vn":
                norms.append([float(x) for x in p[1:4]])
            elif p[0] == "f":
                vi, ni = [], []
                for tok in p[1:]:
                    c = tok.split("/")
                    v = int(c[0])
                    vi.append(v - 1 if v > 0 else len(verts) + v)
                    if len(c) >= 3 and c[2]:
                        n = int(c[2])
                        ni.append(n - 1 if n > 0 else len(norms) + n)
                    else:
                        ni.append(-1)
                for k in range(1, len(vi) - 1):
                    tris.append((vi[0], vi[k], vi[k + 1]))
                    ntris.append((ni[0], ni[k], ni[k + 1]))
    v = np.asarray(verts, f32).reshape(-1, 3)
    n = np.asarray(norms, f32).reshape(-1, 3) if norms else None
    return (v, n, np.asarray(tris, np.int64).reshape(-1, 3),
            np.asarray(ntris, np.int64).reshape(-1, 3) if norms else None)


def _keys(spec) -> Optional[Keys]:
    """The track of a shape's ``transform``, None for none or the
    identity (one key that moves nothing)."""
    if not spec:
        return None
    k = len(spec["times"])
    ident = (k == 1
             and list(spec.get("translations", [[0.0] * 3])[0]) == [0.0] * 3
             and list(spec.get("scales", [[1.0] * 3])[0]) == [1.0] * 3
             and list(spec.get("rotations", [[1.0, 0.0, 0.0, 0.0]])[0])
             == [1.0, 0.0, 0.0, 0.0])
    if ident:
        return None
    rot = np.asarray(spec.get("rotations", [[1.0, 0.0, 0.0, 0.0]] * k),
                     f32).reshape(k, 4)
    rot = rot / np.maximum(np.linalg.norm(rot, axis=-1, keepdims=True),
                           f32(1e-37))
    return Keys(
        times=np.asarray(spec["times"], f32).reshape(k),
        translate=np.asarray(spec.get("translations", [[0.0] * 3] * k),
                             f32).reshape(k, 3),
        scale=np.asarray(spec.get("scales", [[1.0] * 3] * k),
                         f32).reshape(k, 3),
        rotate=rot.astype(f32))


def _material(cfg, name) -> Material:
    m = cfg["materials"][name]
    return Material(KIND[m["kind"]], np.asarray(m["color"], f32),
                    float(m.get("roughness", m.get("exponent", 0.0))))


def _emitter(color, power) -> Material:
    return Material(KIND["emitter"], np.asarray(color, f32), float(power))


def _mesh(verts, tris, norms, ntris, material, keys) -> Mesh:
    v0, v1, v2 = (verts[tris[:, k]] for k in range(3))
    t = tris.shape[0]
    if norms is not None and ntris is not None:
        has_n = (ntris >= 0).all(axis=-1)
        safe = np.maximum(ntris, 0)
        n0, n1, n2 = (norms[safe[:, k]] for k in range(3))
    else:
        has_n = np.zeros(t, bool)
        n0 = n1 = n2 = np.zeros((t, 3), f32)
    gn = np.cross(v1 - v0, v2 - v0)
    gl = np.linalg.norm(gn, axis=-1, keepdims=True)
    gn = (gn / np.maximum(gl, f32(1e-37))).astype(f32)
    return Mesh(v0, v1, v2, n0, n1, n2, has_n, gn, material, keys)


def flatten(cfg: dict, obj_paths: dict) -> FlatScene:
    """The configuration ``cfg`` as flat tables; ``obj_paths`` maps each of
    its ``meshes`` entries to the OBJ file written for it."""
    planes, spheres, rects, meshes, lights = [], [], [], [], []
    moving = False
    for s in cfg["shapes"]:
        keys = _keys(s.get("transform"))
        moving |= keys is not None
        kind = s["type"]
        if kind == "plane":
            n = np.asarray(s["normal"], f32)
            n = n / np.maximum(np.linalg.norm(n), f32(1e-37))
            planes.append(dict(pos=np.asarray(s["position"], f32),
                               normal=n.astype(f32),
                               bullseye=bool(s.get("bullseye", False)),
                               material=_material(cfg, s["material"]),
                               keys=keys))
        elif kind in ("sphere", "sphere_light"):
            mat = (_emitter(s["color"], s["power"]) if kind == "sphere_light"
                   else _material(cfg, s["material"]))
            spheres.append(dict(center=np.asarray(s["position"], f32),
                                radius=f32(s["radius"]), material=mat,
                                keys=keys))
            if kind == "sphere_light":
                lights.append(dict(kind=LIGHT_SPHERE, index=len(spheres) - 1,
                                   color=np.asarray(s["color"], f32),
                                   power=f32(s["power"])))
        elif kind == "rect_light":
            rects.append(dict(corner=np.asarray(s["corner"], f32),
                              side1=np.asarray(s["side1"], f32),
                              side2=np.asarray(s["side2"], f32),
                              material=_emitter(s["color"], s["power"]),
                              keys=keys))
            lights.append(dict(kind=LIGHT_RECT, index=len(rects) - 1,
                               color=np.asarray(s["color"], f32),
                               power=f32(s["power"])))
        elif kind == "mesh":
            mat = _material(cfg, s["material"])
            if "obj" in s:
                verts, norms, tris, ntris = read_obj(obj_paths[s["obj"]])
            else:
                verts = np.asarray(s["vertices"], f32).reshape(-1, 3)
                tris = np.asarray(s["indices"], np.int64).reshape(-1, 3)
                norms = ntris = None
            meshes.append(_mesh(verts, tris, norms, ntris, mat, keys))
        else:
            raise ValueError(f"unknown shape type {kind!r}")
    return FlatScene(planes, spheres, rects, meshes, lights, moving)
