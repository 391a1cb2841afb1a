"""The stage 1-7 demo scenes, the big five-instance scene,
the seeded many-shape and many-light scenes, and a procedural stand-in for
the demos' mesh asset (counterpart of ``rayito_tpu/models/demo.py``).

``write_bumpy_standin`` writes an OBJ file with the published topology of
the reference's ``bumpy.obj`` (24,578 vertices, 24,576 quads at n=64): a
cube-sphere with n x n quads per face and a deterministic sinusoidal bump.
Both packages load it through their own ``stage6_scene(obj_path)`` and
``stage7_scene1(obj_path)``.
"""

from __future__ import annotations

import math

import numpy as np

from . import scene as _own
from .scene import (
    DiffuseMaterial,
    GlossyMaterial,
    PhongMaterial,
    Plane,
    RectangleLight,
    ReflectionMaterial,
    Scene,
    ShapeLight,
    Sphere,
    Transform,
    TriangleMesh,
)


def stage1_scene() -> Scene:
    """Stage 1: one pink plane at y = -2, no bullseye."""
    s = Scene()
    s.add(Plane(position=(0.0, -2.0, 0.0), normal=(0.0, 1.0, 0.0),
                material=DiffuseMaterial((1.0, 0.5, 0.8))))
    return s


STAGE1_CAMERA = ((0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0))
STAGE1_FOV = 30.0


def stage2_scene() -> Scene:
    """Stage 2: a white bullseye plane and two rect lights."""
    s = Scene()
    s.add(Plane(position=(0.0, -2.0, 0.0), normal=(0.0, 1.0, 0.0),
                material=DiffuseMaterial((1.0, 1.0, 1.0)), bullseye=True))
    s.add(RectangleLight(corner=(-2.5, 2.0, -2.5), side1=(5.0, 0.0, 0.0),
                         side2=(0.0, 0.0, 5.0), color=(1.0, 0.5, 1.0),
                         power=3.0))
    s.add(RectangleLight(corner=(-2.0, -1.0, -2.0), side1=(4.0, 0.0, 0.0),
                         side2=(0.0, 0.0, 4.0), color=(1.0, 1.0, 0.5),
                         power=0.75))
    return s


STAGE23_CAMERA = ((0.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
STAGE23_FOV = 45.0


def stage3_scene() -> Scene:
    """Stages 3 and 4 (the same scene): a bullseye plane, a diffuse and a
    phong sphere, a rect light and a sphere ShapeLight."""
    s = Scene()
    blueish = DiffuseMaterial((0.9, 0.9, 1.0))
    purplish = DiffuseMaterial((0.9, 0.7, 0.8))
    greenish = PhongMaterial((0.7, 0.9, 0.7), 16.0)
    s.add(Plane(position=(0.0, -2.0, 0.0), normal=(0.0, 1.0, 0.0),
                material=blueish, bullseye=True))
    s.add(Sphere(position=(3.0, -1.0, 0.0), radius=1.0, material=purplish))
    s.add(Sphere(position=(-3.0, 0.0, -2.0), radius=2.0, material=greenish))
    s.add(RectangleLight(corner=(-2.5, 4.0, -2.5), side1=(5.0, 0.0, 0.0),
                         side2=(0.0, 0.0, 5.0), color=(1.0, 1.0, 1.0),
                         power=1.0))
    s.add(ShapeLight(
        Sphere(position=(0.0, 0.0, 2.0), radius=1.0, material=blueish),
        color=(1.0, 1.0, 0.1), power=4.0))
    return s


def stage5_scene() -> Scene:
    """Stage-5 demo scene: bullseye plane, 4 spheres (2 diffuse, 2 glossy), a
    3 x 3 rect light of power 5 and a sphere ShapeLight of power 10."""
    s = Scene()
    blueish = DiffuseMaterial((0.7, 0.7, 0.9))
    purplish = DiffuseMaterial((0.8, 0.3, 0.7))
    yellowish = DiffuseMaterial((0.7, 0.7, 0.2))
    bluish_glossy = GlossyMaterial((0.5, 0.3, 0.8), 0.3)
    greenish_glossy = GlossyMaterial((0.3, 0.9, 0.3), 0.1)
    s.add(Plane(position=(0.0, -2.0, 0.0), normal=(0.0, 1.0, 0.0),
                material=blueish, bullseye=True))
    s.add(Sphere(position=(3.0, -1.0, 0.0), radius=1.0, material=purplish))
    s.add(Sphere(position=(-3.0, 0.0, -2.0), radius=2.0,
                 material=greenish_glossy))
    s.add(Sphere(position=(1.5, -1.5, 2.5), radius=0.5,
                 material=bluish_glossy))
    s.add(Sphere(position=(-2.0, -1.5, 1.0), radius=0.5, material=yellowish))
    s.add(RectangleLight(corner=(-1.5, 4.0, -1.5), side1=(3.0, 0.0, 0.0),
                         side2=(0.0, 0.0, 3.0), color=(1.0, 1.0, 1.0),
                         power=5.0))
    s.add(ShapeLight(
        Sphere(position=(0.0, 0.5, 2.0), radius=0.5, material=blueish),
        color=(1.0, 1.0, 0.3), power=10.0))
    return s


STAGE5_CAMERA = ((0.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))

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


# ---------------------------------------------------------------------------
# Stage 7: keyed transforms, motion blur
# ---------------------------------------------------------------------------


def _axis_angle(axis, angle):
    """Host-side axis-angle quaternion (w, x, y, z) about the normalised
    ``axis``."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    h = angle * 0.5
    s = math.sin(h)
    return (math.cos(h), a[0] * s, a[1] * s, a[2] * s)


def _cube(pkg, material):
    """The unit cube of the stage-7 scenes from ``pkg``'s TriangleMesh: 8
    vertices at [0, 1]^3, 6 quad faces with the last duplicated, as in the
    reference renderer."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    quads = [(0, 1, 2, 3), (1, 5, 6, 2), (5, 4, 7, 6), (4, 0, 3, 7),
             (3, 2, 6, 7), (3, 2, 6, 7)]
    tris, fids = [], []
    for fid, (a, b, c, d) in enumerate(quads):
        tris += [(a, b, c), (a, c, d)]
        fids += [fid, fid]
    return pkg.TriangleMesh(
        vertices=verts, indices=np.array(tris, np.int32), material=material,
        face_ids=np.array(fids, np.int32),
    )


def make_cube(material) -> TriangleMesh:
    """The unit cube of the stage-7 scenes (``_cube``)."""
    return _cube(_own, material)


def _keys(times, translations, rotations=None) -> Transform:
    n = len(times)
    return Transform(times=list(times), translations=list(translations),
                     scales=[(1.0, 1.0, 1.0)] * n,
                     rotations=list(rotations or [(1.0, 0.0, 0.0, 0.0)] * n))


def stage7_scene1(obj_path: str) -> Scene:
    """Stage-7 demo scene 1: a keyed transform on every shape, a
    translating sphere (motion blur), a cube rotating 45 degrees about Y
    over the shutter, the OBJ mesh at ``obj_path`` under a three-key
    rotation, and a four-key animated sphere light of power 100. The
    rotation keys are the correct products (the reference renderer's
    concatenating rotate() chains through an aliasing-bugged product;
    ``ops.quaternion.multiply_buggy`` reproduces it)."""
    from .obj import load_obj

    s = Scene()
    blueish = DiffuseMaterial((0.6, 0.6, 0.9))
    purplish = DiffuseMaterial((0.8, 0.3, 0.7))
    reddish = DiffuseMaterial((0.8, 0.3, 0.1))
    bluish_glossy = GlossyMaterial((0.5, 0.3, 0.8), 0.3)
    greenish_glossy = GlossyMaterial((0.3, 0.9, 0.3), 0.1)
    reddish_glossy = GlossyMaterial((0.8, 0.1, 0.1), 0.3)
    reflective = ReflectionMaterial((0.7, 0.7, 0.2))
    origin = (0.0, 0.0, 0.0)

    s.add(Plane(origin, (0.0, 1.0, 0.0), blueish, bullseye=True,
                transform=Transform(times=[0.0],
                                    translations=[(0.0, -2.0, 0.0)])))
    s.add(Sphere(origin, 1.0, purplish, transform=_keys(
        [0.0, 1.0], [(2.0, -1.0, 0.0), (3.0, -1.0, 0.0)])))
    for radius, mat, pos in ((2.0, greenish_glossy, (-3.0, 0.0, -2.0)),
                             (0.5, bluish_glossy, (1.5, -1.5, 2.5)),
                             (0.5, reflective, (-2.0, -1.5, 1.0))):
        s.add(Sphere(origin, radius, mat,
                     transform=Transform(times=[0.0], translations=[pos])))
    cube = make_cube(reddish)
    cube.transform = _keys([0.0, 1.0], [(0.0, -2.0, -2.0)] * 2,
                           [(1.0, 0.0, 0.0, 0.0),
                            _axis_angle((0, 1, 0), math.pi / 4)])
    s.add(cube)
    obj = load_obj(obj_path, reddish_glossy)
    if obj is not None:
        obj.transform = _keys([0.0, 0.5, 1.0], [(0.2, 0.0, 0.0)] * 3,
                              [(1.0, 0.0, 0.0, 0.0),
                               _axis_angle((0, 1, 0), math.pi / 4),
                               _axis_angle((0, 1, 0), 3 * math.pi / 4)])
        s.add(obj)
    s.add(RectangleLight(origin, (3.0, 0.0, 0.0), (0.0, 0.0, 3.0),
                         (1.0, 1.0, 1.0), 5.0,
                         transform=Transform(times=[0.0],
                                             translations=[(-1.5, 4.0, -1.5)])))
    s.add(ShapeLight(
        Sphere(origin, 0.1, blueish, transform=_keys(
            [0.0, 0.33, 0.67, 1.0],
            [(0.0, 0.5, 4.0), (0.0, 1.5, 4.0), (1.0, 1.5, 4.0),
             (1.0, 0.5, 4.0)])),
        color=(1.0, 1.0, 0.3), power=100.0,
    ))
    return s


STAGE7_CAMERA = ((-4.0, 5.0, 15.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))


def kinematic_position(start, velocity, time, gravity=(0.0, -9.8, 0.0),
                       ground_height: float = 0.0):
    """Closed-form gravity with one bounce off the ground plane."""
    start = np.asarray(start, np.float64)
    velocity = np.asarray(velocity, np.float64)
    gravity = np.asarray(gravity, np.float64)
    up = -gravity / np.linalg.norm(gravity)
    v_up = velocity @ up
    p_up = start @ up
    a_up = -np.linalg.norm(gravity)
    disc = v_up * v_up - 2.0 * a_up * p_up
    if disc > 0.0:
        t_hit = (-v_up - np.sqrt(disc)) / a_up
        if t_hit < time:
            isect = start + velocity * t_hit + gravity * (t_hit * t_hit * 0.5)
            v_hit = velocity + gravity * t_hit
            v_reb = v_hit - 2.0 * up * (v_hit @ up)
            t_reb = time - t_hit
            return tuple(isect + v_reb * t_reb + gravity * (t_reb * t_reb * 0.5))
    return tuple(start + velocity * time + gravity * (time * time * 0.5))


def stage7_scene2() -> Scene:
    """Stage-7 demo scene 2: ten bouncing spheres and ten tumbling cubes,
    all motion-blurred by two-key transforms, under a rect light of power
    50 (the reference's bench.py stage-7b frame)."""
    s = Scene()
    blueish = DiffuseMaterial((0.6, 0.6, 0.9))
    yellowish_glossy = GlossyMaterial((0.9, 0.9, 0.3), 0.3)
    red = DiffuseMaterial((1.0, 0.2, 0.2))
    s.add(Plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), red, bullseye=True))
    dt = 0.2
    t_off = 0.0  # accumulated, as the reference does: its bits matter
    for _ in range(10):
        p = [kinematic_position((-10.0, 10.0, 0.0), (4.5, 0.0, 0.0), t)
             for t in (t_off, t_off + dt)]
        s.add(Sphere((0.0, 0.0, 0.0), 1.0, blueish,
                     transform=_keys([0.0, 1.0], p)))
        t_off += dt * 2.0
    t_off = 0.0
    for _ in range(10):
        p = [kinematic_position((10.0, 10.0, 2.0), (-4.5, 0.0, 0.0), t)
             for t in (t_off, t_off + dt)]
        rot0 = t_off * math.pi * 0.5
        if rot0 > math.pi * 2.0:
            rot0 -= math.pi * 2.0
        rot1 = rot0 + dt * math.pi * 0.5
        cube = make_cube(yellowish_glossy)
        cube.transform = _keys([0.0, 1.0], p,
                               [_axis_angle((1.0, 0.0, 1.0), rot0),
                                _axis_angle((1.0, 0.0, 1.0), rot1)])
        s.add(cube)
        t_off += dt * 2.0
    s.add(RectangleLight((0.0, 0.0, 0.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0),
                         (1.0, 1.0, 1.0), 50.0,
                         transform=Transform(times=[0.0],
                                             translations=[(-1.0, 15.0, 1.0)])))
    return s


STAGE7_SCENE2_CAMERA = ((-4.0, 10.0, 30.0), (0.0, 5.0, 0.0), (0.0, 1.0, 0.0))


# ---------------------------------------------------------------------------
# Seeded many-shape and many-light scenes (those of the reference's scale
# tests, tests/test_rolled_scale.py). ``pkg`` is the package whose classes
# build the scene: this one by default; the parity tests pass the reference
# package, so that both build the same scene from one definition.
# ---------------------------------------------------------------------------


def _two_key_translation(pkg, rs):
    tr = pkg.Transform()
    tr.set_translation(0.0, tuple(rs.uniform(-0.5, 0.5, 3)))
    tr.set_translation(1.0, tuple(rs.uniform(-0.5, 0.5, 3)))
    return tr


def many_spheres_scene(motion: bool = False, twins: bool = False, pkg=None):
    """A plane, 40 seeded spheres and a rect light. With ``motion`` every
    third sphere has a two-key translation; with ``twins`` sphere 30 is
    sphere 18 again."""
    pkg = pkg or _own
    rs = np.random.default_rng(5)
    b = pkg.Scene()
    b.add(pkg.Plane((0, -2, 0), (0, 1, 0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.7))))
    mats = [pkg.DiffuseMaterial((0.8, 0.3, 0.2)),
            pkg.GlossyMaterial((0.2, 0.6, 0.8), 0.25)]
    spheres = []
    for i in range(40):
        spheres.append((tuple(rs.uniform(-6, 6, 3)),
                        float(rs.uniform(0.2, 0.5))))
        if twins and i == 30:
            spheres[30] = spheres[18]
        sph = pkg.Sphere(*spheres[i], mats[i % 2])
        if motion and i % 3 == 0:
            sph.transform = _two_key_translation(pkg, rs)
        b.add(sph)
    b.add(pkg.RectangleLight((-3, 9, -3), (6, 0, 0), (0, 0, 6),
                             (1.0, 1.0, 1.0), 3.0))
    return b


def many_rects_scene(motion: bool = False, pkg=None):
    """A plane and 40 seeded rect lights (no sphere: the sphere tables are
    empty). With ``motion`` every third rect has a two-key translation."""
    pkg = pkg or _own
    rs = np.random.default_rng(7)
    b = pkg.Scene()
    b.add(pkg.Plane((0, -2, 0), (0, 1, 0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.7))))
    for i in range(40):
        r = pkg.RectangleLight(
            tuple(rs.uniform(-6, 6, 3)), tuple(rs.uniform(-1.5, 1.5, 3)),
            tuple(rs.uniform(-1.5, 1.5, 3)), tuple(rs.uniform(0.5, 1.0, 3)),
            2.0)
        if motion and i % 3 == 0:
            r.transform = _two_key_translation(pkg, rs)
        b.add(r)
    return b


def sixteen_lights_scene(pkg=None):
    """A plane, a glossy sphere, 8 rect and 8 sphere lights."""
    pkg = pkg or _own
    rs = np.random.default_rng(9)
    b = pkg.Scene()
    b.add(pkg.Plane((0, -1, 0), (0, 1, 0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.7))))
    b.add(pkg.Sphere((0.0, 0.5, 0.0), 1.0,
                     pkg.GlossyMaterial((0.8, 0.7, 0.2), 0.3)))
    for i in range(16):
        if i % 2 == 0:
            b.add(pkg.RectangleLight(
                tuple(rs.uniform(-6, 6, 3) + np.asarray([0, 6, 0])),
                (1.5, 0, 0), (0, 0, 1.5), tuple(rs.uniform(0.5, 1.0, 3)),
                2.0))
        else:
            b.add(pkg.ShapeLight(
                pkg.Sphere(tuple(rs.uniform(-6, 6, 3) + np.asarray([0, 5, 0])),
                           0.4, None),
                tuple(rs.uniform(0.5, 1.0, 3)), 3.0))
    return b


def many_sphere_lights_scene(pkg=None):
    """A plane, a glossy sphere and 65 seeded small sphere lights above
    them (more than the 64 the card's shading once took): static."""
    pkg = pkg or _own
    rs = np.random.default_rng(65)
    b = pkg.Scene()
    b.add(pkg.Plane((0, -1, 0), (0, 1, 0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.7))))
    b.add(pkg.Sphere((0.0, 0.5, 0.0), 1.0,
                     pkg.GlossyMaterial((0.8, 0.7, 0.2), 0.3)))
    for _ in range(65):
        b.add(pkg.ShapeLight(
            pkg.Sphere(tuple(rs.uniform((-5.0, 3.0, -5.0), (5.0, 6.0, 5.0))),
                       0.25, None),
            tuple(rs.uniform(0.5, 1.0, 3)), 3.0))
    return b


def deep_light_scene(pkg=None):
    """A sphere light inside nine nested groups, each drifting over the
    shutter and the outermost turning about Y (a light chain of nine
    links, past the 8 the card's shading once took), over a plane and a
    glossy sphere, beside an unnested rect light."""
    pkg = pkg or _own
    s = pkg.Scene()
    s.add(pkg.Plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.6, 0.6, 0.9))))
    s.add(pkg.Sphere((0.0, 0.0, 0.0), 1.0,
                     pkg.GlossyMaterial((0.8, 0.3, 0.1), 0.3)))
    node = pkg.ShapeLight(pkg.Sphere((1.0, 2.0, 0.5), 0.5, None),
                          (1.0, 0.9, 0.6), 6.0)
    for g in range(9):
        group = pkg.Group()
        group.transform.set_translation(0.0, (0.04, 0.0, 0.0))
        group.transform.set_translation(1.0, (0.04, 0.03 * g, -0.02))
        if g == 8:
            group.transform.set_rotation(0.0, (1.0, 0.0, 0.0, 0.0))
            group.transform.set_rotation(
                1.0, (math.cos(math.pi / 8), 0.0, math.sin(math.pi / 8), 0.0))
        group.add(node)
        node = group
    s.add(node)
    s.add(pkg.RectangleLight((-2.0, 3.5, -1.0), (1.5, 0.0, 0.0),
                             (0.0, 0.0, 1.5), (1.0, 1.0, 1.0), 4.0))
    return s


# ---------------------------------------------------------------------------
# Scenes that hold the tiny-mesh fold and the 'xla' pipeline at their edges
# (``pkg`` as above, where the reference's copy is compared)
# ---------------------------------------------------------------------------


def one_key_cube_scene(pkg=None):
    """A cube under one key of translation, scale and an unnormalised
    rotation over a plane: every transform slot has one key, so the tables
    have K == 1 and the rotation is taken as it is (no nlerp)."""
    pkg = pkg or _own
    s = pkg.Scene()
    s.add(pkg.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.6, 0.6, 0.9))))
    cube = _cube(pkg, pkg.DiffuseMaterial((0.8, 0.3, 0.1)))
    cube.transform = pkg.Transform(
        times=[0.0], translations=[(-0.4, -0.3, 0.2)],
        scales=[(1.3, 0.9, 1.1)], rotations=[(0.9, 0.2, 0.3, 0.1)])
    s.add(cube)
    return s


def nested_cube_scene(pkg=None):
    """A cube with two keys of its own inside a group that turns about Y
    and drifts over the shutter (a transform chain of depth 2), a cube of
    one translated link beside it, over a plane."""
    pkg = pkg or _own
    s = pkg.Scene()
    s.add(pkg.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.6, 0.6, 0.9))))
    group = pkg.Group()
    group.transform.set_rotation(0.0, (1.0, 0.0, 0.0, 0.0))
    group.transform.set_rotation(
        1.0, (math.cos(math.pi / 5), 0.0, math.sin(math.pi / 5), 0.0))
    group.transform.set_translation(1.0, (0.3, 0.1, 0.0))
    cube = _cube(pkg, pkg.DiffuseMaterial((0.8, 0.3, 0.1)))
    cube.transform.set_translation(0.0, (-0.6, -0.5, -0.4))
    cube.transform.set_translation(1.0, (-0.2, -0.5, -0.6))
    cube.transform.set_scaling(1.0, (1.2, 0.8, 1.0))
    group.add(cube)
    s.add(group)
    still = _cube(pkg, pkg.GlossyMaterial((0.3, 0.9, 0.3), 0.2))
    still.transform.set_translation(0.0, (1.2, 0.4, -0.8))
    s.add(still)
    return s


def deep_cube_scene(depth: int = 9, pkg=None):
    """A cube with two keys of its own inside ``depth - 1`` nested groups,
    each drifting over the shutter and the outermost turning about Y (a
    transform chain of ``depth`` links, deeper than any demo scene's), over
    a plane, under an unnested rect light."""
    pkg = pkg or _own
    s = pkg.Scene()
    s.add(pkg.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.6, 0.6, 0.9))))
    node = _cube(pkg, pkg.GlossyMaterial((0.8, 0.3, 0.1), 0.3))
    node.transform.set_translation(0.0, (-0.6, -0.5, -0.4))
    node.transform.set_translation(1.0, (-0.2, -0.5, -0.6))
    for g in range(depth - 1):
        group = pkg.Group()
        group.transform.set_translation(0.0, (0.05, 0.0, 0.0))
        group.transform.set_translation(1.0, (0.05, 0.02 * g, 0.0))
        if g == depth - 2:
            group.transform.set_rotation(0.0, (1.0, 0.0, 0.0, 0.0))
            group.transform.set_rotation(
                1.0, (math.cos(math.pi / 8), 0.0, math.sin(math.pi / 8), 0.0))
        group.add(node)
        node = group
    s.add(node)
    s.add(pkg.RectangleLight((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0),
                             (0.0, 0.0, 2.0), (1.0, 1.0, 1.0), 8.0))
    return s


def tied_slivers_scene():
    """15,360 seeded slanted slivers (320 clusters, 20 superclusters), each
    from z = 0 up to z = 1 over the square [-1, 1]^2, and a rect light:
    every cluster and supercluster box spans z in [0, 1] and much of the
    square, so a ray straight up the z axis enters them all at the same t,
    and the tie rule (the lower index first) alone decides which the 'xla'
    route's K1/K2 truncation keeps."""
    n_tri = 15360
    rs = np.random.default_rng(9)
    base = rs.uniform(-1.0, 0.8, (n_tri, 2))
    v0 = np.concatenate([base, np.zeros((n_tri, 1))], 1)
    tris = np.stack([v0, v0 + [0.2, 0.0, 0.0], v0 + [0.1, 0.2, 1.0]], 1)
    s = Scene()
    s.add(TriangleMesh(tris.reshape(-1, 3).astype(np.float32),
                       np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3),
                       DiffuseMaterial((0.6, 0.5, 0.4))))
    s.add(RectangleLight((-2.0, 4.0, 0.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0),
                         (1.0, 1.0, 1.0), 6.0))
    return s


def twin_mesh_scene():
    """One tiny moving mesh of 192 triangles, 96 seeded ones twice (every
    hit ties with its twin row, and the lower row must win), over a plane:
    the most rows a tiny mesh may have, under two keys of translation and
    rotation."""
    rs = np.random.default_rng(3)
    tris = rs.normal(0.0, 0.6, (96, 3, 3)).astype(np.float32)
    verts = np.concatenate([tris, tris]).reshape(-1, 3)
    s = Scene()
    s.add(Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                DiffuseMaterial((0.6, 0.6, 0.9))))
    mesh = TriangleMesh(verts, np.arange(576, dtype=np.int32).reshape(-1, 3),
                        DiffuseMaterial((0.8, 0.3, 0.1)))
    mesh.transform.set_translation(1.0, (0.2, 0.1, 0.0))
    mesh.transform.set_rotation(
        1.0, (math.cos(math.pi / 8), 0.0, 0.0, math.sin(math.pi / 8)))
    s.add(mesh)
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
