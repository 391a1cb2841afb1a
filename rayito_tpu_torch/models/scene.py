"""Scene description: builder objects compiled to flat tensors on a device.

Counterpart of ``rayito_tpu/models/scene.py``. ``Scene.compile(device)``
lowers the builder graph into one :class:`SceneData` whose tensors all live
on ``SceneData.device``; nothing else in the port chooses a device.
``compile`` builds numpy arrays first (bit-identical to the reference's
tables) and hands them to :func:`scene_data_from_arrays`, which the parity
tests also call with the arrays the JAX package compiled.

Shape identity is a dense global ``shape_id`` (planes, spheres, rects,
meshes in that order); every light records the shape id of its geometry.
Material kinds: 0 lambert, 1 glossy, 2 perfect reflection, 3 emitter,
4 phong.

This slice covers static scenes. Keyed transforms, groups and tiny
transformed meshes raise ``NotImplementedError``; the reference's TPU-only
scheduling options raise ``ValueError`` (see ``UNPORTED_KNOBS``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

MAT_LAMBERT = 0
MAT_GLOSSY = 1
MAT_REFLECTION = 2
MAT_EMITTER = 3
MAT_PHONG = 4

LIGHT_RECT = 0
LIGHT_SPHERE = 1
LIGHT_MESH = 2


# ---------------------------------------------------------------------------
# Builder-side objects (host, plain Python)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Material:
    kind: int
    color: Sequence[float]
    param: float = 0.0  # roughness (glossy), exponent (phong), power (emitter)


def DiffuseMaterial(color):
    return Material(MAT_LAMBERT, color)


def GlossyMaterial(color, roughness):
    return Material(MAT_GLOSSY, color, roughness)


def ReflectionMaterial(color):
    return Material(MAT_REFLECTION, color)


def EmitterMaterial(color, power):
    return Material(MAT_EMITTER, color, power)


@dataclasses.dataclass
class Transform:
    """Keyed Scale->Rotate->Translate track. Only the identity (static)
    transform compiles in this slice."""

    times: List[float] = dataclasses.field(default_factory=lambda: [0.0])
    translations: List[Sequence[float]] = dataclasses.field(
        default_factory=lambda: [(0.0, 0.0, 0.0)]
    )
    scales: List[Sequence[float]] = dataclasses.field(
        default_factory=lambda: [(1.0, 1.0, 1.0)]
    )
    rotations: List[Sequence[float]] = dataclasses.field(
        default_factory=lambda: [(1.0, 0.0, 0.0, 0.0)]  # (w, x, y, z)
    )

    def is_identity(self) -> bool:
        return (
            len(self.times) == 1
            and tuple(self.translations[0]) == (0.0, 0.0, 0.0)
            and tuple(self.scales[0]) == (1.0, 1.0, 1.0)
            and tuple(self.rotations[0]) == (1.0, 0.0, 0.0, 0.0)
        )


@dataclasses.dataclass
class Plane:
    """Infinite one-sided plane with optional bullseye texture."""

    position: Sequence[float]
    normal: Sequence[float]
    material: Material
    bullseye: bool = False
    transform: Transform = dataclasses.field(default_factory=Transform)


@dataclasses.dataclass
class Sphere:
    position: Sequence[float]
    radius: float
    material: Material
    transform: Transform = dataclasses.field(default_factory=Transform)


@dataclasses.dataclass
class RectangleLight:
    """Double-sided parallelogram area light."""

    corner: Sequence[float]
    side1: Sequence[float]
    side2: Sequence[float]
    color: Sequence[float]
    power: float
    transform: Transform = dataclasses.field(default_factory=Transform)


@dataclasses.dataclass
class TriangleMesh:
    """Indexed triangle mesh; ``face_ids`` keeps the polygon id of each
    fan triangle."""

    vertices: np.ndarray  # [V, 3] float32
    indices: np.ndarray  # [T, 3] int32
    material: Material
    normals: Optional[np.ndarray] = None  # [Vn, 3]
    normal_indices: Optional[np.ndarray] = None  # [T, 3] into normals
    face_ids: Optional[np.ndarray] = None  # [T]
    transform: Transform = dataclasses.field(default_factory=Transform)


@dataclasses.dataclass
class ShapeLight:
    """Wrap a sphere or mesh as an emitter (its material is replaced)."""

    shape: object
    color: Sequence[float]
    power: float


class Group:
    """Placeholder for the reference's nested transform groups."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Group (nested transforms) is not ported yet"
        )


# ---------------------------------------------------------------------------
# Device-side compiled scene
# ---------------------------------------------------------------------------

# Reference SceneData options that exist only to schedule XLA or Mosaic
# work on a TPU. Each produced output bit-identical to the default, or was a
# measured loss there; the port has one code path and rejects them loudly.
UNPORTED_KNOBS = {
    "fuse_sort": "sort payload fusion (an XLA sort schedule)",
    "share_occl_sort": "shared origin-cell occlusion sort",
    "fuse_occl_pair": "fused 2N-lane occlusion launch",
    "gather_chunks": "chunked live-prefix row gather (an XLA schedule)",
    "static_split": "spatial split of the static domain",
    "cluster_cuts": "subtree-aligned cluster cuts",
    "traverse_prune": "in-kernel best-t cluster prune",
    "traverse_sub": "sub-block traversal",
    "traverse_wide": "lane-carried ILP width of the TPU kernel",
    "mask_gate": "unit-root mask gate (a pure skip)",
    "tri_chunk": "VMEM table streaming chunk",
}

# tensor fields, named as in the reference's SceneData (tuples hold one
# tensor per traversal domain)
ARRAY_FIELDS = (
    "mat_kind", "mat_color", "mat_param", "mat_rows",
    "pln_pos", "pln_normal", "pln_mat", "pln_bullseye",
    "sph_center", "sph_radius", "sph_mat",
    "rect_corner", "rect_side1", "rect_side2", "rect_mat",
    "mesh_mat",
    "tri_meta_rows", "tri_vert_rows", "tri_vm_rows",
    "light_kind", "light_index", "light_shape_id", "light_color",
    "light_power",
)
DOMAIN_FIELDS = ("ktab_tri", "ktab_mxu", "ktab_box", "ktab_base")
STATIC_FIELDS = (
    "ktab_xf", "ktab_seg", "light_kinds_host", "light_indices_host",
    "traversal", "traverse_mt", "traverse_b", "traverse_sb", "live_prefix",
    "sort_occl",
)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Flat, kind-segregated scene tensors on one explicit device."""

    device: torch.device
    mat_kind: torch.Tensor
    mat_color: torch.Tensor
    mat_param: torch.Tensor
    mat_rows: torch.Tensor  # [M, 8]: kind, r, g, b, param
    pln_pos: torch.Tensor
    pln_normal: torch.Tensor
    pln_mat: torch.Tensor
    pln_bullseye: torch.Tensor
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor
    rect_corner: torch.Tensor
    rect_side1: torch.Tensor
    rect_side2: torch.Tensor
    rect_mat: torch.Tensor
    mesh_mat: torch.Tensor
    tri_meta_rows: torch.Tensor  # [T, 16] shading normals | flags | ids
    tri_vert_rows: torch.Tensor  # [T, 16] v0 v1 v2 (winner re-test rows)
    tri_vm_rows: torch.Tensor  # [T, 32] vert | meta fused rows
    light_kind: torch.Tensor
    light_index: torch.Tensor
    light_shape_id: torch.Tensor
    light_color: torch.Tensor
    light_power: torch.Tensor
    # per traversal domain: MT rows [C, 16, 128], BW rows (or empty),
    # cluster boxes [8, C_pad], per-cluster global triangle base [C]
    ktab_tri: tuple = ()
    ktab_mxu: tuple = ()
    ktab_box: tuple = ()
    ktab_base: tuple = ()
    ktab_xf: tuple = ()  # domain transform ids (0 = world space)
    ktab_seg: tuple = ()  # per domain ((cl_start, tri0), ...)
    light_kinds_host: tuple = ()
    light_indices_host: tuple = ()
    # 'pallas' = the hand-kernel traversal (the only one ported so far)
    traversal: str = "pallas"
    # per-cluster triangle test: 'vpu' Möller-Trumbore | 'bw'
    # Baldwin-Weber | 'bw_closest' (BW on closest hit, MT on occlusion)
    traverse_mt: str = "bw_closest"
    traverse_b: int = 128  # rays per ray block (mask granularity)
    traverse_sb: int = 2048  # rays per step (padding / live-prefix unit)
    live_prefix: bool = True  # skip steps past the sorted live prefix
    sort_occl: bool = True  # coherence-sort occlusion launches

    def __post_init__(self):
        if self.traversal == "xla":
            raise NotImplementedError(
                "traversal='xla' (render/mesh_intersect.py) is not ported "
                "yet; the port traverses through its CUDA kernels"
            )
        if self.traversal != "pallas":
            raise ValueError(f"traversal must be 'pallas', got "
                             f"{self.traversal!r}")
        if self.traverse_mt == "mxu":
            raise ValueError(
                "traverse_mt='mxu' is the TPU matrix-unit triangle test; "
                "it is not ported (use 'vpu', 'bw' or 'bw_closest')"
            )
        if self.traverse_mt not in ("vpu", "bw", "bw_closest"):
            raise ValueError(f"traverse_mt must be 'vpu'|'bw'|'bw_closest', "
                             f"got {self.traverse_mt!r}")
        validate_blocks(self.traverse_b, self.traverse_sb)
        if any(x != 0 for x in self.ktab_xf):
            raise NotImplementedError(
                "transformed traversal domains are not ported yet"
            )

    @property
    def n_planes(self) -> int:
        return self.pln_mat.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.sph_mat.shape[0]

    @property
    def n_rects(self) -> int:
        return self.rect_mat.shape[0]

    @property
    def n_meshes(self) -> int:
        return self.mesh_mat.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]

    @property
    def sphere_id0(self) -> int:
        return self.n_planes

    @property
    def rect_id0(self) -> int:
        return self.n_planes + self.n_spheres

    @property
    def mesh_id0(self) -> int:
        return self.n_planes + self.n_spheres + self.n_rects


def validate_blocks(b: int, sb: int) -> None:
    """Ray-block and step sizes: powers of two, b | sb, sb >= 256."""
    if sb <= 0 or sb % 256 or (sb & (sb - 1)):
        raise ValueError(f"traverse sb={sb!r}: must be a power of two "
                         ">= 256")
    if b <= 0 or sb % b or (b & (b - 1)) or b > 1024:
        raise ValueError(f"traverse b={b!r}: must be a power of two "
                         f"<= 1024 dividing sb={sb}")


def scene_data_from_arrays(arrays: dict, static: dict, device) -> SceneData:
    """Build a SceneData on ``device`` from numpy arrays named like the
    reference SceneData's fields (``ARRAY_FIELDS``; ``DOMAIN_FIELDS`` hold a
    sequence with one array per domain) and host-static values
    (``STATIC_FIELDS``). A TPU-only option in ``static`` raises ValueError;
    an unknown name raises TypeError."""
    for k in static:
        if k in UNPORTED_KNOBS:
            raise ValueError(
                f"{k}: {UNPORTED_KNOBS[k]} is a TPU-only option of "
                "rayito_tpu and is not ported"
            )
        if k not in STATIC_FIELDS:
            raise TypeError(f"unknown SceneData static field {k!r}")
    device = torch.device(device)

    def dev(a):
        return torch.from_numpy(np.array(a)).to(device)  # a writable copy

    kw = {k: dev(arrays[k]) for k in ARRAY_FIELDS}
    for k in DOMAIN_FIELDS:
        kw[k] = tuple(dev(a) for a in arrays.get(k, ()))
    return SceneData(device=device, **kw, **static)


class Scene:
    """The ShapeSet equivalent: collects shapes, compiles to SceneData."""

    def __init__(self):
        self.planes: List[Plane] = []
        self.spheres: List[Sphere] = []
        self.rect_lights: List[RectangleLight] = []
        self.meshes: List[TriangleMesh] = []
        self._lights: List[tuple] = []  # (kind, index-within-kind, color, power)

    def add(self, shape) -> None:
        if isinstance(shape, Plane):
            self.planes.append(shape)
        elif isinstance(shape, Sphere):
            self.spheres.append(shape)
        elif isinstance(shape, RectangleLight):
            self.rect_lights.append(shape)
            self._lights.append((LIGHT_RECT, len(self.rect_lights) - 1,
                                 shape.color, shape.power))
        elif isinstance(shape, TriangleMesh):
            self.meshes.append(shape)
        elif isinstance(shape, ShapeLight):
            inner = shape.shape
            inner.material = EmitterMaterial(shape.color, shape.power)
            if isinstance(inner, Sphere):
                self.spheres.append(inner)
                self._lights.append((LIGHT_SPHERE, len(self.spheres) - 1,
                                     shape.color, shape.power))
            elif isinstance(inner, TriangleMesh):
                self.meshes.append(inner)
                self._lights.append((LIGHT_MESH, len(self.meshes) - 1,
                                     shape.color, shape.power))
            else:
                raise TypeError(f"ShapeLight cannot wrap {type(inner)}")
        else:
            raise TypeError(f"unknown shape type {type(shape)}")

    def compile_arrays(self, traversal: str = "pallas",
                       traverse_mt: str = "bw_closest", **knobs):
        """Lower to (arrays, static) — the inputs of
        :func:`scene_data_from_arrays`. Same table construction as the
        reference's ``Scene.compile``."""
        from ..accel.bvh import bvh_prim_order
        from ..accel.clusters import build_clusters
        from ..accel.kernel_tables import build_bw_rows, build_kernel_tables_multi

        shapes = self.planes + self.spheres + self.rect_lights + self.meshes
        if not all(s.transform.is_identity() for s in shapes):
            raise NotImplementedError(
                "keyed transforms (motion blur) are not ported yet"
            )
        f32, i32 = np.float32, np.int32
        materials: List[Material] = []

        def mat_id(m: Material) -> int:
            for i, existing in enumerate(materials):
                if existing is m:
                    return i
            materials.append(m)
            return len(materials) - 1

        n_p, n_s, n_r = len(self.planes), len(self.spheres), len(self.rect_lights)
        sphere_id0, rect_id0, mesh_id0 = n_p, n_p + n_s, n_p + n_s + n_r

        pln_normal_raw = np.array([p.normal for p in self.planes], f32)
        pln_normal_raw = pln_normal_raw.reshape(n_p, 3)
        a = dict(
            pln_pos=np.array([p.position for p in self.planes], f32).reshape(n_p, 3),
            pln_normal=pln_normal_raw / np.maximum(
                np.linalg.norm(pln_normal_raw, axis=-1, keepdims=True), 1e-37
            ),
            pln_mat=np.array([mat_id(p.material) for p in self.planes], i32),
            pln_bullseye=np.array([p.bullseye for p in self.planes], bool),
            sph_center=np.array([s.position for s in self.spheres], f32).reshape(n_s, 3),
            sph_radius=np.array([s.radius for s in self.spheres], f32),
            sph_mat=np.array([mat_id(s.material) for s in self.spheres], i32),
            rect_corner=np.array([r.corner for r in self.rect_lights], f32).reshape(n_r, 3),
            rect_side1=np.array([r.side1 for r in self.rect_lights], f32).reshape(n_r, 3),
            rect_side2=np.array([r.side2 for r in self.rect_lights], f32).reshape(n_r, 3),
            rect_mat=np.array(
                [mat_id(EmitterMaterial(r.color, r.power))
                 for r in self.rect_lights], i32,
            ),
        )

        # --- meshes: BVH-ordered, 48-padded triangle runs (global ids)
        segs, vm_parts, mesh_mat = [], [], []
        t_off = 0
        for mi, m in enumerate(self.meshes):
            verts = np.asarray(m.vertices, f32)
            idx = np.asarray(m.indices, i32)
            t = idx.shape[0]
            v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
            if m.normals is not None and m.normal_indices is not None:
                nrm = np.asarray(m.normals, f32)
                nidx = np.asarray(m.normal_indices, i32)
                has_n = (nidx >= 0).all(axis=-1)
                safe = np.maximum(nidx, 0)
                n0, n1, n2 = nrm[safe[:, 0]], nrm[safe[:, 1]], nrm[safe[:, 2]]
            else:
                has_n = np.zeros(t, bool)
                n0 = n1 = n2 = np.zeros((t, 3), f32)
            order = bvh_prim_order(v0, v1, v2)
            cl = build_clusters(v0[order], v1[order], v2[order])
            tp = cl.v0.shape[0]
            fids = (np.asarray(m.face_ids, i32) if m.face_ids is not None
                    else np.arange(t, dtype=i32))
            meta = np.zeros((tp, 16), f32)
            meta[:t, 0:3] = n0[order]
            meta[:t, 3:6] = n1[order]
            meta[:t, 6:9] = n2[order]
            meta[:t, 9] = has_n[order]
            meta[:, 10] = -1.0
            meta[:t, 10] = fids[order]
            meta[:, 11] = mi
            gn = np.cross(cl.v1 - cl.v0, cl.v2 - cl.v0)
            gl = np.linalg.norm(gn, axis=-1, keepdims=True)
            meta[:, 12:15] = gn / np.maximum(gl, 1e-37)
            vert = np.zeros((tp, 16), f32)
            vert[:, 0:3] = cl.v0
            vert[:, 3:6] = cl.v1
            vert[:, 6:9] = cl.v2
            vm_parts.append(np.concatenate([vert, meta], axis=1))
            segs.append((cl.v0, cl.v1, cl.v2, np.arange(tp) < t, t_off))
            mesh_mat.append(mat_id(m.material))
            t_off += tp
        tri_vm = (np.concatenate(vm_parts, 0) if vm_parts
                  else np.zeros((0, 32), f32))
        a["tri_vm_rows"] = tri_vm
        a["tri_vert_rows"] = np.ascontiguousarray(tri_vm[:, :16])
        a["tri_meta_rows"] = np.ascontiguousarray(tri_vm[:, 16:])
        a["mesh_mat"] = np.array(mesh_mat, i32)

        # --- the one merged world-space traversal domain
        static = dict(traversal=traversal, traverse_mt=traverse_mt, **knobs)
        dom = {k: [] for k in ("ktab_tri", "ktab_mxu", "ktab_box", "ktab_base")}
        if segs:
            kt = build_kernel_tables_multi(segs)
            dom["ktab_tri"].append(kt.tri)
            dom["ktab_box"].append(kt.cl_box)
            dom["ktab_base"].append(kt.tri_base)
            if traverse_mt in ("bw", "bw_closest"):
                dom["ktab_mxu"].append(build_bw_rows(kt.tri))
            static["ktab_xf"] = (0,)
            static["ktab_seg"] = (kt.seg,)
        a.update(dom)

        # --- lights
        kinds, indices, sids, colors, powers = [], [], [], [], []
        for kind, idx, color, power in self._lights:
            sid0 = {LIGHT_RECT: rect_id0, LIGHT_SPHERE: sphere_id0}.get(
                kind, mesh_id0
            )
            kinds.append(kind)
            indices.append(idx)
            sids.append(sid0 + idx)
            colors.append(np.asarray(color, f32))
            powers.append(f32(power))
        n_l = len(kinds)
        a.update(
            light_kind=np.array(kinds, i32).reshape(n_l),
            light_index=np.array(indices, i32).reshape(n_l),
            light_shape_id=np.array(sids, i32).reshape(n_l),
            light_color=np.array(colors, f32).reshape(n_l, 3),
            light_power=np.array(powers, f32).reshape(n_l),
        )
        static["light_kinds_host"] = tuple(kinds)
        static["light_indices_host"] = tuple(indices)

        if not materials:
            materials.append(DiffuseMaterial((0.0, 0.0, 0.0)))
        a["mat_kind"] = np.array([m.kind for m in materials], i32)
        a["mat_color"] = np.array([m.color for m in materials], f32).reshape(-1, 3)
        a["mat_param"] = np.array([m.param for m in materials], f32)
        rows = np.zeros((len(materials), 8), f32)
        rows[:, 0] = a["mat_kind"]
        rows[:, 1:4] = a["mat_color"]
        rows[:, 4] = a["mat_param"]
        a["mat_rows"] = rows
        return a, static

    def compile(self, device, traversal: str = "pallas",
                traverse_mt: str = "bw_closest", **knobs) -> SceneData:
        """Lower to a SceneData on ``device``. ``knobs`` are further
        SceneData static fields; the reference's TPU-only options raise
        ValueError."""
        arrays, static = self.compile_arrays(traversal, traverse_mt, **knobs)
        return scene_data_from_arrays(arrays, static, device)
