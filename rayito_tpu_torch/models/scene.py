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

Every shape has a keyed transform slot (``*_xf``; slot 0 is the identity)
and nested ``Group``s compile to per-slot parent pointers. Two mesh
traversals, chosen once at compile (``SceneData.traversal``):

  * ``'pallas'``, the port's native route: the CUDA kernels. Meshes with
    the identity transform merge into one world-space traversal domain;
    each transformed mesh above 192 triangles gets a domain of its own,
    entered in mesh-local space; smaller transformed meshes are folded
    densely (``ktab_small``, ``render/mesh_intersect.py``);
  * ``'xla'``: the reference's two-level cluster pipeline, mesh by mesh in
    its local space, truncated at K1 superclusters and K2 clusters per ray
    (``render/mesh_intersect.py``), over the cluster tables ``cl_*``,
    ``sc_*``, ``sc_rows`` and ``tri_rows``.

Both routes' tables are always built, so ``dataclasses.replace(scene,
traversal=...)`` switches a compiled scene. The reference's TPU-only
scheduling options raise ``ValueError`` (see ``UNPORTED_KNOBS``).
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..accel.kernel_tables import build_slice_boxes
from ..ops import transform as xf

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


def PhongMaterial(color, exponent):
    return Material(MAT_PHONG, color, exponent)


@dataclasses.dataclass
class Transform:
    """Keyed Scale->Rotate->Translate track: parallel key lists; a static
    shape has one key with the identity."""

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

    @property
    def num_keys(self) -> int:
        return len(self.times)

    def is_identity(self) -> bool:
        return (
            self.num_keys == 1
            and tuple(self.translations[0]) == (0.0, 0.0, 0.0)
            and tuple(self.scales[0]) == (1.0, 1.0, 1.0)
            and tuple(self.rotations[0]) == (1.0, 0.0, 0.0, 0.0)
        )

    # Key management of the reference renderer's mutators: a key at the
    # exact time is reused; a time outside the range duplicates the end
    # key; a time between keys inserts an interpolated key (lerp, nlerp in
    # float64). ``rotate`` concatenates with the correct Hamilton product,
    # not the reference's aliasing-bugged operator*=.

    def _interp_key(self, i, frac):
        t0 = np.asarray(self.translations[i], np.float64)
        t1 = np.asarray(self.translations[i + 1], np.float64)
        s0 = np.asarray(self.scales[i], np.float64)
        s1 = np.asarray(self.scales[i + 1], np.float64)
        q0 = np.asarray(self.rotations[i], np.float64)
        q1 = np.asarray(self.rotations[i + 1], np.float64)
        q = q0 * (1.0 - frac) + q1 * frac
        q = q / max(np.linalg.norm(q), 1e-37)
        return (tuple(t0 * (1.0 - frac) + t1 * frac),
                tuple(s0 * (1.0 - frac) + s1 * frac), tuple(q))

    def find_or_insert_key(self, time: float) -> int:
        if time in self.times:
            return self.times.index(time)
        if not self.times or time > self.times[-1]:
            self.times.append(time)
            self.translations.append(tuple(self.translations[-1]))
            self.scales.append(tuple(self.scales[-1]))
            self.rotations.append(tuple(self.rotations[-1]))
            return len(self.times) - 1
        if time < self.times[0]:
            self.times.insert(0, time)
            self.translations.insert(0, tuple(self.translations[0]))
            self.scales.insert(0, tuple(self.scales[0]))
            self.rotations.insert(0, tuple(self.rotations[0]))
            return 0
        i = bisect.bisect_right(self.times, time) - 1
        frac = (time - self.times[i]) / (self.times[i + 1] - self.times[i])
        tr, sc, ro = self._interp_key(i, frac)
        self.times.insert(i + 1, time)
        self.translations.insert(i + 1, tr)
        self.scales.insert(i + 1, sc)
        self.rotations.insert(i + 1, ro)
        return i + 1

    def set_translation(self, time, translation) -> "Transform":
        k = self.find_or_insert_key(float(time))
        self.translations[k] = tuple(translation)
        return self

    def set_scaling(self, time, scale) -> "Transform":
        k = self.find_or_insert_key(float(time))
        self.scales[k] = tuple(scale)
        return self

    def set_rotation(self, time, quaternion_wxyz) -> "Transform":
        k = self.find_or_insert_key(float(time))
        self.rotations[k] = tuple(quaternion_wxyz)
        return self

    def translate(self, time, delta) -> "Transform":
        k = self.find_or_insert_key(float(time))
        self.translations[k] = tuple(
            a + b for a, b in zip(self.translations[k], delta))
        return self

    def scale(self, time, factors) -> "Transform":
        k = self.find_or_insert_key(float(time))
        self.scales[k] = tuple(a * b for a, b in zip(self.scales[k], factors))
        return self

    def rotate(self, time, quaternion_wxyz) -> "Transform":
        """R_k = R_k * q at the key of ``time``."""
        k = self.find_or_insert_key(float(time))
        w1, x1, y1, z1 = self.rotations[k]
        w2, x2, y2, z2 = quaternion_wxyz
        self.rotations[k] = (
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + w2 * x1 + (y1 * z2 - z1 * y2),
            w1 * y2 + w2 * y1 + (z1 * x2 - x1 * z2),
            w1 * z2 + w2 * z1 + (x1 * y2 - y1 * x2),
        )
        return self


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


@dataclasses.dataclass
class Group:
    """A set of child shapes (or nested Groups) with its own keyed
    Transform, applied to rays before the children's. ``Scene.add``
    flattens the tree: each leaf records its chain of enclosing group
    transforms, which compile to per-slot parent pointers."""

    transform: Transform = dataclasses.field(default_factory=Transform)
    children: List[object] = dataclasses.field(default_factory=list)

    def add(self, shape) -> None:
        self.children.append(shape)


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
    # a [N, 48] minor dimension pads to 128 lanes on the TPU, so the
    # reference folds tiny meshes triangle by triangle there (and only
    # there); in eager PyTorch its 12 folds per cube would cost about 12x
    # the launches of the dense test
    "tiny_fold": "per-triangle fold of tiny meshes",
}

# tensor fields, named as in the reference's SceneData (tuples hold one
# tensor per traversal domain)
ARRAY_FIELDS = (
    "mat_kind", "mat_color", "mat_param", "mat_rows",
    "pln_pos", "pln_normal", "pln_mat", "pln_bullseye", "pln_xf",
    "sph_center", "sph_radius", "sph_mat", "sph_xf",
    "rect_corner", "rect_side1", "rect_side2", "rect_mat", "rect_xf",
    "mesh_mat", "mesh_xf", "tri_area_cdf", "mesh_total_area",
    "tri_meta_rows", "tri_vert_rows", "tri_vm_rows",
    "light_kind", "light_index", "light_shape_id", "light_color",
    "light_power",
    "xf_times", "xf_translate", "xf_scale", "xf_rotate", "xf_nkeys",
    "xf_parent",
    "cl_min", "cl_max", "sc_min", "sc_max", "sc_rows", "tri_rows",
)
DOMAIN_FIELDS = ("ktab_tri", "ktab_mxu", "ktab_box", "ktab_base")
# per domain, built from ktab_tri by scene_data_from_arrays (port-only)
SLICE_FIELD = "ktab_slice"
STATIC_FIELDS = (
    "ktab_xf", "ktab_seg", "ktab_small", "mesh_tri_ranges", "mesh_cl_ranges",
    "mesh_sc_ranges", "light_kinds_host", "light_indices_host", "has_motion",
    "xf_depth",
    "traversal", "traverse_mt", "traverse_b", "traverse_sb", "live_prefix",
    "sort_occl", "traverse_items", "items_w", "items_max", "items_cap",
)
# transform slots the host reads (shape ids and parent pointers), kept as
# host tuples beside their tensors so no query waits on the device
HOST_XF_FIELDS = ("pln_xf", "sph_xf", "rect_xf", "mesh_xf", "xf_parent")
# optional array of the reference's SceneData: the lane-packed winner rows
# [ceil(T / 4), 128] it ships instead of tri_vm_rows above 96k triangles
PACKED_ROWS_FIELD = "tri_vm_packed"


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
    pln_xf: torch.Tensor  # [n] i32 transform slot per shape (0 = identity)
    sph_center: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor
    sph_xf: torch.Tensor
    rect_corner: torch.Tensor
    rect_side1: torch.Tensor
    rect_side2: torch.Tensor
    rect_mat: torch.Tensor
    rect_xf: torch.Tensor
    mesh_mat: torch.Tensor
    mesh_xf: torch.Tensor
    # mesh-light sampling: per-mesh cumulative triangle areas over the
    # padded global triangle order, and each mesh's local-space area
    tri_area_cdf: torch.Tensor  # [T] f32
    mesh_total_area: torch.Tensor  # [n_mesh] f32
    tri_meta_rows: torch.Tensor  # [T, 16] shading normals | flags | ids
    tri_vert_rows: torch.Tensor  # [T, 16] v0 v1 v2 (winner re-test rows)
    tri_vm_rows: torch.Tensor  # [T, 32] vert | meta fused rows
    light_kind: torch.Tensor
    light_index: torch.Tensor
    light_shape_id: torch.Tensor
    light_color: torch.Tensor
    light_power: torch.Tensor
    # keyed TRS tables [X, K(, 3|4)], keys padded with the last key
    xf_times: torch.Tensor
    xf_translate: torch.Tensor
    xf_scale: torch.Tensor
    xf_rotate: torch.Tensor
    xf_nkeys: torch.Tensor
    xf_parent: torch.Tensor  # [X] i32 enclosing group's slot, -1 = root
    # the 'xla' route's cluster tables (accel/clusters.py), meshes in order:
    # 48-triangle cluster boxes [C, 3] (pad boxes +inf / -inf), 16-cluster
    # supercluster boxes [S, 3], packed children boxes [S, 128] and
    # triangle rows [C, 512]
    cl_min: torch.Tensor
    cl_max: torch.Tensor
    sc_min: torch.Tensor
    sc_max: torch.Tensor
    sc_rows: torch.Tensor
    tri_rows: torch.Tensor
    # per traversal domain: MT rows [C, 16, 128], BW rows (or empty),
    # cluster boxes [8, C_pad], per-cluster global triangle base [C]
    ktab_tri: tuple = ()
    ktab_mxu: tuple = ()
    ktab_box: tuple = ()
    ktab_base: tuple = ()
    # per domain, each cluster's 32-lane slice boxes [C, 4, 8]
    # (accel/kernel_tables.py build_slice_boxes)
    ktab_slice: tuple = ()
    ktab_xf: tuple = ()  # domain transform ids (0 = world space)
    # per domain, its transform chain's slots, outermost first (i32 [depth],
    # empty for world space; ops/transform.py chain_slots), built with the
    # scene for render/traverse.py ray_pack's kernel to read
    ktab_chain: tuple = dataclasses.field(default=(), init=False,
                                          repr=False, compare=False)
    # the lights as csrc/shade.cu reads them, built with the scene
    # (render/shade.py light_records): one record a light (i32 [L, 7]) and
    # every light's chain slots, outermost first (i32 [S])
    light_table: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    light_slots: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    ktab_seg: tuple = ()  # per domain ((cl_start, tri0), ...)
    # transformed meshes of at most 192 triangles: folded densely
    # (render/mesh_intersect.py) instead of a launch domain of their own
    ktab_small: tuple = ()
    mesh_tri_ranges: tuple = ()  # per mesh (first global triangle, count)
    # per mesh (first cluster, cluster count) in the 48-wide cluster order,
    # the count a multiple of 16; (first supercluster, count)
    mesh_cl_ranges: tuple = ()
    mesh_sc_ranges: tuple = ()
    light_kinds_host: tuple = ()
    light_indices_host: tuple = ()
    # any non-identity transform: static scenes skip every transform step
    has_motion: bool = False
    xf_depth: int = 1  # longest transform chain (1 = no nested groups)
    # host copies of HOST_XF_FIELDS, filled by scene_data_from_arrays
    pln_xf_host: tuple = ()
    sph_xf_host: tuple = ()
    rect_xf_host: tuple = ()
    mesh_xf_host: tuple = ()
    xf_parent_host: tuple = ()
    # mesh traversal: 'pallas' (the CUDA kernels) or 'xla' (the two-level
    # cluster pipeline); Scene.compile resolves it from RAYITO_TRAVERSAL
    traversal: str = "pallas"
    # per-cluster triangle test: 'vpu' Möller-Trumbore | 'bw'
    # Baldwin-Weber | 'bw_closest' (BW on closest hit, MT on occlusion)
    traverse_mt: str = "bw_closest"
    traverse_b: int = 128  # rays per ray block (mask granularity)
    traverse_sb: int = 2048  # rays per step (padding / live-prefix unit)
    live_prefix: bool = True  # skip steps past the sorted live prefix
    sort_occl: bool = True  # coherence-sort occlusion launches
    # item-list traversal (traverse_items kernel) instead of the block scan;
    # launches whose list exceeds the budget fall back to the scan. The
    # reference's module defaults (ITEMS_W, ITEMS_MAX, ITEMS_CAP) and its
    # trace-time RAYITO_TRAVERSE_ITEMS read, as compile-time fields.
    traverse_items: bool = False
    items_w: int = 4  # items per group (per-block runs are w-aligned)
    items_max: int = 24576  # items per launch
    items_cap: int = 64  # items per ray block

    def __post_init__(self):
        if self.traversal not in ("pallas", "xla"):
            raise ValueError(f"traversal must be 'pallas'|'xla', got "
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
        validate_items(self.items_w, self.items_max, self.items_cap)
        object.__setattr__(self, "ktab_chain", tuple(
            torch.tensor(xf.chain_slots(self, x), dtype=torch.int32,
                         device=self.device) for x in self.ktab_xf))
        from ..render.shade import light_records

        records, slots = light_records(self)
        object.__setattr__(self, "light_table", torch.from_numpy(
            records).to(self.device))
        object.__setattr__(self, "light_slots", torch.from_numpy(
            slots).to(self.device))

    def to(self, device) -> "SceneData":
        """This scene with every tensor on ``device`` (itself if it is
        there already)."""
        device = torch.device(device)
        if device == self.device:
            return self
        kw = {k: getattr(self, k).to(device) for k in ARRAY_FIELDS}
        for k in DOMAIN_FIELDS + (SLICE_FIELD,):
            kw[k] = tuple(t.to(device) for t in getattr(self, k))
        return dataclasses.replace(self, device=device, **kw)

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


def validate_items(w: int, maxitems: int, cap: int) -> None:
    """Item-list budget: 1 <= w <= 8, maxitems and cap positive."""
    if not 1 <= w <= 8:
        raise ValueError(f"items_w={w!r}: must be in 1..8")
    if maxitems <= 0 or cap <= 0:
        raise ValueError(f"items_max={maxitems!r}, items_cap={cap!r}: must "
                         "be positive")


def resolve_traversal(traversal: Optional[str] = None) -> str:
    """The mesh traversal of a compile: ``traversal`` if given, else the
    RAYITO_TRAVERSAL environment variable, where unset or 'auto' gives
    'pallas' (the card's kernels are the port's native route; the
    reference's auto picks its kernels only on a TPU)."""
    if traversal is None:
        traversal = os.environ.get("RAYITO_TRAVERSAL", "auto").lower()
        if traversal == "auto":
            traversal = "pallas"
    if traversal not in ("pallas", "xla"):
        raise ValueError(f"traversal must be 'pallas'|'xla' (or "
                         f"RAYITO_TRAVERSAL 'auto'), got {traversal!r}")
    return traversal


def scene_data_from_arrays(arrays: dict, static: dict, device) -> SceneData:
    """Build a SceneData on ``device`` from numpy arrays named like the
    reference SceneData's fields (``ARRAY_FIELDS``; ``DOMAIN_FIELDS`` hold a
    sequence with one array per domain) and host-static values
    (``STATIC_FIELDS``). The slice boxes of each domain's clusters
    (``ktab_slice``) are built here from ``ktab_tri``. A TPU-only option
    in ``static`` raises ValueError; an unknown name raises TypeError.
    Where ``arrays`` holds the reference's lane-packed rows
    (``tri_vm_packed``, 4 rows of 32 per 128-float row) and an empty
    ``tri_vm_rows``, the [T, 32] table is rebuilt from them: the same
    floats, since device memory here has no lane tiling to save."""
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

    arrays = dict(arrays)
    packed = arrays.pop(PACKED_ROWS_FIELD, None)
    if (packed is not None and np.shape(packed)[0]
            and not np.shape(arrays["tri_vm_rows"])[0]):
        n_tri = np.shape(arrays["tri_vert_rows"])[0]
        arrays["tri_vm_rows"] = np.asarray(packed).reshape(-1, 32)[:n_tri]
    kw = {k: dev(arrays[k]) for k in ARRAY_FIELDS}
    for k in DOMAIN_FIELDS:
        kw[k] = tuple(dev(a) for a in arrays.get(k, ()))
    kw[SLICE_FIELD] = tuple(dev(build_slice_boxes(np.asarray(a)))
                            for a in arrays.get("ktab_tri", ()))
    for k in HOST_XF_FIELDS:
        kw[k + "_host"] = tuple(int(x) for x in np.asarray(arrays[k]))
    return SceneData(device=device, **kw, **static)


class Scene:
    """The ShapeSet equivalent: collects shapes, compiles to SceneData."""

    def __init__(self):
        self.planes: List[Plane] = []
        self.spheres: List[Sphere] = []
        self.rect_lights: List[RectangleLight] = []
        self.meshes: List[TriangleMesh] = []
        self._lights: List[tuple] = []  # (kind, index-within-kind, color, power)
        # per shape, the enclosing Group transforms (outermost first),
        # parallel to the kind lists above
        self._chains = {"pln": [], "sph": [], "rect": [], "mesh": []}

    def add(self, shape, _enclosing: tuple = ()) -> None:
        if isinstance(shape, Group):
            for child in shape.children:
                self.add(child, _enclosing + (shape.transform,))
            return
        if isinstance(shape, ShapeLight):
            inner = shape.shape
            inner.material = EmitterMaterial(shape.color, shape.power)
            if isinstance(inner, Sphere):
                kind = LIGHT_SPHERE
            elif isinstance(inner, TriangleMesh):
                kind = LIGHT_MESH
            else:
                raise TypeError(f"ShapeLight cannot wrap {type(inner)}")
            self.add(inner, _enclosing)
            idx = len(self.spheres if kind == LIGHT_SPHERE else self.meshes)
            self._lights.append((kind, idx - 1, shape.color, shape.power))
            return
        if isinstance(shape, Plane):
            self.planes.append(shape)
            self._chains["pln"].append(_enclosing)
        elif isinstance(shape, Sphere):
            self.spheres.append(shape)
            self._chains["sph"].append(_enclosing)
        elif isinstance(shape, RectangleLight):
            self.rect_lights.append(shape)
            self._chains["rect"].append(_enclosing)
            self._lights.append((LIGHT_RECT, len(self.rect_lights) - 1,
                                 shape.color, shape.power))
        elif isinstance(shape, TriangleMesh):
            self.meshes.append(shape)
            self._chains["mesh"].append(_enclosing)
        else:
            raise TypeError(f"unknown shape type {type(shape)}")

    def compile_arrays(self, traversal: Optional[str] = None,
                       traverse_mt: str = "bw_closest", **knobs):
        """Lower to (arrays, static) — the inputs of
        :func:`scene_data_from_arrays`. Same table construction as the
        reference's ``Scene.compile``; ``traversal`` as in
        :func:`resolve_traversal`."""
        from ..accel.bvh import bvh_prim_order
        from ..accel.clusters import (SC_ROW_WIDTH, TRI_ROW_WIDTH,
                                      build_clusters)
        from ..accel.kernel_tables import build_bw_rows, build_kernel_tables_multi

        f32, i32 = np.float32, np.int32
        materials: List[Material] = []

        def mat_id(m: Material) -> int:
            for i, existing in enumerate(materials):
                if existing is m:
                    return i
            materials.append(m)
            return len(materials) - 1

        # transform slots: slot 0 is the identity; a shape inside groups
        # gets a slot whose parent chain is its (deduplicated) group slots;
        # identity links collapse onto the parent slot (the root: slot 0)
        transforms: List[Transform] = [Transform()]
        parents: List[int] = [-1]
        slot_of = {}

        def alloc_slot(t: Transform, parent: int) -> int:
            if t.is_identity():
                return parent
            key = (id(t), parent)
            if key not in slot_of:
                transforms.append(t)
                parents.append(parent)
                slot_of[key] = len(transforms) - 1
            return slot_of[key]

        def xf_ids(shapes, chains):
            out = []
            for s, chain in zip(shapes, chains):
                parent = -1
                for g in chain:  # outermost group first
                    parent = alloc_slot(g, parent)
                out.append(max(alloc_slot(s.transform, parent), 0))
            return np.array(out, i32)

        n_p, n_s, n_r = len(self.planes), len(self.spheres), len(self.rect_lights)
        sphere_id0, rect_id0, mesh_id0 = n_p, n_p + n_s, n_p + n_s + n_r
        ch = self._chains
        pln_xf = xf_ids(self.planes, ch["pln"])
        sph_xf = xf_ids(self.spheres, ch["sph"])
        rect_xf = xf_ids(self.rect_lights, ch["rect"])
        mesh_xf = xf_ids(self.meshes, ch["mesh"])

        pln_normal_raw = np.array([p.normal for p in self.planes], f32)
        pln_normal_raw = pln_normal_raw.reshape(n_p, 3)
        a = dict(
            pln_pos=np.array([p.position for p in self.planes], f32).reshape(n_p, 3),
            pln_normal=pln_normal_raw / np.maximum(
                np.linalg.norm(pln_normal_raw, axis=-1, keepdims=True), 1e-37
            ),
            pln_mat=np.array([mat_id(p.material) for p in self.planes], i32),
            pln_bullseye=np.array([p.bullseye for p in self.planes], bool),
            pln_xf=pln_xf, sph_xf=sph_xf, rect_xf=rect_xf, mesh_xf=mesh_xf,
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
        segs, vm_parts, mesh_mat, tri_ranges = [], [], [], []
        cl_ranges, sc_ranges, cdf_parts, total_area = [], [], [], []
        tables = {k: [] for k in ("cl_min", "cl_max", "sc_min", "sc_max",
                                  "sc_rows", "tri_rows")}
        t_off = cl_off = sc_off = 0
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
            tri_ranges.append((t_off, t))
            for k, parts in tables.items():
                parts.append(getattr(cl, k))
            cl_ranges.append((cl_off, cl.n_clusters))
            sc_ranges.append((sc_off, cl.n_supers))
            # triangle-area CDF for mesh-light sampling: local-space areas
            # (a scaled light keeps them: a quirk of the reference
            # renderer); the zero-area padding can never be selected
            areas = 0.5 * np.linalg.norm(gn, axis=-1)
            cdf = np.cumsum(areas.astype(np.float64)).astype(f32)
            cdf_parts.append(cdf)
            total_area.append(cdf[-1])
            t_off += tp
            cl_off += cl.n_clusters
            sc_off += cl.n_supers
        tri_vm = (np.concatenate(vm_parts, 0) if vm_parts
                  else np.zeros((0, 32), f32))
        a["tri_vm_rows"] = tri_vm
        a["tri_vert_rows"] = np.ascontiguousarray(tri_vm[:, :16])
        a["tri_meta_rows"] = np.ascontiguousarray(tri_vm[:, 16:])
        a["mesh_mat"] = np.array(mesh_mat, i32)
        a["tri_area_cdf"] = (np.concatenate(cdf_parts, 0) if cdf_parts
                             else np.zeros(0, f32))
        a["mesh_total_area"] = np.array(total_area, f32)
        for k, parts in tables.items():
            width = {"sc_rows": SC_ROW_WIDTH,
                     "tri_rows": TRI_ROW_WIDTH}.get(k, 3)
            a[k] = (np.concatenate(parts, 0) if parts
                    else np.zeros((0, width), f32))

        # --- traversal domains: the identity-transform meshes merge into
        # one world-space domain (first); each transformed mesh above 192
        # triangles gets its own, entered in mesh-local space; the smaller
        # transformed meshes are folded densely (ktab_small)
        static_segs, domain_specs, small = [], [], []
        for mi, seg in enumerate(segs):
            if mesh_xf[mi] == 0:
                static_segs.append(seg)
            elif tri_ranges[mi][1] > 192:
                domain_specs.append(([seg], int(mesh_xf[mi])))
            else:
                small.append(mi)
        if static_segs:
            domain_specs.insert(0, (static_segs, 0))
        dom = {k: [] for k in DOMAIN_FIELDS}
        seg_tables = []
        for dsegs, _ in domain_specs:
            kt = build_kernel_tables_multi(dsegs)
            dom["ktab_tri"].append(kt.tri)
            dom["ktab_box"].append(kt.cl_box)
            dom["ktab_base"].append(kt.tri_base)
            if traverse_mt in ("bw", "bw_closest"):
                dom["ktab_mxu"].append(build_bw_rows(kt.tri))
            seg_tables.append(kt.seg)
        static = dict(traversal=resolve_traversal(traversal),
                      traverse_mt=traverse_mt, **knobs)
        static["ktab_xf"] = tuple(x for _, x in domain_specs)
        static["ktab_seg"] = tuple(seg_tables)
        static["ktab_small"] = tuple(small)
        static["mesh_tri_ranges"] = tuple(tri_ranges)
        static["mesh_cl_ranges"] = tuple(cl_ranges)
        static["mesh_sc_ranges"] = tuple(sc_ranges)
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
        # the reference warns here that a mesh light keeps a large light
        # set on its unrolled loop; here each mesh light is evaluated alone
        # while the rect and sphere lights share one evaluation per kind
        from ..render.pathtracer import ROLL_LIGHTS

        if n_l > ROLL_LIGHTS and LIGHT_MESH in kinds:
            print(
                f"rayito_tpu_torch: scene has {n_l} lights including "
                f"{kinds.count(LIGHT_MESH)} mesh light(s): path-mode NEE "
                "evaluates every mesh light on its own for each light sample "
                "(only rect and sphere lights share one evaluation per kind; "
                "expect more launches per frame, not wrong results)",
                file=sys.stderr,
            )
        static["light_kinds_host"] = tuple(kinds)
        static["light_indices_host"] = tuple(indices)

        # --- transform tables, padded to the most keys with the last key;
        # rotation keys normalised
        n_x, n_k = len(transforms), max(t.num_keys for t in transforms)
        xf_times = np.zeros((n_x, n_k), f32)
        xf_trans = np.zeros((n_x, n_k, 3), f32)
        xf_scale = np.ones((n_x, n_k, 3), f32)
        xf_rot = np.zeros((n_x, n_k, 4), f32)
        xf_rot[:, :, 0] = 1.0
        xf_nkeys = np.zeros(n_x, i32)
        for ti, t in enumerate(transforms):
            k = t.num_keys
            xf_nkeys[ti] = k
            xf_times[ti, :k] = np.asarray(t.times, f32)
            xf_times[ti, k:] = xf_times[ti, k - 1]
            xf_trans[ti, :k] = np.asarray(t.translations, f32).reshape(k, 3)
            xf_trans[ti, k:] = xf_trans[ti, k - 1]
            xf_scale[ti, :k] = np.asarray(t.scales, f32).reshape(k, 3)
            xf_scale[ti, k:] = xf_scale[ti, k - 1]
            rot = np.asarray(t.rotations, f32).reshape(k, 4)
            rot = rot / np.maximum(
                np.linalg.norm(rot, axis=-1, keepdims=True), 1e-37)
            xf_rot[ti, :k] = rot
            xf_rot[ti, k:] = xf_rot[ti, k - 1]
        a.update(xf_times=xf_times, xf_translate=xf_trans, xf_scale=xf_scale,
                 xf_rotate=xf_rot, xf_nkeys=xf_nkeys,
                 xf_parent=np.array(parents, i32))

        def depth(s: int) -> int:
            d = 0
            while s >= 0:
                d, s = d + 1, parents[s]
            return d

        static["has_motion"] = n_x > 1  # every slot past 0 is non-identity
        static["xf_depth"] = max(depth(s) for s in range(n_x))

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

    def compile(self, device, traversal: Optional[str] = None,
                traverse_mt: str = "bw_closest", **knobs) -> SceneData:
        """Lower to a SceneData on ``device``. ``traversal`` is 'pallas'
        (the CUDA kernels) or 'xla' (the two-level cluster pipeline); None
        reads RAYITO_TRAVERSAL here, once, where unset or 'auto' gives
        'pallas', the port's native route. ``knobs`` are further SceneData
        static fields; the reference's TPU-only options raise
        ValueError."""
        arrays, static = self.compile_arrays(traversal, traverse_mt, **knobs)
        return scene_data_from_arrays(arrays, static, device)
