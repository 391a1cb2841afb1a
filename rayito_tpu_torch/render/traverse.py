"""Mesh traversal through the hand-written CUDA kernels.

Counterpart of ``rayito_tpu/render/pallas_traverse.py``'s ``traverse()``.
One launch domain's nearest (or any) triangle hit for a wavefront:

  1. the rays are packed into ``soa8`` rows [n_pad, 8] (o, d, tmax, pad),
     taken first into the domain's space where the domain has a transform
     chain (``chain``: each lane at its own time);
  2. a coherence key (octant, root-box entry cell) orders the wavefront
     with one packed sort; lanes with the key's miss flag sort to the end,
     and the number of live steps stays on the device;
  3. ``cluster_masks`` (kernel) marks, per ray block, the clusters any of
     its rays slab-hits; the kernel tests a 32-cluster word's clusters only
     against the rays that hit the word's root box (``word_roots_plain``,
     ``word_live_plain``);
  4. ``traverse_blocks`` (kernel) tests each ray against the listed
     clusters' 128 triangles and keeps the nearest packed (t, lane) key,
     one (ray block, nonzero mask word) unit at a time, merged per ray;
     a warp skips each 32-lane slice of a cluster whose box
     (``slices``) none of its rays slab-hits (:func:`slice_slab_plain`);
     or, with ``items``, ``build_items`` (kernel) flattens the masks into
     one list of (ray block, cluster) items and ``traverse_items``
     (kernel) folds it, with ``traverse_blocks`` taking launches whose list
     overflows the budget (the choice is made on the device);
  5. the results are scattered back to the caller's lane order.

Steps 1, 2 and 5 were XLA in the reference. Here ``ray_pack`` (kernel)
packs the rows and writes the sort operand, ``torch.sort`` sorts it,
``ray_reorder`` (kernel) moves the rows into sorted order and writes the
live step count, and ``ray_unsort`` (kernel) scatters the results back:
three launches and the sort a call. ``gather_rows_t`` (kernel) serves the
exact winner re-test in ``render/trace.py``. ``cluster_pipeline``
(kernel) is phases 2-3 of the ``traversal='xla'`` route's two-level
pipeline (``render/mesh_intersect.py``), the body of the reference's
device-side block loop. ``fold_small_plain`` is the dense fold of one tiny
transformed mesh (the reference's XLA ``_brute_force_mesh``), a part of the
plain twin of the ``fold_small`` kernel (``render/mesh_intersect.py``).

Every kernel has its plain PyTorch version beside it (``*_plain``), with
the same contract. A wrapper runs the plain version only for CPU tensors;
for CUDA tensors it launches the kernel or raises. Each wrapper counts its
launches (``utils/cuda_lib.counted``). With tracing on, ``cluster_masks``
adds the set bits of the masks it writes to the counter ``traverse.pairs``,
``ray_pack`` the lanes that reach the domain's root to
``traverse.live_rays``, the fold the 32-lane slices its warps ran to
``traverse.slices``, and ``traverse`` the lanes it was handed to
``traverse.lanes`` and those it took through a chain to
``traverse.chain_lanes`` (``utils/tracing.py``).

t carries the key's ~2^-17 relative slack; exact t comes from the winner
re-test. With ``any_hit`` only ``prim >= 0`` is defined (prim is 0/-1).
"""

from __future__ import annotations

import dataclasses

import torch

from ..accel.clusters import (CLUSTERS_PER_SUPER, SC_ROW_WIDTH,
                              TRI_PER_CLUSTER, TRI_ROW_WIDTH)
from ..accel.kernel_tables import KTRI, N_SLICES, NEVER_HIT, SLICE
from ..models.scene import validate_blocks, validate_items
from ..ops import transform as xf
from ..ops.intersect import triangle_intersect
from ..ops.vec3 import V3
from ..utils import cuda_lib, tracing

_INF = float("inf")
_IMAX = 2**31 - 1
_MISS_FLAG = 1 << 30


def _check_dtype(name, t, dtype, ndim):
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name}: expected a {ndim}-d {dtype} tensor, got "
            f"{t.dim()}-d {t.dtype}"
        )


def _ptr(t):
    return None if t is None else t.data_ptr()


def _live_floor(n_live, n_steps: int) -> int:
    """Host value of the live step count (plain versions only)."""
    if n_live is None:
        return n_steps
    return max(min(int(n_live), n_steps), 1)


def _step_alive(soat):
    """The reference's dead-step guard: a step whose max tmax (NaN
    propagating) is not > 0 gets all-zero masks."""
    return soat[:, :, 6].amax(dim=1) > 0.0


def _pack_key(t, lane):
    return (t.view(torch.int32) & ~(KTRI - 1)) | lane


# ---------------------------------------------------------------------------
# Kernel 1: cluster masks (replaces _mask_kernel)
# ---------------------------------------------------------------------------


def cluster_masks_plain(soat, cl_box, tmin: float, n_live=None, b: int = 128):
    """soat [n_steps, sb, 8] f32, cl_box [8, C_pad] f32 -> masks
    [n_steps * sb / b, C_pad / 32] i32: bit c % 32 of word c / 32 is set
    iff some ray of the block slab-hits cluster c. Rows of steps past the
    live prefix, and of steps whose max tmax is not > 0, are zero."""
    n_steps, sb, _ = soat.shape
    c_pad = cl_box.shape[1]
    rb = sb // b
    out = torch.zeros((n_steps * rb, c_pad // 32), dtype=torch.int32,
                      device=soat.device)
    alive = _step_alive(soat)
    shifts = torch.arange(32, dtype=torch.int64, device=soat.device)
    box = [cl_box[k][None, :] for k in range(6)]
    tmin_t = torch.tensor(tmin, dtype=torch.float32, device=soat.device)
    for s in range(_live_floor(n_live, n_steps)):
        if not bool(alive[s]):
            continue
        r = soat[s]
        ox, oy, oz = r[:, 0:1], r[:, 1:2], r[:, 2:3]
        ix, iy, iz = 1.0 / r[:, 3:4], 1.0 / r[:, 4:5], 1.0 / r[:, 5:6]
        tmax = r[:, 6:7]
        tx0, ty0, tz0 = (box[0] - ox) * ix, (box[1] - oy) * iy, (box[2] - oz) * iz
        tx1, ty1, tz1 = (box[3] - ox) * ix, (box[4] - oy) * iy, (box[5] - oz) * iz
        mn, mx = torch.minimum, torch.maximum
        near = mx(mx(mn(tx0, tx1), mn(ty0, ty1)), mn(tz0, tz1))
        far = mn(mn(mx(tx0, tx1), mx(ty0, ty1)), mx(tz0, tz1))
        hit = (mx(near, tmin_t) <= mn(far, tmax)) & (far >= tmin_t)
        blk = hit.view(rb, b, c_pad).any(dim=1).view(rb, c_pad // 32, 32)
        words = (blk.to(torch.int64) << shifts).sum(dim=2)
        words = torch.where(words >= 2**31, words - 2**32, words)
        out[s * rb:(s + 1) * rb] = words.to(torch.int32)
    return out


@cuda_lib.counted
def cluster_masks(soat, cl_box, tmin: float, n_live=None, b: int = 128):
    """Kernel wrapper of :func:`cluster_masks_plain` (same contract)."""
    _check_dtype("cluster_masks", soat, torch.float32, 3)
    _check_dtype("cluster_masks", cl_box, torch.float32, 2)
    n_steps, sb, width = soat.shape
    c_pad = cl_box.shape[1]
    if width != 8 or cl_box.shape[0] != 8 or c_pad % 32:
        raise ValueError("cluster_masks: soat [n_steps, sb, 8] and cl_box "
                         "[8, C_pad] with C_pad % 32 == 0 expected")
    validate_blocks(b, sb)
    if cuda_lib.on_cpu("cluster_masks", soat, cl_box, n_live):
        out = cluster_masks_plain(soat, cl_box, tmin, n_live, b)
        if tracing.enabled():
            tracing.count("traverse.pairs", popcount(out))
        return out
    _check_live(n_live, soat.device)
    alive = _step_alive(soat).to(torch.uint8)
    args = [soat, cl_box, alive] + ([n_live] if n_live is not None else [])
    lib, stream = cuda_lib.launch_args("cluster_masks", *args)
    n_blocks = n_steps * sb // b
    out = torch.empty((n_blocks, c_pad // 32), dtype=torch.int32,
                      device=soat.device)
    cuda_lib.check(lib.rt_cluster_masks(
        soat.data_ptr(), cl_box.data_ptr(), alive.data_ptr(), _ptr(n_live),
        out.data_ptr(), n_blocks, c_pad, b, sb, n_steps, float(tmin),
        tracing.counter_ptr("traverse.pairs", soat), stream,
    ), "cluster_masks")
    cuda_lib.count_launch(cluster_masks, soat.device)
    return out


def popcount(words) -> torch.Tensor:
    """The set bits of the int32 ``words``, summed: an int64 scalar."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).sum()


def word_roots_plain(cl_box):
    """cl_box [8, C_pad] f32 -> roots [12, C_pad / 32] f32: per 32-cluster
    mask word, rows 0-5 the exact f32 union box (min.xyz, max.xyz) of its
    real clusters and rows 6-11 that of its lane pads (``box[0] >= 1e29``,
    left out of the real union as the reference's unit roots leave them).
    Each axis spans the min and max of both planes of every member box; a
    group without members is the never-hit 1e30 point box. The gate of the
    cluster_masks kernel."""
    n_words = cl_box.shape[1] // 32
    g = cl_box[:6].reshape(6, n_words, 32)
    lo, hi = torch.minimum(g[:3], g[3:]), torch.maximum(g[:3], g[3:])
    real = (cl_box[0] < 1e29).reshape(1, n_words, 32)
    rows = []
    for member in (real, ~real):
        empty = ~member.any(dim=2)
        rows.append(torch.where(empty, float(NEVER_HIT), torch.where(
            member, lo, _INF).amin(dim=2)))
        rows.append(torch.where(empty, float(NEVER_HIT), torch.where(
            member, hi, -_INF).amax(dim=2)))
    return torch.cat(rows, dim=0)


def word_live_plain(soat, roots, tmin: float, b: int = 128):
    """soat [n_steps, sb, 8] f32, roots [12, n_words] (from
    :func:`word_roots_plain`) -> [n_steps * sb / b, n_words] bool: some ray
    of the block hits the word's real or pad root under the reference's
    NaN-robust root slab (``slab_root``: an axis whose entry or exit is NaN
    spans (-inf, inf)). A ray that hits a cluster of the word hits one of
    its roots, so a word the masks set is live; ``b=1`` gives the per-ray
    root hits."""
    n_steps, sb, _ = soat.shape
    rays = soat.reshape(n_steps * sb, 8)
    tmax = rays[:, 6:7]
    mn, mx = torch.minimum, torch.maximum

    def slab_root(rt):
        near = far = None
        for k in range(3):
            o, inv = rays[:, k:k + 1], 1.0 / rays[:, 3 + k:4 + k]
            t0, t1 = (rt[k][None, :] - o) * inv, (rt[k + 3][None, :] - o) * inv
            bad = torch.isnan(t0) | torch.isnan(t1)
            lo = torch.where(bad, -_INF, mn(t0, t1))
            hi = torch.where(bad, _INF, mx(t0, t1))
            near = lo if near is None else mx(near, lo)
            far = hi if far is None else mn(far, hi)
        return (torch.clamp_min(near, tmin) <= mn(far, tmax)) & (far >= tmin)

    hit = slab_root(roots[0:6]) | slab_root(roots[6:12])
    return hit.view(n_steps * sb // b, b, -1).any(dim=1)


def _check_flag(name, flag):
    if flag is not None and (flag.dtype != torch.bool or flag.numel() != 1):
        raise ValueError(f"{name}: the gate flag must be a one-element bool "
                         "tensor")


def _check_live(n_live, device):
    if n_live is not None and (
        n_live.dtype != torch.int32 or n_live.numel() != 1
        or n_live.device != device
    ):
        raise ValueError("n_live must be a one-element int32 tensor on the "
                         "rays' device")


# ---------------------------------------------------------------------------
# Kernel 2: block traversal (replaces _traverse_kernel)
# ---------------------------------------------------------------------------


def _keys(mt_mode, row, o, d, tmin, lane):
    """Packed keys of rays (o, d: columns [..., n, 1]) against cluster rows
    (``row(k)``: row k broadcast as [..., 1, 128]); same operation order as
    the reference's ``_mt_key_rows``."""
    ox, oy, oz = o
    dx, dy, dz = d
    if mt_mode == "bw":
        nx, ny, nz, dpl = row(0), row(1), row(2), row(3)
        rux, ruy, ruz, rud = row(4), row(5), row(6), row(7)
        rvx, rvy, rvz, rvd = row(8), row(9), row(10), row(11)
        den = nx * dx + ny * dy + nz * dz
        t = (dpl - (nx * ox + ny * oy + nz * oz)) / den
        hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
        u = rux * hx + ruy * hy + ruz * hz + rud
        v = rvx * hx + rvy * hy + rvz * hz + rvd
    else:
        v0x, v0y, v0z = row(0), row(1), row(2)
        e1x, e1y, e1z = row(3), row(4), row(5)
        e2x, e2y, e2z = row(6), row(7), row(8)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv = 1.0 / det
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= tmin)
    return torch.where(ok, _pack_key(t, lane), _IMAX)


# the fold's per-ray widening of a slice box (csrc/fold.cuh FoldRay)
SLICE_PAD_ORIGIN = 2.0**-16  # of the ray's largest |origin coordinate|
SLICE_PAD_TMIN = 2.0  # of tmin times its largest |direction component|
SLICE_TMAX_SCALE = 1.0 + 2.0**-14


def slice_rays_plain(rays, tmin: float, mt_mode: str):
    """The fold's per-ray terms of the slice test from ``soat`` rows
    [..., 8]: (o, inverse direction, box widening, upper t), each [..., 1]
    or a 3-tuple of them, in the kernel's operation order. The upper t is
    tmax widened for BW rows and inf for MT rows: a BW key's t places the
    ray at the triangle, an MT key's t can err far on a grazing ray, while
    the line still crosses the triangle inside its box."""
    col = [rays[..., k:k + 1] for k in range(7)]
    o, d, tm = col[0:3], col[3:6], col[6]
    inv = tuple(1.0 / x for x in d)
    mx = torch.maximum
    pad = (SLICE_PAD_ORIGIN * mx(mx(o[0].abs(), o[1].abs()), o[2].abs())
           + (SLICE_PAD_TMIN * tmin) * mx(mx(d[0].abs(), d[1].abs()),
                                          d[2].abs()))
    if mt_mode != "bw":
        tm = torch.full_like(tm, _INF)
    cap = torch.where(tm != tm, _INF,
                      torch.clamp_min(tm * SLICE_TMAX_SCALE, 0.0))
    return tuple(o), inv, pad, cap


def slice_slab_plain(ray_terms, box, tmin: float):
    """Whether rays (``slice_rays_plain``'s terms) slab-hit slice boxes
    ``box`` [..., 8] (broadcast against them) widened by the ray's pad,
    over [tmin, cap]: ``cluster_masks``' NaN-robust root slab, where an
    axis whose entry or exit is NaN spans (-inf, inf)."""
    o, inv, pad, cap = ray_terms
    near = torch.full((), -_INF, device=box.device)
    far = torch.full((), _INF, device=box.device)
    for k in range(3):
        t0 = ((box[..., k] - pad[..., 0]) - o[k][..., 0]) * inv[k][..., 0]
        t1 = ((box[..., k + 3] + pad[..., 0]) - o[k][..., 0]) * inv[k][..., 0]
        ok = (t0 == t0) & (t1 == t1)
        near = torch.where(ok, torch.maximum(near, torch.minimum(t0, t1)),
                           near)
        far = torch.where(ok, torch.minimum(far, torch.maximum(t0, t1)), far)
    return ((torch.maximum(near, torch.tensor(tmin))
             <= torch.minimum(far, cap[..., 0])) & (far >= tmin))


# (ray block, cluster) pairs per batch of slice_runs_plain
_SLICE_PAIR_BATCH = 2048


def slice_runs_plain(blk, cid, soab, slices, tmin: float, mt_mode: str,
                     b: int):
    """The slice runs of the fold over (ray block ``blk``, cluster ``cid``)
    pairs (int64 [P] each; soab [n_blocks, b, 8], slices [C, 4, 8]): per
    pair, per 32-ray group of the block (a warp; the whole block at
    b < 32) and per slice, 1 when a ray of the group slab-hits the slice's
    box (:func:`slice_slab_plain`). An int64 scalar."""
    dev = soab.device
    cid = torch.clamp_max(cid, slices.shape[0] - 1)
    group = min(b, SLICE)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for p0 in range(0, blk.numel(), _SLICE_PAIR_BATCH):
        pb = blk[p0:p0 + _SLICE_PAIR_BATCH]
        pc = cid[p0:p0 + _SLICE_PAIR_BATCH]
        terms = slice_rays_plain(soab[pb][:, :, None, :], tmin, mt_mode)
        hit = slice_slab_plain(terms, slices[pc][:, None, :, :], tmin)
        total += hit.view(hit.shape[0], -1, group, N_SLICES).any(2).sum()
    return total


def fold_slices_plain(masks, soat, slices, tmin: float, mt_mode: str,
                      n_live=None, b: int = 128):
    """The slice runs of ``traverse_blocks``' closest-hit fold (its counter
    ``traverse.slices``, :func:`slice_runs_plain`) over the clusters each
    live ray block's mask lists. An any-hit fold, which stops once its
    rays have hits, runs at most this."""
    n_steps, sb, _ = soat.shape
    dev = soat.device
    n_blocks = _live_floor(n_live, n_steps) * sb // b
    n_words = masks.shape[1]
    bits = ((masks[:n_blocks, :, None].to(torch.int64)
             >> torch.arange(32, device=dev)) & 1).bool()
    bits = bits.reshape(n_blocks, n_words * 32)[:, :slices.shape[0]]
    blk, cid = torch.nonzero(bits, as_tuple=True)
    return slice_runs_plain(blk, cid, soat.reshape(-1, b, 8), slices, tmin,
                            mt_mode, b)


def _check_slices(name, slices, tri):
    _check_dtype(name, slices, torch.float32, 3)
    if tuple(slices.shape) != (tri.shape[0], N_SLICES, 8):
        raise ValueError(f"{name}: slices must be [C, {N_SLICES}, 8] for a "
                         f"tri table of C = {tri.shape[0]} clusters")


def traverse_blocks_plain(masks, soat, tri, tmin: float, mt_mode: str = "vpu",
                          any_hit: bool = False, n_live=None, b: int = 128,
                          run_if=None, *, slices=None):
    """masks [n_blocks, n_words] i32, soat [n_steps, sb, 8] f32, tri
    [C, 16, 128] f32 (MT rows for 'vpu', BW rows for 'bw') -> (t, prim)
    each [n_steps, sb, 1]: per ray the minimum packed key over the
    triangles of its block's listed clusters (strict <, so ties go to the
    lowest cluster), t = key bits with the lane cleared (inf on a miss),
    prim = cluster * 128 + lane (-1). Steps past the live prefix are
    misses. ``any_hit`` only loosens the contract to prim >= 0; the plain
    version always finds the nearest hit. With a one-element bool
    ``run_if`` that is False the launch does nothing and its outputs are
    undefined (here: misses). ``slices``, the kernel's slice boxes, is not
    read: this version runs every test, of which the kernel's slice cull
    skips only some that cannot pass."""
    del any_hit, slices
    n_steps, sb, _ = soat.shape
    dev = soat.device
    if run_if is not None and not bool(run_if):
        return (torch.full((n_steps, sb, 1), _INF, device=dev),
                torch.full((n_steps, sb, 1), -1, dtype=torch.int32,
                           device=dev))
    n = n_steps * sb
    rays = soat.reshape(n, 8)
    n_run = _live_floor(n_live, n_steps) * sb
    kb = _pack_key(torch.minimum(rays[:, 6], torch.tensor(3e38, device=dev)),
                   KTRI - 1)
    cb = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(KTRI, dtype=torch.int32, device=dev)[None, :]
    n_words = masks.shape[1]
    for c in range(min(tri.shape[0], n_words * 32)):
        word = masks[:, c // 32]
        blk_has = ((word >> (c % 32)) & 1).bool()
        sel = torch.nonzero(blk_has.repeat_interleave(b)[:n_run]).squeeze(1)
        if sel.numel() == 0:
            continue
        r = rays[sel]
        o = (r[:, 0:1], r[:, 1:2], r[:, 2:3])
        d = (r[:, 3:4], r[:, 4:5], r[:, 5:6])
        kmin = _keys(mt_mode, lambda k: tri[c, k][None, :], o, d, tmin,
                     lane).amin(dim=1)
        better = kmin < kb[sel]
        kb[sel] = torch.where(better, kmin, kb[sel])
        cb[sel] = torch.where(better, c, cb[sel])
    found = cb >= 0
    t = torch.where(found, (kb & ~(KTRI - 1)).view(torch.float32), _INF)
    prim = torch.where(found, cb * KTRI + (kb & (KTRI - 1)), -1)
    return t.view(n_steps, sb, 1), prim.view(n_steps, sb, 1)


_LIST_HEAD = 4  # int32 counters ahead of the kernel's unit list


@cuda_lib.counted
def traverse_blocks(masks, soat, tri, tmin: float, mt_mode: str = "vpu",
                    any_hit: bool = False, n_live=None, b: int = 128,
                    run_if=None, *, slices):
    """Kernel wrapper of :func:`traverse_blocks_plain` (same contract; a
    clear ``run_if`` flag makes the kernel exit before writing). slices:
    the tri table's slice boxes [C, 4, 8]
    (``accel/kernel_tables.py build_slice_boxes``), from which the kernel's
    warps skip the 32-lane slices none of their rays can reach. With
    tracing on the kernel adds the slices its warps ran to the counter
    ``traverse.slices`` (on the CPU: :func:`fold_slices_plain`)."""
    _check_dtype("traverse_blocks", masks, torch.int32, 2)
    _check_dtype("traverse_blocks", soat, torch.float32, 3)
    _check_dtype("traverse_blocks", tri, torch.float32, 3)
    _check_slices("traverse_blocks", slices, tri)
    n_steps, sb, width = soat.shape
    validate_blocks(b, sb)
    if (width != 8 or tuple(tri.shape[1:]) != (16, KTRI)
            or masks.shape[0] != n_steps * sb // b):
        raise ValueError("traverse_blocks: shapes do not match "
                         "(masks [n_blocks, n_words], soat [n_steps, sb, 8],"
                         " tri [C, 16, 128])")
    if mt_mode not in ("vpu", "bw"):
        raise ValueError(f"traverse_blocks: mt_mode {mt_mode!r}")
    if cuda_lib.on_cpu("traverse_blocks", masks, soat, tri, slices, n_live,
                       run_if):
        if tracing.enabled() and (run_if is None or bool(run_if)):
            tracing.count("traverse.slices", fold_slices_plain(
                masks, soat, slices, tmin, mt_mode, n_live, b))
        return traverse_blocks_plain(masks, soat, tri, tmin, mt_mode,
                                     any_hit, n_live, b, run_if)
    _check_live(n_live, soat.device)
    _check_flag("traverse_blocks", run_if)
    args = [t for t in (masks, soat, tri, slices, n_live, run_if)
            if t is not None]
    lib, stream = cuda_lib.launch_args("traverse_blocks", *args)
    n_units = masks.shape[0] * masks.shape[1]
    # the fold's tickets: a warp's (unit, 32-ray group, slice)
    if n_units * max(b // SLICE, 1) * N_SLICES >= 2**31 - 2**24:
        raise ValueError("traverse_blocks: too many mask words")
    if soat.data_ptr() % 16 or slices.data_ptr() % 16:
        raise ValueError("traverse_blocks: soat and slices must be 16-byte "
                         "aligned")
    n = n_steps * sb
    t = torch.empty((n_steps, sb, 1), dtype=torch.float32, device=soat.device)
    p = torch.empty((n_steps, sb, 1), dtype=torch.int32, device=soat.device)
    # the rays' 64-bit bests, then the unit list (head and word ids)
    scratch = torch.empty((n + (n_units + _LIST_HEAD + 1) // 2,),
                          dtype=torch.int64, device=soat.device)
    cuda_lib.check(lib.rt_traverse_blocks(
        masks.data_ptr(), soat.data_ptr(), tri.data_ptr(),
        slices.data_ptr(), _ptr(n_live), _ptr(run_if), scratch.data_ptr(),
        scratch.data_ptr() + 8 * n, t.data_ptr(), p.data_ptr(),
        tracing.counter_ptr("traverse.slices", soat), masks.shape[0], b,
        masks.shape[1], tri.shape[0], sb, n_steps, float(tmin),
        int(mt_mode == "bw"), int(bool(any_hit)), stream,
    ), "traverse_blocks")
    cuda_lib.count_launch(traverse_blocks, soat.device)
    return t, p


# ---------------------------------------------------------------------------
# Kernel 3: gathered, transposed rows (replaces _transpose_rows_kernel)
# ---------------------------------------------------------------------------


def gather_rows_t_plain(table, idx):
    """table [T, K] f32, idx [N] i32 -> [K, N]: out[k, i] =
    table[clamp(idx[i], 0, T-1), k] (transpose_rows(table[idx]))."""
    safe = idx.clamp(0, table.shape[0] - 1).to(torch.int64)
    return table[safe].t().contiguous()


@cuda_lib.counted
def gather_rows_t(table, idx):
    """Kernel wrapper of :func:`gather_rows_t_plain` (K in {16, 32})."""
    _check_dtype("gather_rows_t", table, torch.float32, 2)
    _check_dtype("gather_rows_t", idx, torch.int32, 1)
    k = table.shape[1]
    if k not in (16, 32) or table.shape[0] == 0:
        raise ValueError(f"gather_rows_t: table [T>0, 16|32], got "
                         f"{tuple(table.shape)}")
    if cuda_lib.on_cpu("gather_rows_t", table, idx):
        return gather_rows_t_plain(table, idx)
    lib, stream = cuda_lib.launch_args("gather_rows_t", table, idx)
    if table.data_ptr() % 16:
        raise ValueError("gather_rows_t: table must be 16-byte aligned")
    n = idx.shape[0]
    out = torch.empty((k, n), dtype=torch.float32, device=table.device)
    cuda_lib.check(lib.rt_gather_rows_t(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, table.shape[0],
        k, stream,
    ), "gather_rows_t")
    cuda_lib.count_launch(gather_rows_t, table.device)
    return out


# ---------------------------------------------------------------------------
# Kernels 4 and 5: item-list traversal (replaces _items_kernel) and its list
# (replaces the XLA _build_items)
# ---------------------------------------------------------------------------

CID_BITS = 13  # cluster-id field of a packed item (bid << 13 | cid)
_CID_MASK = (1 << CID_BITS) - 1
_I64_MAX = 2**63 - 1
# items the plain version folds per batch of tensor ops ([256, b, 128] keys)
_PLAIN_ITEM_BATCH = 256


def build_items_plain(masks, w: int, maxitems: int, cap: int):
    """masks [n_blocks, n_words] i32 -> the global item list of the item
    traversal, bit-identical to the reference's ``_build_items``:

    (items [maxitems + w] i32 packed ``bid << 13 | cid``, -1 past the end;
    n_steps [] i32 item groups to run; overflow [] bool; block_used
    [n_blocks] bool). Each block's run lists its set clusters ascending,
    padded to a multiple of ``w`` by repeating the last one; a block with
    more than ``cap`` set clusters repeats its cap-th. On overflow (more
    than ``maxitems`` items, or a block above ``cap``) the list is
    truncated and n_steps clamped to ``maxitems // w``.

    No [n_blocks, cap, 32 n_words] selection tensor: a cumsum ranks each
    set bit, one scatter writes the block's clusters in rank order, and a
    gather reads item j's cluster. Nothing waits on the device."""
    nblk, nw = masks.shape
    c32 = nw * 32
    dev = masks.device
    i32 = torch.int32
    shifts = torch.arange(32, dtype=i32, device=dev)
    bits = ((masks[:, :, None] >> shifts) & 1).reshape(nblk, c32)
    rank = torch.cumsum(bits, dim=1, dtype=i32)
    counts = rank[:, -1]
    aligned = (counts + (w - 1)) // w * w
    ends = torch.cumsum(aligned, dim=0, dtype=i32)
    start = ends - aligned
    total = ends[-1]
    overflow = (total > maxitems) | (counts > cap).any()
    # order[b * c32 + r] = the cluster of block b's (r+1)-th set bit; unset
    # bits land in one spare slot past the end
    row0 = torch.arange(nblk, dtype=torch.int64, device=dev)[:, None] * c32
    slot = torch.where(bits > 0, row0 + (rank - 1), nblk * c32)
    cids = torch.arange(c32, dtype=i32, device=dev).expand(nblk, c32)
    order = torch.zeros(nblk * c32 + 1, dtype=i32, device=dev)
    order.scatter_(0, slot.reshape(-1), cids.reshape(-1))
    # item j belongs to the last block whose run starts at or before j
    j = torch.arange(maxitems, dtype=i32, device=dev)
    bid = torch.searchsorted(start, j, right=True, out_int32=True) - 1
    bl = bid.long()
    r = j - start[bl]
    r = torch.minimum(r, torch.clamp_min(counts[bl] - 1, 0))
    r = torch.clamp_max(r, cap - 1)
    cid = order[bl * c32 + r]
    items = torch.where(j < total, (bid << CID_BITS) | cid, -1)
    items = torch.cat([items, torch.full((w,), -1, dtype=i32, device=dev)])
    n_steps = torch.clamp_max(total, maxitems) // w
    return items, n_steps, overflow, aligned > 0


# build_items.cu's state words (its counters, then a 64-bit status word per
# tile of 8 ray blocks and per fill CTA, at most 4 per SM): enough for
# 2^19 ray blocks, allocated zeroed once per device and never freed, since
# captured graphs hold its address
ITEMS_STATE_WORDS = 4 + 2 * ((1 << 16) + 1024)
_items_state = {}


@cuda_lib.counted
def build_items(masks, w: int, maxitems: int, cap: int):
    """Kernel wrapper of :func:`build_items_plain` (same contract): one
    single-pass launch, nothing read back to the host."""
    _check_dtype("build_items", masks, torch.int32, 2)
    validate_items(w, maxitems, cap)
    nblk, nw = masks.shape
    if nblk == 0 or nw == 0:
        raise ValueError("build_items: masks [n_blocks > 0, n_words > 0] "
                         "expected")
    if cuda_lib.on_cpu("build_items", masks):
        return build_items_plain(masks, w, maxitems, cap)
    if nblk * (nw * 32 + w) >= 2**31 or maxitems + w >= 2**31:
        raise ValueError("build_items: the list's counts must fit in int32")
    if nblk > 1 << 19:
        raise ValueError("build_items: at most 2^19 ray blocks")
    lib, stream = cuda_lib.launch_args("build_items", masks)
    dev = masks.device
    state = _items_state.get(dev)
    if state is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"build_items: the first launch on {dev} was "
                               "made under a capture")
        state = _items_state[dev] = torch.zeros(
            (ITEMS_STATE_WORDS,), dtype=torch.int32, device=dev)
    # the list, then the group count
    ints = torch.empty((maxitems + w + 1,), dtype=torch.int32, device=dev)
    # the overflow flag, then block_used
    flags = torch.empty((nblk + 1,), dtype=torch.bool, device=dev)
    cuda_lib.check(lib.rt_build_items(
        masks.data_ptr(), ints.data_ptr(), ints.data_ptr() + 4 * (maxitems + w),
        flags.data_ptr(), flags.data_ptr() + 1, state.data_ptr(),
        ITEMS_STATE_WORDS, nblk, nw, w, maxitems, cap, stream,
    ), "build_items")
    cuda_lib.count_launch(build_items, dev)
    return ints[:maxitems + w], ints[maxitems + w], flags[0], flags[1:]


def traverse_items_plain(items, n_steps, soab, tri, tmin: float,
                         mt_mode: str = "vpu", w: int = 4, skip=None, *,
                         slices=None):
    """items [maxitems + w] i32, n_steps [] i32 (from :func:`build_items`),
    soab [n_blocks, b, 8] f32, tri [C, 16, 128] f32 -> (t, prim) each
    [n_blocks, b, 1]. Per ray, the minimum packed key over its block's
    items below the initial key ``pack(min(tmax, 3e38), 127)`` (a tie
    with it is a miss); equal keys go to the lowest cluster, as the scan's
    strict < over ascending clusters does, so the result equals
    :func:`traverse_blocks_plain`'s. Rays of blocks without items are
    misses. Item clusters past the table read its last cluster, as the
    reference's index map clamps them. A set one-element bool ``skip``
    makes the launch write misses only. ``slices`` is not read, as in
    :func:`traverse_blocks_plain`."""
    del slices
    nblk, b, _ = soab.shape
    dev = soab.device
    n = nblk * b
    rays = soab.reshape(n, 8)
    kb0 = _pack_key(torch.clamp_max(rays[:, 6], 3e38), KTRI - 1)
    best = torch.full((n,), _I64_MAX, dtype=torch.int64, device=dev)
    n_items = 0 if skip is not None and bool(skip) else int(n_steps) * w
    lane = torch.arange(KTRI, dtype=torch.int32, device=dev)[None, :]
    ray_ix = torch.arange(b, dtype=torch.int64, device=dev)[None, :]
    for s0 in range(0, n_items, _PLAIN_ITEM_BATCH):
        it = items[s0:min(s0 + _PLAIN_ITEM_BATCH, n_items)].long()
        bid, cid = it >> CID_BITS, it & _CID_MASK
        rows = tri[torch.clamp_max(cid, tri.shape[0] - 1)]  # [L, 16, 128]
        r = soab[bid]  # [L, b, 8]
        o = (r[..., 0:1], r[..., 1:2], r[..., 2:3])
        d = (r[..., 3:4], r[..., 4:5], r[..., 5:6])
        kmin = _keys(mt_mode, lambda k: rows[:, k, None, :], o, d, tmin,
                     lane).amin(dim=2)  # [L, b]
        ix = bid[:, None] * b + ray_ix
        cand = torch.where(kmin < kb0[ix], kmin.long() * 2**32 + cid[:, None],
                           _I64_MAX)
        best.scatter_reduce_(0, ix.reshape(-1), cand.reshape(-1), "amin")
    found = best != _I64_MAX
    key = (best >> 32).to(torch.int32)
    cl = (best & 0xFFFFFFFF).to(torch.int32)
    t = torch.where(found, (key & ~(KTRI - 1)).view(torch.float32), _INF)
    prim = torch.where(found, cl * KTRI + (key & (KTRI - 1)), -1)
    return t.view(nblk, b, 1), prim.view(nblk, b, 1)


def _item_slices_plain(items, n_steps, soab, slices, tmin: float,
                       mt_mode: str, w: int):
    """:func:`slice_runs_plain` over the list's items, its pads (an item
    equal to the one before it) and items of no block dropped, as the
    kernel reads them."""
    n_items = min(max(int(n_steps), 0), (items.shape[0] - w) // w) * w
    it = items[:n_items].long()
    bid, cid = it >> CID_BITS, it & _CID_MASK
    keep = (bid >= 0) & (bid < soab.shape[0])
    keep[1:] &= it[1:] != it[:-1]
    return slice_runs_plain(bid[keep], cid[keep], soab, slices, tmin,
                            mt_mode, soab.shape[1])


@cuda_lib.counted
def traverse_items(items, n_steps, soab, tri, tmin: float,
                   mt_mode: str = "vpu", w: int = 4, skip=None, *, slices):
    """Kernel wrapper of :func:`traverse_items_plain` (same contract; a
    set ``skip`` flag makes the fold exit at once). slices, and the
    counter ``traverse.slices`` (on the CPU :func:`slice_runs_plain` over
    the list's items): as in :func:`traverse_blocks`."""
    _check_dtype("traverse_items", items, torch.int32, 1)
    _check_dtype("traverse_items", soab, torch.float32, 3)
    _check_dtype("traverse_items", tri, torch.float32, 3)
    _check_slices("traverse_items", slices, tri)
    nblk, b, width = soab.shape
    if (width != 8 or tuple(tri.shape[1:]) != (16, KTRI)
            or n_steps.dtype != torch.int32 or n_steps.numel() != 1
            or not 1 <= w <= 8 or items.shape[0] <= w
            or tri.shape[0] == 0 or tri.shape[0] > 1 << CID_BITS):
        raise ValueError("traverse_items: items [maxitems + w] i32, n_steps "
                         "[] i32, soab [n_blocks, b, 8], tri [C, 16, 128] "
                         "with 0 < C <= 8192 and 1 <= w <= 8 expected")
    if mt_mode not in ("vpu", "bw"):
        raise ValueError(f"traverse_items: mt_mode {mt_mode!r}")
    if b > 1024 or b & (b - 1):
        raise ValueError(f"traverse_items: b={b} must be a power of two "
                         "<= 1024")
    if cuda_lib.on_cpu("traverse_items", items, n_steps, soab, tri, slices,
                       skip):
        if tracing.enabled() and (skip is None or not bool(skip)):
            tracing.count("traverse.slices", _item_slices_plain(
                items, n_steps, soab, slices, tmin, mt_mode, w))
        return traverse_items_plain(items, n_steps, soab, tri, tmin,
                                    mt_mode, w, skip)
    _check_flag("traverse_items", skip)
    args = [t for t in (items, n_steps, soab, tri, slices, skip)
            if t is not None]
    lib, stream = cuda_lib.launch_args("traverse_items", *args)
    if soab.data_ptr() % 16 or slices.data_ptr() % 16:
        raise ValueError("traverse_items: soab and slices must be 16-byte "
                         "aligned")
    # the fold's tickets: a warp's (32-item chunk, 32-ray group, slice)
    if ((items.shape[0] // 32 + 1) * max(b // SLICE, 1) * N_SLICES
            >= 2**31 - 2**24):
        raise ValueError("traverse_items: too many items")
    t = torch.empty((nblk, b, 1), dtype=torch.float32, device=soab.device)
    p = torch.empty((nblk, b, 1), dtype=torch.int32, device=soab.device)
    # the rays' 64-bit bests, then the group counter
    best = torch.empty((nblk * b + 1,), dtype=torch.int64, device=soab.device)
    cuda_lib.check(lib.rt_traverse_items(
        items.data_ptr(), n_steps.data_ptr(), soab.data_ptr(), tri.data_ptr(),
        slices.data_ptr(), _ptr(skip), best.data_ptr(),
        best.data_ptr() + 8 * nblk * b, t.data_ptr(), p.data_ptr(),
        tracing.counter_ptr("traverse.slices", soab), nblk, b, tri.shape[0],
        (items.shape[0] - w) // w, w, float(tmin), int(mt_mode == "bw"),
        stream,
    ), "traverse_items")
    cuda_lib.count_launch(traverse_items, soab.device)
    return t, p


# ---------------------------------------------------------------------------
# Kernel 6: the 'xla' route's cluster pipeline (the body of the reference's
# XLA while_loop, rayito_tpu/render/mesh_intersect.py:186-281; no
# pallas_call)
# ---------------------------------------------------------------------------

# superclusters and clusters a ray keeps, nearest first (the reference's
# K1 and K2; the kernel holds at most these)
K1_SUPERS = 16
K2_CLUSTERS = 24
# compacted slots per batch of the plain version: its [chunk, 24, 512] f32
# triangle gather is 805 MB on the card
PIPELINE_CHUNK = 16384


def _slab6(ox, oy, oz, ix, iy, iz, tmin, tmax, bx0, by0, bz0, bx1, by1, bz1):
    """Component-wise slab test; entry t or INF. torch.maximum / minimum
    propagate the NaN of 0 * inf (an axis-parallel ray on a box plane),
    which then fails ``t0 <= t1`` as in the reference. ``tmin`` is a
    number or a 0-dim tensor."""
    tx0 = (bx0 - ox) * ix
    tx1 = (bx1 - ox) * ix
    ty0 = (by0 - oy) * iy
    ty1 = (by1 - oy) * iy
    tz0 = (bz0 - oz) * iz
    tz1 = (bz1 - oz) * iz
    near = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.minimum(tz0, tz1))
    far = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.maximum(tz0, tz1))
    t0 = torch.maximum(near, tmin)
    t1 = torch.minimum(far, tmax)
    return torch.where(t0 <= t1, t0, _INF)


def box_slab(o, inv, tmin, tmax, lo, hi):
    """_slab6 of rays [R] (o, inv: V3 of [R]) against boxes whose
    components are trailing dims of ``lo`` / ``hi`` V3s."""
    ex = (slice(None),) + (None,) * (lo.x.dim() - 1)
    if not torch.is_tensor(tmin):  # a CPU scalar: no copy to the card
        tmin = torch.tensor(tmin, dtype=torch.float32)
    return _slab6(o.x[ex], o.y[ex], o.z[ex], inv.x[ex], inv.y[ex], inv.z[ex],
                  tmin, tmax[ex], lo.x, lo.y, lo.z, hi.x, hi.y, hi.z)


def nearest_k(t, k: int):
    """(t, index) of the k smallest entries of each row of t, ascending,
    ties to the lower index (``jax.lax.top_k(-t, k)``'s order)."""
    t_sorted, order = torch.sort(t, dim=1, stable=True)
    return t_sorted[:, :k], order[:, :k]


def _pipeline_chunk(t_sc, o, d, tmin, tmax, sc_rows, tri_rows, k1: int,
                    k2: int, tri0: int):
    """Phases 2-3 for the rays o, d (V3 of [R]) with their phase-1 rows
    t_sc [R, S]: (t [R], global prim [R] i32, overflow per ray [R] i32)."""
    n_r = t_sc.shape[0]
    inv = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    T = TRI_PER_CLUSTER

    # phase 2: the nearest k1 superclusters' children, from packed rows
    t1, sc_idx = nearest_k(t_sc, k1)
    ovf = torch.clamp_min(torch.isfinite(t_sc).sum(1) - k1, 0)
    rows = sc_rows[sc_idx]  # [R, k1, 128]
    col = lambda c: rows[:, :, c * 16:(c + 1) * 16]
    t_cl = box_slab(o, inv, tmin, tmax, V3(col(0), col(1), col(2)),
                    V3(col(3), col(4), col(5)))
    t_cl = torch.where((t1 < _INF)[:, :, None], t_cl, _INF).reshape(
        n_r, k1 * CLUSTERS_PER_SUPER)
    ovf = ovf + torch.clamp_min((t_cl < _INF).sum(1) - k2, 0)
    t2, cand = nearest_k(t_cl, k2)  # slots into k1 * 16
    sc_sel = sc_idx.gather(1, cand >> 4)
    cl_sel = sc_sel * CLUSTERS_PER_SUPER + (cand & 15)

    # phase 3: Möller-Trumbore over the candidates' 48-triangle rows, in
    # the reference's formulation
    trows = tri_rows[cl_sel]  # [R, k2, 512]
    comp = lambda b: trows[:, :, b * T:(b + 1) * T]  # [R, k2, 48]
    v0x, v0y, v0z = comp(0), comp(1), comp(2)
    v1x, v1y, v1z = comp(3), comp(4), comp(5)
    v2x, v2y, v2z = comp(6), comp(7), comp(8)
    ex = (slice(None), None, None)
    dx, dy, dz = d.x[ex], d.y[ex], d.z[ex]
    ox, oy, oz = o.x[ex], o.y[ex], o.z[ex]
    e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
    e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
    gnx = e1y * e2z - e1z * e2y
    gny = e1z * e2x - e1x * e2z
    gnz = e1x * e2y - e1y * e2x
    det = -(dx * gnx + dy * gny + dz * gnz)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    t0x, t0y, t0z = v0x - ox, v0y - oy, v0z - oz
    rcx = dy * t0z - dz * t0y
    rcy = dz * t0x - dx * t0z
    rcz = dx * t0y - dy * t0x
    t1x, t1y, t1z = v1x - ox, v1y - oy, v1z - oz
    gamma = -(t1x * rcx + t1y * rcy + t1z * rcz) * inv_det
    t2x, t2y, t2z = v2x - ox, v2y - oy, v2z - oz
    beta = (t2x * rcx + t2y * rcy + t2z * rcz) * inv_det
    t = -(t0x * gnx + t0y * gny + t0z * gnz) * inv_det
    hit = ((det != 0.0) & (gamma >= 0.0) & (gamma <= 1.0) & (beta >= 0.0)
           & (beta + gamma <= 1.0) & (t >= tmin) & (t < tmax[ex])
           & (t2 < _INF)[:, :, None])
    t_tri = torch.where(hit, t, _INF).reshape(n_r, k2 * T)
    arg = torch.argmin(t_tri, dim=1, keepdim=True)  # all-INF rows: 0
    cl_win = cl_sel.gather(1, arg // T)[:, 0]
    prim = (tri0 + cl_win * T + arg[:, 0] % T).to(torch.int32)
    return t_tri.gather(1, arg)[:, 0], prim, ovf.to(torch.int32)


def cluster_pipeline_plain(ray_of_slot, n_active, o, d, tmax, tmin: float,
                           t_sc, sc_rows, tri_rows, k1: int, k2: int,
                           tri0: int):
    """Phases 2-3 of the two-level pipeline for one mesh, per compacted
    slot. ray_of_slot [N] i32 (the lanes with a candidate first, ascending),
    n_active [] i32 (how many), o, d (V3 of [N] f32), tmax [N] f32, t_sc
    [N, S] f32 (phase 1, by lane), sc_rows [S, 128] and tri_rows [C, 512]
    (the mesh's rows) -> (t, prim, overflow) per slot, [N] f32 / i32 / i32:
    for slot s < n_active, lane ray_of_slot[s]'s nearest hit among the
    triangles of its k2 nearest clusters, themselves children of its k1
    nearest superclusters (ties to the lower index), the global triangle
    id tri0 + cluster * 48 + triangle (an all-miss slot: the first
    candidate's first triangle), and max(#superclusters entered - k1, 0) +
    max(#clusters entered - k2, 0). Slots at or past n_active are INF / -1
    / 0. Reads n_active on the host."""
    n = ray_of_slot.shape[0]
    dev = t_sc.device
    t_slot = torch.full((n,), _INF, device=dev)
    prim_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ovf_slot = torch.zeros((n,), dtype=torch.int32, device=dev)
    n_act = int(n_active)
    for c0 in range(0, n_act, PIPELINE_CHUNK):
        c1 = min(c0 + PIPELINE_CHUNK, n_act)
        lanes = ray_of_slot[c0:c1].long()
        t_slot[c0:c1], prim_slot[c0:c1], ovf_slot[c0:c1] = _pipeline_chunk(
            t_sc[lanes], o[lanes], d[lanes], tmin, tmax[lanes], sc_rows,
            tri_rows, k1, k2, tri0)
    return t_slot, prim_slot, ovf_slot


@cuda_lib.counted
def cluster_pipeline(ray_of_slot, n_active, o, d, tmax, tmin: float, t_sc,
                     sc_rows, tri_rows, k1: int, k2: int, tri0: int):
    """Kernel wrapper of :func:`cluster_pipeline_plain` (same contract):
    one launch over every slot; the kernel reads n_active on the device,
    so the host never waits."""
    name = "cluster_pipeline"
    comps = (o.x, o.y, o.z, d.x, d.y, d.z, tmax)
    _check_dtype(name, ray_of_slot, torch.int32, 1)
    _check_dtype(name, n_active, torch.int32, 0)
    _check_dtype(name, t_sc, torch.float32, 2)
    _check_dtype(name, sc_rows, torch.float32, 2)
    _check_dtype(name, tri_rows, torch.float32, 2)
    for c in comps:
        _check_dtype(name, c, torch.float32, 1)
    n, s = t_sc.shape
    if (ray_of_slot.shape[0] != n or any(c.shape[0] != n for c in comps)
            or tuple(sc_rows.shape) != (s, SC_ROW_WIDTH)
            or tri_rows.shape[1] != TRI_ROW_WIDTH
            or tri_rows.shape[0] < s * CLUSTERS_PER_SUPER
            or not 1 <= k1 <= min(s, K1_SUPERS)
            or not 1 <= k2 <= min(k1 * CLUSTERS_PER_SUPER, K2_CLUSTERS)):
        raise ValueError(f"{name}: ray_of_slot [N], rays [N], t_sc [N, S], "
                         "sc_rows [S, 128], tri_rows [>= 16 S, 512], 1 <= k1 "
                         "<= min(S, 16) and 1 <= k2 <= min(16 k1, 24) "
                         "expected")
    tensors = (ray_of_slot, n_active, *comps, t_sc, sc_rows, tri_rows)
    if cuda_lib.on_cpu(name, *tensors):
        return cluster_pipeline_plain(ray_of_slot, n_active, o, d, tmax, tmin,
                                      t_sc, sc_rows, tri_rows, k1, k2, tri0)
    lib, stream = cuda_lib.launch_args(name, *tensors)
    if n * s >= 2**31 or tri_rows.shape[0] * TRI_ROW_WIDTH >= 2**31:
        raise ValueError(f"{name}: t_sc and tri_rows must hold < 2^31 "
                         "entries")
    dev = t_sc.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    ovf = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, prim, ovf
    cuda_lib.check(lib.rt_cluster_pipeline(
        ray_of_slot.data_ptr(), n_active.data_ptr(),
        *(c.data_ptr() for c in comps), t_sc.data_ptr(), sc_rows.data_ptr(),
        tri_rows.data_ptr(), t.data_ptr(), prim.data_ptr(), ovf.data_ptr(),
        n, s, k1, k2, tri0, float(tmin), stream,
    ), name)
    cuda_lib.count_launch(cluster_pipeline, dev)
    return t, prim, ovf


# ---------------------------------------------------------------------------
# The dense fold of one tiny mesh (the reference's XLA _brute_force_mesh):
# the per-mesh part of fold_small's plain twin (render/mesh_intersect.py)
# ---------------------------------------------------------------------------


def fold_small_plain(rows, tri0: int, o: V3, d: V3, tmin: float, tmax,
                     first: bool = False):
    """Nearest hit of one tiny mesh for every lane: rows [T <= 192, 16] f32
    (its ``tri_vert_rows``: v0, v1, v2 first), the lanes' o, d (V3 of [N]
    f32), tmax [N] f32. One dense [N, T] Möller-Trumbore (t >= tmin, t <
    tmax). Returns (t [N], INF on a miss; prim [N] i32, tri0 + the first
    triangle of least t, -1 on a miss; beta [N], gamma [N] of that
    triangle, of triangle 0 on a miss), and with ``first`` the first row
    that hits ([N] int64, -1 on a miss)."""
    vert = lambda k: V3(rows[None, :, k], rows[None, :, k + 1],
                        rows[None, :, k + 2])
    t, _, beta, gamma, _ = triangle_intersect(
        o[:, None], d[:, None], tmin, tmax[:, None], vert(0), vert(3),
        vert(6))
    j = torch.argmin(t, dim=1, keepdim=True)  # the first of tied minima
    t_best = t.gather(1, j)[:, 0]
    prim = torch.where(torch.isfinite(t_best), tri0 + j[:, 0].to(torch.int32),
                       -1).to(torch.int32)
    out = (t_best, prim, beta.gather(1, j)[:, 0], gamma.gather(1, j)[:, 0])
    if not first:
        return out
    hit = torch.isfinite(t)
    j_first = torch.where(hit.any(1), torch.argmax(hit.to(torch.int32), 1),
                          -1)
    return out + (j_first,)


# ---------------------------------------------------------------------------
# Kernels 7-9: traverse()'s plumbing around the coherence sort (the
# reference's XLA ray packing, _coherence_key and unsort)
# ---------------------------------------------------------------------------

LANE_BITS = 17  # lane field of a packed sort operand (launches <= 2^17)
_LANE_MASK = (1 << LANE_BITS) - 1


def _part1by2(x):
    """Spread the low 9 bits of x so they occupy every 3rd bit."""
    x = x & 0x1FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def coherence_key(ox, oy, oz, dx, dy, dz, tmax, cl_box, tmin: float):
    """Ray-sort key: (miss flag, direction octant, morton cell of the
    root-box entry point) — ``_coherence_key`` of the reference. Purely a
    performance heuristic; results are unsorted afterwards."""
    rmin = cl_box[0:3].amin(dim=1)
    rmax = torch.where(cl_box[3:6] >= 1e29, -_INF, cl_box[3:6]).amax(dim=1)
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    tx0, ty0, tz0 = (rmin[0] - ox) * ix, (rmin[1] - oy) * iy, (rmin[2] - oz) * iz
    tx1, ty1, tz1 = (rmax[0] - ox) * ix, (rmax[1] - oy) * iy, (rmax[2] - oz) * iz
    mn, mx = torch.minimum, torch.maximum
    near = mx(mx(mn(tx0, tx1), mn(ty0, ty1)), mn(tz0, tz1))
    far = mn(mn(mx(tx0, tx1), mx(ty0, ty1)), mx(tz0, tz1))
    # clamp_min propagates NaN as torch.maximum does; a Python scalar
    # keeps the host from copying tmin to the device
    live = (torch.clamp_min(near, tmin) <= mn(far, tmax)) & (tmax > tmin)
    tn = near.clamp(0.0, 3e38)
    ext = torch.clamp_min(rmax - rmin, 1e-30)

    def cell(oc, dc, k):
        q = ((oc + dc * tn - rmin[k]) / ext[k] * 512.0).clamp(0.0, 511.0)
        # non-finite cells belong to missed lanes, masked out below
        return _part1by2(torch.nan_to_num(q).to(torch.int32))

    morton = (cell(ox, dx, 0) << 2) | (cell(oy, dy, 1) << 1) | cell(oz, dz, 2)
    octant = ((dx < 0).to(torch.int32) * 4 + (dy < 0).to(torch.int32) * 2
              + (dz < 0).to(torch.int32))
    key = (octant << 27) | morton
    return torch.where(live, key, _MISS_FLAG)


def _n_tot(n: int, sb: int) -> int:
    return max(1, -(-n // sb)) * sb


@dataclasses.dataclass(frozen=True)
class Chain:
    """A traversal domain's transform chain, for :func:`ray_pack` to take
    each lane into the domain's space at the lane's own time: ``tables``
    the scene's transform tables (xf_times [X, K], xf_translate [X, K, 3],
    xf_scale [X, K, 3], xf_rotate [X, K, 4], xf_nkeys [X] i32), ``slots``
    the chain's slots, outermost first, i32 [depth >= 1] on the tables'
    device (the scene's ``ktab_chain`` row of the domain), ``time`` each
    lane's time [N] f32. ``want_ray`` and ``want_rot`` ask for the local
    ray and the world-from-local rotation back."""

    tables: tuple
    slots: torch.Tensor
    time: torch.Tensor
    want_ray: bool = False
    want_rot: bool = False


def _chain_plain(chain: Chain, o, d):
    """``ops/transform.py`` ``local_ray`` of ``chain``: (o, d) in the
    domain's space and the local outputs of :func:`ray_pack_plain`. Each
    slot is taken as a per-lane id on its device, so the twin never reads
    the device back and can run under a graph capture."""
    slots = chain.slots
    links = [xf.eval_transform(*chain.tables, slots[c:c + 1], chain.time)
             for c in reversed(range(slots.shape[0]))]
    o, d, rot = xf.ray_to_local(links, o, d)
    ray = (torch.stack((o.x, o.y, o.z, d.x, d.y, d.z)) if chain.want_ray
           else None)
    rot = (torch.stack((rot.w, rot.v.x, rot.v.y, rot.v.z)) if chain.want_rot
           else None)
    return o, d, (ray, rot)


def ray_pack_plain(o, d, tmax, cl_box, tmin: float, sb: int = 2048,
                   key: bool = True, chain: Chain | None = None):
    """Rays o, d (V3 of [N] f32), tmax [N] f32 -> (soa8 [n_tot, 8] f32,
    operand [n_tot] i32 or None), n_tot = N rounded up to a multiple of
    ``sb`` (at least ``sb``). A row is (o, d, tmax, 0); padding lanes have
    d = 1 and tmax = 0, so they produce no candidates. With ``key``, the
    operand of the coherence sort: a launch of at most 2^17 lanes packs
    13 coarse key bits above the lane id, ``((key >> 17) << 17) | lane``,
    a larger one gives the key itself; with tracing on, the lanes whose
    key is below the miss flag (those that reach the root box) are added
    to ``traverse.live_rays``.

    With a ``chain`` (:class:`Chain`) o and d are world rays: each lane is
    taken through the chain first (``ops/transform.py`` ``local_ray``),
    the rows and the operand are the local ray's, and a third element
    follows, (ray [6, N] f32: the local o and d; rot [4, N] f32: the
    world-from-local rotation, w x y z), each None unless the chain's
    ``want_ray`` / ``want_rot`` asks for it."""
    local = None
    if chain is not None:
        o, d, local = _chain_plain(chain, o, d)
    n = o.x.shape[0]
    n_tot = _n_tot(n, sb)
    soa8 = torch.zeros((n_tot, 8), dtype=torch.float32, device=cl_box.device)
    soa8[n:, 3:6] = 1.0
    for k, comp in enumerate((o.x, o.y, o.z, d.x, d.y, d.z, tmax)):
        soa8[:n, k] = comp
    operand = None
    if key:
        col = lambda k: soa8[:, k]
        operand = coherence_key(col(0), col(1), col(2), col(3), col(4),
                                col(5), col(6), cl_box, float(tmin))
        if tracing.enabled():
            tracing.count("traverse.live_rays",
                          (operand < _MISS_FLAG).sum(dtype=torch.int32))
        if n_tot <= 1 << LANE_BITS:
            lanes = torch.arange(n_tot, dtype=torch.int32,
                                 device=cl_box.device)
            operand = ((operand >> LANE_BITS) << LANE_BITS) | lanes
    return (soa8, operand) if chain is None else (soa8, operand, local)


def _check_rays(name, comps, n):
    for c in comps:
        _check_dtype(name, c, torch.float32, 1)
        if c.shape[0] != n:
            raise ValueError(f"{name}: o, d and tmax must all be [N]")


def _check_chain(chain: Chain, n: int) -> None:
    times, translate, scale, rotate, nkeys = chain.tables
    x, k = times.shape if times.dim() == 2 else (0, 0)
    shapes = ((times, torch.float32, (x, k)),
              (translate, torch.float32, (x, k, 3)),
              (scale, torch.float32, (x, k, 3)),
              (rotate, torch.float32, (x, k, 4)),
              (nkeys, torch.int32, (x,)), (chain.time, torch.float32, (n,)))
    slots = chain.slots
    if (x == 0 or k == 0 or any(t.dtype != dt or tuple(t.shape) != sh
                                or not t.is_contiguous()
                                for t, dt, sh in shapes)
            or not torch.is_tensor(slots) or slots.dtype != torch.int32
            or slots.dim() != 1 or slots.shape[0] == 0
            or not slots.is_contiguous()):
        raise ValueError("ray_pack: a chain's tables are contiguous f32 "
                         "[X, K], [X, K, 3], [X, K, 3], [X, K, 4] and i32 "
                         "[X], its slots i32 [depth >= 1] and its time f32 "
                         "[N], contiguous too")


@cuda_lib.counted
def ray_pack(o, d, tmax, cl_box, tmin: float, sb: int = 2048,
             key: bool = True, chain: Chain | None = None):
    """Kernel wrapper of :func:`ray_pack_plain` (same contract): one launch
    takes the lanes through the chain, packs the rows and writes the
    operand and the chain's outputs; with tracing on the kernel adds the
    live lanes to ``traverse.live_rays`` itself."""
    comps = (o.x, o.y, o.z, d.x, d.y, d.z, tmax)
    n = o.x.shape[0]
    _check_rays("ray_pack", comps, n)
    _check_dtype("ray_pack", cl_box, torch.float32, 2)
    if cl_box.shape[0] != 8 or cl_box.shape[1] == 0 or sb <= 0:
        raise ValueError("ray_pack: cl_box [8, C_pad > 0] and sb > 0 "
                         "expected")
    inputs = comps + (cl_box,)
    if chain is not None:
        _check_chain(chain, n)
        inputs += tuple(chain.tables) + (chain.slots, chain.time)
    if cuda_lib.on_cpu("ray_pack", *inputs):
        return ray_pack_plain(o, d, tmax, cl_box, tmin, sb, key, chain)
    lib, stream = cuda_lib.launch_args("ray_pack", *inputs)
    n_tot = _n_tot(n, sb)
    if n_tot >= 2**31 or cl_box.numel() >= 2**31:
        raise ValueError("ray_pack: lanes and boxes must fit in int32")
    dev = cl_box.device
    f32 = dict(dtype=torch.float32, device=dev)
    soa8 = torch.empty((n_tot, 8), **f32)
    operand = (torch.empty((n_tot,), dtype=torch.int32, device=dev) if key
               else None)
    live = tracing.counter_ptr("traverse.live_rays", dev) if key else None
    ptrs, depth, k, local = (None,) * 9, 0, 0, None
    if chain is not None:
        local = (torch.empty((6, n), **f32) if chain.want_ray else None,
                 torch.empty((4, n), **f32) if chain.want_rot else None)
        ptrs = (chain.slots.data_ptr(),
                *(t.data_ptr() for t in chain.tables),
                chain.time.data_ptr(), *(_ptr(t) for t in local))
        depth, k = chain.slots.shape[0], chain.tables[0].shape[1]
    cuda_lib.check(lib.rt_ray_pack(
        *(c.data_ptr() for c in comps), cl_box.data_ptr(), soa8.data_ptr(),
        _ptr(operand), live, *ptrs, depth, k, n, n_tot, cl_box.shape[1],
        float(tmin), int(bool(key)), stream,
    ), "ray_pack")
    cuda_lib.count_launch(ray_pack, dev)
    return (soa8, operand) if chain is None else (soa8, operand, local)


def coherence_sort(operand):
    """The coherence sort of :func:`ray_pack`'s operand: (the sorted
    operand [n_tot] i32, the stable sort's lane order [n_tot] i64 or None
    for a packed operand, whose low bits are the lanes). One packed
    keys-only sort up to 2^17 lanes, a stable sort of the keys above."""
    if operand.shape[0] <= 1 << LANE_BITS:
        return torch.sort(operand).values, None
    return tuple(torch.sort(operand, stable=True))


def ray_reorder_plain(soa8, vals, idx=None, sb: int = 2048,
                      live: bool = True):
    """soa8 [n_tot, 8] f32 and the coherence sort's output (``vals``
    [n_tot] i32, ``idx`` [n_tot] i64 or None; :func:`coherence_sort`) ->
    (soat [n_tot, 8] f32, the rows in sorted order; perm [n_tot] i32, the
    lane of each sorted slot; n_live [1] i32, the steps of ``sb`` lanes
    that hold the live lanes (operand below the miss flag, which sort
    first), or None without ``live``)."""
    perm = (vals & _LANE_MASK) if idx is None else idx.to(torch.int32)
    n_live = None
    if live:
        cnt = (vals < _MISS_FLAG).sum(dtype=torch.int32)
        n_live = ((cnt + sb - 1) // sb).reshape(1)
    return soa8[perm], perm, n_live


@cuda_lib.counted
def ray_reorder(soa8, vals, idx=None, sb: int = 2048, live: bool = True):
    """Kernel wrapper of :func:`ray_reorder_plain` (same contract): one
    launch moves the rows and writes perm and n_live."""
    _check_dtype("ray_reorder", soa8, torch.float32, 2)
    _check_dtype("ray_reorder", vals, torch.int32, 1)
    if idx is not None:
        _check_dtype("ray_reorder", idx, torch.int64, 1)
    n_tot = soa8.shape[0]
    if (soa8.shape[1] != 8 or vals.shape[0] != n_tot or sb <= 0
            or (idx is not None and idx.shape[0] != n_tot)
            or (idx is None and n_tot > 1 << LANE_BITS)):
        raise ValueError("ray_reorder: soa8 [n_tot, 8], vals [n_tot], idx "
                         "[n_tot] or None (a packed operand, n_tot <= "
                         "2^17) and sb > 0 expected")
    if cuda_lib.on_cpu("ray_reorder", soa8, vals, idx):
        return ray_reorder_plain(soa8, vals, idx, sb, live)
    args = [t for t in (soa8, vals, idx) if t is not None]
    lib, stream = cuda_lib.launch_args("ray_reorder", *args)
    if soa8.data_ptr() % 16:
        raise ValueError("ray_reorder: soa8 must be 16-byte aligned")
    dev = soa8.device
    soat = torch.empty_like(soa8)
    perm = torch.empty((n_tot,), dtype=torch.int32, device=dev)
    n_live = torch.empty((1,), dtype=torch.int32, device=dev) if live else None
    cuda_lib.check(lib.rt_ray_reorder(
        soa8.data_ptr(), vals.data_ptr(), _ptr(idx), soat.data_ptr(),
        perm.data_ptr(), _ptr(n_live), n_tot, sb, stream,
    ), "ray_reorder")
    cuda_lib.count_launch(ray_reorder, dev)
    return soat, perm, n_live


def prepare_rays(o, d, tmax, cl_box, tmin: float, sort_rays: bool = True,
                 sb: int = 2048, live_prefix: bool = True,
                 chain: Chain | None = None):
    """Pack rays into kernel rows and coherence-sort them. Returns (soat
    [n_steps, sb, 8], perm [n_steps * sb] i32 or None, n_live [1] i32
    device count of live steps or None), and with a ``chain`` the chain's
    outputs of :func:`ray_pack` fourth. Padding lanes have d = 1 and
    tmax = 0, so they produce no candidates. ``ray_pack``, the sort and
    ``ray_reorder``; with tracing on the key is computed for the
    ``traverse.live_rays`` counter even when nothing is sorted."""
    n = o.x.shape[0]
    dev = cl_box.device
    n_steps = max(1, -(-n // sb))
    o, d = (V3(v.x.contiguous(), v.y.contiguous(), v.z.contiguous())
            for v in (o, d))
    if not torch.is_tensor(tmax):
        tmax = torch.full((n,), float(tmax), device=dev)
    tmax = tmax.to(torch.float32).expand(n).contiguous()
    if chain is not None:
        chain = dataclasses.replace(chain, time=chain.time.contiguous())
    soa8, operand, *local = ray_pack(o, d, tmax, cl_box, float(tmin), sb,
                                     key=sort_rays or tracing.enabled(),
                                     chain=chain)
    if not sort_rays:
        return (soa8.view(n_steps, sb, 8), None, None, *local)
    vals, idx = coherence_sort(operand)
    # miss-flagged lanes (dead, root-missing, padding) sort past the live
    # prefix; the kernels skip the steps beyond it
    soat, perm, n_live = ray_reorder(soa8, vals, idx, sb, live_prefix)
    return (soat.view(n_steps, sb, 8), perm, n_live, *local)


def ray_unsort_plain(p_bn, t_bn, perm, n: int, hit_only: bool = False):
    """The traversal's results in sorted order (p_bn [n_tot] i32, t_bn
    [n_tot] f32 or None) back in the caller's lane order: (t [n] f32 or
    None, prim [n] i32) with prim[perm[j]] = p_bn[j] (perm [n_tot] i32 from
    :func:`ray_reorder`; None: the identity). ``hit_only`` maps prim to 0
    on a hit and -1 on a miss first (an any-hit query without t)."""
    if hit_only:
        p_bn = torch.where(p_bn >= 0, 0, -1).to(torch.int32)
    if perm is None:
        prim, t = p_bn, t_bn
    else:
        prim = torch.empty_like(p_bn)
        prim[perm.long()] = p_bn
        t = None
        if t_bn is not None:
            t = torch.empty_like(t_bn)
            t[perm.long()] = t_bn
    return (None if t is None else t[:n]), prim[:n]


@cuda_lib.counted
def ray_unsort(p_bn, t_bn, perm, n: int, hit_only: bool = False):
    """Kernel wrapper of :func:`ray_unsort_plain` (same contract): one
    launch writes the [n] outputs."""
    _check_dtype("ray_unsort", p_bn, torch.int32, 1)
    n_tot = p_bn.shape[0]
    if t_bn is not None:
        _check_dtype("ray_unsort", t_bn, torch.float32, 1)
    if perm is not None:
        _check_dtype("ray_unsort", perm, torch.int32, 1)
    if (not 0 <= n <= n_tot or (t_bn is not None and t_bn.shape[0] != n_tot)
            or (perm is not None and perm.shape[0] != n_tot)):
        raise ValueError("ray_unsort: p_bn, t_bn and perm [n_tot] with "
                         "0 <= n <= n_tot expected")
    if cuda_lib.on_cpu("ray_unsort", p_bn, t_bn, perm):
        return ray_unsort_plain(p_bn, t_bn, perm, n, hit_only)
    args = [x for x in (p_bn, t_bn, perm) if x is not None]
    lib, stream = cuda_lib.launch_args("ray_unsort", *args)
    dev = p_bn.device
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    t = (torch.empty((n,), dtype=torch.float32, device=dev)
         if t_bn is not None else None)
    cuda_lib.check(lib.rt_ray_unsort(
        p_bn.data_ptr(), _ptr(t_bn), _ptr(perm), prim.data_ptr(), _ptr(t),
        n, n_tot, int(bool(hit_only)), stream,
    ), "ray_unsort")
    cuda_lib.count_launch(ray_unsort, dev)
    return t, prim


def _items_route(masks, soat, tri, slices, tmin: float, mt_mode: str,
                 any_hit: bool, n_live, b: int, w: int, maxitems: int,
                 cap: int):
    """The item traversal with the scan as its overflow fallback, both
    launched and gated on the device-side overflow flag (the reference's
    ``lax.cond``); outputs of blocks without items are misses."""
    n_steps, sb, _ = soat.shape
    item_list, n_groups, overflow, block_used = build_items(masks, w,
                                                            maxitems, cap)
    t_i, p_i = traverse_items(item_list, n_groups, soat.view(-1, b, 8), tri,
                              tmin, mt_mode, w, skip=overflow, slices=slices)
    t_s, p_s = traverse_blocks(masks, soat, tri, tmin, mt_mode, any_hit,
                               n_live, b, run_if=overflow, slices=slices)
    used = block_used[:, None].expand(-1, b).reshape(n_steps, sb, 1)
    t_i = torch.where(used, t_i.view(n_steps, sb, 1), _INF)
    p_i = torch.where(used, p_i.view(n_steps, sb, 1), -1)
    return torch.where(overflow, t_s, t_i), torch.where(overflow, p_s, p_i)


def traverse(o, d, tmax, cl_box, tri, tmin: float, sort_rays: bool = True,
             want_t: bool = True, mt_mode: str = "vpu", any_hit: bool = False,
             b: int = 128, sb: int = 2048, live_prefix: bool = True,
             items: bool = False, items_w: int = 4, items_max: int = 24576,
             items_cap: int = 64, *, slices, chain: Chain | None = None):
    """Nearest triangle hit of rays (o, d: V3 of [N]) against one domain's
    tables (cl_box [8, C_pad], tri [C, 16, 128] rows for ``mt_mode``,
    slices [C, 4, 8] its clusters' slice boxes).
    tmax: [N] or scalar. Returns (t [N] f32 or None, prim [N] i32
    table-local triangle id or -1); see the module docstring. With a
    ``chain`` (:class:`Chain`) o and d are world rays, which ``ray_pack``
    takes into the domain's space, and a third element follows: the
    chain's (local ray [6, N], rotation [4, N]) of :func:`ray_pack`, as it
    asks for them. ``items``
    takes the item route for tables of at most 8192 clusters (the packed
    item's cluster field), with the budget ``items_max`` items per launch
    and ``items_cap`` per ray block; the result is the scan's, bit for
    bit (any-hit: prim >= 0). Nothing waits on the device.

    Steps past the live prefix are misses on both routes: the scan kernel
    writes misses there, and their mask rows are zero, so the item list
    holds none of their blocks."""
    validate_blocks(b, sb)
    n = o.x.shape[0]
    tracing.count("traverse.lanes", n, cl_box)
    if chain is not None:
        tracing.count("traverse.chain_lanes", n, cl_box)
    with tracing.device_span("traversal_plumbing", cl_box):
        soat, perm, n_live, *local = prepare_rays(
            o, d, tmax, cl_box, tmin, sort_rays, sb, live_prefix, chain)
    n_tot = soat.shape[0] * sb
    masks = cluster_masks(soat, cl_box, float(tmin), n_live, b)
    if items and tri.shape[0] <= 1 << CID_BITS:
        validate_items(items_w, items_max, items_cap)
        t_bn, p_bn = _items_route(masks, soat, tri, slices, float(tmin),
                                  mt_mode, any_hit, n_live, b, items_w,
                                  items_max, items_cap)
    else:
        t_bn, p_bn = traverse_blocks(masks, soat, tri, float(tmin), mt_mode,
                                     any_hit, n_live, b, slices=slices)
    with tracing.device_span("traversal_plumbing", cl_box):
        t, prim = ray_unsort(p_bn.view(n_tot),
                             t_bn.view(n_tot) if want_t else None, perm, n,
                             hit_only=any_hit and not want_t)
    return (t, prim, *local)
