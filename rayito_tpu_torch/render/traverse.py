"""Mesh traversal through the three hand-written CUDA kernels.

Counterpart of ``rayito_tpu/render/pallas_traverse.py``'s ``traverse()``.
One launch domain's nearest (or any) triangle hit for a wavefront:

  1. the rays are packed into ``soa8`` rows [n_pad, 8] (o, d, tmax, pad);
  2. a coherence key (octant, root-box entry cell) orders the wavefront
     with one packed sort; lanes with the key's miss flag sort to the end,
     and the number of live steps stays on the device;
  3. ``cluster_masks`` (kernel) marks, per ray block, the clusters any of
     its rays slab-hits;
  4. ``traverse_blocks`` (kernel) tests each ray against the listed
     clusters' 128 triangles and keeps the nearest packed (t, lane) key;
  5. the results are scattered back to the caller's lane order.

``gather_rows_t`` (kernel) serves the exact winner re-test in
``render/trace.py``. Steps 1, 2 and 5 were XLA in the reference and are
plain torch here.

Every kernel has its plain PyTorch version beside it (``*_plain``), with
the same contract. A wrapper runs the plain version only for CPU tensors;
for CUDA tensors it launches the kernel or raises. Each wrapper counts its
kernel launches in its ``launches`` attribute.

t carries the key's ~2^-17 relative slack; exact t comes from the winner
re-test. With ``any_hit`` only ``prim >= 0`` is defined (prim is 0/-1).
"""

from __future__ import annotations

import torch

from ..accel.kernel_tables import KTRI
from ..models.scene import validate_blocks
from ..utils import cuda_lib

_INF = float("inf")
_IMAX = 2**31 - 1
_MISS_FLAG = 1 << 30


def _on_cpu(name, *tensors) -> bool:
    """True: run the plain version (CPU tensors). False: launch the CUDA
    kernel (CUDA tensors). Anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors
                                  if t is not None}) == 1:
        return False
    raise ValueError(f"{name}: tensors must all be on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")


def _cuda_args(name, *tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return (cuda_lib.library(),
            torch.cuda.current_stream(tensors[0].device).cuda_stream)


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
    if _on_cpu("cluster_masks", soat, cl_box, n_live):
        return cluster_masks_plain(soat, cl_box, tmin, n_live, b)
    _check_live(n_live, soat.device)
    alive = _step_alive(soat).to(torch.uint8)
    args = [soat, cl_box, alive] + ([n_live] if n_live is not None else [])
    lib, stream = _cuda_args("cluster_masks", *args)
    n_blocks = n_steps * sb // b
    out = torch.empty((n_blocks, c_pad // 32), dtype=torch.int32,
                      device=soat.device)
    cuda_lib.check(lib.rt_cluster_masks(
        soat.data_ptr(), cl_box.data_ptr(), alive.data_ptr(), _ptr(n_live),
        out.data_ptr(), n_blocks, c_pad, b, sb, n_steps, float(tmin), stream,
    ), "cluster_masks")
    cluster_masks.launches += 1
    return out


cluster_masks.launches = 0


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


def _keys(mt_mode, rows, o, d, tmin, lane):
    """[n, 128] packed keys of rays (o, d: [n, 1] columns) against one
    cluster's rows [16, 128]; same operation order as the reference."""
    ox, oy, oz = o
    dx, dy, dz = d
    row = lambda k: rows[k][None, :]
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


def traverse_blocks_plain(masks, soat, tri, tmin: float, mt_mode: str = "vpu",
                          any_hit: bool = False, n_live=None, b: int = 128):
    """masks [n_blocks, n_words] i32, soat [n_steps, sb, 8] f32, tri
    [C, 16, 128] f32 (MT rows for 'vpu', BW rows for 'bw') -> (t, prim)
    each [n_steps, sb, 1]: per ray the minimum packed key over the
    triangles of its block's listed clusters (strict <, so ties go to the
    lowest cluster), t = key bits with the lane cleared (inf on a miss),
    prim = cluster * 128 + lane (-1). Steps past the live prefix are
    misses. ``any_hit`` only loosens the contract to prim >= 0; the plain
    version always finds the nearest hit."""
    del any_hit
    n_steps, sb, _ = soat.shape
    dev = soat.device
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
        kmin = _keys(mt_mode, tri[c], o, d, tmin, lane).amin(dim=1)
        better = kmin < kb[sel]
        kb[sel] = torch.where(better, kmin, kb[sel])
        cb[sel] = torch.where(better, c, cb[sel])
    found = cb >= 0
    t = torch.where(found, (kb & ~(KTRI - 1)).view(torch.float32), _INF)
    prim = torch.where(found, cb * KTRI + (kb & (KTRI - 1)), -1)
    return t.view(n_steps, sb, 1), prim.view(n_steps, sb, 1)


def traverse_blocks(masks, soat, tri, tmin: float, mt_mode: str = "vpu",
                    any_hit: bool = False, n_live=None, b: int = 128):
    """Kernel wrapper of :func:`traverse_blocks_plain` (same contract)."""
    _check_dtype("traverse_blocks", masks, torch.int32, 2)
    _check_dtype("traverse_blocks", soat, torch.float32, 3)
    _check_dtype("traverse_blocks", tri, torch.float32, 3)
    n_steps, sb, width = soat.shape
    validate_blocks(b, sb)
    if (width != 8 or tuple(tri.shape[1:]) != (16, KTRI)
            or masks.shape[0] != n_steps * sb // b):
        raise ValueError("traverse_blocks: shapes do not match "
                         "(masks [n_blocks, n_words], soat [n_steps, sb, 8],"
                         " tri [C, 16, 128])")
    if mt_mode not in ("vpu", "bw"):
        raise ValueError(f"traverse_blocks: mt_mode {mt_mode!r}")
    if _on_cpu("traverse_blocks", masks, soat, tri, n_live):
        return traverse_blocks_plain(masks, soat, tri, tmin, mt_mode,
                                     any_hit, n_live, b)
    _check_live(n_live, soat.device)
    args = [masks, soat, tri] + ([n_live] if n_live is not None else [])
    lib, stream = _cuda_args("traverse_blocks", *args)
    t = torch.empty((n_steps, sb, 1), dtype=torch.float32, device=soat.device)
    p = torch.empty((n_steps, sb, 1), dtype=torch.int32, device=soat.device)
    cuda_lib.check(lib.rt_traverse_blocks(
        masks.data_ptr(), soat.data_ptr(), tri.data_ptr(), _ptr(n_live),
        t.data_ptr(), p.data_ptr(), masks.shape[0], b, masks.shape[1],
        tri.shape[0], sb, n_steps, float(tmin), int(mt_mode == "bw"),
        int(bool(any_hit)), stream,
    ), "traverse_blocks")
    traverse_blocks.launches += 1
    return t, p


traverse_blocks.launches = 0


# ---------------------------------------------------------------------------
# Kernel 3: gathered, transposed rows (replaces _transpose_rows_kernel)
# ---------------------------------------------------------------------------


def gather_rows_t_plain(table, idx):
    """table [T, K] f32, idx [N] i32 -> [K, N]: out[k, i] =
    table[clamp(idx[i], 0, T-1), k] (transpose_rows(table[idx]))."""
    safe = idx.clamp(0, table.shape[0] - 1).to(torch.int64)
    return table[safe].t().contiguous()


def gather_rows_t(table, idx):
    """Kernel wrapper of :func:`gather_rows_t_plain` (K in {16, 32})."""
    _check_dtype("gather_rows_t", table, torch.float32, 2)
    _check_dtype("gather_rows_t", idx, torch.int32, 1)
    k = table.shape[1]
    if k not in (16, 32) or table.shape[0] == 0:
        raise ValueError(f"gather_rows_t: table [T>0, 16|32], got "
                         f"{tuple(table.shape)}")
    if _on_cpu("gather_rows_t", table, idx):
        return gather_rows_t_plain(table, idx)
    lib, stream = _cuda_args("gather_rows_t", table, idx)
    if table.data_ptr() % 16:
        raise ValueError("gather_rows_t: table must be 16-byte aligned")
    n = idx.shape[0]
    out = torch.empty((k, n), dtype=torch.float32, device=table.device)
    cuda_lib.check(lib.rt_gather_rows_t(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, table.shape[0],
        k, stream,
    ), "gather_rows_t")
    gather_rows_t.launches += 1
    return out


gather_rows_t.launches = 0

KERNELS = (cluster_masks, traverse_blocks, gather_rows_t)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# traverse(): the XLA-side plumbing of the reference, in plain torch
# ---------------------------------------------------------------------------


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
    f32 = torch.float32
    dev = ox.device
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    rmin = cl_box[0:3].amin(dim=1)
    rmax = torch.where(cl_box[3:6] >= 1e29, -inf, cl_box[3:6]).amax(dim=1)
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    tx0, ty0, tz0 = (rmin[0] - ox) * ix, (rmin[1] - oy) * iy, (rmin[2] - oz) * iz
    tx1, ty1, tz1 = (rmax[0] - ox) * ix, (rmax[1] - oy) * iy, (rmax[2] - oz) * iz
    mn, mx = torch.minimum, torch.maximum
    near = mx(mx(mn(tx0, tx1), mn(ty0, ty1)), mn(tz0, tz1))
    far = mn(mn(mx(tx0, tx1), mx(ty0, ty1)), mx(tz0, tz1))
    tmin_t = torch.tensor(tmin, dtype=f32, device=dev)
    live = (mx(near, tmin_t) <= mn(far, tmax)) & (tmax > tmin_t)
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


def prepare_rays(o, d, tmax, cl_box, tmin: float, sort_rays: bool = True,
                 sb: int = 2048, live_prefix: bool = True):
    """Pack rays into kernel rows and coherence-sort them. Returns (soat
    [n_steps, sb, 8], perm [n_steps * sb] i32 or None, n_live [1] i32
    device count of live steps or None). Padding lanes have d = 1 and
    tmax = 0, so they produce no candidates."""
    n = o.x.shape[0]
    dev = cl_box.device
    n_steps = max(1, -(-n // sb))
    n_tot = n_steps * sb
    soa8 = torch.zeros((n_tot, 8), dtype=torch.float32, device=dev)
    soa8[n:, 3:6] = 1.0
    for k, comp in enumerate((o.x, o.y, o.z, d.x, d.y, d.z)):
        soa8[:n, k] = comp
    soa8[:n, 6] = tmax
    if not sort_rays:
        return soa8.view(n_steps, sb, 8), None, None

    col = lambda k: soa8[:, k]
    key = coherence_key(col(0), col(1), col(2), col(3), col(4), col(5),
                        col(6), cl_box, float(tmin))
    n_live = None
    if live_prefix:
        # miss-flagged lanes (dead, root-missing, padding) sort past the
        # live prefix; the kernels skip the steps beyond it
        live_cnt = (key < _MISS_FLAG).sum(dtype=torch.int32)
        n_live = ((live_cnt + sb - 1) // sb).to(torch.int32).reshape(1)
    lane_ids = torch.arange(n_tot, dtype=torch.int32, device=dev)
    if n_tot <= (1 << 17):
        # one packed operand: 13 coarse key bits above the lane id
        packed = ((key >> 17) << 17) | lane_ids
        perm = torch.sort(packed).values & ((1 << 17) - 1)
    else:
        perm = torch.sort(key, stable=True).indices.to(torch.int32)
    return soa8[perm].view(n_steps, sb, 8), perm, n_live


def traverse(o, d, tmax, cl_box, tri, tmin: float, sort_rays: bool = True,
             want_t: bool = True, mt_mode: str = "vpu", any_hit: bool = False,
             b: int = 128, sb: int = 2048, live_prefix: bool = True):
    """Nearest triangle hit of rays (o, d: V3 of [N]) against one domain's
    tables (cl_box [8, C_pad], tri [C, 16, 128] rows for ``mt_mode``).
    tmax: [N] or scalar. Returns (t [N] f32 or None, prim [N] i32
    table-local triangle id or -1); see the module docstring."""
    validate_blocks(b, sb)
    n = o.x.shape[0]
    soat, perm, n_live = prepare_rays(o, d, tmax, cl_box, tmin, sort_rays,
                                      sb, live_prefix)
    n_tot = soat.shape[0] * sb
    masks = cluster_masks(soat, cl_box, float(tmin), n_live, b)
    t_bn, p_bn = traverse_blocks(masks, soat, tri, float(tmin), mt_mode,
                                 any_hit, n_live, b)
    t_bn, p_bn = t_bn.view(n_tot), p_bn.view(n_tot)
    if any_hit and not want_t:
        p_bn = torch.where(p_bn >= 0, 0, -1).to(torch.int32)
    if perm is not None:
        prim = torch.empty_like(p_bn)
        prim[perm.long()] = p_bn
        if want_t:
            t = torch.empty_like(t_bn)
            t[perm.long()] = t_bn
    else:
        prim, t = p_bn, t_bn
    return (t[:n] if want_t else None), prim[:n]
