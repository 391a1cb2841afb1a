"""Multi-device rendering: the frame's lanes split over an ordered list of
devices (counterpart of ``rayito_tpu/parallel/sharding.py``).

The scene is copied once to each distinct device; paths are independent,
so nothing is exchanged while they bounce. Each launch takes at most
``len(mesh) * config.max_rays_per_pass`` lanes of the spp-major frame grid
(lane = si * W * H + py * W + px); each device takes its contiguous share
of the launch; a ragged tail pads to a multiple of the device count with
inactive lanes, which trace nothing and count no query. The radiance comes
back to the host and is added in ascending lane order. Per-lane
counter-based seeding makes the image bit-identical for any device count,
and to the unsharded render. The 'xla' route's ``overflow`` is summed over
devices; it is the unsharded render's wherever each device's share sees
the same wave size (the count's pad-slot term depends on it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.camera import PerspectiveCamera
from ..models.scene import SceneData
from ..ops.vec3 import to_aos
from ..render.pathtracer import _camera_rays, pathtrace_wave, warn_overflow
from ..utils.config import RenderConfig


def make_mesh(devices=None) -> list:
    """The ordered devices to shard over: by default every CUDA card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise RuntimeError("no CUDA card to shard over; pass the devices "
                           "explicitly")
    return devices


def _shard_pass(scene: SceneData, config: RenderConfig,
                camera: PerspectiveCamera, px, py, si, active):
    """One device's share of a launch, enqueued on the scene's device:
    (radiance [n, 3], overflow, issued queries), on that device."""
    dev = scene.device
    px, py, si, active = (torch.from_numpy(a).to(dev)
                          for a in (px, py, si, active))
    o, d, t = _camera_rays(config, camera, px, py, si)
    rad, overflow, queries = pathtrace_wave(scene, config, o, d, t, px, py,
                                            si, active=active)
    return to_aos(rad), overflow, queries


def _lane_pixel_arrays(lo: int, hi: int, width: int, n_pix: int):
    """(px, py, si) int32 for flat lane indices [lo, hi) of the spp-major
    frame grid, made per launch so a large frame never holds its whole
    grid on the host."""
    lanes = np.arange(lo, hi, dtype=np.int64)
    si = (lanes // n_pix).astype(np.int32)
    p = (lanes % n_pix).astype(np.int32)
    return (p % width).astype(np.int32), (p // width).astype(np.int32), si


def sharded_lane_range(scene: SceneData, config: RenderConfig,
                       camera: PerspectiveCamera, mesh, lane_lo: int,
                       lane_hi: int, out: np.ndarray):
    """Render flat lanes [lane_lo, lane_hi) of the spp-major frame grid
    over the devices ``mesh``, adding radiance SUMS into ``out`` (the
    float32 [H * W, 3] view of the frame accumulator) in ascending sample
    order, so any split of the range gives the same bits. Returns
    (overflow int, issued queries int)."""
    n_dev = len(mesh)
    scenes = {}
    for dev in mesh:
        if dev not in scenes:
            scenes[dev] = scene.to(dev)
    w = config.width
    n_pix = w * config.height
    budget = config.max_rays_per_pass * n_dev
    overflow = queries = 0
    lo = lane_lo
    while lo < lane_hi:
        hi = min(lo + budget, lane_hi)
        n = hi - lo
        n_pad = (-n) % n_dev
        px, py, si = _lane_pixel_arrays(lo, hi, w, n_pix)
        active = np.ones(n + n_pad, bool)
        if n_pad:
            pad = np.zeros(n_pad, np.int32)
            px, py, si = (np.concatenate([a, pad]) for a in (px, py, si))
            active[n:] = False
        share = (n + n_pad) // n_dev
        # enqueue every device's share, then read the results back
        outs = [_shard_pass(scenes[dev], config, camera,
                            *(a[k * share:(k + 1) * share]
                              for a in (px, py, si, active)))
                for k, dev in enumerate(mesh)]
        rad = np.concatenate([r.cpu().numpy() for r, _, _ in outs])[:n]
        overflow += sum(int(ovf) for _, ovf, _ in outs)
        queries += sum(int(q) for _, _, q in outs)
        # the launch's lanes are per-sample runs of contiguous pixels
        pos, off = lo, 0
        while pos < hi:
            run = min(hi, (pos // n_pix + 1) * n_pix) - pos
            p0 = pos % n_pix
            out[p0:p0 + run] += rad[off:off + run]
            pos += run
            off += run
        lo = hi
    return overflow, queries


def render_path_sharded_with_stats(scene: SceneData, config: RenderConfig,
                                   camera: PerspectiveCamera, mesh=None):
    """Path-trace a frame sharded over ``mesh`` (default: every CUDA
    card), launch-chunked to the wave budget. Returns (image [H, W, 3]
    float32, overflow int, queries int); warns on a positive overflow."""
    mesh = mesh or make_mesh()
    w, h = config.width, config.height
    spp = config.pixel_samples ** 2
    acc = np.zeros((h * w, 3), np.float32)
    overflow, queries = sharded_lane_range(scene, config, camera, mesh, 0,
                                           w * h * spp, acc)
    warn_overflow(overflow)
    return acc.reshape(h, w, 3) / np.float32(spp), overflow, queries


def render_path_sharded(scene: SceneData, config: RenderConfig,
                        camera: PerspectiveCamera, mesh=None):
    """render_path_sharded_with_stats, image only."""
    return render_path_sharded_with_stats(scene, config, camera, mesh)[0]
