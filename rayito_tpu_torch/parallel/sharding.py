"""Multi-device rendering: the frame's lanes split over an ordered list of
devices (counterpart of ``rayito_tpu/parallel/sharding.py``).

The scene is copied once to each distinct device (on the card, once per
device graph: each device's share of a launch replays that device's CUDA
graph, captured on first use, and the CPU runs it eagerly, as
``render/pathtracer.py`` does); paths are independent, so nothing is
exchanged while they bounce. Each launch takes at most
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
from ..utils import graphs
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


def _lane_pixel_arrays(lane0, lane_hi, width: int, n_pix: int,
                       share: int, device=None):
    """(px, py, si) int32 and the active mask of the ``share`` flat lanes
    from ``lane0`` (an int or an int64 device scalar) of the spp-major
    frame grid, computed on ``device``; lanes at or past ``lane_hi`` are
    inactive padding with pixel and sample 0."""
    lanes = lane0 + torch.arange(share, dtype=torch.int64, device=device)
    active = lanes < lane_hi
    p = lanes % n_pix
    px, py, si = (torch.where(active, v, 0).to(torch.int32)
                  for v in (p % width, p // width, lanes // n_pix))
    return px, py, si, active


def _shard_body(scene: SceneData, config: RenderConfig,
                camera: PerspectiveCamera, lane0, lane_hi, share: int):
    """One device's share of a launch, eagerly, on the scene's device
    (lanes as ``_lane_pixel_arrays``). Returns (radiance [share, 3],
    overflow, issued queries) on that device."""
    dev = scene.device
    px, py, si, active = _lane_pixel_arrays(
        lane0, lane_hi, config.width, config.width * config.height, share,
        dev)
    o, d, t = _camera_rays(config, camera.to(dev), px, py, si)
    rad, overflow, queries = pathtrace_wave(scene, config, o, d, t, px, py,
                                            si, active=active)
    return to_aos(rad), overflow, queries


def _shard_pass(scene: SceneData, scene_on, config: RenderConfig,
                camera: PerspectiveCamera, dev, lane0: int, lane_hi: int,
                share: int):
    """Enqueue one device's share of a launch on ``dev`` through
    ``utils/graphs.run``: a replay of that device's graph of (scene, config,
    share) on the card, the eager body on the CPU.
    ``scene_on(dev)`` is the scene on ``dev``. (radiance [share, 3],
    overflow, issued queries), on ``dev``."""
    i64 = dict(dtype=torch.int64, device=dev)
    sd = scene_on(dev)

    def body(lane0, lane_hi, camera):
        return _shard_body(sd, config, PerspectiveCamera.from_flat(camera),
                           lane0, lane_hi, share)

    return graphs.run(
        ("shard", config, share), scene, dev, body,
        {"lane0": torch.full((), lane0, **i64),
         "lane_hi": torch.full((), lane_hi, **i64),
         "camera": camera.to(dev).flat()},
        label=f"sharded pass on {dev}, {share} lanes", keep=(sd,))


def sharded_lane_range(scene: SceneData, config: RenderConfig,
                       camera: PerspectiveCamera, mesh, lane_lo: int,
                       lane_hi: int, out: np.ndarray):
    """Render flat lanes [lane_lo, lane_hi) of the spp-major frame grid
    over the devices ``mesh``, adding radiance SUMS into ``out`` (the
    float32 [H * W, 3] view of the frame accumulator) in ascending sample
    order, so any split of the range gives the same bits. Returns
    (overflow int, issued queries int)."""
    n_dev = len(mesh)
    cams = {dev: camera.to(dev) for dev in mesh}
    scenes = {}

    def scene_on(dev):
        if dev not in scenes:
            scenes[dev] = scene.to(dev)
        return scenes[dev]

    w = config.width
    n_pix = w * config.height
    budget = config.max_rays_per_pass * n_dev
    overflow = queries = 0
    lo = lane_lo
    while lo < lane_hi:
        hi = min(lo + budget, lane_hi)
        n = hi - lo
        share = (n + (-n) % n_dev) // n_dev
        # enqueue every device's share, then read the results back
        outs = [_shard_pass(scene, scene_on, config, cams[dev], dev,
                            lo + k * share, hi, share)
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
