"""Progressive rendering with checkpoint/resume (counterpart of
``rayito_tpu/render/progressive.py``).

Monte-Carlo accumulation is resumable: samples are additive and keyed by
their index, so this module renders in sample chunks, saves the running
radiance SUM and the sample count after each chunk, and resumes from the
newest checkpoint bit for bit.

A checkpoint carries a digest of every render input (the config, the
camera's fields, every SceneData tensor); resume refuses one whose digest
differs and starts fresh instead of blending incompatible sums. A
checkpoint written by the JAX package has another digest, so it is refused
the same way.

With tracing on (``utils/tracing.py``) a render is the host span
``render``; each pass is ``pass``, each band's launch ``band.replay``
(``utils/graphs.run``) serving the request (render, first sample of the
pass, band), its read-back ``band.readback`` and its add into the image
``band.host_add``; then ``checkpoint`` and ``progress`` (the callbacks).
The read-back's copy on the device is the device span ``readback``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.camera import PerspectiveCamera
from ..models.scene import SceneData
from ..parallel.sharding import sharded_lane_range
from ..utils import tracing
from ..utils.config import RenderConfig
from .pathtracer import _render_path_pass, warn_overflow


@dataclasses.dataclass
class RenderStats:
    samples_done: int
    samples_total: int
    seconds: float
    rays_traced: int  # issued scene queries (see pathtrace_wave)
    # candidates the 'xla' route's K1/K2 truncation dropped (see
    # render/mesh_intersect.py); 0 on the kernel route
    overflow: int = 0

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_traced / max(self.seconds, 1e-9) / 1e6


def _leaves(obj):
    """numpy arrays of the tensors and numbers in ``obj``, depth first in
    field order; tensors are moved to the CPU, strings and devices are
    left out."""
    if isinstance(obj, torch.Tensor):
        yield obj.detach().cpu().numpy()
    elif isinstance(obj, (bool, int, float)):
        yield np.asarray(obj)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(obj):  # the camera, its V3s, SceneData
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name))


def render_inputs_digest(scene: SceneData, config: RenderConfig,
                         camera: PerspectiveCamera) -> str:
    """Stable digest of everything that determines the accumulated image
    (not of the device it is rendered on)."""
    h = hashlib.sha256()
    h.update(repr(config).encode())
    for arr in _leaves((camera, scene)):
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _one_pass(scene, config, camera, mesh, banded: bool, s_done: int,
              hi: int, acc, rid, overflow: int, rays: int):
    """Samples [s_done, hi) of every pixel added into ``acc`` (the host
    image, in place). Returns (overflow, rays) with this pass's added."""
    w, h = config.width, config.height
    n_pix = w * h
    si = torch.arange(s_done, hi, dtype=torch.int32, device=scene.device)
    if mesh is not None:
        ovf, q = sharded_lane_range(scene, config, camera, mesh,
                                    s_done * n_pix, hi * n_pix,
                                    acc.reshape(-1, 3))
        return overflow + ovf, rays + q
    if banded:
        # render_path_with_stats's bands: a uniform height, the last band
        # shifted up and cropped; every band is dispatched (one replay each
        # on the card) before the host adds them in order
        band = max(1, config.max_rays_per_pass // w)
        r0s = [min(b * band, h - band) for b in range(-(-h // band))]
    else:
        band, r0s = h, [0]
    outs = []
    for b, r0 in enumerate(r0s):
        with tracing.requesting((rid, s_done, b)):
            outs.append(_render_path_pass(scene, config, camera, si, r0,
                                          band))
    for b, (img, ovf, q) in enumerate(outs):
        skip = max(0, b * band - r0s[b])
        with tracing.span("band.readback", request=(rid, s_done, b)):
            with tracing.device_span("readback", img):
                part = img.cpu().numpy()
        with tracing.span("band.host_add", request=(rid, s_done, b)):
            acc[r0s[b] + skip:r0s[b] + band] += part[skip:]
        overflow += int(ovf)
        rays += int(q)
    return overflow, rays


def render_progressive(
    scene: SceneData,
    config: RenderConfig,
    camera: PerspectiveCamera,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    on_progress: Optional[Callable[[RenderStats], None]] = None,
    on_preview: Optional[Callable[[np.ndarray, RenderStats], None]] = None,
    mesh=None,
):
    """Render config.pixel_samples^2 samples per pixel in resumable chunks.

    ``on_preview`` (if given) receives the current mean-radiance image
    [H, W, 3] and the stats after every chunk: the live viewer's feed.

    Returns (image [H, W, 3] mean radiance, RenderStats). A frame above
    config.max_rays_per_pass pixels renders in pixel-row bands per sample,
    as render_path_with_stats does, and checkpoints per whole sample; the
    image equals render_path_with_stats's bit for bit.

    Each launch is one ``_render_path_pass``: one replay of the pass graph
    on the card, as the reference dispatches one jitted pass per launch.

    ``mesh`` (devices from parallel/sharding.make_mesh) shards every
    chunk's lanes over those devices. Per-lane seeding keeps the image
    bit-identical to the unsharded render whatever the device count, so a
    checkpoint written sharded resumes unsharded and the other way round.
    A positive ``overflow`` (samples rendered in this call) prints the
    reference's warning.
    """
    with tracing.span("render") as rid:
        return _render_progressive(scene, config, camera, checkpoint_path,
                                   checkpoint_every, on_progress, on_preview,
                                   mesh, rid)


def _render_progressive(scene, config, camera, checkpoint_path,
                        checkpoint_every, on_progress, on_preview, mesh,
                        rid):
    spp_total = config.pixel_samples ** 2
    w, h = config.width, config.height
    n_pix = w * h
    banded = mesh is None and n_pix > config.max_rays_per_pass

    digest = None
    acc = np.zeros((h, w, 3), np.float32)
    s_done = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        digest = render_inputs_digest(scene, config, camera)
        with np.load(checkpoint_path, allow_pickle=False) as ck:
            ck_digest = str(ck["digest"]) if "digest" in ck else None
            if ck["acc"].shape == acc.shape and ck_digest == digest:
                acc = ck["acc"].astype(np.float32)
                s_done = int(ck["samples_done"])
            else:
                print(f"[rayito_tpu_torch] checkpoint {checkpoint_path} does "
                      "not match the render inputs (digest/shape mismatch) — "
                      "starting fresh", file=sys.stderr)

    def save_checkpoint():
        nonlocal digest
        if digest is None:
            digest = render_inputs_digest(scene, config, camera)
        tmp = checkpoint_path + ".tmp"
        np.savez(tmp if not tmp.endswith(".npz") else tmp[:-4], acc=acc,
                 samples_done=s_done, spp_total=spp_total, seed=config.seed,
                 digest=digest)
        # numpy appends .npz; normalise and replace atomically
        produced = tmp if os.path.exists(tmp) else tmp + ".npz"
        os.replace(produced, checkpoint_path)

    t0 = time.perf_counter()
    rays = overflow = 0
    chunks_since_save = 0
    if mesh is not None:
        # the per-device wave budget scales the chunk; a chunk below one
        # sample is split by sharding's own lane chunking
        lane_budget = config.max_rays_per_pass * len(mesh)
        chunk = max(1, min(spp_total, lane_budget // n_pix))
    else:
        chunk = 1 if banded else max(
            1, min(spp_total, config.max_rays_per_pass // n_pix))
    camera = camera.to(scene.device)
    while s_done < spp_total:
        with tracing.span("pass"):
            hi = min(s_done + chunk, spp_total)
            overflow, rays = _one_pass(scene, config, camera, mesh, banded,
                                       s_done, hi, acc, rid, overflow, rays)
            s_done = hi
            chunks_since_save += 1
            if checkpoint_path and (chunks_since_save >= checkpoint_every
                                    or s_done >= spp_total):
                with tracing.span("checkpoint"):
                    save_checkpoint()
                chunks_since_save = 0
            if on_progress or on_preview:
                with tracing.span("progress"):
                    st = RenderStats(s_done, spp_total,
                                     time.perf_counter() - t0, rays,
                                     overflow)
                    if on_progress:
                        on_progress(st)
                    if on_preview:
                        on_preview(acc / np.float32(max(s_done, 1)), st)

    warn_overflow(overflow)
    stats = RenderStats(s_done, spp_total, time.perf_counter() - t0, rays,
                        overflow)
    return acc / np.float32(spp_total), stats
