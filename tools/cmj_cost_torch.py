"""What the sample streams and their cycle walk cost a frame on the card.

A sample count that is not a power of two makes ``ops/rng.cmj_permute``
walk. The plain versions run all ``(w + 1) - num`` masked rounds on a CUDA
tensor (a CUDA graph holds them; w + 1 is the next power of two), where
the port's earliest form stopped once every lane was in range, reading the
card back after each round; since the ``cmj`` kernel (``csrc/cmj.cu``)
each lane walks on its own inside one launch. This tool renders the
stage-6 scene (the n=64 bumpy
stand-in, depth 3, 131,072-lane launches) through
``render_path_with_stats`` at three sample counts:

  * 512x512 at 2x2 pixel samples: powers of two, no round (the control);
  * 512x512 at 3x3: the 2-D pattern's 9 walks 7 rounds, the axes' 3 one;
  * 128x128 at 12x12: the time sample's 144 walks 112 rounds, the lens
    and light patterns 112, their axes' 12 four.

For each it prints one JSON line: the frame's host-clock ms (mean of 2
after a warm-up frame), its queries, and one launch's camera rays
(``_camera_rays``, eager): ``cam_ms`` between CUDA events (median of 5;
the host's enqueue of each small op included) and ``cam_kernel_ms``, the
device time of their kernels under torch.profiler. In a tree whose
``cmj_permute`` takes ``fixed_rounds``, also the same two through the
draw set's plain version (``cmj_draws_plain``) with the walk stopping
early (``cam_early_ms``, ``cam_early_kernel_ms``), the card read back
each round. A replayed graph runs the fixed rounds at about their kernel
time; an eager pass pays their event time.

``--root`` names the tree whose ``rayito_tpu_torch`` is imported (default:
this checkout), so two commits can be compared in one call:

    python3 tools/cmj_cost_torch.py --root build/parent --label parent
    python3 tools/cmj_cost_torch.py --label change

in turns (parent, change, change, parent) on one GPU, from the repo root.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

CASES = ((512, 2), (512, 3), (128, 12))
LAUNCH = 131072


def _event_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _kernel_ms(fn) -> float:
    """Device ms of the kernels of one call of ``fn`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rayito_tpu_torch.utils.profiling import collect_device_ops

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(us for us, _ in collect_device_ops(prof).values()) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.models.demo import (STAGE6_CAMERA, stage6_scene,
                                              write_bumpy_standin)
    from rayito_tpu_torch.ops import rng
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils.config import RenderConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    obj = os.path.join(tempfile.mkdtemp(), "bumpy64.obj")
    write_bumpy_standin(obj, n=64)
    scene = stage6_scene(obj).compile(dev)
    cam = PerspectiveCamera.make(30.0, *STAGE6_CAMERA, focal_distance=16.0,
                                 lens_radius=0.0)
    early = "fixed_rounds" in inspect.signature(rng.cmj_permute).parameters
    for width, ps in CASES:
        cfg = RenderConfig(width=width, height=width, pixel_samples=ps,
                           light_samples=1, max_depth=3,
                           aspect_correction=True, max_rays_per_pass=LAUNCH)
        pt.render_path_with_stats(scene, cfg, cam)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            _, _, queries = pt.render_path_with_stats(scene, cfg, cam)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) / 2 * 1e3
        lanes = torch.arange(LAUNCH, dtype=torch.int64, device=dev) % (
            width * width * ps * ps)
        px = (lanes % width).to(torch.int32)
        py = (lanes // width % width).to(torch.int32)
        si = (lanes // (width * width)).to(torch.int32)
        cam_d = cam.to(dev) if hasattr(cam, "to") else cam
        rays = lambda: pt._camera_rays(cfg, cam_d, px, py, si)  # noqa: E731
        r = {"label": args.label, "width": width, "pixel_samples": ps,
             "frame_ms": frame_ms, "queries": int(queries),
             "cam_ms": _event_ms(rays), "cam_kernel_ms": _kernel_ms(rays),
             "card": card}
        if early:
            # the draw set's plain version, its walk stopping early
            walk, draws = rng.cmj_permute, rng.cmj_draws
            rng.cmj_permute = (lambda i, num, p:  # noqa: E731
                               walk(i, num, p, fixed_rounds=False))
            rng.cmj_draws = rng.cmj_draws_plain
            try:
                r["cam_early_ms"] = _event_ms(rays)
                r["cam_early_kernel_ms"] = _kernel_ms(rays)
            finally:
                rng.cmj_permute, rng.cmj_draws = walk, draws
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
