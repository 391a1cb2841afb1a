"""Where a frame's time goes on a CUDA GPU (rayito_tpu_torch).

Renders chip_smoke.py's stage-6 frame (n=64 bumpy stand-in, 512x512,
sample 0 over both 256-row bands), or with ``--scene big`` its big-scene
frame (five stand-ins, 1 spp, depth 3; ``--route items`` at the list
budget that never overflows, or ``--route scan``), or with ``--scene
stage7`` / ``stage7b`` its stage-7 frames (the moving n=64 stand-in at
512x512; bench.py's stage-7b config at 512x256), or with ``--scene stage5``
/ ``mesh_light`` / ``spheres40`` / ``lights16`` its stage-5, mesh-light and
many-shape frames, with ``--scene stage1`` / ``stage2`` / ``stage3`` its
512x512 direct-lighting frames, or with ``--scene cli_stage6`` the CLI's
640x480 stage-6 render (2x2 samples, depth 3), once to warm up, times
three frames on the host clock, then profiles one frame with
torch.profiler and prints what follows. The path frames run each launch
as one replay of its pass graph, as the entry points do on the card, or
with ``--eager`` through the eager pass body (the stage 1-3 and CLI
frames call the entry points themselves):

  * the card (nvidia-smi name and power limit) and the frame time;
  * device time summed over kernels, and the busy share of the frame;
  * the device ops (kernels run on the card) of the profiled frame;
  * the number of kernel and CUDA-graph launches per frame;
  * the twelve kernels that take the most device time;
  * utils/profiling.span_table of one more frame run with tracing on
    (utils/tracing.py; its traced graphs captured by a frame before it):
    each device span's ms per frame, its self ms (less its child spans)
    and its instances, read from the markers' log with
    ``tracing.snapshot()`` (camera_rays, bounce[i], query.closest,
    query.shadow[i], analytic_folds, transforms, mesh,
    traversal_plumbing, tiny_mesh_fold, draws, shading.prepare,
    shading.resolve, image), and the counters (launches per kernel,
    query.rays.*, traverse.pairs, traverse.live_rays).

Run from the repo root on a machine with a GPU:
``python3 tools/frame_profile_torch.py [--scene big --route scan] [--eager]``
(``--scene stage7``, ``--scene stage7b``, ``--scene mesh_light``, ...).
``--scene`` takes a comma-separated list, profiled one after another in
one process, and ``stage6_xla``, ``big_xla``, ``stage7_xla`` and
``cli_stage6_xla``, the same frames under traversal='xla'; each frame also
prints one JSON line (``--label`` names the tree in it) with its issued
queries, its overflow where the frame reports one, and the first 16 hex
digits of the SHA-256 of its image's bytes.
``--root`` names the tree whose ``chip_smoke.py`` and ``rayito_tpu_torch``
are imported (default: this checkout), so that two commits can be
profiled in turns on one card:
``python3 tools/frame_profile_torch.py --root build/parent --label parent
--scene stage6,stage7b``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _xla_frame(cs, setup):
    """The frame of ``setup`` under traversal='xla' (the path frames)."""
    def make(dev):
        import dataclasses

        scene, cfg, cam, _ = setup(dev)[:4]
        return cs._frame_fn(dataclasses.replace(scene, traversal="xla"), cfg,
                            cam)
    return make


def _cli_xla(cs):
    """The CLI's 640x480 stage-6 render under traversal='xla'."""
    def make(dev):
        import dataclasses

        from rayito_tpu_torch.render import pathtracer as pt

        scene, cfg, cam = cs._cli_inputs(dev, cs._standin_obj())
        scene = dataclasses.replace(scene, traversal="xla")

        def frame():
            img, frame.overflow, q = pt.render_path_with_stats(scene, cfg,
                                                               cam)
            return img, q
        return frame
    return make


def profile_frame(frame, card: str, label: str, tree: str) -> dict:
    """Warm-up, three timed frames, one profiled frame; prints the report
    and returns its numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rayito_tpu_torch.utils import profiling
    from rayito_tpu_torch.utils.profiling import collect_device_ops

    try:  # a tree before tracing has no span table
        from rayito_tpu_torch.utils import tracing
    except ImportError:
        tracing = None

    imgs, queries = frame()
    torch.cuda.synchronize()
    overflow = getattr(frame, "overflow", None)
    bits = hashlib.sha256(
        (imgs.cpu().numpy() if torch.is_tensor(imgs) else imgs).tobytes()
    ).hexdigest()[:16]
    t0 = time.perf_counter()
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / 3 * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator row repeats its kernels' device time
    kernels = collect_device_ops(prof)
    device_ms = sum(us for us, _ in kernels.values()) / 1e3
    counts = {e.key: e.count for e in prof.key_averages()}
    launches = sum(counts.get(k, 0) for k in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    graph_launches = sum(counts.get(k, 0)
                         for k in ("cudaGraphLaunch", "cuGraphLaunch"))
    ops = sum(n for _, n in kernels.values())
    print(f"card: {card}; {label}")
    print(f"frame: {frame_ms:.1f} ms (host clock, mean of 3); "
          f"{prof_ms:.1f} ms under the profiler")
    print(f"device time: {device_ms:.1f} ms over kernels: "
          f"{100 * device_ms / frame_ms:.1f}% of the unprofiled frame, "
          f"{100 * device_ms / prof_ms:.1f}% of the profiled one")
    print(f"kernel launches per frame: {launches}; graph launches "
          f"{graph_launches}; device ops {ops}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in top[:12]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:90]}")
    spans, counters = {}, {}
    if tracing is not None:
        with tracing.on():
            frame()  # captures the traced graphs
            torch.cuda.synchronize()
            tracing.reset()
            frame()
            snap = tracing.snapshot()
        spans, counters = profiling.span_table(snap), snap.counters
        tracing.reset()
    print("device spans of one traced frame (ms, self ms, instances):")
    for name, (ms, own, count) in sorted(spans.items(), key=lambda kv:
                                         -kv[1][0]):
        print(f"  {ms:9.3f} ms {own:9.3f} self {count:6d}x  {name}")
    print(f"counters of the traced frame: {counters}")
    rec = {"tree": tree, "frame": label, "frame_ms": frame_ms,
           "profiled_ms": prof_ms, "kernel_ms": device_ms,
           "device_ops": ops, "kernel_launches": launches,
           "graph_launches": graph_launches, "queries": int(queries),
           "overflow": None if overflow is None else int(overflow),
           "image_sha256": bits, "card": card,
           "spans": {k: {"ms": ms, "self_ms": own, "instances": c}
                     for k, (ms, own, c) in spans.items()},
           "counters": counters}
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    root = ROOT
    if "--root" in sys.argv:  # before chip_smoke is imported
        root = sys.argv[sys.argv.index("--root") + 1]
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from rayito_tpu_torch.utils import graphs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="the tree to import (default: this checkout)")
    ap.add_argument("--label", default="change",
                    help="the tree's name in the JSON lines")
    setups = {"stage6": cs.stage6_setup, "stage7": cs.stage7_setup,
              "stage7b": cs.stage7b_setup, "stage5": cs.stage5_setup,
              "mesh_light": cs.mesh_light_setup,
              "spheres40": cs.many_spheres_setup,
              "lights16": cs.sixteen_lights_setup,
              "cli_stage6": cs.cli_setup,
              **{k: (lambda dev, k=k: cs.direct_setup(dev, k))
                 for k in ("stage1", "stage2", "stage3")}}
    makers = {"stage6_xla": _xla_frame(cs, cs.stage6_setup),
              "stage7_xla": _xla_frame(cs, cs.stage7_setup),
              "cli_stage6_xla": _cli_xla(cs)}
    ap.add_argument("--scene", default="stage6",
                    help="comma-separated frames: big, big_xla, "
                    + ", ".join([*setups, *makers]))
    ap.add_argument("--route", choices=("items", "scan"), default="items")
    ap.add_argument("--eager", action="store_true",
                    help="the eager pass body (path frames)")
    args = ap.parse_args()
    names = args.scene.split(",")
    for name in names:
        if name not in (*setups, *makers, "big", "big_xla"):
            ap.error(f"unknown --scene {name}")
        if args.eager and name in ("stage1", "stage2", "stage3",
                                   "cli_stage6", "cli_stage6_xla"):
            ap.error(f"--scene {name} calls an entry point")
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to profile", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    for name in names:
        if name in setups:
            frame = setups[name](dev)[-1]
        elif name in makers:
            frame = makers[name](dev)
        else:
            import dataclasses

            scan, items, _, _, _, big_frame = cs.big_setup(dev)
            scene = items if args.route == "items" else scan
            if name == "big_xla":
                scene = dataclasses.replace(scan, traversal="xla")
            def frame(graph=True, scene=scene, big_frame=big_frame):
                out = big_frame(scene, graph)
                frame.overflow = big_frame.overflow
                return out
        if args.eager:
            path_frame = frame
            frame = lambda f=path_frame: f(graph=False)  # noqa: E731
        label = (f"scene {name}"
                 + (f", {args.route} route" if name == "big" else "")
                 + (", eager pass body" if args.eager else ""))
        profile_frame(frame, card, label, args.label)
        graphs.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
