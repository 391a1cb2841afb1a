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
  * utils/profiling.phase_table: device time by renderer phase.

Run from the repo root on a machine with a GPU:
``python3 tools/frame_profile_torch.py [--scene big --route scan] [--eager]``
(``--scene stage7``, ``--scene stage7b``, ``--scene mesh_light``, ...).
``--root`` names the tree whose ``chip_smoke.py`` and ``rayito_tpu_torch``
are imported (default: this checkout), so that two commits can be
profiled in turns on one card:
``python3 tools/frame_profile_torch.py --root build/parent --scene stage6``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    root = ROOT
    if "--root" in sys.argv:  # before chip_smoke is imported
        root = sys.argv[sys.argv.index("--root") + 1]
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from rayito_tpu_torch.utils.profiling import collect_device_ops, phase_table

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="the tree to import (default: this checkout)")
    setups = {"stage6": cs.stage6_setup, "stage7": cs.stage7_setup,
              "stage7b": cs.stage7b_setup, "stage5": cs.stage5_setup,
              "mesh_light": cs.mesh_light_setup,
              "spheres40": cs.many_spheres_setup,
              "lights16": cs.sixteen_lights_setup,
              "cli_stage6": cs.cli_setup,
              **{k: (lambda dev, k=k: cs.direct_setup(dev, k))
                 for k in ("stage1", "stage2", "stage3")}}
    ap.add_argument("--scene", choices=("big", *setups), default="stage6")
    ap.add_argument("--route", choices=("items", "scan"), default="items")
    ap.add_argument("--eager", action="store_true",
                    help="the eager pass body (path frames)")
    args = ap.parse_args()
    if args.eager and args.scene in ("stage1", "stage2", "stage3",
                                     "cli_stage6"):
        ap.error(f"--scene {args.scene} calls an entry point")
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to profile", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    if args.scene in setups:
        frame = setups[args.scene](dev)[-1]
    else:
        scan, items, _, _, _, big_frame = cs.big_setup(dev)
        scene = items if args.route == "items" else scan
        frame = lambda graph=True: big_frame(scene, graph)  # noqa: E731
    if args.eager:
        path_frame = frame
        frame = lambda: path_frame(graph=False)  # noqa: E731
    frame()
    torch.cuda.synchronize()
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
    print(f"card: {card}; scene {args.scene}"
          + (f", {args.route} route" if args.scene == "big" else "")
          + (", eager pass body" if args.eager else ""))
    print(f"frame: {frame_ms:.1f} ms (host clock, mean of 3); "
          f"{prof_ms:.1f} ms under the profiler")
    print(f"device time: {device_ms:.1f} ms over kernels: "
          f"{100 * device_ms / frame_ms:.1f}% of the unprofiled frame, "
          f"{100 * device_ms / prof_ms:.1f}% of the profiled one")
    print(f"kernel launches per frame: {launches}; graph launches "
          f"{graph_launches}; device ops "
          f"{sum(n for _, n in kernels.values())}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for name, (us, count) in top[:12]:
        print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:90]}")
    print("by phase:")
    for label, ms, count in phase_table(prof):
        print(f"  {ms:9.3f} ms {count:6d}x  {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
