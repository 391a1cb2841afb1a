"""What tracing (rayito_tpu_torch/utils/tracing.py) costs a pass on the card.

For each benchmark cell named, builds its scene as ``portbench/run.py``
does and renders progressively at its traffic's settings: first one
render with tracing off and one with it on (which capture the untraced and
the traced pass graphs), then ``--rounds`` rounds of two turns, off then on
in even rounds and on then off in odd ones, each turn ``--seconds`` of
back-to-back renders. A pass is timed on the host clock from its first
band's dispatch to its last band's host add, as the benchmark times it;
with tracing on the spans and counters are read back and reset after each
render (outside the timed passes), so the log never fills. Prints one JSON
line per cell: each side's pass count and pass ms (median, quartiles),
the median's change in percent, and the card's name and power limit.

Run from the repo root on a machine with a GPU:

    python3 tools/tracing_cost_torch.py \
        --cells stage6_bumpy.gui640,stage7_motion.gui640
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="stage6_bumpy.gui640")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    args = ap.parse_args()

    import torch

    from portbench import port_scene, spec, standin
    from portbench import run as prun
    from rayito_tpu_torch.render.progressive import render_progressive
    from rayito_tpu_torch.utils import graphs, tracing

    if not torch.cuda.is_available():
        print("no CUDA device: nothing to measure", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    for name in args.cells.split(","):
        cell = spec.load_cell(ROOT, name)
        objs = {k: standin.cached(os.path.join(ROOT, prun.CACHE), m)
                for k, m in cell.config.get("meshes", {}).items()}
        scene = port_scene.build(cell.config, objs).compile(dev)
        rc = prun.render_config(cell.traffic, args.seed)
        cam = prun.camera_of(cell.config["camera"])

        def turn(traced: bool, seconds: float) -> list:
            passes = []
            with tracing.on(traced):
                end = time.perf_counter() + seconds
                while not passes or time.perf_counter() < end:
                    stamps = []
                    t0 = time.perf_counter()
                    render_progressive(
                        scene, rc, cam,
                        on_progress=lambda st: stamps.append(
                            time.perf_counter()))
                    passes += [(b - a) * 1e3 for a, b in
                               zip([t0] + stamps[:-1], stamps)]
                    if traced:
                        tracing.snapshot()
                        tracing.reset()
            return passes

        turn(False, 0.0)  # captures the untraced graphs
        turn(True, 0.0)  # captures the traced ones
        ms = {False: [], True: []}
        for r in range(args.rounds):
            for traced in ((False, True) if r % 2 == 0 else (True, False)):
                ms[traced] += turn(traced, args.seconds)
        rec = {"cell": name, "card": card}
        for traced, label in ((False, "off"), (True, "on")):
            q1, med, q3 = statistics.quantiles(ms[traced], n=4)
            rec[label] = {"passes": len(ms[traced]), "median_ms": med,
                          "q1_ms": q1, "q3_ms": q3}
        rec["median_change_pct"] = 100.0 * (
            rec["on"]["median_ms"] / rec["off"]["median_ms"] - 1.0)
        print(json.dumps(rec), flush=True)
        del scene
        graphs.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
