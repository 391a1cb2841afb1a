"""The readings that the limit of ``compare.py`` is set from, for one cell
at its own size: the program's mismatch share on each of ``--seeds``
seeds (one render each through the window's entry, ``render_progressive``,
judged as a run judges it) and the control's on the first
``--control-seeds`` of them (the reference computed in bfloat16, the
precision below the configuration's float32, put in the program's place).

    python3 portbench/calibrate.py --workload stage6_bumpy.gui640 \
        --seeds 12 --control-seeds 3 --first-seed 1000

Prints one line per reading and, last, one JSON object with all of them.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2**31 + 11)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from portbench import compare, port_scene, run, spec, standin
    from portbench.reference import scene as rscene
    from portbench.reference import tracer

    import torch

    run.cache_env(ROOT)
    cell = spec.load_cell(ROOT, args.workload)
    dev = torch.device(args.device)
    obj_paths = {k: standin.cached(os.path.join(ROOT, run.CACHE), m)
                 for k, m in cell.config.get("meshes", {}).items()}
    from rayito_tpu_torch.render.progressive import render_progressive
    from rayito_tpu_torch.utils import graphs

    scene = port_scene.build(cell.config, obj_paths).compile(dev)
    flat = rscene.flatten(cell.config, obj_paths)
    camera = run.camera_of(cell.config["camera"])
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    out = {"workload": args.workload, "program": {}, "control": {}}
    for k, seed in enumerate(seeds):
        rc = run.render_config(cell.traffic, seed)
        pix = compare.sample_pixels(seed, rc.width, rc.height)
        img, _ = render_progressive(scene, rc, camera)
        got = img.reshape(-1, 3)[pix].copy()
        graphs.clear()  # one seed's pass graphs at a time
        rc_ref = dict(width=rc.width, height=rc.height,
                      pixel_samples=rc.pixel_samples,
                      light_samples=rc.light_samples,
                      max_depth=rc.max_depth, seed=seed,
                      ray_tmin=rc.ray_tmin)
        t = time.perf_counter()
        ref = tracer.render_pixels(flat, cell.config["camera"], rc_ref, pix,
                                   dev, torch.float32)
        t_ref = time.perf_counter() - t
        share = compare.mismatch_share(got, ref)
        out["program"][seed] = share
        print(f"program seed {seed}: mismatch share {share!r} "
              f"(reference {t_ref:.2f} s)", flush=True)
        if k < args.control_seeds:
            low = tracer.render_pixels(flat, cell.config["camera"], rc_ref,
                                       pix, dev, torch.bfloat16)
            c = compare.mismatch_share(low, ref)
            out["control"][seed] = c
            print(f"control seed {seed}: mismatch share {c!r}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
