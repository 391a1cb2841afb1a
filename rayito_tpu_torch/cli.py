"""Command-line renderer of the port (counterpart of ``rayito_tpu/cli.py``):
the GUI's knobs as flags, the demo scenes by name, output as PPM (LDR,
tone-mapped like the GUI) or PFM (HDR).

    python -m rayito_tpu_torch.cli --scene stage6 --obj bumpy.obj \
        --width 640 --height 480 --pixel-samples 2 --depth 3 -o out.ppm

It renders on the CUDA card unless given ``--device cpu``; with no card
and no ``--device cpu`` it exits with an error. The mesh traversal comes
from RAYITO_TRAVERSAL at the scene's compile: unset or ``auto`` is the
kernel route (``pallas``), ``xla`` the two-level cluster pipeline. Beyond
the reference's GUI: --checkpoint (progressive accumulation, resumable), --sharded (the
frame's lanes over every CUDA card), --view (a live preview in a browser),
scene and render stats on stderr, NaN / negative-pixel counts.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_scene(name: str, obj_path: str):
    """(Scene, camera spec, fov, mode) of demo scene ``name``."""
    from .models import demo

    scenes = {
        "stage1": (demo.stage1_scene, demo.STAGE1_CAMERA, demo.STAGE1_FOV,
                   "color"),
        "stage2": (demo.stage2_scene, demo.STAGE23_CAMERA, demo.STAGE23_FOV,
                   "direct"),
        "stage3": (demo.stage3_scene, demo.STAGE23_CAMERA, demo.STAGE23_FOV,
                   "direct"),
        "stage4": (demo.stage3_scene, demo.STAGE23_CAMERA, demo.STAGE23_FOV,
                   "direct"),
        "stage5": (demo.stage5_scene, demo.STAGE5_CAMERA, 30.0, "path"),
        "stage6": (lambda: demo.stage6_scene(obj_path), demo.STAGE6_CAMERA,
                   30.0, "path"),
        "stage7": (lambda: demo.stage7_scene1(obj_path), demo.STAGE7_CAMERA,
                   30.0, "path"),
        "stage7b": (demo.stage7_scene2, demo.STAGE7_SCENE2_CAMERA, 30.0,
                    "path"),
    }
    if name not in scenes:
        raise SystemExit(f"unknown scene {name!r}; choose from "
                         f"{sorted(scenes)}")
    make, cam, fov, mode = scenes[name]
    return make(), cam, fov, mode


def _device(name: str):
    """The torch device to render on; a CUDA device must exist."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"rayito_tpu_torch: --device {name} needs a CUDA card, and "
            "torch finds none (torch.cuda.is_available() is false); pass "
            "--device cpu to render on the CPU")
    return device


def main(argv=None):
    p = argparse.ArgumentParser(prog="rayito_tpu_torch",
                                description=__doc__)
    p.add_argument("--scene", default="stage6",
                   help="demo scene: stage1..stage7, stage7b")
    p.add_argument("--obj", default="models/bumpy.obj",
                   help="OBJ path for the mesh scenes (stage6, stage7)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on: cuda (default), "
                        "cuda:N or cpu")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--pixel-samples", type=int, default=2,
                   help="per-axis hint; total spp = hint^2 (GUI semantics)")
    p.add_argument("--light-samples", type=int, default=1)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--focal-distance", type=float, default=16.0)
    p.add_argument("--lens-radius", type=float, default=0.0)
    p.add_argument("--shutter", type=float, nargs=2, default=(0.0, 1.0),
                   metavar=("OPEN", "CLOSE"))
    p.add_argument("--exposure", type=float, default=0.0)
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("-o", "--output", default="out.ppm")
    p.add_argument("--pfm", action="store_true",
                   help="write HDR PFM (no tonemap)")
    p.add_argument("--no-tonemap", action="store_true",
                   help="write raw clamped radiance to the PPM")
    p.add_argument("--diagnostic-colors", action="store_true",
                   help="paint NaN pixels blue / negative pixels green")
    p.add_argument("--checkpoint", default=None,
                   help="progressive checkpoint file (.npz); resumes if "
                        "present")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="save every N sample chunks")
    p.add_argument("--view", type=int, nargs="?", const=8652, default=None,
                   metavar="PORT",
                   help="serve a live auto-refreshing preview of the "
                        "progressive render at http://localhost:PORT "
                        "(default 8652)")
    p.add_argument("--sharded", action="store_true",
                   help="shard the frame's lanes over every CUDA card (the "
                        "one --device names, if it is the CPU)")
    p.add_argument("--interactive", action="store_true",
                   help="with --view: after the first render, keep serving "
                        "and re-render on knob submissions from the page. "
                        "Each re-render rewrites the output file; Ctrl-C "
                        "exits.")
    args = p.parse_args(argv)
    if args.interactive and args.view is None:
        p.error("--interactive requires --view")
    device = _device(args.device)

    from .models.camera import PerspectiveCamera
    from .utils.config import RenderConfig
    from .utils.image import (diagnose, diagnostic_colors, tone_map,
                              write_pfm, write_ppm)
    from .utils.native import is_available as native_available

    scene_desc, cam_spec, default_fov, mode = build_scene(args.scene,
                                                          args.obj)
    t0 = time.perf_counter()
    scene = scene_desc.compile(device)
    fov = args.fov if args.fov is not None else default_fov
    # clusters of the structure in use: the kernel tables' (the 128-wide
    # clusters of every domain) or the two-level pipeline's 48-wide ones
    if scene.traversal == "pallas" and scene.ktab_tri:
        n_clusters = sum(t.shape[0] for t in scene.ktab_tri)
    else:
        n_clusters = scene.cl_min.shape[0]
    print(
        f"[rayito_tpu_torch] scene={args.scene} device={scene.device} "
        f"planes={scene.n_planes} spheres={scene.n_spheres} "
        f"rects={scene.n_rects} meshes={scene.n_meshes} "
        f"tris={scene.tri_vm_rows.shape[0]} lights={scene.n_lights} "
        f"clusters={n_clusters} traversal={scene.traversal} "
        f"motion={scene.has_motion} "
        f"native={'c++' if native_available() else 'python'} "
        f"compile={time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )

    cfg = RenderConfig(
        width=args.width, height=args.height,
        pixel_samples=args.pixel_samples, light_samples=args.light_samples,
        max_depth=args.depth, gamma=args.gamma, exposure=args.exposure,
        seed=args.seed,
    )

    t1 = time.perf_counter()
    mesh = None
    if mode == "color":
        from .render.integrator import render_color

        img = render_color(scene, cfg, fov=fov, camera=cam_spec)
        stats_line = ""
    elif mode == "direct":
        from .render.integrator import render_direct

        img = render_direct(scene, cfg, fov=fov, camera=cam_spec)
        stats_line = ""
    else:
        camera = PerspectiveCamera.make(
            fov, *cam_spec, focal_distance=args.focal_distance,
            lens_radius=args.lens_radius, shutter_open=args.shutter[0],
            shutter_close=args.shutter[1],
        )
        from .render.progressive import render_progressive

        if args.sharded:
            from .parallel.sharding import make_mesh

            mesh = make_mesh(None if device.type == "cuda" else [device])
            print(f"[rayito_tpu_torch] sharding the wavefront over "
                  f"{len(mesh)} device(s)", file=sys.stderr)
        viewer = None
        if args.view is not None:
            from .utils.viewer import LiveViewer

            knobs = None
            if args.interactive:
                knobs = {
                    "width": args.width, "height": args.height,
                    "pixel_samples": args.pixel_samples,
                    "light_samples": args.light_samples,
                    "depth": args.depth, "fov": fov,
                    "focal_distance": args.focal_distance,
                    "lens_radius": args.lens_radius,
                    "shutter_open": args.shutter[0],
                    "shutter_close": args.shutter[1],
                    "exposure": args.exposure, "gamma": args.gamma,
                }
            viewer = LiveViewer(port=args.view, exposure=args.exposure,
                                gamma=args.gamma, knobs=knobs)
            print(f"[rayito_tpu_torch] live preview at http://localhost:"
                  f"{viewer.port}/", file=sys.stderr)
        img, stats = render_progressive(
            scene, cfg, camera, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            on_preview=viewer.on_preview if viewer else None, mesh=mesh,
        )
        if viewer:
            viewer.update(img, stats)
        stats_line = (
            (f" (sharded x{len(mesh)})" if mesh is not None else "")
            + f" rays={stats.rays_traced / 1e6:.1f}M"
            f" throughput={stats.mrays_per_sec:.2f} Mrays/s"
            + (f" OVERFLOW={stats.overflow}" if stats.overflow else "")
        )

    dt = time.perf_counter() - t1
    diag = diagnose(img)
    print(
        f"[rayito_tpu_torch] rendered {args.width}x{args.height} "
        f"spp={cfg.pixel_samples ** 2} on {scene.device} in {dt:.1f}s"
        f"{stats_line} nan={diag['nan_pixels']} "
        f"neg={diag['negative_pixels']}",
        file=sys.stderr,
    )

    def write_out(img):
        out = img
        if args.diagnostic_colors:
            out = diagnostic_colors(out)
        if args.pfm:
            write_pfm(args.output, out)
        else:
            if mode == "path" and not args.no_tonemap:
                out = tone_map(out, args.exposure, args.gamma)
            write_ppm(args.output, out)
        print(f"[rayito_tpu_torch] wrote {args.output}", file=sys.stderr)

    write_out(img)

    if args.interactive and mode == "path" and viewer is not None:
        _interactive_loop(args, scene, cam_spec, viewer, write_out, mesh=mesh)
    return 0


# knob name -> coercion; shutter_* map into the 2-tuple
_KNOB_TYPES = {
    "width": int, "height": int, "pixel_samples": int,
    "light_samples": int, "depth": int, "fov": float,
    "focal_distance": float, "lens_radius": float,
    "shutter_open": float, "shutter_close": float,
    "exposure": float, "gamma": float,
}

# upper bounds of the integer knobs: POST /render payloads come from the
# network, so an unbounded width, height or spp must not be able to ask
# for a terabyte-scale render
_KNOB_MAX = {
    "width": 16384, "height": 16384, "pixel_samples": 64,
    "light_samples": 16, "depth": 64,
}


def apply_knobs(args, fov, req):
    """Coerce a {name: string} knob submission onto the arg namespace;
    invalid or out-of-range values keep the old setting. Returns the
    (possibly updated) fov."""
    for name, raw in req.items():
        ctor = _KNOB_TYPES.get(name)
        if ctor is None:
            continue
        try:
            val = ctor(float(raw)) if ctor is int else ctor(raw)
        except (TypeError, ValueError):
            continue
        if ctor is int and not 1 <= val <= _KNOB_MAX[name]:
            continue
        if name == "fov":
            fov = val
        elif name == "shutter_open":
            args.shutter = (val, args.shutter[1])
        elif name == "shutter_close":
            args.shutter = (args.shutter[0], val)
        else:
            setattr(args, name, val)
    return fov


def _interactive_loop(args, scene, cam_spec, viewer, write_out, mesh=None):
    """Re-render on every knob submission until Ctrl-C (the GUI's
    spinbox / render-button loop). ``mesh`` keeps every re-render on the
    sharded path; the checkpoint rides along, and its digest makes a knob
    change start fresh instead of blending."""
    from .models.camera import PerspectiveCamera
    from .render.progressive import render_progressive
    from .utils import graphs
    from .utils.config import RenderConfig

    fov = float(viewer.knobs["fov"])
    last_cfg = None
    viewer.set_state("idle")
    print("[rayito_tpu_torch] interactive: edit knobs on the page and "
          "press Render (Ctrl-C to exit)", file=sys.stderr)
    while True:
        try:
            req = viewer.wait_knobs()
        except KeyboardInterrupt:
            print("[rayito_tpu_torch] interactive loop closed",
                  file=sys.stderr)
            return
        fov = apply_knobs(args, fov, req)
        viewer.exposure = args.exposure
        viewer.gamma = args.gamma
        cfg = RenderConfig(
            width=args.width, height=args.height,
            pixel_samples=args.pixel_samples,
            light_samples=args.light_samples, max_depth=args.depth,
            gamma=args.gamma, exposure=args.exposure, seed=args.seed,
        )
        camera = PerspectiveCamera.make(
            fov, *cam_spec, focal_distance=args.focal_distance,
            lens_radius=args.lens_radius, shutter_open=args.shutter[0],
            shutter_close=args.shutter[1],
        )
        if cfg != last_cfg:
            # a new config captures new pass graphs: free the old ones
            # and their pools (a camera change replays the same graphs)
            graphs.clear()
            last_cfg = cfg
        viewer.set_state("rendering")
        t0 = time.perf_counter()
        img, stats = render_progressive(
            scene, cfg, camera, on_preview=viewer.on_preview, mesh=mesh,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
        )
        viewer.update(img, stats)
        viewer.set_state("idle")
        print(f"[rayito_tpu_torch] re-rendered {cfg.width}x{cfg.height} "
              f"spp={cfg.pixel_samples ** 2} depth={cfg.max_depth} in "
              f"{time.perf_counter() - t0:.1f}s "
              f"({stats.mrays_per_sec:.2f} Mrays/s)", file=sys.stderr)
        write_out(img)


if __name__ == "__main__":
    raise SystemExit(main())
