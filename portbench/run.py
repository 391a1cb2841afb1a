"""Run one cell of the benchmark of rayito_tpu_torch once and print its
result as the last line of standard output.

    python3 portbench/run.py --workload stage6_bumpy.gui640 --seed 7 \
        --seconds 30 --trace 0

A cell is a scene configuration under a traffic mix (``BENCHMARK.json``).
The run builds the scene through the program's scene API, compiles it for
the card and warms up with one whole progressive render, which captures
the render's pass graphs and loads the kernel library (set-up). Then one
user renders the scene again and again, each render starting when the
last has returned, until ``--seconds`` have passed (the window): every
render is ``render_progressive`` at the traffic's RenderConfig, seeded by
``--seed``, one pass per sample of every pixel. With ``--trace 1`` one
render of the window runs under the profiler and the per-layer metrics
are read from it.

After the window, with the program's state freed, the plain reference
renders a sample of pixels drawn from the seed, and every render's value
of those pixels is held against it (``compare.py``).

It runs on the card it starts on and exits with another code than 0 and
no result where there is none (or fewer than the cell asks for), or where
a module of JAX or of the JAX package has been loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "rayito_tpu")
CACHE = os.path.join("build", "portbench")


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(root, CACHE)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def note(*a) -> None:
    print("[portbench]", *a, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "not read")


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def render_config(traffic: dict, seed: int):
    from rayito_tpu_torch.utils.config import RenderConfig

    return RenderConfig(
        width=traffic["width"], height=traffic["height"],
        pixel_samples=traffic["pixel_samples"],
        light_samples=traffic["light_samples"],
        max_depth=traffic["max_depth"],
        max_rays_per_pass=traffic["max_rays_per_pass"], seed=seed)


def camera_of(cam: dict):
    from rayito_tpu_torch.models.camera import PerspectiveCamera

    s0, s1 = cam["shutter"]
    return PerspectiveCamera.make(
        cam["fov_degrees"], tuple(cam["origin"]), tuple(cam["target"]),
        tuple(cam["up"]), focal_distance=cam["focal_distance"],
        lens_radius=cam["lens_radius"], shutter_open=s0, shutter_close=s1)


def band_lanes(rc) -> int:
    """Lanes of one launch: the image, or one band of rows when the image
    is above the launch budget (render/progressive.py's banding)."""
    if rc.width * rc.height <= rc.max_rays_per_pass:
        return rc.width * rc.height
    return max(1, rc.max_rays_per_pass // rc.width) * rc.width


class Window:
    """The closed loop: renders back to back, each pass timed from the
    dispatch of its first band (the render's start, or the previous
    pass's end) to the host add of its last (the progress callback)."""

    def __init__(self, render, pix):
        self.render, self.pix = render, pix
        self.passes, self.samples_of, self.queries = [], [], 0
        self.renders = 0

    def one(self):
        stamps = []
        t0 = time.perf_counter()
        img, st = self.render(lambda s: stamps.append(time.perf_counter()))
        self.passes += [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
        self.samples_of.append(img.reshape(-1, 3)[self.pix].copy())
        self.queries += st.rays_traced
        self.renders += 1

    def run(self, seconds: float, traced=None):
        """Renders until ``seconds`` have passed since the first began (at
        least two with ``traced``, which runs the second: it returns what
        ``traced(self.one)`` returned)."""
        got = None
        self.t0 = time.perf_counter()
        while True:
            if traced is not None and self.renders == 1:
                got = traced(self.one)
            else:
                self.one()
            self.t1 = time.perf_counter()
            if (self.t1 - self.t0 >= seconds
                    and (traced is None or self.renders >= 2)):
                return got


def main(argv=None, *, device: str = "cuda", root: str = ROOT,
         here: str = HERE, out=None) -> int:
    args = parse_args(argv)
    out = out or sys.stdout
    cache_env(root)
    from portbench import compare, spec, standin, stats
    from portbench import trace as ptrace

    cell = spec.load_cell(root, args.workload, here)
    chips = int(cell.entry.get("chips", 1))

    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            note("no CUDA device: torch.cuda.is_available() is false")
            return 2
        if torch.cuda.device_count() < chips:
            note(f"the cell needs {chips} card(s); torch finds "
                 f"{torch.cuda.device_count()}")
            return 2
    dev = torch.device(device)

    from portbench import port_scene
    from rayito_tpu_torch.render.progressive import render_progressive
    from rayito_tpu_torch.utils import cuda_lib, graphs

    # --- set-up: the program's kernels, the scene, one warm-up render
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        cuda_lib.library()
    t_lib = time.perf_counter() - t
    t = time.perf_counter()
    obj_paths = {k: standin.cached(os.path.join(root, CACHE), m)
                 for k, m in cell.config.get("meshes", {}).items()}
    t_obj = time.perf_counter() - t
    t = time.perf_counter()
    scene = port_scene.build(cell.config, obj_paths).compile(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_compile = time.perf_counter() - t
    rc = render_config(cell.traffic, args.seed)
    camera = camera_of(cell.config["camera"])
    pix = compare.sample_pixels(args.seed, rc.width, rc.height)

    def render(on_progress):
        return render_progressive(scene, rc, camera, on_progress=on_progress)

    t = time.perf_counter()
    render(None)
    t_warm = time.perf_counter() - t

    # --- the window
    win = Window(render, pix)
    trace_path = os.path.join(root, CACHE, "trace.json")
    traced = None
    if args.trace:
        def traced(one):
            return ptrace.profile(one, trace_path)[1]
    events = win.run(args.seconds, traced)
    setup_s = win.t0 - T_START
    note(f"setup {setup_s:.3f} s: kernels and context {t_lib:.3f}, "
         f"stand-in {t_obj:.3f}, scene compile {t_compile:.3f}, warm-up "
         f"render {t_warm:.3f}")
    window_s = win.t1 - win.t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    spp = rc.pixel_samples ** 2
    samples = win.renders * rc.width * rc.height * spp
    note(f"window {window_s:.3f} s: {win.renders} renders, "
         f"{len(win.passes)} passes, {samples} pixel samples, "
         f"{win.queries} queries")
    ms = sorted(p * 1e3 for p in win.passes)
    note("pass ms: min {:.3f} q1 {:.3f} median {:.3f} q3 {:.3f} p95 {:.3f} "
         "max {:.3f}; first passes of renders median {:.3f}".format(
             ms[0], *(stats.percentile(ms, q) for q in (25, 50, 75, 95)),
             ms[-1], stats.percentile(win.passes[::spp], 50) * 1e3))

    # --- the per-layer context, read before the program's state goes
    ctx = None
    if args.trace:
        import importlib.util

        def roofline(name):
            p = os.path.join(here, "rooflines", name + ".py")
            s = importlib.util.spec_from_file_location(
                "portbench_roofline_" + name, p)
            m = importlib.util.module_from_spec(s)
            s.loader.exec_module(m)
            return m

        from rayito_tpu_torch.render import shade as pshade

        import rayito_tpu_torch

        csrc = os.path.join(os.path.dirname(rayito_tpu_torch.__file__),
                            "csrc")
        ctx = types.SimpleNamespace(
            trace=ptrace.parse(events, spp), config=cell.config,
            traffic=cell.traffic, queries=win.queries, samples=samples,
            launch_calls=ptrace.LAUNCHES, kernel_id=ptrace.kernel_id,
            hand_kernels=ptrace.hand_kernels(csrc), roofline=roofline,
            scene=dict(lanes=band_lanes(rc),
                       nls=pshade.light_samples(scene, rc),
                       motion=bool(scene.has_motion),
                       analytic=pshade.analytic_lights(scene)))
        del events

    # --- the program's state freed; then the reference
    del scene, render, win.render
    graphs.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        note("card:", power_limit())
    found = forbidden_modules()
    if found:
        note("forbidden modules loaded:", ", ".join(found))
        return 3

    from portbench.reference import scene as rscene
    from portbench.reference import tracer

    t = time.perf_counter()
    flat = rscene.flatten(cell.config, obj_paths)
    rc_ref = dict(width=rc.width, height=rc.height,
                  pixel_samples=rc.pixel_samples,
                  light_samples=rc.light_samples, max_depth=rc.max_depth,
                  seed=args.seed, ray_tmin=rc.ray_tmin)
    ref = tracer.render_pixels(flat, cell.config["camera"], rc_ref, pix,
                               dev, torch.float32)
    shares = [compare.mismatch_share(got, ref) for got in win.samples_of]
    worst = max(shares)
    limit = compare.MISMATCH_LIMIT
    failed = sum(s > limit for s in shares)
    note(f"reference: {len(pix)} pixels x {spp} samples in "
         f"{time.perf_counter() - t:.3f} s; mismatch shares of the renders "
         f"{min(shares):.6f}..{worst:.6f}")

    # --- the result
    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], here)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {
            "msamples_per_s": lambda: stats.rate(samples, window_s) / 1e6,
            "pass_ms_p95": lambda: stats.percentile(win.passes, 95) * 1e3,
            "setup_s": lambda: setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]()),
                                  "unit": m["unit"]}
    result = {"correct": failed == 0 and win.renders > 0,
              "attempted": win.renders, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": kind, "count": chips,
                         "memory_peak_bytes": int(peak)}}
    if ctx is not None:
        result["device"]["busy_s"] = ctx.trace.busy_us * 1e-6
        result["device"]["window_s"] = ctx.trace.window_us * 1e-6
        result["breakdown"] = ptrace.breakdown(ctx.trace)
    result["checks"] = {"mismatch_share": {"value": worst, "limit": limit}}
    found = forbidden_modules()
    if found:
        note("forbidden modules loaded:", ", ".join(found))
        return 3
    print(f"check mismatch_share {worst!r} limit {limit!r}", file=sys.stderr,
          flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
