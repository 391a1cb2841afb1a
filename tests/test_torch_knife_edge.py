"""Which pixels of a sphere-light scene move with float32 rounding, and why
(CPU only): a report, and a test of its diagnosis.

``report`` renders a scene with ``rayito_tpu`` (JAX on the CPU) and with
``rayito_tpu_torch`` (PyTorch on the CPU) and prints the relative RMSE
between the two, the pixels more than 1e-4 apart and both query counts.
Then it records the inputs and results of every NEE shadow-query pair the
reference makes (``scene_occluded_pair``), replays the first bounce's on
the port, and prints the lanes whose light-side bit differs ON IDENTICAL
INPUTS, with the nearest shape along each lane's shadow ray and that
shape's t beside the ray's tmax. A lane whose nearest shape is its own
sphere light, at a t within rounding of tmax, is the knife edge: the sample
sits on the light's surface, the sphere quadratic (b*b - 4ac cancels)
places the hit within about 1e-5 * distance of it, and the 1e-4 shadow
epsilon decides lit or self-shadowed by the last bits of t, which follow
the compiler's fused multiply-adds.

Scenes: ``sixteen_lights`` (8 rect + 8 sphere lights over a plane, 32x32,
depth 2: the many-light parity scene) and ``stage5`` (at the reference's
golden configuration, also held against ``tests/goldens/path_stage5.pfm``).

The test holds the diagnosis on ``sixteen_lights``: every lane that
differs on identical inputs ends on a sphere light. Run the report twice
to see what the compiler alone moves:

    python tests/test_torch_knife_edge.py --scene sixteen_lights
    XLA_FLAGS=--xla_backend_optimization_level=0 python tests/test_torch_knife_edge.py --scene sixteen_lights

from the repo root, with ``JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, HERE)


def _stats(img, ref) -> str:
    rel = float(np.sqrt(np.mean((img - ref) ** 2))
                / max(np.sqrt(np.mean(ref ** 2)), 1e-20))
    apart = np.abs(img - ref).max(axis=2)
    return (f"relative RMSE {rel:.6g}, pixels > 1e-4 apart "
            f"{int((apart > 1e-4).sum())}, > 1e-2 apart "
            f"{int((apart > 1e-2).sum())}, max {float(apart.max()):.4g}")


def report(scene_name: str) -> dict:
    """Print the report for ``scene_name``; return its counts."""
    import jax
    import torch

    import rayito_tpu as rt
    import rayito_tpu_torch as tt
    from rayito_tpu.models import demo as jdemo
    from rayito_tpu.models.camera import PerspectiveCamera as JCam
    from rayito_tpu.render import pathtracer as jpath
    from rayito_tpu.utils.config import RenderConfig as JConfig
    from rayito_tpu_torch.models import demo as tdemo
    from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
    from rayito_tpu_torch.ops.vec3 import V3
    from rayito_tpu_torch.render import pathtracer as tpath
    from rayito_tpu_torch.render import trace as ttrace
    from rayito_tpu_torch.utils.config import RenderConfig as TConfig
    from rayito_tpu_torch.utils.image import read_pfm

    if scene_name == "stage5":
        kw = dict(width=96, height=64, pixel_samples=2, light_samples=1,
                  max_depth=3, seed=1)
        cam = dict(focal_distance=16.0, lens_radius=0.0, shutter_open=0.0,
                   shutter_close=1.0)
        jsd = jdemo.stage5_scene().compile(traversal="pallas")
        tsd = tdemo.stage5_scene().compile("cpu")
        jcam = JCam.make(30.0, *jdemo.STAGE5_CAMERA, **cam)
        tcam = TCam.make(30.0, *tdemo.STAGE5_CAMERA, **cam)
    else:
        kw = dict(width=32, height=32, pixel_samples=1, light_samples=1,
                  max_depth=2)
        spec = (40.0, (0, 3, 10), (0, 0, 0), (0, 1, 0))
        jsd = tdemo.sixteen_lights_scene(pkg=rt).compile(traversal="pallas")
        tsd = tdemo.sixteen_lights_scene(pkg=tt).compile("cpu")
        jcam, tcam = JCam.make(*spec), TCam.make(*spec)

    # record every shadow-query pair of the reference, in call order
    pairs = []
    real_pair = jpath.scene_occluded_pair

    def recording_pair(scene, o, d1, tmax1, d2, tmax2, time, tmin, live):
        out = real_pair(scene, o, d1, tmax1, d2, tmax2, time, tmin, live)
        jax.debug.callback(
            lambda *a: pairs.append([np.asarray(x).copy() for x in a]),
            o.x, o.y, o.z, d1.x, d1.y, d1.z, tmax1, time, out[0],
            ordered=True)
        return out

    # the patched function is read at trace time: drop what was traced
    # before, and the traces that hold the recorder afterwards
    jax.clear_caches()
    jpath.scene_occluded_pair = recording_pair
    try:
        ref, _, j_q = jpath.render_path_with_stats(jsd, JConfig(**kw), jcam)
        jax.effects_barrier()
    finally:
        jpath.scene_occluded_pair = real_pair
        jax.clear_caches()
    ref = np.asarray(ref, np.float32)
    port, _, t_q = tpath.render_path_with_stats(tsd, TConfig(**kw), tcam)

    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, scene "
          f"{scene_name}, {kw['width']}x{kw['height']}")
    print(f"queries: reference {int(j_q)}, port {int(t_q)}")
    print("port vs reference: " + _stats(port, ref))
    if scene_name == "stage5":
        golden = read_pfm(os.path.join(HERE, "tests", "goldens",
                                       "path_stage5.pfm"))
        print("reference vs golden: " + _stats(ref, golden))
        print("port vs golden:      " + _stats(port, golden))
    apart = np.argwhere(np.abs(port - ref).max(axis=2) > 1e-4)
    print(f"pixels (row, col) > 1e-4 apart: {apart.tolist()}")

    # the first bounce's first light sample, replayed on the port
    ox, oy, oz, dx, dy, dz, tmax, time, ref_occ = pairs[0]
    f = torch.from_numpy
    o, d = V3(f(ox), f(oy), f(oz)), V3(f(dx), f(dy), f(dz))
    got, _ = ttrace.scene_occluded(tsd, o, d, f(time), kw.get("ray_tmin",
                                                              1e-4), f(tmax))
    lanes = np.argwhere(got.numpy() != ref_occ)[:, 0]
    print(f"first shadow query: {len(tmax)} lanes, {int((tmax > 0).sum())} "
          f"live; light-side bit differs on identical inputs in "
          f"{len(lanes)} lanes")
    on_own = on_sphere = 0
    if len(lanes):
        def sel(v):
            return V3(v.x[lanes], v.y[lanes], v.z[lanes])

        hit = ttrace.scene_intersect(tsd, sel(o), sel(d), f(time)[lanes],
                                     1e-4, torch.full((len(lanes),), 1e30))
        light_sids = set(tsd.light_shape_id.tolist())
        sph_light = [s for s, k in zip(tsd.light_shape_id.tolist(),
                                       tsd.light_kinds_host) if k == 1]
        on_sphere = sum(int(s) in sph_light for s in hit.shape_id.tolist())
        on_own = sum(int(s) in sph_light and abs(t - tm) <= 1e-4 * tm + 1e-4
                     for s, t, tm in zip(hit.shape_id.tolist(),
                                         hit.t.tolist(), tmax[lanes]))
        print(f"  nearest shape is a sphere light within 1e-4 relative of "
              f"the ray's end in {on_own} of them")
        for lane, s, t, tm in zip(lanes, hit.shape_id.tolist(),
                                  hit.t.tolist(), tmax[lanes]):
            kind = ("sphere light" if s in sph_light else
                    "light" if s in light_sids else "shape")
            print(f"  lane {int(lane)}: nearest {kind} {s} at t={t:.6f}, "
                  f"tmax={float(tm):.6f}, reference occluded "
                  f"{bool(ref_occ[lane])}")
    return {"lanes": len(tmax), "live": int((tmax > 0).sum()),
            "differing": len(lanes), "nearest_a_sphere_light": on_sphere,
            "at_the_rays_end": on_own,
            "pixels_apart": len(apart)}


def test_differing_shadow_lanes_end_on_their_own_sphere_light():
    """On identical inputs the port's light-side shadow bit differs from
    the reference's in a few lanes. In every one of them the nearest shape
    along the shadow ray is a sphere light, and in nine of ten it stands
    within 1e-4 relative of the ray's end: the light the lane sampled (the
    rest graze another sphere light on the way)."""
    out = report("sixteen_lights")
    assert out["live"] > out["lanes"] // 4
    assert out["differing"] <= out["lanes"] // 16
    assert out["nearest_a_sphere_light"] == out["differing"]
    assert out["at_the_rays_end"] >= 0.9 * out["differing"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("sixteen_lights", "stage5"),
                    default="sixteen_lights")
    report(ap.parse_args().scene)
    return 0


if __name__ == "__main__":
    sys.exit(main())
