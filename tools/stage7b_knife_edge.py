"""How far stage 7b's image moves with float32 rounding (CPU only).

Renders the stage-7b scene at the golden config of
``tests/test_golden_path.py`` (96x64, 2x2 samples, depth 3, seed 1,
shutter 0..1) with ``rayito_tpu`` (JAX on the CPU) and with
``rayito_tpu_torch`` (PyTorch on the CPU), at the ray epsilon ``--tmin``
(default 1e-4, the golden's), and prints for each render against the
reference's golden ``tests/goldens/path_stage7b.pfm`` (at 1e-4 only) and
against each other: relative RMSE, the share of pixels more than 1e-3
apart, and each channel's mean over the golden's.

Run it twice to see what the compiler alone moves: once as it is, and
once with the reference built without LLVM's optimisations,

    python tools/stage7b_knife_edge.py
    XLA_FLAGS=--xla_backend_optimization_level=0 python tools/stage7b_knife_edge.py
    python tools/stage7b_knife_edge.py --tmin 1e-2

from the repo root, with ``JAX_PLATFORMS=cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _stats(img, ref) -> str:
    rel = float(np.sqrt(np.mean((img - ref) ** 2))
                / max(np.sqrt(np.mean(ref ** 2)), 1e-20))
    apart = float((np.abs(img - ref).max(axis=2) > 1e-3).mean())
    means = img.mean(axis=(0, 1)) / ref.mean(axis=(0, 1))
    return (f"relative RMSE {rel:.6g}, pixels > 1e-3 apart {apart:.4%}, "
            f"channel means / reference {np.round(means, 5).tolist()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tmin", type=float, default=1e-4)
    args = ap.parse_args()

    from rayito_tpu.models import demo as jdemo
    from rayito_tpu.models.camera import PerspectiveCamera as JCam
    from rayito_tpu.render.pathtracer import render_path_with_stats
    from rayito_tpu.utils.config import RenderConfig as JConfig
    from rayito_tpu.utils.image import read_pfm
    from rayito_tpu_torch.models import demo as tdemo
    from rayito_tpu_torch.models.camera import PerspectiveCamera as TCam
    from rayito_tpu_torch.render.pathtracer import render_path
    from rayito_tpu_torch.utils.config import RenderConfig as TConfig

    kw = dict(width=96, height=64, pixel_samples=2, light_samples=1,
              max_depth=3, seed=1, ray_tmin=args.tmin)
    cam = dict(focal_distance=16.0, lens_radius=0.0, shutter_open=0.0,
               shutter_close=1.0)
    ref = np.asarray(render_path_with_stats(
        jdemo.stage7_scene2().compile(), JConfig(**kw),
        JCam.make(30.0, *jdemo.STAGE7_SCENE2_CAMERA, **cam))[0], np.float32)
    port = render_path(tdemo.stage7_scene2().compile("cpu"), TConfig(**kw),
                       TCam.make(30.0, *tdemo.STAGE7_SCENE2_CAMERA, **cam))
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
          f"epsilon {args.tmin:g}")
    if args.tmin == 1e-4:
        golden = read_pfm(os.path.join(HERE, "tests", "goldens",
                                       "path_stage7b.pfm"))
        print("reference vs golden: " + _stats(ref, golden))
        print("port vs golden:      " + _stats(port, golden))
    print("port vs reference:   " + _stats(port, ref))
    return 0


if __name__ == "__main__":
    sys.exit(main())
