"""Render configuration (counterpart of ``rayito_tpu/utils/config.py``, ported
as it is: numpy-free plain Python).

One dataclass replaces the reference's scattered compile-time constants
(Rayito_Stage3/main.cpp:88-93), stage-4 hint variables, and Qt spinboxes
(Rayito_Stage7_QT/MainWindow.ui defaults — SURVEY §2.10)."""

from __future__ import annotations

import dataclasses

from ..ops.vec3 import RAY_TMIN, RAY_TMIN_EARLY


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 640
    height: int = 480
    pixel_samples: int = 1  # per-axis hint: total spp = pixel_samples**2
    light_samples: int = 1  # per-axis hint: numLightSamples = light_samples**2
    max_depth: int = 3
    # tone mapping (GUI defaults)
    gamma: float = 2.2
    exposure: float = 0.0
    # camera defaults (GUI spinboxes)
    fov_degrees: float = 30.0
    focal_distance: float = 16.0
    lens_radius: float = 0.0
    shutter_open: float = 0.0
    shutter_close: float = 1.0
    # numeric-fidelity switches (SURVEY §2.11)
    ray_tmin: float = RAY_TMIN  # 1e-4 (stage 4+); stages 1-3 pass 1e-5
    pixel_div_minus_one: bool = False  # stages 1-2 divide by (w-1)/(h-1)
    aspect_correction: bool = True  # stage 5+ RenderThread xu aspect fix
    # RNG seed for the whole frame
    seed: int = 1
    # wavefront sizing: rays per device launch (pixels*spp chunked to this).
    # 256k lanes keeps the cluster-expansion intermediates ([N, K1*16, 3]
    # box gathers) comfortably inside HBM.
    max_rays_per_pass: int = 1 << 18


CONFIG_STAGE123 = RenderConfig(
    width=512,
    height=512,
    ray_tmin=RAY_TMIN_EARLY,
    pixel_div_minus_one=True,
    aspect_correction=False,
)
