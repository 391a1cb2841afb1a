"""Screen-sample generation shared by the integrators (counterpart of the
screen-space helpers in ``rayito_tpu/render/integrator.py``; the stage
1-4 direct integrators are not ported yet)."""

from __future__ import annotations

import torch

from ..ops import rng as rngo
from ..utils.config import RenderConfig


def _pixel_grid(width: int, height: int, device=None):
    """Row-major pixel coordinates (px, py), each [H * W] int32."""
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device),
        indexing="ij",
    )
    return px.reshape(-1), py.reshape(-1)


def screen_uv(config: RenderConfig, px, py, jx, jy):
    """Pixel indices + intra-pixel jitter -> [0,1]^2 screen coordinates
    (y flipped: image rows are top-down)."""
    div1 = config.pixel_div_minus_one
    w = float(config.width - 1 if div1 else config.width)
    h = float(config.height - 1 if div1 else config.height)
    xu = (px.to(torch.float32) + jx) / w
    yu = 1.0 - (py.to(torch.float32) + jy) / h
    if config.aspect_correction:
        aspect = float(torch.tensor(config.width, dtype=torch.float32)
                       / torch.tensor(config.height, dtype=torch.float32))
        xu = (xu - 0.5) * aspect + 0.5
    return xu, yu


def _subpixel_jitter(config: RenderConfig, px, py, si, spp_x: int,
                     spp_y: int):
    """Stratified CMJ jitter in the pixel, keyed by (pixel, purpose,
    seed)."""
    perm = rngo.hash_combine(px, py, rngo.PURPOSE_SUBPIXEL, config.seed)
    return rngo.cmj_sample_2d(si, spp_x, spp_y, perm)
