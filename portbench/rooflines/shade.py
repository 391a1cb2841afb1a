"""The work of the bounce's shading kernels, ``bounce_prepare_kernel`` and
``bounce_resolve_kernel`` (``rayito_tpu_torch/csrc/shade.cu``): the bytes
one launch must move, each input read once and each output written once,
as a function of its lanes and of the scene. Their arithmetic (a few
hundred flops a lane) bounds them far below the bytes, so the bytes set
the least time.

Per lane, at ``nls`` light samples (rows of float32 unless said):
  bounce_prepare reads the hit (t, valid byte, material, colour modifier,
  normal), the draw set (6 nls + 2 rows), alive (a byte), the Dirac count,
  throughput, origin, direction and result, and the lane's time if the
  scene moves; it writes 14 lane rows, the Dirac count and a byte, and per
  light sample 17 rows (13 with a mesh light), the chosen light and two
  bytes;
  bounce_resolve reads 14 lane rows and a byte, per light sample 15 rows
  (11 with a mesh light), the light index and two bytes, the normal,
  throughput, origin and direction, the lane's time if the scene moves,
  and each light sample's shadow results (a byte each with analytic
  lights, a hit record of 24 bytes with a mesh light); it writes 12 rows
  and a byte.
A launch also reads the scene tables it may touch, once (``tables``).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # one H100 SXM's HBM3, NVIDIA's data sheet
KERNELS = ("bounce_prepare_kernel", "bounce_resolve_kernel")


def lane_bytes(kernel: str, nls: int, motion: bool, analytic: bool) -> int:
    t = 4 if motion else 0
    if kernel == "bounce_prepare_kernel":
        reads = 4 + 1 + 4 + 4 + 12 + (6 * nls + 2) * 4 + 1 + 4 + 48 + t
        ls_rows = 17 if analytic else 13
        return reads + 14 * 4 + 4 + 1 + nls * (ls_rows * 4 + 4 + 2)
    if kernel == "bounce_resolve_kernel":
        ls_rows = 15 if analytic else 11
        queries = nls * (2 if analytic else 1 + 24)
        return (14 * 4 + 1 + nls * (ls_rows * 4 + 4 + 2) + 48 + t + queries
                + 12 * 4 + 1)
    raise ValueError(f"not a shading kernel: {kernel}")


def table_bytes(config: dict) -> int:
    """The scene tables a shading launch may read: materials, lights,
    rects, spheres, meshes' areas and, where anything moves, the keyed
    transforms (a mesh light's triangles besides)."""
    shapes = config["shapes"]
    named = {s["material"] for s in shapes
             if s["type"] in ("plane", "sphere", "mesh")}
    lights = [s for s in shapes if s["type"] in ("rect_light",
                                                 "sphere_light")]
    n_mat = len(named) + len(lights)
    n_rect = sum(s["type"] == "rect_light" for s in shapes)
    n_sph = sum(s["type"] in ("sphere", "sphere_light") for s in shapes)
    n_mesh = sum(s["type"] == "mesh" for s in shapes)
    total = (n_mat * (4 + 12 + 4) + len(lights) * (12 + 4 + 4)
             + n_rect * 36 + n_sph * 16 + n_mesh * 4)
    moving = [s["transform"] for s in shapes if s.get("transform")]
    if moving:
        slots = 1 + len(moving)
        keys = max(len(t["times"]) for t in moving)
        total += slots * keys * (4 + 12 + 12 + 16) + slots * 4
    return total


def least_seconds(launches: dict, lanes: int, nls: int, motion: bool,
                  analytic: bool, tables: int) -> float:
    """The least time of ``launches`` ({kernel: launch count}) of ``lanes``
    lanes each at the card's memory bandwidth."""
    total = sum(n * (lanes * lane_bytes(k, nls, motion, analytic) + tables)
                for k, n in launches.items())
    return total / PEAK_BYTES_PER_S
