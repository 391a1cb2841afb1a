"""Smoke test of the rayito_tpu_torch port on one CUDA GPU.

Run from the repo root: ``python3 chip_smoke.py``. It needs one Hopper
card (the kernels are built for sm_90a) and nvcc; it imports nothing of
JAX. Phases, each printed, each fatal on failure:

  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: nvcc compiles rayito_tpu_torch/csrc into a shared library;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at stage-6 shapes (131,072 camera, bounce and shadow rays on the
     n=64 bumpy stand-in, 392 clusters), with median times;
  4. frame: one full-size stage-6 frame (512x512, bench.py's config) through
     the entry point, counting every kernel's launches, checked against the
     same frame rendered with the plain versions; then 3 timed frames.

Prints a JSON line of per-kernel results, then, last, one JSON line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def _median_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _phase(name: str) -> None:
    print(f"== {name}", flush=True)


def main() -> int:
    import torch

    _phase("device")
    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke test needs a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")

    from rayito_tpu_torch.utils import cuda_lib

    _phase("build")
    info = cuda_lib.build(verbose=True)
    print(f"nvcc build: {info['seconds']:.2f} s (built={info['built']})")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    cuda_lib.library()
    return run(torch.device("cuda", 0), card)


# the stage-6 main path: bench.py's frame on the n=64 bumpy stand-in
MESH_N = 64
WIDTH = 512
RAYS_PER_PASS = 1 << 17  # 256-row bands of 131,072 rays


def stage6_setup(dev):
    """(scene, config, camera, frame) of the stage-6 frame on ``dev``;
    ``frame()`` renders sample 0 over every row band through
    ``_render_path_frame`` and returns (images, issued queries)."""
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.models.demo import (
        STAGE6_CAMERA,
        stage6_scene,
        write_bumpy_standin,
    )
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import cuda_lib
    from rayito_tpu_torch.utils.config import RenderConfig

    obj = os.path.join(cuda_lib.BUILD_DIR, f"bumpy_standin_n{MESH_N}.obj")
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    write_bumpy_standin(obj, n=MESH_N)
    scene = stage6_scene(obj).compile(dev)
    cfg = RenderConfig(width=WIDTH, height=WIDTH, pixel_samples=2,
                       light_samples=1, max_depth=3, aspect_correction=True,
                       max_rays_per_pass=RAYS_PER_PASS)
    cam = PerspectiveCamera.make(30.0, *STAGE6_CAMERA, focal_distance=16.0,
                                 lens_radius=0.0)
    band = cfg.max_rays_per_pass // cfg.width
    if cfg.height % band:
        raise ValueError("the frame must be a whole number of bands")
    row0s = list(range(0, cfg.height, band))

    def frame():
        imgs, _, q = pt._render_path_frame(scene, cfg, cam,
                                           [[0]] * len(row0s), row0s, band)
        return imgs, q

    return scene, cfg, cam, frame


def run(dev, card: str) -> int:
    """Phases 3-4 on ``dev``."""
    import numpy as np
    import torch

    from rayito_tpu_torch.accel.kernel_tables import KTRI
    from rayito_tpu_torch.ops.vec3 import V3
    from rayito_tpu_torch.render import trace as tr
    from rayito_tpu_torch.render import traverse as tv
    from rayito_tpu_torch.render.integrator import _pixel_grid, screen_uv
    from rayito_tpu_torch.utils.image import diagnose

    _phase("scene")
    t0 = time.perf_counter()
    scene, cfg, cam, frame = stage6_setup(dev)
    n_cl = scene.ktab_tri[0].shape[0]
    print(f"stage-6 scene with the n={MESH_N} stand-in: "
          f"{scene.tri_vm_rows.shape[0]} triangle rows, {n_cl} kernel "
          f"clusters (padded), box table {tuple(scene.ktab_box[0].shape)}; "
          f"{time.perf_counter() - t0:.1f} s")
    band = cfg.max_rays_per_pass // cfg.width

    _phase("kernels")
    # camera rays of the first band (pixel centres), their closest hits,
    # cosine-ish bounce rays from the hits and shadow rays to the light
    px, py = _pixel_grid(cfg.width, band, dev)
    half = torch.full(px.shape, 0.5, device=dev)
    xu, yu = screen_uv(cfg, px, py, half, half)
    o, d, _ = cam.make_rays(xu, yu, half, half, half)
    n = px.shape[0]
    hit = tr.scene_intersect(scene, o, d, None, cfg.ray_tmin, 1e30)
    rng = np.random.default_rng(0)
    rnd = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)).to(dev)
    nrm = hit.normal
    bd = V3(rnd[0] + 1.5 * nrm.x, rnd[1] + 1.5 * nrm.y, rnd[2] + 1.5 * nrm.z)
    inv = 1.0 / torch.sqrt(bd.x * bd.x + bd.y * bd.y + bd.z * bd.z)
    bd = bd * inv
    pos = o + d * torch.where(hit.valid, hit.t, 0.0)
    lpt = torch.from_numpy(rng.uniform(0, 1, (2, n)).astype(np.float32)).to(dev)
    light = V3(-1.5 + 3.0 * lpt[0], torch.full_like(lpt[0], 4.0),
               -1.5 + 3.0 * lpt[1])
    sd = light - pos
    dist = torch.sqrt(sd.x * sd.x + sd.y * sd.y + sd.z * sd.z)
    sd = sd * (1.0 / dist)
    alive = hit.valid
    cases = [
        ("camera", o, d, torch.full((n,), 1e30, device=dev), "bw", False),
        ("bounce", pos, bd, torch.where(alive, 1e30, 0.0), "bw", False),
        ("shadow", pos, sd, tr._occl_tmax_down(~alive, dist - cfg.ray_tmin),
         "vpu", True),
    ]
    box = scene.ktab_box[0]
    results = {}
    tmin = cfg.ray_tmin
    for name, co, cd, ctmax, mt, any_hit in cases:
        tri = scene.ktab_tri[0] if mt == "vpu" else scene.ktab_mxu[0]
        soat, perm, n_live = tv.prepare_rays(co, cd, ctmax, box, tmin)
        live = int(n_live)
        m_k = tv.cluster_masks(soat, box, tmin, n_live)
        m_p = tv.cluster_masks_plain(soat, box, tmin, n_live)
        torch.cuda.synchronize()
        bad_m = int((m_k != m_p).sum())
        mask_err = int((m_k.long() - m_p.long()).abs().max())
        t_k, p_k = tv.traverse_blocks(m_k, soat, tri, tmin, mt, any_hit,
                                      n_live)
        t_p, p_p = tv.traverse_blocks_plain(m_k, soat, tri, tmin, mt,
                                            any_hit, n_live)
        torch.cuda.synchronize()
        if any_hit:
            bad_p = int(((p_k >= 0) != (p_p >= 0)).sum())
            bad_t = 0
            t_err = 0.0
        else:
            bad_p = int((p_k != p_p).sum())
            bad_t = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
            fin = torch.isfinite(t_p)
            t_err = float((t_k[fin] - t_p[fin]).abs().max()) if fin.any() else 0.0
        hits = int((p_p >= 0).sum())
        print(f"{name}: {n} rays, {live} live steps of {soat.shape[0]}, "
              f"mask words differing {bad_m}, prim differing {bad_p}, "
              f"t bits differing {bad_t}, hits {hits}")
        if bad_m or bad_p or bad_t:
            raise AssertionError(f"{name}: kernel disagrees with plain")
        r = {
            "mask_ms": _median_ms(
                lambda: tv.cluster_masks(soat, box, tmin, n_live), 20),
            "mask_plain_ms": _median_ms(
                lambda: tv.cluster_masks_plain(soat, box, tmin, n_live), 3),
            "trav_ms": _median_ms(lambda: tv.traverse_blocks(
                m_k, soat, tri, tmin, mt, any_hit, n_live), 20),
            "trav_plain_ms": _median_ms(lambda: tv.traverse_blocks_plain(
                m_k, soat, tri, tmin, mt, any_hit, n_live), 3),
            "t_err": t_err,
            "mask_err": mask_err,
        }
        if not any_hit:
            found = p_k.view(-1) >= 0
            p_safe = torch.clamp_min(p_k.view(-1), 0)
            cl = p_safe // KTRI
            idx = torch.where(
                found, scene.ktab_base[0][cl.long()] + p_safe - cl * KTRI, 0
            ).to(torch.int32)
            for k, table in ((32, scene.tri_vm_rows), (16, scene.tri_vert_rows)):
                g_k = tv.gather_rows_t(table, idx)
                g_p = tv.gather_rows_t_plain(table, idx)
                torch.cuda.synchronize()
                bad_g = int((g_k.view(torch.int32) != g_p.view(torch.int32)).sum())
                r[f"gather{k}_err"] = float((g_k - g_p).abs().max())
                print(f"{name}: gather_rows_t [T, {k}] elements differing {bad_g}")
                if bad_g:
                    raise AssertionError(f"{name}: gather_rows_t disagrees")
                r[f"gather{k}_ms"] = _median_ms(
                    lambda: tv.gather_rows_t(table, idx), 50)
                r[f"gather{k}_plain_ms"] = _median_ms(
                    lambda: tv.gather_rows_t_plain(table, idx), 50)
        results[name] = r
        print(f"{name}: " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()),
              flush=True)

    _phase("frame")
    frame()  # warm-up
    torch.cuda.synchronize()
    tv.reset_launch_counts()
    imgs, queries = frame()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in tv.KERNELS}
    print(f"launches in one frame: {launches}")
    img = imgs.reshape(cfg.height, cfg.width, 3).cpu().numpy()
    diag = diagnose(img)
    print(f"frame {img.shape}: queries {int(queries)}, {diag}")
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the path was never launched")
    if diag["nan_pixels"] or diag["negative_pixels"] or not np.isfinite(img).all():
        raise AssertionError("NaN, infinite or negative pixels")
    if not img.max() > 0:
        raise AssertionError("black frame")

    # the same frame through the plain versions on the card
    saved = (tv.cluster_masks, tv.traverse_blocks, tr.gather_rows_t)
    tv.cluster_masks = tv.cluster_masks_plain
    tv.traverse_blocks = tv.traverse_blocks_plain
    tr.gather_rows_t = tv.gather_rows_t_plain
    try:
        t0 = time.perf_counter()
        imgs_p, q_p = frame()
        torch.cuda.synchronize()
        plain_frame_s = time.perf_counter() - t0
    finally:
        tv.cluster_masks, tv.traverse_blocks, tr.gather_rows_t = saved
    img_p = imgs_p.reshape(cfg.height, cfg.width, 3).cpu().numpy()
    rel = float(np.sqrt(np.mean((img - img_p) ** 2))
                / max(np.sqrt(np.mean(img_p ** 2)), 1e-20))
    print(f"plain-version frame: queries {int(q_p)}, {plain_frame_s:.2f} s; "
          f"relative RMSE vs kernels {rel:.3e}; max abs diff "
          f"{float(np.abs(img - img_p).max()):.3e}")
    if rel > 0.005:
        raise AssertionError(f"frame relative RMSE {rel} > 0.5%")

    n_frames = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qs = [frame()[1] for _ in range(n_frames)]
    torch.cuda.synchronize()
    frame_s = (time.perf_counter() - t0) / n_frames
    q_frame = sum(int(q) for q in qs) / n_frames
    mrays = q_frame / frame_s / 1e6
    print(f"stage-6 frame (n={MESH_N} stand-in, {WIDTH}x{WIDTH}, sample 0, "
          f"{cfg.height // band} bands): "
          f"{frame_s * 1e3:.1f} ms/frame, {q_frame:.0f} issued queries, "
          f"{mrays:.3f} Mrays/s on {card}")

    src = "rayito_tpu_torch/csrc/"
    ref = "rayito_tpu/render/pallas_traverse.py:"
    cam_r = results["camera"]
    kernels = [
        {"name": "cluster_masks", "route": "cuda",
         "source": src + "cluster_masks.cu", "replaces": ref + "1184",
         "launches": launches["cluster_masks"],
         "max_abs_err": max(r["mask_err"] for r in results.values()),
         "ms": cam_r["mask_ms"], "plain_ms": cam_r["mask_plain_ms"]},
        {"name": "traverse_blocks", "route": "cuda",
         "source": src + "traverse_blocks.cu", "replaces": ref + "488",
         "launches": launches["traverse_blocks"],
         "max_abs_err": max(r["t_err"] for r in results.values()),
         "ms": cam_r["trav_ms"], "plain_ms": cam_r["trav_plain_ms"]},
        {"name": "gather_rows_t", "route": "cuda",
         "source": src + "gather_rows_t.cu", "replaces": ref + "1141",
         "launches": launches["gather_rows_t"],
         "max_abs_err": max(r[k] for r in results.values() for k in r
                            if k.startswith("gather") and k.endswith("_err")),
         "ms": cam_r["gather32_ms"], "plain_ms": cam_r["gather32_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
