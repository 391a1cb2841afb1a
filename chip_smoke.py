"""Smoke test of the rayito_tpu_torch port on one CUDA GPU.

Run from the repo root: ``python3 chip_smoke.py``. It needs one Hopper
card (the kernels are built for sm_90a) and nvcc; it imports nothing of
JAX. Phases, each printed, each fatal on failure:

  1. device: CUDA must be available; prints the card's name and power limit;
  2. build: nvcc compiles rayito_tpu_torch/csrc into a shared library, one
     process per source, all started together; then phase 24 (the sample
     streams), so a wrong sample kernel stops the run early, and phase 26
     (the scalar divisions);
  3. kernels: each CUDA kernel of the stage-6 path against its plain
     PyTorch version on the card, at stage-6 shapes (131,072 camera, bounce
     and shadow rays on the n=64 bumpy stand-in, 392 clusters), with median
     device times (CUDA-graph replays of 20 calls, so the host's launch
     cost stays out; the time around one call beside them), each kernel's
     bound (the least time for its work on an H100 SXM:
     operations at 67 TFLOP/s f32 or bytes at 3.35 TB/s, counted from this
     run's masks) and its share of it, and for gather_rows_t the time of
     the one PyTorch call that computes the same result (library_ms);
  4. frame: one full-size stage-6 frame (512x512, bench.py's config) through
     the dispatch (``_render_path_frame``: one replay of the pass graph per
     launch), counting every kernel's launches, checked against the same
     frame rendered with the plain versions through the eager pass body;
     then one timed frame; then phase 27 (the shading kernels);
  5. big-scene kernels: the big scene (five n=64 stand-ins, 245,760
     triangles, 1,920 clusters) and its camera, bounce and shadow
     populations of one 131,072-ray band: each of the five kernels against
     its plain version (bounds and shares as in phase 3): build_items bit
     for bit on all four outputs at the reference's budget (24,576 items,
     64 per block) and at one that never overflows, with the item counts
     and overflow flags; traverse_items against its plain version and
     against traverse_blocks (t bits and prim); traverse_items,
     traverse_blocks and build_items timed by CUDA-graph replay in the same
     run (scan_vs_items: the scan's time over the item kernel's;
     build_items is one single-pass launch a call); the item
     route against the scan route through traverse();
  6. big-scene frame: the 512x512 frame of tools/bench_big_scene.py (1 spp,
     depth 3, 131,072-ray bands) with traverse_items=True at the budget
     that never overflows, counting every kernel's launches, checked
     against the plain versions, the scan route and the reference's budget
     (both bit-identical; that budget's overflow share is printed); then
     one timed frame of the item route and one of the scan route;
  7. stage-7 kernels: stage7_scene1 on the n=64 stand-in, whose mesh is a
     traversal domain of its own under a three-key rotation; camera,
     bounce and shadow populations of one band at seeded lane times, moved
     into the domain's local space at those times, through cluster_masks,
     traverse_blocks and gather_rows_t against their plain versions (bit
     for bit, timed and bounded as in phase 3);
  8. stage-7 frame: 512x512, 1 spp, depth 3, shutter 0..1, counted and
     checked against the plain versions as in phase 4 (fold_small 18
     times: once per query on each band), then one timed frame; the
     cube's fold_small calls of its first band against their plain twin;
  9. stage-7b frame: bench.py's stage-7b config (stage7_scene2, 512x256,
     1 spp, depth 3, shutter 0..1): no traversal launch (no domain), and
     gather_rows_t, cmj and fold_small launched, fold_small once per query
     for all ten cubes (9 launches); the tiny meshes' meta-row gather
     against its plain version on the eager frame's own inputs, and
     fold_small against its plain twin (fold_small_query_plain) on every
     query of that frame, closest and any hit, every output bit for bit
     (t, prim, beta, gamma, the winner's rotation; occluded), timed and
     bounded (flops at 67 TFLOP/s, instructions at the issue limit, or
     bytes); the same on a one-key scene (the K == 1 table), a cube in a
     turning group (a chain of depth 2), at lane times outside the keys,
     a 192-row mesh of twin rows (every hit to the lower twin) and stage
     7b's cubes cut into four chained launches a query;
     that eager frame bit-identical to the replayed one, one timed frame;
 10. stage-5 frame: stage5_scene (no mesh) at 512x512, 1 spp, depth 3: no
     kernel launch but the sample streams', the analytic fold's and the
     shading's (which must launch), no NaN or
     negative pixel, the eager frame bit-identical, host launches
     counted, one timed frame;
 11. mesh-light kernels: the stage-6 geometry with the n=64 stand-in
     wrapped as a ShapeLight in place of the sphere light (49,152 light
     triangles behind one area CDF). sample_light of the mesh light on the
     card against the same call on the CPU (identical triangle picks, pdf
     to 1e-5 relative). Then three populations of one band through
     cluster_masks, traverse_blocks and gather_rows_t against their plain
     versions (bit for bit, timed and bounded as in phase 3): camera rays;
     the BRDF-side closest-hit rays NEE sends when a mesh light is present,
     whose dead lanes carry tmax = tmin; the light-side shadow rays, which
     end on a triangle of the traversed mesh. Each population once more
     through the item route (traverse_items, build_items) against the scan;
 12. mesh-light frame: 512x512, 1 spp, depth 3, counted (closest-hit and
     any-hit launches apart) and checked against the plain versions as in
     phase 4, then one timed frame;
 13. many-shape frames: 40 spheres and 16 lights at 512x512, 1 spp,
     depth 3, each through analytic_fold against the same frame through
     its plain twin with one row per batch (the fold shape by shape,
     through the eager body): bit for bit, with
     the batched form's host launches; and each lane's chosen light against the
     per-light functions evaluated for all 16 lights, bit for bit;
 14. stages 1-4: the direct integrators at CONFIG_STAGE123, 512x512, on the
     card (no traversal launch): stage 1's quantised PPM byte-equal to the
     CPU's; stage 2 (64 unstratified samples) and stage 3 (4x4 pixel x 4x4
     light samples, the golden configuration; stage 4 renders the same)
     timed at 512x512 and held against the CPU at 128x128
     (the CPU's time cuts the size), no kernel launch but the sample
     streams' (stages 2-3 draw) and the analytic fold's: stage 2 within
     0.5%; stage 3, a
     float32 knife edge (a sphere light's shadow ray ends on the light),
     by its channel means and its share of agreeing pixels, and its
     geometry and shading without the sphere light (1e-2 epsilon) within
     0.5%;
 15. the CLI in process: ``cli.main`` on stage 6 at its defaults (640x480,
     2x2 samples, depth 3, the n=64 stand-in, --pfm) with the launch
     counts set to 0 just before it and read just after (masks, traversal
     and gather must launch; the run captures its graph, so its counts
     hold the capture's eager warm-up pass beside the replays), and once
     more in one replayed render_path_with_stats frame; its PFM
     bit-identical to
     render_path_with_stats on the same inputs, to --sharded over the one
     card, and to a run stopped after its first sample and resumed from
     --checkpoint; the stats line (queries, seconds, Mrays/s);
 16. traversal='xla' (the two-level cluster pipeline), stage 6: one band's
     camera, bounce and shadow populations (131,072 rays each) and the
     420-layer stack crossed end-on (which truncates at both levels) and
     slivers whose boxes all tie (the tie rule decides every cut),
     through the cluster_pipeline kernel for every mesh against its plain
     version on the card, bit for bit (t, prim, per-slot overflow), with
     device times (CUDA-graph replays of 20 calls), the plain version's
     time and the bound of this run's work (the larger of the warp
     instructions counted from the SASS at the issue limit, 24 flops per
     slab test and 46 per Möller-Trumbore test of the kept superclusters'
     children and the kept clusters' triangles, and the bytes); every 8th
     ray (16,384) through
     mesh_intersect_clusters on the card against the CPU (t, beta and
     gamma bits, prim and overflow equal); the [T, 16] vertex and meta
     rows the route gathers for the camera rays through gather_rows_t
     against its plain version, timed and bounded;
 17. the stage-6 frame of phase 4 under 'xla', its passes replayed graphs:
     cluster_pipeline and gather_rows_t launched and no kernel of the
     other route, the same frame through the eager pass body with the
     plain versions bit for bit (overflow and queries too), the kernel
     route's replayed frame within 0.5% when nothing overflowed (printed
     beside it otherwise), and one timed frame;
 18. the big-scene frame of phase 6 under 'xla' (its five meshes one by
     one): overflow and its share of the queries, the relative RMSE
     against the scan route, checked and timed as in phase 17;
 19. the stage-7 frame under 'xla', checked and timed as in phase 17;
 20. cli.main at its defaults under RAYITO_TRAVERSAL=xla: the launch
     counts as in phase 17, its passes graph replays (counted), the stats
     line naming the traversal and the pipeline's cluster count, its PFM
     bit-identical to render_path_with_stats under 'xla';
 21. ``python -m rayito_tpu_torch.cli --scene stage1`` in a subprocess with
     no --device: it must render on cuda;
 22. one profiled, replayed 512x512 stage-6 frame on each route: host
     kernel and graph launches, kernel ms, the share of that frame's wall
     ms they fill, and its costliest kernels by name
     (utils/profiling.collect_device_ops; 'xla' with device time in the
     cluster_pipeline kernel);
 23. graphs, the reference's dispatch (each pass a CUDA graph captured once
     and replayed): the frames of phases 4, 6 (item and scan route), 8-10,
     12, 13 and 14 (stage 3 at its golden configuration), the CLI's
     render, and under 'xla' the frames of phases 17-19 and the CLI's
     render, each replayed frame against the same frame through the eager
     pass body, bit for bit with its queries (and overflow under 'xla');
     per frame the capture ms
     (warm-up run included), pool MB, frame ms (mean of 3 on the host
     clock, and by CUDA events), the kernel launches of one replayed frame,
     and of one profiled replayed frame its device ops, kernel ms, wall ms
     and busy share (their ratio), host kernel and graph launches, and
     each kernel's launches from the device records, which must equal its
     counter (stage 3 not profiled: 16 replays of 26,574 device ops);
 24. sample streams (run right after the build): the single draws
     hash_combine, cmj_sample_1d and cmj_sample_2d (torch ops, no kernel;
     the fixed cycle-walk rounds on the card) against the same calls on
     the CPU, bit for bit, at 131,072 lanes, with no cmj launch: 1-D
     samples of seeded permutations at every num in 1-300, 1,000 and
     4,097; every draw of the path's patterns at pixel samples
     {1, 2, 3, 12} x light samples {1, 2}; the draw sets (cmj_draws, one
     launch of cmj_draws_kernel a set, csrc/cmj.cu) of every renderer's
     plan at the same patterns against cmj_draws_plain; stage 6's bounce
     and camera sets and stage 3's light loop (4x4 light samples, two
     lights) timed (CUDA-graph replays of 20 sets), the plain version
     beside them, the bound (the set's own arithmetic in lane
     instructions, counted in the kernel's SASS without its plan
     decoding, loop control or addressing, at the SMs' issue rate of 33.4
     T/s, or bytes at 3.35 TB/s) and share, and each set's launches read
     from the device counter (one for stage 6's bounce and camera sets);
 25. degenerate inputs: one lane (stage 6 at 1x1), a scene with no mesh
     and no light, and the 'xla' route on 128 lanes, each pass captured,
     replayed twice and bit-identical to its eager body;
 26. scalar divisions (run after phase 24): the CLI's 640x480 camera rays
     (2x2 samples) on the card bit-identical to the CPU's; one replayed
     stage-6 pass's radiance (128x128, depth 3) bit-identical to the
     CPU's once both take the card's sin, cos and pow (the values the
     CPU's own library moves printed); and utils/div_audit.ScalarDivisions
     over one eager pass of every path above at 64x32 (cli.main too,
     plain and --sharded): no division by a Python or CPU scalar and no
     float32 root outside sqrt_ieee left on any of them;
 27. shading kernels (run after phase 4): bounce_prepare and
     bounce_resolve (csrc/shade.cu) against their plain versions on the
     card, every output bit for bit, on the inputs the eager pass body
     hands them: stage 6's first band at bounces 0 and 1, stage 7's first
     band at seeded lane times in [-0.5, 1.5] (its keyed rect and sphere
     lights), the box mesh light at light_samples=2 (the BRDF-side
     closest-hit branch), the 16-light scene at light_samples 1 and 2, 65
     sphere lights and a sphere light nine groups deep (at seeded lane
     times), past the 64 lights and 8 links the kernel once took by value:
     each scene's light table and chain slots read from the scene's device
     tables (SceneData.light_table, light_slots);
     stage 6's bounce 0 timed (CUDA-graph replays of 20 calls, each after
     an 80 MB write that evicts the inputs from L2, less the write's time;
     and back to back), beside the plain versions, with each kernel's bound (bytes at 3.35 TB/s: each
     input read once, each output written once; or SHADE_OPS at 67
     TFLOP/s) and share;
 28. analytic folds (run after phase 8): analytic_fold
     (csrc/analytic_fold.cu) against its plain twin on the card, every
     output bit for bit (t, shape id, material, normal, color_mod;
     occluded), on one 131,072-lane band at bounce 0 of stage 6 and of
     stage 7 (at seeded lane times): the camera and bounce rays' closest
     hit and the shadow rays' any hit; each timed (CUDA-graph replays of
     20 calls) beside the plain twin, with its bound (the larger of the
     lane instructions from the SASS, AF_INSNS, at the issue limit and the
     bytes at 3.35 TB/s) and share. Every query of every path launches
     analytic_fold once (stage 7's frame: 18, counted in phase 8);
 29. traversal plumbing (run after phase 28): ray_pack, ray_reorder and
     ray_unsort (csrc/ray_prep.cu) against their plain twins on the card,
     every output bit for bit, at the cells' shape (262,144 lanes, the
     stable sort) on stage 6's bounce and shadow rays: each timed (20 calls
     in a CUDA graph between events, each after an 80 MB write that evicts
     L2, less its time, and back to back) beside its plain twin, the
     torch.sort between them, the torch calls the kernels replaced (the
     soa8[perm] gather, the index_put unsort) as library_ms, and the bound
     (bytes at 3.35 TB/s: each input byte read once, each output byte
     written once);
     and a whole call's plumbing (prepare_rays and the unsort) through the
     kernels and through the plain twins. Every traverse() call launches
     each of the three once (stage 6's frame: 18, counted in phase 4).

Every frame that draws samples launches cmj (all but stage 1's); every
path-trace frame launches bounce_prepare and bounce_resolve once per
bounce and pass, read from the device counters (phases 4-13 and 23); the
plain-version frames swap all fourteen kernels for their plain versions
(``_swap_plain``), the sample streams, the tiny-mesh fold, the shading,
the analytic fold and the traversal's plumbing included.
Launches are counted with tracing on (``utils/tracing.py``): each kernel
wrapper adds one to its ``launches.<kernel>`` counter, which a captured
graph books at every replay (``utils/cuda_lib.launch_counts``). A phase
that counts turns tracing on around its counted frame and the captures
before it (its traced graphs), and captures the untraced graphs after it
for what it times; the counts are set to 0 after a frame that captured
its graphs, so a counted frame is replays only unless said otherwise. Host launches are counted as kernel and graph launches (cudaLaunchKernel,
cudaGraphLaunch). Every phase's graphs are freed
(``utils/graphs.clear()``) before the next phase.

Prints a JSON line of phase 23's numbers per frame, a JSON line of
per-kernel results (camera-ray times; launches in the frame of the path
each kernel serves first, and per frame, the 'xla' frames and the
replayed frames included; per stage-7, mesh-light and 'xla' population),
then, last, one JSON line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
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


def _device_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed between two events (median of ``replays``), per
    call; the host's launch cost stays out. ``fn`` must not synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _median_ms(graph.replay, replays) / reps


def _fmt(r: dict) -> str:
    """key value pairs, numbers unrounded to 6 significant digits."""
    return ", ".join(f"{k} {v:.6g}" if isinstance(v, (int, float))
                     else f"{k} {v}" for k, v in r.items())


def _tracing():
    """utils/tracing.on(): the launch counters count only with tracing on,
    so a phase that reads them turns it on around what it counts, the
    captures of its graphs included."""
    from rayito_tpu_torch.utils import tracing

    return tracing.on()


def _phase(name: str) -> None:
    print(f"== {name}", flush=True)


def main() -> int:
    import torch

    t_start = time.perf_counter()
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
    from rayito_tpu_torch.utils import graphs

    dev = torch.device("cuda", 0)
    phases = [lambda: run_samples(dev, card),
              lambda: run_divisions(dev, card),
              lambda: run(dev, card), lambda: run_shade(dev, card),
              lambda: run_big(dev, card),
              lambda: run_stage7(dev, card), lambda: run_analytic(dev, card),
              lambda: run_plumbing(dev, card),
              lambda: run_stage7b(dev, card),
              lambda: run_stage5(dev, card),
              lambda: run_mesh_light(dev, card), lambda: run_many(dev, card),
              lambda: run_direct(dev, card), lambda: run_cli(dev, card),
              lambda: run_xla(dev, card), run_cli_subprocess,
              lambda: run_frame_profile(dev), lambda: run_graphs(dev, card),
              lambda: run_probes(dev, card)]
    outs = []
    for phase in phases:
        t0 = time.perf_counter()
        outs.append(phase())
        graphs.clear()  # the pools of one phase's graphs go with it
        print(f"-- phase done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    (samples, _, stage6, shading, big, stage7, analytic, plumbing, stage7b,
     stage5, mesh_light, _, direct, cli, xla, _, _, by_graph, _) = outs

    records = kernel_records(samples, stage6, big, stage7, stage7b, stage5,
                             mesh_light, xla, shading, analytic, plumbing)
    for k in records:
        k["launches_frame"]["stages1_4"] = direct["launches"][k["name"]]
        k["launches_frame"]["cli_stage6"] = cli["launches"][k["name"]]
        k["launches_frame"]["cli_main"] = cli["main_launches"][k["name"]]
        for path in ("stage6", "big", "stage7", "cli"):
            k["launches_frame"][path + "_xla"] = \
                xla[path]["launches"][k["name"]]
        for path, r in by_graph.items():
            k["launches_frame"][path + "_graph"] = r["launches"][k["name"]]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"graphs": {k: {m: v for m, v in r.items()
                                     if m != "launches"}
                                 for k, r in by_graph.items()}}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_records(samples: dict, stage6: dict, big: dict, stage7: dict,
                   stage7b: dict, stage5: dict, mesh_light: dict,
                   xla: dict, shading: dict, analytic: dict,
                   plumbing: dict) -> list:
    """The fourteen kernels' records: launches (device-counted, replays
    included) in the replayed frame of the path each serves first (stage 6;
    the big scene for the item route; the 'xla' stage-6 frame for
    cluster_pipeline; stage 7b for fold_small) and per frame of each path;
    errors
    over every population; camera-ray times with
    their bounds (big_* for the big scene); per stage-7 population (rays in
    the moving domain's local space) and per mesh-light population the
    times, bounds and shares of the stage-6 kernels, and the stage-7b
    frame's meta-row gather, and the 'xla' route's vertex and meta rows."""
    src = "rayito_tpu_torch/csrc/"
    ref = "rayito_tpu/render/pallas_traverse.py:"
    cam_r, big_cam = stage6["results"]["camera"], big["results"]["camera"]
    launches, big_launches = stage6["launches"], big["launches"]
    big_res = big["results"].values()
    s6_res = [*stage6["results"].values(), *stage7["results"].values(),
              *mesh_light["results"].values()]
    pipe = xla["pipeline"]
    # the stage-6 mesh with the most camera-ray work (the bumpy stand-in)
    main_mesh = max(pipe["camera"],
                    key=lambda m: pipe["camera"][m]["tri_tests"])

    def timed(r, key, big_key=None):
        """ms, plain_ms, bound_ms, bound_by, library_ms of ``key`` in r,
        and the big scene's ms and bound_ms (of ``big_key``)."""
        out = {"ms": r[key + "_ms"], "plain_ms": r[key + "_plain_ms"],
               "bound_ms": r[key + "_bound_ms"],
               "bound_by": r[key + "_bound_by"],
               "library_ms": r.get(key + "_library_ms")}
        if big_key:
            out.update(big_ms=big_cam[big_key + "_ms"],
                       big_plain_ms=big_cam[big_key + "_plain_ms"],
                       big_bound_ms=big_cam[big_key + "_bound_ms"])
        return out

    def per_population(key, path=stage7):
        return {name: {k: r[f"{key}_{k}"] for k in
                       ("ms", "plain_ms", "bound_ms", "share", "library_ms")
                       if f"{key}_{k}" in r}
                for name, r in path["results"].items()
                if f"{key}_ms" in r}

    kernels = [
        {"name": "cluster_masks", "route": "cuda",
         "source": src + "cluster_masks.cu", "replaces": ref + "1184",
         "launches": launches["cluster_masks"],
         "max_abs_err": max(r["mask_err"] for r in [*s6_res, *big_res]),
         **timed(cam_r, "mask", "mask"), "stage7": per_population("mask"),
         "mesh_light": per_population("mask", mesh_light)},
        {"name": "traverse_blocks", "route": "cuda",
         "source": src + "traverse_blocks.cu", "replaces": ref + "488",
         "launches": launches["traverse_blocks"],
         "max_abs_err": max(r["t_err"] for r in s6_res),
         **timed(cam_r, "trav", "scan"), "stage7": per_population("trav"),
         "mesh_light": per_population("trav", mesh_light)},
        {"name": "gather_rows_t", "route": "cuda",
         "source": src + "gather_rows_t.cu", "replaces": ref + "1141",
         "launches": launches["gather_rows_t"],
         "max_abs_err": max(
             r[k] for r in [*s6_res, *big_res,
                            *stage7b["results"].values(), xla["gathers"]]
             for k in r if k.endswith("_err") and
             (k.startswith("gather") or k.startswith("meta")
              or k.startswith("xla"))),
         **timed(cam_r, "gather32", "gather32"),
         "stage7": per_population("gather32"),
         "mesh_light": per_population("gather32", mesh_light),
         "stage7b": {k: stage7b["results"]["meta"]["meta_" + k]
                     for k in ("ms", "plain_ms", "bound_ms", "share",
                               "library_ms")},
         "xla": {rows: {k: xla["gathers"][f"{rows}_{k}"]
                        for k in ("ms", "plain_ms", "bound_ms", "share",
                                  "library_ms")}
                 for rows in ("xla_vert", "xla_meta")}},
        {"name": "traverse_items", "route": "cuda",
         "source": src + "traverse_items.cu", "replaces": ref + "314",
         "launches": big_launches["traverse_items"],
         "max_abs_err": max(r["items_t_err"] for r in big_res),
         "mesh_light_lanes_differing": mesh_light["items_route_differing"],
         **timed(big_cam, "items")},
        {"name": "build_items", "route": "cuda",
         "source": src + "build_items.cu", "replaces": ref + "262",
         "launches": big_launches["build_items"],
         "max_abs_err": max(r["build_err"] for r in big_res),
         **timed(big_cam, "build_items")},
        {"name": "cluster_pipeline", "route": "cuda",
         "source": src + "cluster_pipeline.cu",
         "replaces": "rayito_tpu/render/mesh_intersect.py:186",
         "note": "port-only: the body of the reference's XLA while_loop "
                 "(mesh_intersect.py:283), no pallas_call",
         "launches": xla["stage6"]["launches"]["cluster_pipeline"],
         "max_abs_err": max(r["pipe_err"] for pop in pipe.values()
                            for r in pop.values()),
         **timed(pipe["camera"][main_mesh], "pipe"),
         "populations": {f"{name}_mesh{m}": {
             k: r[f"pipe_{k}"] for k in ("ms", "plain_ms", "bound_ms",
                                         "share")}
             for name, pop in pipe.items() for m, r in pop.items()}},
        {"name": "cmj", "route": "cuda", "source": src + "cmj.cu",
         "replaces": "rayito_tpu/ops/rng.py:74",
         "note": "port-only: the reference's XLA uint32 sample streams "
                 "(ops/rng.py:74-205, cmj_permute's while_loop at :134), no "
                 "pallas_call; ms is stage 6's bounce draw set (every seed "
                 "and sample of one bounce, one cmj_draws_kernel launch)",
         "launches": launches["cmj"],
         "max_abs_err": samples["max_abs_err"],
         **timed(samples, "draw"),
         "sets": {key: {k: samples[f"{key}_{k}"] for k in
                        ("ms", "plain_ms", "bound_ms", "share", "launches")}
                  for key in ("draw", "camera_set", "direct_set")}},
        {"name": "fold_small", "route": "cuda",
         "source": src + "fold_small.cu",
         "replaces": "rayito_tpu/render/trace.py:628",
         "note": "port-only: the reference's loop over its tiny meshes "
                 "(render/trace.py:628-650: each mesh's transform chain and "
                 "its XLA dense fold _brute_force_mesh), no pallas_call; one "
                 "launch per query for all ten cubes; ms per launch, the "
                 "mean over the stage-7b frame's 9 queries",
         "launches": stage7b["launches"]["fold_small"],
         "max_abs_err": stage7b["fold"]["err"],
         **{k: stage7b["fold"][k] for k in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
    ]
    main_pop = shading["stage6_b0"]
    shade_err = max(r["shade_err"] for r in shading.values())
    for key, line in (("prepare", 150), ("resolve", 338)):
        kernels.append({
            "name": "bounce_" + key, "route": "cuda",
            "source": src + "shade.cu",
            "replaces": f"rayito_tpu/render/pathtracer.py:{line}",
            "note": "port-only: the XLA-fused bounce body of the "
                    "reference's pathtrace_wave (pathtracer.py:150-305 "
                    "before the shadow queries, :338-396 after them), no "
                    "pallas_call; ms, bound and share of stage 6's first "
                    "band at bounce 0 (131,072 lanes), each call after an "
                    "80 MB write that evicts its inputs from L2 (warm_ms: "
                    "back to back); launches once per bounce and pass",
            "launches": launches["bounce_" + key],
            "max_abs_err": shade_err,
            **{k: main_pop[f"{key}_{k}"] for k in
               ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "share": main_pop[f"{key}_share"],
            "warm_ms": main_pop[f"{key}_warm_ms"],
            "bytes": main_pop[f"{key}_bytes"],
            "populations": {name: {k: r[k] for k in (
                "lanes", "light_samples", "alive_lanes", "queries")}
                for name, r in shading.items()}})
    kernels.append({
        "name": "analytic_fold", "route": "cuda",
        "source": src + "analytic_fold.cu",
        "replaces": "rayito_tpu/render/trace.py:176",
        "note": "port-only: the reference's XLA fold over its planes, "
                "spheres and rects (render/trace.py:176-387, "
                "_analytic_occluded :777), each keyed row's transform chain "
                "inside it, no pallas_call; ms, bound and share of stage 6's "
                "first band's camera rays (131,072 lanes); one launch per "
                "closest or any-hit query",
        "launches": launches["analytic_fold"],
        "max_abs_err": 0.0,
        **{k: analytic["stage-6 camera"][k] for k in
           ("ms", "plain_ms", "bound_ms", "bound_by", "share")},
        "library_ms": None,
        "populations": analytic})
    main_call = plumbing["bounce"]
    for key, line in (("pack", "pack"), ("reorder", "gather"),
                      ("unsort", "unsort")):
        kernels.append({
            "name": "ray_" + key, "route": "cuda",
            "source": src + "ray_prep.cu",
            "replaces": "rayito_tpu/render/pallas_traverse.py:traverse",
            "note": "port-only: the reference's XLA plumbing around its "
                    "coherence sort (ray packing, _coherence_key, the "
                    "gather and the unsort), no pallas_call; ms, bound and "
                    "share of stage 6's bounce rays at the cells' 262,144 "
                    "lanes; library_ms the torch call it replaced (" + line
                    + "); one launch per traverse() call",
            "launches": launches["ray_" + key],
            "max_abs_err": 0.0,
            **{k: main_call[f"{key}_{k}"] for k in
               ("ms", "plain_ms", "bound_ms", "bound_by", "share")},
            "library_ms": main_call.get(f"{key}_library_ms"),
            "populations": plumbing})
    for k in kernels:
        k["launches_frame"] = {
            "stage6": launches[k["name"]],
            "big_scene": big_launches[k["name"]],
            "stage7": stage7["launches"][k["name"]],
            "stage7b": stage7b["launches"][k["name"]],
            "stage5": stage5["launches"][k["name"]],
            "mesh_light": mesh_light["launches"][k["name"]]}
    return kernels


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): f32
# outside the tensor cores, and device memory. With -fmad=false no multiply
# and add fuse, so the kernels here can reach at most half the f32 rate.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
TEST_OPS = {"bw": 31, "vpu": 46}  # flops of one (ray, triangle) test
SLAB_OPS = 24  # flops of one (ray, box) slab test
# flops of one link of a keyed transform in csrc/fold_small.cu: the ray's
# point and direction to local space (36 + 33, the divisions by the scale
# included), and with more than one key per slot the key pair's frac, the
# lerps and the normalised nlerp (47, its square root and reciprocal
# included); the chain's quaternion products are not counted
XF_FLOPS = {"link": 69, "keyed": 47}
# Instructions issued, counted from the SASS (tools/cmj_sass.py --kernels
# cluster_pipeline_kernel,fold_small_kernel on sm_90a, each loop's
# float_loads): the float instructions of a test (arithmetic, compares,
# selects, the IEEE division's MUFU.RCP and FCHK) and the loads of its
# data, the same rule for both kernels; integer, address and control work
# is left out, so the bounds stay lower bounds. fold_small, lane
# instructions per triangle test: its unrolled test loop's 336 for four
# tests on a closest-hit query, 332 on an any-hit one; a link of a
# transform chain is counted at one instruction per flop (XF_FLOPS).
# cluster_pipeline, warp instructions: its slab-test loop's 35 per
# iteration (two kept superclusters' 32 children), its triangle loop's 340
# per four tests a lane (a slot's 48 x n2 candidates take ceil(48 n2 / 32)
# tests a lane); the phase-1 row loop and the sorts are not counted.
FOLD_INSNS = {"closest": 336 / 4, "any": 332 / 4}
PIPE_INSNS = {"slab": 35, "test": 340 / 4}


def _bound(ops: float, nbytes: float):
    """(ms, "operations" | "bytes"): the least time for the work."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _listed(masks, n_clusters: int):
    """(listed (ray block, cluster) pairs, distinct clusters listed) of a
    mask table, clusters past the tri table left out as the kernels do."""
    import torch

    bits = torch.stack([(masks >> k) & 1 for k in range(32)], dim=2)
    bits = bits.reshape(masks.shape[0], -1)[:, :n_clusters]
    return int(bits.sum()), int(bits.any(dim=0).sum())


def _put_bound(r, key, ops, nbytes):
    r[key + "_bound_ms"], r[key + "_bound_by"] = _bound(ops, nbytes)
    r[key + "_share"] = r[key + "_bound_ms"] / r[key + "_ms"]


def _traverse_bound(r, key, masks, soat, tri, mt, runs):
    """Bound of one traverse_blocks (or traverse_items) launch: the tests
    its warps ran, 32 x 32 a slice run (``runs``, the counter
    ``traverse.slices``), and beside it (``_listed_bound_ms``) every listed
    pair's 128 x 128, which the slice cull skips most of; each input read
    once (the masks, the rays, the listed clusters' rows and slice boxes),
    t and prim written once."""
    pairs, clusters = _listed(masks, tri.shape[0])
    rows = 12 if mt == "bw" else 9
    nbytes = (masks.numel() * 4 + soat.numel() * 4
              + clusters * (rows * 128 + 32) * 4
              + soat.shape[0] * soat.shape[1] * 8)
    _put_bound(r, key, runs * 32 * 32 * TEST_OPS[mt], nbytes)
    r[key + "_listed_bound_ms"] = _bound(
        pairs * 128 * 128 * TEST_OPS[mt], nbytes)[0]
    r["pairs"] = pairs
    r[key + "_runs"] = runs


def _mask_bound(r, soat, box, tmin, n_live, masks):
    """Bound of one cluster_masks launch on this run's rays: per live
    block, one root slab test per (ray, word root) and one exact test per
    (candidate ray, cluster) of each word (a candidate hits the word's
    root); the dense pass's bound (every ray against every box) beside it.
    Bytes: the rays, the box table and the words, once each."""
    import torch

    from rayito_tpu_torch.render import traverse as tv

    n_steps, sb, _ = soat.shape
    b = 128
    live_steps = max(min(int(n_live), n_steps), 1)
    alive = tv._step_alive(soat)[:live_steps]
    live_blocks = int(alive.sum()) * (sb // b)
    roots = tv.word_roots_plain(box)
    n_words = box.shape[1] // 32
    pad_words = int((box[0].view(n_words, 32) >= 1e29).any(dim=1).sum())
    cand = tv.word_live_plain(soat, roots, tmin, b=1).view(n_steps, sb, -1)
    cand = cand[:live_steps][alive]
    ops = (live_blocks * b * (n_words + pad_words) + int(cand.sum()) * 32)
    nbytes = soat.numel() * 4 + box.numel() * 4 + masks.numel() * 4
    _put_bound(r, "mask", ops * SLAB_OPS, nbytes)
    r["mask_dense_bound_ms"] = _bound(
        live_blocks * b * box.shape[1] * SLAB_OPS, nbytes)[0]
    r["mask_live_words"] = int(
        cand.view(-1, b, n_words).any(dim=1).sum()) / max(live_blocks, 1)


# the stage-6 main path: bench.py's frame on the n=64 bumpy stand-in
MESH_N = 64
WIDTH = 512
RAYS_PER_PASS = 1 << 17  # 256-row bands of 131,072 rays
# the bounce's shading kernels: one launch of each per bounce and pass of
# every path-trace frame
SHADE_KERNELS = ("bounce_prepare", "bounce_resolve")
# the sample streams' kernel launches on every frame that draws samples
# the plumbing around the coherence sort: once each per traverse() call
PLUMBING_KERNELS = ("ray_pack", "ray_reorder", "ray_unsort")
STAGE6_KERNELS = ("cluster_masks", "traverse_blocks", "gather_rows_t",
                  "cmj") + SHADE_KERNELS + PLUMBING_KERNELS
# the traversal kernels: no frame without a traversal domain launches them
TRAVERSAL_KERNELS = ("cluster_masks", "traverse_blocks", "traverse_items",
                     "build_items", "cluster_pipeline") + PLUMBING_KERNELS
# the big scene's item route: the scan stands by for lists that overflow
BIG_ITEM_KERNELS = STAGE6_KERNELS + ("traverse_items", "build_items")


def _check_shade_launches(label, launches, passes: int, depth: int = 3):
    """One launch of each shading kernel per bounce and pass, read from the
    device counters."""
    got = tuple(launches[k] for k in SHADE_KERNELS)
    print(f"{label}: bounce_prepare / bounce_resolve launches {got[0]} / "
          f"{got[1]} ({depth} bounces x {passes} passes)")
    if got != (depth * passes,) * 2:
        raise AssertionError(f"{label}: {depth * passes} launches of each "
                             "shading kernel expected")


def _standin_obj() -> str:
    from rayito_tpu_torch.models.demo import write_bumpy_standin
    from rayito_tpu_torch.utils import cuda_lib

    obj = os.path.join(cuda_lib.BUILD_DIR, f"bumpy_standin_n{MESH_N}.obj")
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    write_bumpy_standin(obj, n=MESH_N)
    return obj


def _frame_fn(scene, cfg, cam):
    """``frame(scene=scene)`` renders sample 0 over every row band through
    ``_render_path_frame``, the card's main path: one replay of the pass
    graph per launch (captured on the first call). It returns (images,
    issued queries). ``frame(scene, graph=False)`` renders the same grid
    through the eager pass body (``_path_pass_body``), as the CPU does: the
    plain-version frames run there, with the kernel wrappers swapped. The
    frame's overflow (the 'xla' route's truncations) is left in
    ``frame.overflow``."""
    import torch

    from rayito_tpu_torch.render import pathtracer as pt

    band = cfg.max_rays_per_pass // cfg.width
    if cfg.height % band:
        raise ValueError("the frame must be a whole number of bands")
    row0s = list(range(0, cfg.height, band))

    def frame(scene=scene, graph=True):
        dev = scene.device
        if graph:
            imgs, frame.overflow, q = pt._render_path_frame(
                scene, cfg, cam, torch.zeros((len(row0s), 1),
                                             dtype=torch.int32, device=dev),
                torch.tensor(row0s, dtype=torch.int32).to(dev), band)
            return imgs, q
        cam_d = cam.to(dev)
        si = torch.zeros((1,), dtype=torch.int32, device=dev)
        imgs, frame.overflow = [], 0
        q = torch.zeros((), dtype=torch.int64, device=dev)
        for r0 in row0s:
            img, ovf, q1 = pt._path_pass_body(
                scene, cfg, cam_d, si,
                torch.full((), r0, dtype=torch.int32, device=dev), band)
            imgs.append(img)
            frame.overflow = frame.overflow + ovf
            q = q + q1
        return torch.stack(imgs), q

    return frame


def _once(setup):
    """A setup built once per device and kept (phase 23 reuses it)."""
    return functools.lru_cache(maxsize=None)(setup)


@_once
def stage6_setup(dev):
    """(scene, config, camera, frame) of the stage-6 frame on ``dev``;
    ``frame()`` renders sample 0 over every row band through
    ``_render_path_frame`` and returns (images, issued queries)."""
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.models.demo import STAGE6_CAMERA, stage6_scene
    from rayito_tpu_torch.utils.config import RenderConfig

    scene = stage6_scene(_standin_obj()).compile(dev)
    cfg = RenderConfig(width=WIDTH, height=WIDTH, pixel_samples=2,
                       light_samples=1, max_depth=3, aspect_correction=True,
                       max_rays_per_pass=RAYS_PER_PASS)
    cam = PerspectiveCamera.make(30.0, *STAGE6_CAMERA, focal_distance=16.0,
                                 lens_radius=0.0)
    return scene, cfg, cam, _frame_fn(scene, cfg, cam)


@_once
def big_setup(dev):
    """(scan scene, items scene, defaults scene, config, camera, frame) of
    the big-scene frame: tools/bench_big_scene.py's config. The items scene
    has the budget that never overflows (every block may list every
    cluster), the defaults scene the reference's ITEMS_MAX / ITEMS_CAP."""
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.models.demo import STAGE6_CAMERA, big_streamed_scene
    from rayito_tpu_torch.utils.config import RenderConfig

    scan = big_streamed_scene(_standin_obj()).compile(dev)
    c_pad = scan.ktab_box[0].shape[1]
    n_blocks = RAYS_PER_PASS // scan.traverse_b
    items = dataclasses.replace(scan, traverse_items=True,
                                items_max=n_blocks * c_pad, items_cap=c_pad)
    defaults = dataclasses.replace(scan, traverse_items=True)
    cfg = RenderConfig(width=WIDTH, height=WIDTH, pixel_samples=1,
                       light_samples=1, max_depth=3, aspect_correction=True,
                       max_rays_per_pass=RAYS_PER_PASS)
    cam = PerspectiveCamera.make(40.0, *STAGE6_CAMERA, focal_distance=16.0,
                                 lens_radius=0.0)
    return scan, items, defaults, cfg, cam, _frame_fn(items, cfg, cam)


@_once
def stage7_setup(dev):
    """(scene, config, camera, frame) of the stage-7 frame: stage7_scene1
    on the n=64 stand-in (its mesh a traversal domain of its own under a
    three-key rotation), 512x512, 1 spp, depth 3, shutter 0..1."""
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.models.demo import STAGE7_CAMERA, stage7_scene1
    from rayito_tpu_torch.utils.config import RenderConfig

    scene = stage7_scene1(_standin_obj()).compile(dev)
    cfg = RenderConfig(width=WIDTH, height=WIDTH, pixel_samples=1,
                       light_samples=1, max_depth=3, aspect_correction=True,
                       max_rays_per_pass=RAYS_PER_PASS)
    cam = PerspectiveCamera.make(30.0, *STAGE7_CAMERA, focal_distance=16.0,
                                 lens_radius=0.0, shutter_open=0.0,
                                 shutter_close=1.0)
    return scene, cfg, cam, _frame_fn(scene, cfg, cam)


@_once
def stage7b_setup(dev):
    """(scene, config, camera, frame) of bench.py's stage-7b frame:
    stage7_scene2 (ten spheres and ten cubes, every cube a tiny moving
    mesh, no traversal domain), 512x256, 1 spp, depth 3, shutter 0..1."""
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.models.demo import (STAGE7_SCENE2_CAMERA,
                                              stage7_scene2)
    from rayito_tpu_torch.utils.config import RenderConfig

    scene = stage7_scene2().compile(dev)
    cfg = RenderConfig(width=WIDTH, height=WIDTH // 2, pixel_samples=1,
                       light_samples=1, max_depth=3, aspect_correction=True,
                       max_rays_per_pass=RAYS_PER_PASS)
    cam = PerspectiveCamera.make(30.0, *STAGE7_SCENE2_CAMERA,
                                 focal_distance=16.0, lens_radius=0.0,
                                 shutter_open=0.0, shutter_close=1.0)
    return scene, cfg, cam, _frame_fn(scene, cfg, cam)


def _still_setup(dev, make_scene, fov, spec, **cfg_kw):
    """(scene, config, camera, frame) of a static 512x512 frame, 1 spp,
    depth 3, in 131,072-ray bands."""
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.utils.config import RenderConfig

    scene = make_scene().compile(dev)
    cfg = RenderConfig(width=WIDTH, height=WIDTH, pixel_samples=1,
                       light_samples=1, max_depth=3,
                       max_rays_per_pass=RAYS_PER_PASS, **cfg_kw)
    cam = PerspectiveCamera.make(fov, *spec, focal_distance=16.0,
                                 lens_radius=0.0)
    return scene, cfg, cam, _frame_fn(scene, cfg, cam)


@_once
def stage5_setup(dev):
    """(scene, config, camera, frame) of the stage-5 frame: bullseye plane,
    four spheres, a rect light and a sphere light; no mesh, no domain."""
    from rayito_tpu_torch.models.demo import STAGE5_CAMERA, stage5_scene

    return _still_setup(dev, stage5_scene, 30.0, STAGE5_CAMERA,
                        aspect_correction=True)


def mesh_light_scene(obj_path: str):
    """The stage-6 geometry with the OBJ mesh wrapped as a ShapeLight and
    the sphere light dropped (the upstream demo's mesh-light switch): the
    light's triangles are the ones the kernels traverse."""
    import rayito_tpu_torch as tt
    from rayito_tpu_torch.models.demo import inline_box_mesh
    from rayito_tpu_torch.models.obj import load_obj

    s = tt.Scene()
    s.add(tt.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                   tt.DiffuseMaterial((0.7, 0.7, 0.9)), bullseye=True))
    s.add(tt.Sphere((3.0, -1.0, 0.0), 1.0, tt.DiffuseMaterial((0.8, 0.3, 0.7))))
    s.add(tt.Sphere((-3.0, 0.0, -2.0), 2.0,
                    tt.GlossyMaterial((0.3, 0.9, 0.3), 0.1)))
    s.add(tt.Sphere((1.5, -1.5, 2.5), 0.5,
                    tt.GlossyMaterial((0.5, 0.3, 0.8), 0.3)))
    s.add(tt.Sphere((-2.0, -1.5, 1.0), 0.5,
                    tt.DiffuseMaterial((0.7, 0.7, 0.2))))
    s.add(inline_box_mesh(tt.DiffuseMaterial((0.8, 0.3, 0.1))))
    s.add(tt.RectangleLight((-1.5, 4.0, -1.5), (3.0, 0.0, 0.0),
                            (0.0, 0.0, 3.0), (1.0, 1.0, 1.0), 5.0))
    s.add(tt.ShapeLight(
        load_obj(obj_path, tt.GlossyMaterial((0.8, 0.1, 0.1), 0.3)),
        color=(1.0, 1.0, 0.3), power=10.0))
    return s


@_once
def mesh_light_setup(dev):
    """(scene, the same scene on the CPU, config, camera, frame) of the
    mesh-light frame: stage 6's camera and config at 1 spp."""
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.models.demo import STAGE6_CAMERA
    from rayito_tpu_torch.models.scene import scene_data_from_arrays
    from rayito_tpu_torch.utils.config import RenderConfig

    arrays, static = mesh_light_scene(_standin_obj()).compile_arrays()
    scene = scene_data_from_arrays(arrays, static, dev)
    on_cpu = scene_data_from_arrays(arrays, static, "cpu")
    cfg = RenderConfig(width=WIDTH, height=WIDTH, pixel_samples=1,
                       light_samples=1, max_depth=3, aspect_correction=True,
                       max_rays_per_pass=RAYS_PER_PASS)
    cam = PerspectiveCamera.make(30.0, *STAGE6_CAMERA, focal_distance=16.0,
                                 lens_radius=0.0)
    return scene, on_cpu, cfg, cam, _frame_fn(scene, cfg, cam)


@_once
def many_spheres_setup(dev):
    from rayito_tpu_torch.models.demo import many_spheres_scene

    return _still_setup(dev, many_spheres_scene, 40.0,
                        ((0, 3, 18), (0, 0, 0), (0, 1, 0)))


@_once
def sixteen_lights_setup(dev):
    from rayito_tpu_torch.models.demo import sixteen_lights_scene

    return _still_setup(dev, sixteen_lights_scene, 40.0,
                        ((0, 3, 10), (0, 0, 0), (0, 1, 0)))


@_once
def many_lights_setup(dev):
    from rayito_tpu_torch.models.demo import many_sphere_lights_scene

    return _still_setup(dev, many_sphere_lights_scene, 40.0,
                        ((0, 3, 10), (0, 0, 0), (0, 1, 0)))


@_once
def deep_light_setup(dev):
    from rayito_tpu_torch.models.demo import deep_light_scene

    return _still_setup(dev, deep_light_scene, 40.0,
                        ((0, 3, 10), (0, 0, 0), (0, 1, 0)))


def _populations(scene, cfg, cam, light_corner, light_sides, time=None):
    """Camera rays of the first band (pixel centres), their closest hits
    (at the lanes' ``time`` where the scene moves), cosine-ish bounce rays
    from the hits and shadow rays to points of the rect light, in world
    space: [(name, o, d, tmax, mt_mode, any_hit)]."""
    import numpy as np
    import torch

    from rayito_tpu_torch.ops.vec3 import V3
    from rayito_tpu_torch.render import trace as tr
    from rayito_tpu_torch.render.integrator import _pixel_grid, screen_uv

    dev = scene.device
    band = cfg.max_rays_per_pass // cfg.width
    px, py = _pixel_grid(cfg.width, band, dev)
    half = torch.full(px.shape, 0.5, device=dev)
    xu, yu = screen_uv(cfg, px, py, half, half)
    o, d, _ = cam.to(xu.device).make_rays(xu, yu, half, half, half)
    n = px.shape[0]
    hit = tr.scene_intersect(scene, o, d, time, cfg.ray_tmin, 1e30)
    rng = np.random.default_rng(0)
    rnd = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)).to(dev)
    nrm = hit.normal
    bd = V3(rnd[0] + 1.5 * nrm.x, rnd[1] + 1.5 * nrm.y, rnd[2] + 1.5 * nrm.z)
    inv = 1.0 / torch.sqrt(bd.x * bd.x + bd.y * bd.y + bd.z * bd.z)
    bd = bd * inv
    pos = o + d * torch.where(hit.valid, hit.t, 0.0)
    lpt = torch.from_numpy(rng.uniform(0, 1, (2, n)).astype(np.float32)).to(dev)
    (cx, cy, cz), (s1, s2) = light_corner, light_sides
    light = V3(cx + s1 * lpt[0], torch.full_like(lpt[0], cy), cz + s2 * lpt[1])
    sd = light - pos
    dist = torch.sqrt(sd.x * sd.x + sd.y * sd.y + sd.z * sd.z)
    sd = sd * (1.0 / dist)
    alive = hit.valid
    return [
        ("camera", o, d, torch.full((n,), 1e30, device=dev), "bw", False),
        ("bounce", pos, bd, torch.where(alive, 1e30, 0.0), "bw", False),
        ("shadow", pos, sd, tr._occl_tmax_down(~alive, dist - cfg.ray_tmin),
         "vpu", True),
    ]


def _winner_rows(scene, di, p):
    """Global triangle ids of domain ``di``'s kernel winners (0 for
    misses)."""
    import torch

    from rayito_tpu_torch.accel.kernel_tables import KTRI

    found = p.view(-1) >= 0
    p_safe = torch.clamp_min(p.view(-1), 0)
    cl = p_safe // KTRI
    return torch.where(
        found, scene.ktab_base[di][cl.long()] + p_safe - cl * KTRI, 0
    ).to(torch.int32)


def _check_gather(name, scene, di, p, r):
    idx = _winner_rows(scene, di, p)
    for k, table in ((32, scene.tri_vm_rows), (16, scene.tri_vert_rows)):
        _check_gather_rows(name, table, idx, r, f"gather{k}")


def _check_gather_rows(name, table, idx, r, key):
    """gather_rows_t on (table, idx) against its plain version, bit for
    bit; device times of both and of the index_select yardstick; the
    bound (bytes: the indices, each distinct row once, the output)."""
    import torch

    from rayito_tpu_torch.render import traverse as tv

    k = table.shape[1]
    g_k = tv.gather_rows_t(table, idx)
    g_p = tv.gather_rows_t_plain(table, idx)
    torch.cuda.synchronize()
    bad_g = int((g_k.view(torch.int32) != g_p.view(torch.int32)).sum())
    r[f"{key}_err"] = float((g_k - g_p).abs().max())
    print(f"{name}: gather_rows_t [T, {k}] elements differing {bad_g}")
    if bad_g:
        raise AssertionError(f"{name}: gather_rows_t disagrees")
    r[f"{key}_ms"] = _device_ms(lambda: tv.gather_rows_t(table, idx))
    r[f"{key}_plain_ms"] = _median_ms(
        lambda: tv.gather_rows_t_plain(table, idx), 50)
    # the one PyTorch call that gives the same [K, N] result, on a
    # table transposed once beforehand (the port never calls it)
    table_t = table.t().contiguous()
    lib = torch.index_select(table_t, 1, idx)
    torch.cuda.synchronize()
    if not torch.equal(lib.view(torch.int32), g_p.view(torch.int32)):
        raise AssertionError(f"{name}: index_select yardstick differs")
    r[f"{key}_library_ms"] = _device_ms(
        lambda: torch.index_select(table_t, 1, idx))
    # bytes: the indices, each distinct table row once, the output
    n, rows = idx.shape[0], int(torch.unique(idx).numel())
    _put_bound(r, key, 0, n * 4 + rows * k * 4 + n * k * 4)


def _check_masks(name, soat, box, tmin, n_live, r):
    import torch

    from rayito_tpu_torch.render import traverse as tv

    m_k = tv.cluster_masks(soat, box, tmin, n_live)
    m_p = tv.cluster_masks_plain(soat, box, tmin, n_live)
    torch.cuda.synchronize()
    bad_m = int((m_k != m_p).sum())
    r["mask_err"] = int((m_k.long() - m_p.long()).abs().max())
    print(f"{name}: mask words differing {bad_m} of {m_k.numel()}")
    if bad_m:
        raise AssertionError(f"{name}: cluster_masks disagrees with plain")
    r["mask_ms"] = _device_ms(
        lambda: tv.cluster_masks(soat, box, tmin, n_live))
    r["mask_call_ms"] = _median_ms(
        lambda: tv.cluster_masks(soat, box, tmin, n_live), 20)
    r["mask_plain_ms"] = _median_ms(
        lambda: tv.cluster_masks_plain(soat, box, tmin, n_live), 3)
    return m_k


def _swap_plain():
    """Point the path at the plain versions of all fourteen kernels (the
    'xla' route's pipeline and winner-row gather, the sample streams' draw
    sets, the tiny-mesh fold, the bounce's shading, the analytic fold and
    the traversal's plumbing too); returns the undo."""
    from rayito_tpu_torch.ops import rng
    from rayito_tpu_torch.render import mesh_intersect as mi
    from rayito_tpu_torch.render import shade
    from rayito_tpu_torch.render import trace as tr
    from rayito_tpu_torch.render import traverse as tv

    saved = (tv.cluster_masks, tv.traverse_blocks, tv.traverse_items,
             tv.build_items, tr.gather_rows_t, mi.gather_rows_t,
             mi.cluster_pipeline, rng.cmj_draws, tr.fold_small,
             shade.bounce_prepare, shade.bounce_resolve, tr.analytic_fold)
    tv.cluster_masks = tv.cluster_masks_plain
    tv.traverse_blocks = tv.traverse_blocks_plain
    tv.traverse_items = tv.traverse_items_plain
    tv.build_items = tv.build_items_plain
    tr.gather_rows_t = tv.gather_rows_t_plain
    mi.gather_rows_t = tv.gather_rows_t_plain
    mi.cluster_pipeline = tv.cluster_pipeline_plain
    rng.cmj_draws = rng.cmj_draws_plain
    tr.fold_small = mi.fold_small_query_plain
    shade.bounce_prepare = shade.bounce_prepare_plain
    shade.bounce_resolve = shade.bounce_resolve_plain
    tr.analytic_fold = tr.analytic_fold_plain
    undo_plumbing = _plain_plumbing()

    def undo():
        undo_plumbing()
        (tv.cluster_masks, tv.traverse_blocks, tv.traverse_items,
         tv.build_items, tr.gather_rows_t, mi.gather_rows_t,
         mi.cluster_pipeline, rng.cmj_draws, tr.fold_small,
         shade.bounce_prepare, shade.bounce_resolve, tr.analytic_fold) = saved

    return undo


# ---------------------------------------------------------------------------
# the sample streams (csrc/cmj.cu)
# ---------------------------------------------------------------------------

SAMPLE_NUMS = list(range(1, 301)) + [1000, 4097]
# (pixel samples, light samples) of the path's patterns
SAMPLE_PATTERNS = [(ps, ls) for ps in (1, 2, 3, 12) for ls in (1, 2)]
# The draw set's own arithmetic, in lane instructions of csrc/cmj.cu's
# draw-set kernel (cmj_draws_kernel), counted in its SASS (the sm_90a
# build of the source as it stands; tools/cmj_sass.py --out lists it):
# the instructions that compute the function, and not the kernel's plan
# decoding (constant-bank reads, the shift and mask derived from a
# divisor's l, the operand selects), loop control, walk tests or
# addressing, the rule `float_loads` keeps for the bounds of
# cluster_pipeline and fold_small. A lane's px, py and si loads; a hash_step per seed operand (0x0680-0x0760); a seed's products
# by the salts its draws use, each permutation salt with its p >> 8, >> 16
# and >> 23 and its (1 | p >> 27) * 0x6935FA69, each rand_float salt with
# its 1 | p >> 18 (0x1120-0x1260, 0x25a0-0x25d0); the flat index's
# multiply-add where the index is not si itself; a permutation's first
# round, its + p and its magic remainder (0x1340-0x1590, 0x1800-0x1910),
# a round after the first (0x1600-0x17c0); a 2-D draw's magic quotient
# and remainder of pidx by nx; a rand_float (its I2FP and FMUL
# included); per IEEE division its fast path (MUFU.RCP, FCHK, five FFMA)
# and the I2FP and FADD of lane values before it; a store per output row.
DRAWS_OPS = {"lane": 3, "operand": 12, "perm_salt": 7, "rand_salt": 3,
             "index": 1, "permute": 35, "round": 27, "split": 7, "rand": 16,
             "div": 9, "store": 1}
# the salts of a draw's seed: its permutations' and its rand_floats'
PERM_SALTS = {1: (0x8FF3CD11,), 2: (0xC2D3C8FB, 0xA511E9B3, 0x63D83595)}
RAND_SALTS = {1: (0xA399D265,), 2: (0xA399D265, 0x711AD6A5)}
# lane instructions one H100 SXM issues per second, whatever their pipe:
# 132 SMs x 4 schedulers x one warp instruction of 32 lanes per clock at
# the 1,980 MHz boost clock (NVIDIA's Hopper architecture white paper)
PEAK_ISSUE = 132 * 4 * 32 * 1.98e9


def _walk_rounds(i, num: int, perm) -> int:
    """Cycle-walk rounds after the first that cmj_permute(i, num, perm)
    takes, summed over the lanes (each lane's own walk, as the kernel runs
    it)."""
    import torch

    from rayito_tpu_torch.ops import rng

    i, perm = rng.u32(i), rng.u32(perm)
    w = rng._permute_w(num)
    x = rng._permute_round(i, perm, w)
    rounds = 0
    out = x >= num
    while bool(out.any()):
        rounds += int(out.sum())
        x = torch.where(out, rng._permute_round(x, perm, w), x)
        out = x >= num
    return rounds


def _draws(px, py, si, ps: int, ls: int, seed: int):
    """Every draw of the path's patterns at (ps, ls), through the single
    draws on the lanes' device: the camera's subpixel and time samples,
    one bounce's light-loop samples (flat index si * nls + lsi) and
    continuation sample, stages 2-3's per-light draws (six hash operands,
    a constant index) and stage 2's (64, 1) pattern."""
    import torch

    from rayito_tpu_torch.ops import rng

    n, nls = px.shape[0], ls * ls
    out = []
    h = rng.hash_combine(px, py, rng.PURPOSE_SUBPIXEL, seed)
    out += [h, *rng.cmj_sample_2d(si, ps, ps, h)]
    h = rng.hash_combine(px, py, rng.PURPOSE_TIME, seed)
    out += [h, rng.cmj_sample_1d(si, ps * ps, h)]
    hs = rng.hash_combine(px, py, rng.PURPOSE_LIGHT_SELECT, 1, seed)
    hl = rng.hash_combine(px, py, rng.PURPOSE_LIGHT, 1, seed)
    out += [hs, hl]
    for lsi in range(nls):
        out += [rng.cmj_sample_1d(si, (ps * ls) ** 2, hs, nls, lsi),
                *rng.cmj_sample_2d(si, ps * ls, ps * ls, hl, nls, lsi)]
    h = rng.hash_combine(px, py, rng.PURPOSE_BOUNCE, 1, seed)
    out += [h, *rng.cmj_sample_2d(si, ps, ps, h)]
    h = rng.hash_combine(px, py, si, rng.PURPOSE_LIGHT, 1, seed)
    for k in range(nls):
        out += rng.cmj_sample_2d(torch.full((n,), k, dtype=torch.int64,
                                            device=px.device), ls, ls, h)
    out += rng.cmj_sample_2d(si, 64, 1, h)
    return out


def _differing(a, b) -> int:
    """Elements whose bits differ (float32 as int32 bits)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _set_work(plan, px, py, si):
    """(lane instructions, bytes) of one cmj_draws launch of ``plan``: the
    draw set's own arithmetic (DRAWS_OPS) per lane, seed and draw, and per
    cycle-walk round after the first, this run's walks; px, py and si read
    once, each output row written once."""
    from rayito_tpu_torch.ops import rng

    lanes = {"px": px, "py": py, "si": si}
    n = px.numel()
    seeds, salts, per_lane, rounds = {}, set(), DRAWS_OPS["lane"], 0
    for dr in plan:
        if dr.seed not in seeds:
            seeds[dr.seed] = rng.u32(rng.hash_combine(*(
                lanes[v] if isinstance(v, str) else v for v in dr.seed)))
            per_lane += DRAWS_OPS["operand"] * len(dr.seed)
        dims = 1 + (dr.ny > 0)
        for kind, salt in ([("perm_salt", c) for c in PERM_SALTS[dims]]
                           + [("rand_salt", c) for c in RAND_SALTS[dims]]):
            if (dr.seed, salt) not in salts:
                salts.add((dr.seed, salt))
                per_lane += DRAWS_OPS[kind]
        p = seeds[dr.seed]
        idx = rng.u32(rng._index(si, dr.index_mul, dr.index_add))
        per_lane += DRAWS_OPS["index"] * ((dr.index_mul, dr.index_add)
                                          != (1, 0))
        per_lane += (dims * (DRAWS_OPS["rand"] + DRAWS_OPS["store"])
                     + (2 * dims - 1) * DRAWS_OPS["div"])
        if not dr.ny:
            per_lane += DRAWS_OPS["permute"]
            rounds += _walk_rounds(idx, dr.nx, rng._mul32(p, 0x8FF3CD11))
            continue
        per_lane += 3 * DRAWS_OPS["permute"] + DRAWS_OPS["split"]
        salt = rng._mul32(p, 0xC2D3C8FB)
        pidx = rng.cmj_permute(idx, dr.nx * dr.ny, salt)
        rounds += (_walk_rounds(idx, dr.nx * dr.ny, salt)
                   + _walk_rounds(pidx % dr.nx, dr.nx,
                                  rng._mul32(p, 0xA511E9B3))
                   + _walk_rounds(pidx // dr.nx, dr.ny,
                                  rng._mul32(p, 0x63D83595)))
    rows = sum(2 if dr.ny else 1 for dr in plan)
    nbytes = n * (px.element_size() + py.element_size() + si.element_size()
                  + 4 * rows)
    return n * per_lane + rounds * DRAWS_OPS["round"], nbytes


def _draw_sets(cfg, n_lights: int) -> dict:
    """{name: plan} of the renderers' draw sets at ``cfg``: the camera's,
    bounce 1's with ``n_lights`` lights, a direct pass's subpixel draws
    (stratified and stage 2's (64, 1)) and its light loop over two
    lights."""
    from rayito_tpu_torch.render import integrator as ig
    from rayito_tpu_torch.render import pathtracer as pt

    ps = cfg.pixel_samples
    return {"camera": pt.camera_draws(cfg),
            "bounce": pt.bounce_draws(cfg, n_lights, 1),
            "direct_subpixel": (ig.subpixel_draw(cfg, ps, ps),
                                ig.subpixel_draw(cfg, 64, 1)),
            "direct_lights": ig.direct_light_draws(cfg, 2)}


def _time_set(r, key, plan, px, py, si):
    """One draw set at these lanes: device ms of its cmj_draws launch
    (CUDA-graph replays of 20 sets), the plain version's ms, the bound
    (the set's own arithmetic, DRAWS_OPS, at PEAK_ISSUE, or bytes at 3.35
    TB/s) and share, and the launches one set made (the device counter,
    read after one set alone)."""
    import torch

    from rayito_tpu_torch.ops import rng
    from rayito_tpu_torch.utils import cuda_lib

    r[key + "_ms"] = _device_ms(lambda: rng.cmj_draws(plan, px, py, si))
    r[key + "_plain_ms"] = _median_ms(
        lambda: rng.cmj_draws_plain(plan, px, py, si), 3)
    with _tracing():
        cuda_lib.reset_launch_counts()
        rng.cmj_draws(plan, px, py, si)
        torch.cuda.synchronize()
        r[key + "_launches"] = cuda_lib.launch_counts()["cmj"]
    if r[key + "_launches"] != len(rng._encode(tuple(plan))[0]):
        raise AssertionError(f"draw set {key}: {r[key + '_launches']} cmj "
                             "launches on the card, not its plan's")
    ops, nbytes = _set_work(plan, px, py, si)
    t_ops, t_bytes = ops / PEAK_ISSUE * 1e3, nbytes / PEAK_BYTES * 1e3
    r[key + "_bound_ms"], r[key + "_bound_by"] = (
        (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"))
    r[key + "_share"] = r[key + "_bound_ms"] / r[key + "_ms"]
    r[key + "_library_ms"] = None


def run_samples(dev, card: str) -> dict:
    """The sample-streams phase, right after the build: the single draws
    hash_combine, cmj_sample_1d and cmj_sample_2d on the card (torch ops
    running the fixed cycle-walk rounds) against the same calls on the
    CPU (the walk stopping once every lane is in range), bit for bit, at
    131,072 lanes, with no cmj launch: 1-D samples of seeded permutations
    at every num in 1-300, 1,000 and 4,097 (int32 and int64 operands in
    turn); every draw of the path's patterns at pixel samples
    {1, 2, 3, 12} x light samples {1, 2}; then the draw sets (one
    cmj_draws launch a set) against cmj_draws_plain, and stage 6's sets
    and stage 3's light loop timed, with bounds and shares."""
    import numpy as np
    import torch

    from rayito_tpu_torch.ops import rng
    from rayito_tpu_torch.render.integrator import _pixel_grid
    from rayito_tpu_torch.utils.config import RenderConfig

    _phase("sample streams")
    n = RAYS_PER_PASS
    rs = np.random.default_rng(11)
    t0 = time.perf_counter()
    bad, err = 0, 0.0
    launches = rng.cmj.launches
    for num in SAMPLE_NUMS:
        idx = torch.arange(n, dtype=torch.int64, device=dev) % num
        perm = torch.from_numpy(rs.integers(0, 2**32, n)).to(dev)
        if num % 2:  # odd nums through int32 operands
            idx, perm = idx.to(torch.int32), perm.to(torch.int32)
        got = rng.cmj_sample_1d(idx, num, perm).cpu()
        want = rng.cmj_sample_1d(idx.cpu(), num, perm.cpu())
        bad += _differing(got, want)
        err = max(err, float((got - want).abs().max()))
    print(f"1-D samples at every num in 1-300, 1000 and 4097 ({n} lanes "
          f"each, seeded permutations), card against CPU: values "
          f"differing {bad}; {time.perf_counter() - t0:.1f} s", flush=True)
    if bad:
        raise AssertionError("cmj_sample_1d on the card disagrees with the "
                             "CPU")

    seed = RenderConfig(width=1, height=1).seed
    px, py = _pixel_grid(WIDTH, n // WIDTH, dev)
    for ps, ls in SAMPLE_PATTERNS:
        si = torch.from_numpy(rs.integers(0, ps * ps, n).astype(np.int32))
        got = [t.cpu() for t in _draws(px, py, si.to(dev), ps, ls, seed)]
        want = _draws(px.cpu(), py.cpu(), si, ps, ls, seed)
        diff = sum(_differing(a, b) for a, b in zip(got, want))
        err = max([err] + [float((a - b).abs().max()) for a, b in
                           zip(got, want) if a.dtype == torch.float32])
        print(f"path patterns, {ps}x{ps} pixel x {ls}x{ls} light samples: "
              f"{len(got)} outputs of {n} lanes, card against CPU, values "
              f"differing {diff}")
        bad += diff
    if bad:
        raise AssertionError("the single draws on the card disagree with "
                             "the CPU")
    if rng.cmj.launches != launches:
        raise AssertionError("a single draw launched the cmj kernel")

    # the draw sets: every renderer's plan through one cmj_draws launch
    # against cmj_draws_plain (the fixed cycle-walk rounds on the card)
    for ps, ls in SAMPLE_PATTERNS:
        si = torch.from_numpy(rs.integers(0, ps * ps, n).astype(np.int32))
        si = si.to(dev)
        cfg = RenderConfig(width=WIDTH, height=n // WIDTH, pixel_samples=ps,
                           light_samples=ls, seed=seed)
        for name, plan in _draw_sets(cfg, 3).items():
            got = rng.cmj_draws(plan, px, py, si)
            want = rng.cmj_draws_plain(plan, px, py, si)
            diff = _differing(got, want)
            err = max(err, float((got - want).abs().max()))
            if diff:
                print(f"draw set {name} at {ps}x{ps} x {ls}x{ls}: "
                      f"{got.shape[0]} rows of {n} lanes, values differing "
                      f"{diff}")
            bad += diff
        print(f"draw sets at {ps}x{ps} pixel x {ls}x{ls} light samples: "
              f"camera, bounce, direct subpixel and light loop, values "
              f"differing {bad}")
    if bad:
        raise AssertionError("the draw sets disagree with cmj_draws_plain")

    si = torch.zeros((n,), dtype=torch.int32, device=dev)
    r = {"lanes": n, "max_abs_err": err}
    # stage 6's sets (its config and lights; the first band, sample 0) and
    # stage 3's light loop at its golden 4x4 light samples
    scene, cfg, _, _ = stage6_setup(dev)
    sets = _draw_sets(cfg, scene.n_lights)
    _time_set(r, "draw", sets["bounce"], px, py, si)
    _time_set(r, "camera_set", sets["camera"], px, py, si)
    stage3 = dataclasses.replace(cfg, pixel_samples=4, light_samples=4)
    _time_set(r, "direct_set", _draw_sets(stage3, 2)["direct_lights"], px,
              py, si)
    if r["draw_launches"] != 1 or r["camera_set_launches"] != 1:
        raise AssertionError("stage 6's bounce or camera set took more than "
                             "one cmj launch")
    print("sample streams: " + _fmt(r), flush=True)
    return r


def run_probes(dev, card: str) -> None:
    """Degenerate inputs on the card, each pass captured, replayed and held
    bit for bit against its eager body (image, overflow, queries): one
    lane (the stage-6 scene at 1x1), a scene with no mesh and no light (a
    plane and a sphere at 16x16), and the 'xla' route below 256 lanes (the
    stage-6 scene at 16x8)."""
    import numpy as np
    import torch

    import rayito_tpu_torch as rt
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import graphs
    from rayito_tpu_torch.utils.config import RenderConfig

    _phase("degenerate inputs")
    s6, _, cam, _ = stage6_setup(dev)
    bare = rt.Scene()
    bare.add(rt.Plane((0.0, -2.0, 0.0), (0.0, 1.0, 0.0),
                      rt.DiffuseMaterial((0.9, 0.9, 1.0))))
    bare.add(rt.Sphere((0.0, 0.0, 0.0), 1.0,
                       rt.DiffuseMaterial((0.8, 0.3, 0.7))))
    cases = (("one lane", s6, 1, 1),
             ("no mesh, no light", bare.compile(dev), 16, 16),
             ("'xla', 128 lanes", dataclasses.replace(s6, traversal="xla"),
              16, 8))
    si = torch.zeros((1,), dtype=torch.int32, device=dev)
    for label, scene, w, h in cases:
        cfg = RenderConfig(width=w, height=h, pixel_samples=1,
                           light_samples=1, max_depth=3)
        graphs.clear()
        eager = pt._path_pass_body(scene, cfg, cam.to(dev), si,
                                   torch.zeros((), dtype=torch.int32,
                                               device=dev), h)
        passes = [pt._render_path_pass(scene, cfg, cam, si, 0, h)
                  for _ in range(2)]
        torch.cuda.synchronize()
        (g,) = graphs.graphs()
        for got in passes:
            same = (torch.equal(got[0].view(torch.int32),
                                eager[0].view(torch.int32))
                    and int(got[1]) == int(eager[1])
                    and int(got[2]) == int(eager[2]))
            if not same or g.replays != 2:
                raise AssertionError(f"{label}: the replayed pass differs "
                                     "from its eager body")
        img = eager[0].cpu().numpy()
        if not np.isfinite(img).all() or (img < 0).any():
            raise AssertionError(f"{label}: NaN, infinite or negative pixels")
        print(f"{label} ({w}x{h}): captured, replayed twice, bit-identical "
              f"to the eager pass (queries {int(eager[2])}, overflow "
              f"{int(eager[1])}, image sum {float(img.sum()):.6g}) on {card}")
    graphs.clear()


def _rel_rmse(img, ref) -> float:
    import numpy as np

    return float(np.sqrt(np.mean((img - ref) ** 2))
                 / max(np.sqrt(np.mean(ref ** 2)), 1e-20))


def _check_image(img, what):
    import numpy as np

    from rayito_tpu_torch.utils.image import diagnose

    diag = diagnose(img)
    if diag["nan_pixels"] or diag["negative_pixels"] or not np.isfinite(img).all():
        raise AssertionError(f"{what}: NaN, infinite or negative pixels")
    if not img.max() > 0:
        raise AssertionError(f"{what}: black frame")
    return diag


def _time_frames(frame, n_frames: int = 3):
    """(seconds per frame, issued queries per frame) over ``n_frames``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qs = [frame()[1] for _ in range(n_frames)]
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / n_frames,
            sum(int(q) for q in qs) / n_frames)


def _slice_runs(name, masks, soat, tri, sl, tmin, mt, any_hit, n_live):
    """The slices one traverse_blocks launch's warps ran, from the device
    counter ``traverse.slices`` (tracing on): on a closest-hit launch
    exactly ``fold_slices_plain``'s count, on an any-hit one at most it
    (its rays stop once they have hits)."""
    import torch

    from rayito_tpu_torch.render import traverse as tv
    from rayito_tpu_torch.utils import tracing

    with _tracing():
        tracing.reset()
        tv.traverse_blocks(masks, soat, tri, tmin, mt, any_hit, n_live,
                           slices=sl)
        torch.cuda.synchronize()
        runs = int(tracing.counters().get("traverse.slices", 0))
    want = int(tv.fold_slices_plain(masks, soat, sl, tmin, mt, n_live))
    pairs = _listed(masks, tri.shape[0])[0]
    print(f"{name}: slices run {runs} (the plain count {want}) of the "
          f"masks' {pairs * 16}: {runs / max(pairs * 16, 1):.4f}")
    if runs > want or (not any_hit and runs != want):
        raise AssertionError(f"{name}: traverse.slices {runs} against "
                             f"the plain count {want}")
    return runs


def _item_slice_runs(il, steps, soab, tri, sl, tmin, mt, w):
    """The slices one traverse_items launch's warps ran (the counter
    ``traverse.slices``), equal to the plain count over its items: the
    item kernel finds the nearest hit on any-hit launches too."""
    import torch

    from rayito_tpu_torch.render import traverse as tv
    from rayito_tpu_torch.utils import tracing

    with _tracing():
        tracing.reset()
        tv.traverse_items(il, steps, soab, tri, tmin, mt, w, slices=sl)
        torch.cuda.synchronize()
        runs = int(tracing.counters().get("traverse.slices", 0))
    want = int(tv._item_slices_plain(il, steps, soab, sl, tmin, mt, w))
    if runs != want:
        raise AssertionError(f"traverse_items: traverse.slices {runs} "
                             f"against the plain count {want}")
    return runs


def _shuffled_population(name, r, co, cd, ctmax, box, tri, sl, tmin, mt,
                         any_hit):
    """The cull's worst case: the population in a seeded random order and
    not sorted, so a block's and a warp's rays are incoherent and nearly
    every slice a warp tests is live. traverse_blocks against its plain
    version (bit for bit on closest hits), its device time, runs and
    bound under ``shuffled_``."""
    import torch

    from rayito_tpu_torch.ops.vec3 import V3
    from rayito_tpu_torch.render import traverse as tv

    n = co.x.shape[0]
    g = torch.Generator(device="cpu").manual_seed(n)
    perm = torch.randperm(n, generator=g).to(co.x.device)
    so, sd = (V3(v.x[perm], v.y[perm], v.z[perm]) for v in (co, cd))
    soat, _, _ = tv.prepare_rays(so, sd, ctmax[perm], box, tmin,
                                 sort_rays=False)
    masks = tv.cluster_masks(soat, box, tmin)
    t_k, p_k = tv.traverse_blocks(masks, soat, tri, tmin, mt, any_hit,
                                  slices=sl)
    t_p, p_p = tv.traverse_blocks_plain(masks, soat, tri, tmin, mt, any_hit)
    torch.cuda.synchronize()
    bad = (int(((p_k >= 0) != (p_p >= 0)).sum()) if any_hit else
           int((p_k != p_p).sum())
           + int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum()))
    if bad:
        raise AssertionError(f"{name} shuffled: kernel disagrees with plain")
    sub = {"shuffled_ms": _device_ms(lambda: tv.traverse_blocks(
        masks, soat, tri, tmin, mt, any_hit, slices=sl))}
    runs = _slice_runs(f"{name} shuffled", masks, soat, tri, sl, tmin, mt,
                       any_hit, None)
    _traverse_bound(sub, "shuffled", masks, soat, tri, mt, runs)
    sub["shuffled_pairs"] = sub.pop("pairs")
    r.update(sub)


def _check_population(name, scene, di, co, cd, ctmax, mt, any_hit, tmin):
    """One ray population through domain ``di``'s kernels (rays in the
    domain's space): cluster_masks, traverse_blocks and, on closest-hit
    launches, gather_rows_t of the winners' rows, each against its plain
    version bit for bit, with device times, bounds and shares."""
    import torch

    from rayito_tpu_torch.render import traverse as tv

    box = scene.ktab_box[di]
    tri = scene.ktab_tri[di] if mt == "vpu" else scene.ktab_mxu[di]
    sl = scene.ktab_slice[di]
    n = co.x.shape[0]
    soat, _, n_live = tv.prepare_rays(co, cd, ctmax, box, tmin)
    r = {}
    m_k = _check_masks(name, soat, box, tmin, n_live, r)
    t_k, p_k = tv.traverse_blocks(m_k, soat, tri, tmin, mt, any_hit, n_live,
                                  slices=sl)
    t_p, p_p = tv.traverse_blocks_plain(m_k, soat, tri, tmin, mt, any_hit,
                                        n_live)
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
    print(f"{name}: {n} rays, {int(n_live)} live steps of {soat.shape[0]}, "
          f"prim differing {bad_p}, t bits differing {bad_t}, hits {hits}")
    if bad_p or bad_t:
        raise AssertionError(f"{name}: kernel disagrees with plain")
    r["trav_ms"] = _device_ms(lambda: tv.traverse_blocks(
        m_k, soat, tri, tmin, mt, any_hit, n_live, slices=sl))
    r["trav_call_ms"] = _median_ms(lambda: tv.traverse_blocks(
        m_k, soat, tri, tmin, mt, any_hit, n_live, slices=sl), 20)
    r["trav_plain_ms"] = _median_ms(lambda: tv.traverse_blocks_plain(
        m_k, soat, tri, tmin, mt, any_hit, n_live), 1)
    r["t_err"] = t_err
    r["hits"] = hits
    _mask_bound(r, soat, box, tmin, n_live, m_k)
    runs = _slice_runs(name, m_k, soat, tri, sl, tmin, mt, any_hit, n_live)
    _traverse_bound(r, "trav", m_k, soat, tri, mt, runs)
    _shuffled_population(name, r, co, cd, ctmax, box, tri, sl, tmin, mt,
                         any_hit)
    if not any_hit:
        _check_gather(name, scene, di, p_k, r)
    print(f"{name}: " + _fmt(r), flush=True)
    return r


def _frame_phase(label: str, cfg, frame, card: str,
                 kernels=STAGE6_KERNELS) -> dict:
    """One main-path frame (replayed graphs, captured by a first frame)
    with the launch counts set to 0 just before it and read just after
    (each of ``kernels`` must have run), its image checked; the same frame
    through the plain versions (relative RMSE at most 0.5%); then one timed
    frame. Returns the launches, frame ms and Mrays/s."""
    import torch

    from rayito_tpu_torch.utils import cuda_lib

    band = cfg.max_rays_per_pass // cfg.width
    with _tracing():
        frame()  # warm-up: captures the pass graph
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        imgs, queries = frame()
        torch.cuda.synchronize()
        launches = cuda_lib.launch_counts()
    frame()  # captures the untraced graph
    print(f"launches in one frame: {launches}")
    img = imgs.reshape(cfg.height, cfg.width, 3).cpu().numpy()
    diag = _check_image(img, label)
    print(f"frame {img.shape}: queries {int(queries)}, {diag}")
    if min(launches[k] for k in kernels) <= 0:
        raise AssertionError("a kernel of the path was never launched")
    _check_shade_launches(label, launches, cfg.height // band, cfg.max_depth)

    undo = _swap_plain()
    try:
        t0 = time.perf_counter()
        imgs_p, q_p = frame(graph=False)
        torch.cuda.synchronize()
        plain_frame_s = time.perf_counter() - t0
    finally:
        undo()
    img_p = imgs_p.reshape(cfg.height, cfg.width, 3).cpu().numpy()
    rel = _rel_rmse(img, img_p)
    print(f"plain-version frame: queries {int(q_p)}, {plain_frame_s:.2f} s; "
          f"relative RMSE vs kernels {rel:.3e}; max abs diff "
          f"{float(abs(img - img_p).max()):.3e}")
    if rel > 0.005:
        raise AssertionError(f"{label}: relative RMSE {rel} > 0.5%")

    frame_s, q_frame = _time_frames(frame, 1)
    mrays = q_frame / frame_s / 1e6
    print(f"{label}, {cfg.height // band} bands): {frame_s * 1e3:.1f} "
          f"ms/frame, {q_frame:.0f} issued queries, {mrays:.3f} Mrays/s on "
          f"{card}", flush=True)
    return {"launches": launches, "frame_ms": frame_s * 1e3,
            "mrays": mrays, "queries": q_frame}


def run(dev, card: str) -> dict:
    """Phases 3-4 on ``dev``: {"results": per-population kernel numbers,
    "launches": per-kernel launches in one stage-6 frame}."""
    _phase("scene")
    t0 = time.perf_counter()
    scene, cfg, cam, frame = stage6_setup(dev)
    n_cl = scene.ktab_tri[0].shape[0]
    print(f"stage-6 scene with the n={MESH_N} stand-in: "
          f"{scene.tri_vm_rows.shape[0]} triangle rows, {n_cl} kernel "
          f"clusters (padded), box table {tuple(scene.ktab_box[0].shape)}; "
          f"{time.perf_counter() - t0:.1f} s")

    _phase("kernels")
    cases = _populations(scene, cfg, cam, (-1.5, 4.0, -1.5), (3.0, 3.0))
    results = {name: _check_population(name, scene, 0, co, cd, ctmax, mt,
                                       any_hit, cfg.ray_tmin)
               for name, co, cd, ctmax, mt, any_hit in cases}

    _phase("frame")
    fr = _frame_phase(f"stage-6 frame (n={MESH_N} stand-in, {WIDTH}x{WIDTH},"
                      " sample 0", cfg, frame, card)
    return {"results": results, "launches": fr["launches"]}


# ---------------------------------------------------------------------------
# the bounce's shading (csrc/shade.cu)
# ---------------------------------------------------------------------------

# Float operations of the shading kernels per lane, counted by hand from
# csrc/shade.cu's formulas along the cheapest path a lane can take (a
# Lambert lane: each add, multiply, compare, select, division, root, sin,
# cos and pow at one operation; loads, integer work and the clamps' NaN
# guards left out), so the bound stays a lower bound. bounce_prepare: per
# lane the material row, the emission gate, the position and the
# continuation's Lambert sample (concentric disk 24, its sin and cos 2,
# the frame 38, the rest 30); per light sample the light choice (3), a rect
# light's sample (58), the direction to it (14), Lambert's evaluation (16),
# the Lambert sample toward the light (94) and, with analytic lights, a
# rect's analytic hit (62). bounce_resolve: per lane the continuation (22);
# per light sample both power heuristics (12), both gains (16), the sums
# (12) and a rect's intersect pdf (28).
SHADE_OPS = {"prepare_lane": 136, "prepare_sample": 185,
             "prepare_analytic": 62, "resolve_lane": 22,
             "resolve_sample": 68}


def _nbytes(*ts) -> int:
    import torch

    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _v3s(*vs):
    return [c for v in vs if v is not None for c in (v.x, v.y, v.z)]


def _shade_tables(scene) -> int:
    """Bytes of the scene tables a shading launch may read, once each."""
    from rayito_tpu_torch.models.scene import LIGHT_MESH
    from rayito_tpu_torch.render import shade

    tabs = [getattr(scene, k) for k in shade._TABLES
            if k not in ("tri_area_cdf", "tri_vert_rows")
            and (scene.has_motion or not k.startswith("xf_"))]
    total = _nbytes(*tabs)
    for kind, idx in zip(scene.light_kinds_host, scene.light_indices_host):
        if kind == LIGHT_MESH:  # its CDF run and vertex rows
            total += scene.mesh_tri_ranges[idx][1] * (4 + 9 * 4)
    return total


def _shade_work(scene, args, prep, res_args=None):
    """(ops, bytes) of one bounce_prepare (``res_args`` None) or
    bounce_resolve launch on these inputs: each input read once, each
    output written once."""
    from rayito_tpu_torch.render import shade

    n = prep.f_c.shape[0]
    nls = prep.light_idx.shape[0]
    analytic = shade.analytic_lights(scene)
    tables = _shade_tables(scene)
    motion = scene.has_motion
    if res_args is None:
        (_, _, _, hit, u, tp, alive, nd, o, d, tm, res) = args
        reads = _nbytes(hit.t, hit.valid, hit.mat, hit.color_mod, u, alive,
                        nd, *_v3s(hit.normal, tp, o, d, res),
                        tm if motion else None)
        ls_rows = 17 if analytic else 13
        writes = n * (14 * 4 + 4 + 1) + nls * n * (ls_rows * 4 + 4 + 2)
        ops = n * (SHADE_OPS["prepare_lane"] + nls * (
            SHADE_OPS["prepare_sample"]
            + SHADE_OPS["prepare_analytic"] * analytic))
        return ops, reads + writes + tables
    (_, _, _, normal, tp, o, d, tm, occ, blk, hits) = res_args
    ls_rows = 15 if analytic else 11  # the tmax rows are not read
    reads = (n * (14 * 4 + 1) + nls * n * (ls_rows * 4 + 4 + 2)
             + _nbytes(*_v3s(normal, tp, o, d), tm if motion else None, *occ,
                       *(() if blk is None else blk))
             + sum(_nbytes(h.valid, h.shape_id, h.t, *_v3s(h.normal))
                   for h in (() if hits is None else hits)))
    writes = n * (12 * 4 + 1)
    ops = n * (SHADE_OPS["resolve_lane"] + nls * SHADE_OPS["resolve_sample"])
    return ops, reads + writes + tables


@contextlib.contextmanager
def _spy_shade(keep: int):
    """Collect the inputs of the first ``keep`` bounces' shading calls the
    path makes: [(prepare args, resolve args)], as the eager pass body
    issues them (the wrappers run as they are)."""
    from rayito_tpu_torch.render import shade

    calls = []
    prep, res = shade.bounce_prepare, shade.bounce_resolve

    def spy_prep(*a):
        if len(calls) < keep:
            calls.append([a, None])
        return prep(*a)

    def spy_res(*a):
        if calls and calls[-1][1] is None:
            calls[-1][1] = a
        return res(*a)

    shade.bounce_prepare, shade.bounce_resolve = spy_prep, spy_res
    try:
        yield calls
    finally:
        shade.bounce_prepare, shade.bounce_resolve = prep, res


def _shade_differ(a, b):
    """(values whose bits differ, the largest |a - b| over finite pairs)
    of two outputs: tensors, V3s, or None both."""
    import torch

    from rayito_tpu_torch.ops.vec3 import V3

    if a is None or b is None:
        if (a is None) != (b is None):
            raise AssertionError("an output is missing on one side")
        return 0, 0.0
    if isinstance(a, V3):
        a, b = torch.stack([a.x, a.y, a.z]), torch.stack([b.x, b.y, b.z])
    if not a.is_floating_point():
        return int((a != b).sum()), 0.0
    bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0
    return bad, err


def _check_shade(label, scene, call, time=None, timed=False) -> dict:
    """One bounce's bounce_prepare and bounce_resolve calls (``call``:
    their recorded arguments, the lane times replaced by ``time`` where
    given): each kernel against its plain version on the same inputs,
    every output bit for bit (the resolve on the kernel's prepared planes
    and the recorded shadow bits); with ``timed``, device times (CUDA-graph
    replays of 20 calls), the plain versions' times, the bounds and
    shares."""
    import dataclasses as dc

    import torch

    from rayito_tpu_torch.render import shade

    args, res_args = (list(a) for a in call)
    if time is not None:
        args[10] = res_args[7] = time
    pk = shade.bounce_prepare(*args)
    pp = shade.bounce_prepare_plain(*args)
    res_args[2] = pk
    rk = shade.bounce_resolve(*res_args)
    rp = shade.bounce_resolve_plain(*res_args)
    torch.cuda.synchronize()
    r = {"lanes": pk.f_c.shape[0], "light_samples": pk.light_idx.shape[0]}
    bad, err = {}, 0.0
    for f in dc.fields(shade.Prepared):
        if f.name != "buffers":
            bad[f.name], e = _shade_differ(getattr(pk, f.name),
                                           getattr(pp, f.name))
            err = max(err, e)
    for name, a, b in zip(("result", "throughput", "o", "d", "alive"), rk,
                          rp):
        bad["resolve_" + name], e = _shade_differ(a, b)
        err = max(err, e)
    differing = {k: v for k, v in bad.items() if v}
    r["shade_err"] = err
    r["alive_lanes"] = int(pk.lane.sum())
    r["queries"] = int(pk.ok_l.sum() + pk.ok_b.sum())
    print(f"{label}: {r['lanes']} lanes x {r['light_samples']} light "
          f"samples, {r['alive_lanes']} shaded, {r['queries']} NEE queries; "
          f"outputs whose bits differ: {differing or 'none'}")
    if differing:
        raise AssertionError(f"{label}: a shading kernel disagrees with its "
                             "plain version")
    if timed:
        # 20 calls on the same inputs keep them in the 50 MB L2 (a launch
        # moves ~30 MB); the frame finds them colder. "ms" is each call
        # after an 80 MB write that evicts them, less that write's own
        # time; "warm_ms" the calls back to back
        flush = torch.empty(80 << 20, dtype=torch.uint8,
                            device=pk.f_c.device)
        flush_ms = _device_ms(flush.zero_)
        for key, fn, plain, work in (
                ("prepare", lambda: shade.bounce_prepare(*args),
                 lambda: shade.bounce_prepare_plain(*args),
                 _shade_work(scene, args, pk)),
                ("resolve", lambda: shade.bounce_resolve(*res_args),
                 lambda: shade.bounce_resolve_plain(*res_args),
                 _shade_work(scene, args, pk, res_args))):
            r[key + "_warm_ms"] = _device_ms(fn)
            r[key + "_ms"] = _device_ms(
                lambda fn=fn: (flush.zero_(), fn())) - flush_ms
            r[key + "_plain_ms"] = _median_ms(plain, 3)
            r[key + "_bytes"] = work[1]
            _put_bound(r, key, *work)
            r[key + "_warm_share"] = r[key + "_bound_ms"] / r[key + "_warm_ms"]
            r[key + "_library_ms"] = None
        r["flush_ms"] = flush_ms
        del flush
        print(f"{label}: " + _fmt({k: v for k, v in r.items()
                                   if v is not None}), flush=True)
    return r


@_once
def box_light_setup(dev):
    """(scene, config, camera, frame) of the box mesh light at 512x512,
    light_samples=2: a plane, the inline box, and a second inline box
    scaled and lifted, wrapped as a ShapeLight."""
    import numpy as np

    import rayito_tpu_torch as tt
    from rayito_tpu_torch.models.demo import inline_box_mesh

    def make():
        s = tt.Scene()
        s.add(tt.Plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0),
                       tt.DiffuseMaterial((0.7, 0.7, 0.8))))
        s.add(inline_box_mesh(tt.DiffuseMaterial((0.8, 0.3, 0.1))))
        lm = inline_box_mesh(tt.DiffuseMaterial((0.9, 0.9, 0.9)))
        lm.vertices = (np.asarray(lm.vertices, np.float32) * np.float32(0.5)
                       + np.float32([0.0, 3.0, 0.0]))
        s.add(tt.ShapeLight(lm, color=(1.0, 1.0, 1.0), power=8.0))
        return s

    scene, cfg, cam, _ = _still_setup(dev, make, 40.0,
                                      ((0, 3, 10), (0, 0, 0), (0, 1, 0)))
    cfg = dataclasses.replace(cfg, light_samples=2)
    return scene, cfg, cam, _frame_fn(scene, cfg, cam)


def run_shade(dev, card: str) -> dict:
    """Phase 27 on ``dev``: bounce_prepare and bounce_resolve against their
    plain versions on the card, bit for bit on every output, on the inputs
    the eager pass body hands them: stage 6's first band at bounces 0 and
    1 (timed, bounded), stage 7's first band at seeded lane times in
    [-0.5, 1.5] (its keyed rect and sphere lights), the box mesh light at
    light_samples=2 (the BRDF-side closest-hit branch), the 16-light scene
    at light_samples 1 and 2, 65 sphere lights, and a sphere light nine
    groups deep at seeded lane times; each scene's light table and chain
    slots are its device tables. Returns {population: numbers}."""
    import numpy as np
    import torch

    _phase("shading kernels")
    s16 = sixteen_lights_setup(dev)
    s16_ls2 = dataclasses.replace(s16[1], light_samples=2)
    cases = [("stage6", stage6_setup(dev), 2, None),
             ("stage7", stage7_setup(dev), 1, "times"),
             ("box_light", box_light_setup(dev), 1, None),
             ("lights16", s16, 1, None),
             ("lights16_ls2", (s16[0], s16_ls2, s16[2],
                               _frame_fn(s16[0], s16_ls2, s16[2])), 1, None),
             ("lights65", many_lights_setup(dev), 1, None),
             ("deep_light9", deep_light_setup(dev), 1, "times")]
    out = {}
    for name, setup, keep, times in cases:
        scene, frame = setup[0], setup[-1]
        table, slots = scene.light_table, scene.light_slots
        if (table.device != dev or slots.device != dev
                or tuple(table.shape) != (scene.n_lights, 7)):
            raise AssertionError(f"shade {name}: the light table is not "
                                 "the scene's on the card")
        print(f"shade {name}: {scene.n_lights} lights, chains of "
              f"{int(table[:, 2].max())} links at most, {slots.numel()} "
              "slots, read from the scene's device tables")
        with _spy_shade(keep) as calls:  # the first band's first bounces
            frame(graph=False)
            torch.cuda.synchronize()
        for bounce, call in enumerate(calls):
            time_l = None
            if times:
                time_l = torch.from_numpy(np.random.default_rng(27).uniform(
                    -0.5, 1.5, RAYS_PER_PASS).astype(np.float32)).to(dev)
            label = f"shade {name} bounce {bounce}"
            out[f"{name}_b{bounce}"] = _check_shade(
                label, scene, call, time_l,
                timed=(name == "stage6" and bounce == 0))
        del calls
    return out


def _item_counts(masks, w: int = 4):
    """(items in the w-aligned list, most clusters listed by one block)."""
    import torch

    bits = torch.stack([(masks >> k) & 1 for k in range(32)]).sum(dim=(0, 2))
    return int(((bits + w - 1) // w * w).sum()), int(bits.max())


def run_big(dev, card: str) -> dict:
    """Phases 5-6 on ``dev``: {"results": per-population kernel numbers,
    "launches": per-kernel launches in one big-scene frame}."""
    import torch

    from rayito_tpu_torch.render import traverse as tv
    from rayito_tpu_torch.utils import cuda_lib

    _phase("big scene")
    t0 = time.perf_counter()
    scan, items, defaults, cfg, cam, frame = big_setup(dev)
    box = scan.ktab_box[0]
    sl = scan.ktab_slice[0]
    c_pad = box.shape[1]
    print(f"big scene (five n={MESH_N} stand-ins): "
          f"{scan.tri_vm_rows.shape[0]} triangle rows, "
          f"{scan.ktab_tri[0].shape[0]} kernel clusters (padded), box table "
          f"{tuple(box.shape)}; item budgets {items.items_max}/"
          f"{items.items_cap} (never overflows) and {defaults.items_max}/"
          f"{defaults.items_cap} (reference defaults); "
          f"{time.perf_counter() - t0:.1f} s")
    w = items.items_w

    _phase("big-scene kernels")
    cases = _populations(scan, cfg, cam, (-4.0, 10.0, -4.0), (8.0, 8.0))
    results = {}
    tmin = cfg.ray_tmin
    for name, co, cd, ctmax, mt, any_hit in cases:
        tri = scan.ktab_tri[0] if mt == "vpu" else scan.ktab_mxu[0]
        soat, _, n_live = tv.prepare_rays(co, cd, ctmax, box, tmin)
        r = {}
        masks = _check_masks(name, soat, box, tmin, n_live, r)
        nblk = masks.shape[0]
        n_items, most = _item_counts(masks, w)
        lists = {}
        r["build_err"] = 0
        for label, sd in (("fits", items), ("defaults", defaults)):
            lists[label] = tv.build_items(masks, w, sd.items_max, sd.items_cap)
            plain = tv.build_items_plain(masks, w, sd.items_max,
                                         sd.items_cap)
            torch.cuda.synchronize()
            bad_b = [int((g.long() != p.long()).sum()) for g, p in
                     zip(lists[label], plain)]
            r["build_err"] = max([r["build_err"]] + [
                int((g.long() - p.long()).abs().max()) for g, p in
                zip(lists[label], plain)])
            print(f"{name}: build_items at the {label} budget "
                  f"{sd.items_max}/{sd.items_cap}: items, n_steps, overflow, "
                  f"block_used differing {bad_b} (n_steps "
                  f"{int(lists[label][1])})")
            if any(bad_b):
                raise AssertionError(f"{name}: build_items disagrees with "
                                     "plain")
        ovf = {k: bool(v[2]) for k, v in lists.items()}
        print(f"{name}: {int(n_live)} live steps, {n_items} items "
              f"({n_items / nblk:.1f} per block, most {most}); overflow at "
              f"{defaults.items_max}/{defaults.items_cap}: {ovf['defaults']}; "
              f"at {items.items_max}/{items.items_cap}: {ovf['fits']}")
        if ovf["fits"]:
            raise AssertionError(f"{name}: the never-overflowing budget "
                                 "overflowed")
        il, steps, _, _ = lists["fits"]
        soab = soat.view(nblk, scan.traverse_b, 8)
        t_k, p_k = tv.traverse_items(il, steps, soab, tri, tmin, mt, w,
                                     slices=sl)
        t_p, p_p = tv.traverse_items_plain(il, steps, soab, tri, tmin, mt, w)
        t_s, p_s = tv.traverse_blocks(masks, soat, tri, tmin, mt, False,
                                      n_live, slices=sl)
        torch.cuda.synchronize()
        # the item kernel finds the nearest hit on any-hit launches too, so
        # every comparison here is exact
        bad = {
            "prim vs plain": int((p_k != p_p).sum()),
            "t bits vs plain": int((t_k.view(torch.int32)
                                    != t_p.view(torch.int32)).sum()),
            "prim vs scan": int((p_k.view(-1) != p_s.view(-1)).sum()),
            "t bits vs scan": int((t_k.view(torch.int32).view(-1)
                                   != t_s.view(torch.int32).view(-1)).sum()),
        }
        fin = torch.isfinite(t_p)
        r["items_t_err"] = (float((t_k[fin] - t_p[fin]).abs().max())
                            if fin.any() else 0.0)
        print(f"{name}: traverse_items differing: {bad}; hits "
              f"{int((p_p >= 0).sum())}")
        if any(bad.values()):
            raise AssertionError(f"{name}: traverse_items disagrees")
        if any_hit:
            # the scan's own any-hit launch: only prim >= 0 is defined
            _, p_a = tv.traverse_blocks(masks, soat, tri, tmin, mt, True,
                                        n_live, slices=sl)
            torch.cuda.synchronize()
            bad_a = int(((p_a.view(-1) >= 0) != (p_p.view(-1) >= 0)).sum())
            print(f"{name}: traverse_blocks any-hit vs plain: prim >= 0 "
                  f"differing {bad_a}")
            if bad_a:
                raise AssertionError(f"{name}: any-hit scan disagrees")
        # the two routes through traverse(), at both budgets
        kw = dict(want_t=not any_hit, mt_mode=mt, any_hit=any_hit,
                  slices=sl)
        t_r, p_r = tv.traverse(co, cd, ctmax, box, tri, tmin, **kw)
        for label, sd in (("fits", items), ("defaults", defaults)):
            t_i, p_i = tv.traverse(co, cd, ctmax, box, tri, tmin, items=True,
                                   items_w=w, items_max=sd.items_max,
                                   items_cap=sd.items_cap, **kw)
            torch.cuda.synchronize()
            bad_r = int((p_i != p_r).sum())
            if not any_hit:
                bad_r += int((t_i.view(torch.int32)
                              != t_r.view(torch.int32)).sum())
            print(f"{name}: traverse(items=True) at the {label} budget vs "
                  f"the scan route: {bad_r} lanes differ")
            if bad_r:
                raise AssertionError(f"{name}: item route != scan route")
        r["items_ms"] = _device_ms(lambda: tv.traverse_items(
            il, steps, soab, tri, tmin, mt, w, slices=sl))
        r["items_plain_ms"] = _median_ms(lambda: tv.traverse_items_plain(
            il, steps, soab, tri, tmin, mt, w), 1)
        r["scan_ms"] = _device_ms(lambda: tv.traverse_blocks(
            masks, soat, tri, tmin, mt, any_hit, n_live, slices=sl))
        r["scan_call_ms"] = _median_ms(lambda: tv.traverse_blocks(
            masks, soat, tri, tmin, mt, any_hit, n_live, slices=sl), 20)
        r["scan_plain_ms"] = _median_ms(lambda: tv.traverse_blocks_plain(
            masks, soat, tri, tmin, mt, any_hit, n_live), 1)
        for label, sd in (("build_items", items),
                          ("build_items_ref", defaults)):
            r[label + "_ms"] = _device_ms(lambda: tv.build_items(
                masks, w, sd.items_max, sd.items_cap))
            r[label + "_plain_ms"] = _device_ms(lambda: tv.build_items_plain(
                masks, w, sd.items_max, sd.items_cap))
            # bytes: the mask words read, the list, n_steps, overflow and
            # block_used written once
            _put_bound(r, label, 0, masks.numel() * 4
                       + (sd.items_max + w + 1) * 4 + 1 + nblk)
        r["route_items_ms"] = _median_ms(lambda: tv.traverse(
            co, cd, ctmax, box, tri, tmin, items=True, items_w=w,
            items_max=items.items_max, items_cap=items.items_cap, **kw), 10)
        r["route_scan_ms"] = _median_ms(lambda: tv.traverse(
            co, cd, ctmax, box, tri, tmin, **kw), 10)
        r["items"] = n_items
        _mask_bound(r, soat, box, tmin, n_live, masks)
        runs = _slice_runs(name, masks, soat, tri, sl, tmin, mt, any_hit,
                           n_live)
        _traverse_bound(r, "scan", masks, soat, tri, mt, runs)
        _traverse_bound(r, "items", masks, soat, tri, mt,
                        _item_slice_runs(il, steps, soab, tri, sl, tmin,
                                         mt, w))
        r["scan_vs_items"] = r["scan_ms"] / r["items_ms"]
        print(f"{name}: device ms per launch (CUDA-graph replay): "
              f"traverse_items {r['items_ms']:.6g}, traverse_blocks "
              f"{r['scan_ms']:.6g} (scan_vs_items {r['scan_vs_items']:.4f}), "
              f"build_items {r['build_items_ms']:.6g} (reference budget "
              f"{r['build_items_ref_ms']:.6g}); {n_items} items")
        if not any_hit:
            _check_gather(name, scan, 0, p_k, r)
        results[name] = r
        print(f"{name}: " + _fmt(r), flush=True)

    _phase("big-scene frame")
    band = cfg.max_rays_per_pass // cfg.width
    with _tracing():
        frame()  # warm-up: captures the pass graph
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        imgs, queries = frame()
        torch.cuda.synchronize()
        launches = cuda_lib.launch_counts()
    frame()  # captures the untraced graph
    print(f"launches in one big-scene frame (traverse_items=True): "
          f"{launches}")
    img = imgs.reshape(cfg.height, cfg.width, 3).cpu().numpy()
    diag = _check_image(img, "big-scene frame")
    print(f"frame {img.shape}: queries {int(queries)}, {diag}")
    if min(launches[k] for k in BIG_ITEM_KERNELS) <= 0:
        raise AssertionError("a kernel of the path was never launched")
    _check_shade_launches("big-scene frame", launches, cfg.height // band,
                          cfg.max_depth)

    undo = _swap_plain()
    try:
        t0 = time.perf_counter()
        imgs_p, q_p = frame(graph=False)
        torch.cuda.synchronize()
        plain_frame_s = time.perf_counter() - t0
    finally:
        undo()
    img_p = imgs_p.reshape(cfg.height, cfg.width, 3).cpu().numpy()
    rel = _rel_rmse(img, img_p)
    print(f"plain-version big-scene frame: queries {int(q_p)}, "
          f"{plain_frame_s:.2f} s; relative RMSE vs kernels {rel:.3e}")
    if rel > 0.005:
        raise AssertionError(f"big-scene frame relative RMSE {rel} > 0.5%")

    imgs_s, q_s = frame(scan)
    flags = []
    build = tv.build_items

    def spy(*a):
        res = build(*a)
        flags.append(res[2])
        return res

    # the eager body, so the spy sees every launch's flag; the wrapper
    # counts its launches on the name it is called by
    spy.launches = build.launches
    tv.build_items = spy
    try:
        imgs_d, q_d = frame(defaults, graph=False)
    finally:
        tv.build_items = build
        build.launches = spy.launches
    torch.cuda.synchronize()
    share = sum(bool(f) for f in flags) / max(len(flags), 1)
    for label, other, q_o in (("scan route", imgs_s, q_s),
                              ("reference budget", imgs_d, q_d)):
        same = torch.equal(imgs.view(torch.int32), other.view(torch.int32))
        print(f"big-scene frame, item route vs {label}: bit-identical "
              f"{same}, queries {int(queries)} / {int(q_o)}")
        if not same or int(q_o) != int(queries):
            raise AssertionError(f"big-scene frame differs from the {label}")
    print(f"reference budget {defaults.items_max}/{defaults.items_cap}: "
          f"{sum(bool(f) for f in flags)} of {len(flags)} launches "
          f"overflowed to the scan (share {share:.3f})")

    for label, sd in (("items", items), ("scan", scan)):
        frame_s, q_frame = _time_frames(lambda: frame(sd), 1)
        mrays = q_frame / frame_s / 1e6
        print(f"big-scene frame, {label} route ({WIDTH}x{WIDTH}, 1 spp, "
              f"depth 3, {cfg.height // band} bands): "
              f"{frame_s * 1e3:.1f} ms/frame, {q_frame:.0f} issued queries, "
              f"{mrays:.3f} Mrays/s on {card}", flush=True)
    return {"results": results, "launches": launches}


def run_stage7(dev, card: str) -> dict:
    """Phases 7-8 on ``dev``: the stage-7 scene's camera, bounce and
    shadow populations at seeded lane times, moved into the bumpy
    domain's local space, through the kernels; then the stage-7 frame, and
    the cube's fold_small calls of its first band against their plain
    twin. Returns {"results", "launches", "frame", "fold"}."""
    import numpy as np
    import torch

    from rayito_tpu_torch.ops import transform as xf

    _phase("stage-7 scene")
    t0 = time.perf_counter()
    scene, cfg, cam, frame = stage7_setup(dev)
    print(f"stage-7 scene with the n={MESH_N} stand-in: domains (transform "
          f"slots) {scene.ktab_xf}, {scene.ktab_tri[0].shape[0]} kernel "
          f"clusters (padded), tiny meshes {scene.ktab_small}, "
          f"{scene.xf_times.shape[0]} transform slots of "
          f"{scene.xf_times.shape[1]} keys; "
          f"{time.perf_counter() - t0:.1f} s")
    if scene.ktab_xf != (scene.mesh_xf_host[1],):
        raise AssertionError("the bumpy mesh is not a transformed domain")

    _phase("stage-7 kernels")
    n = RAYS_PER_PASS
    lane_time = torch.from_numpy(
        np.random.default_rng(7).uniform(0.0, 1.0, n).astype(np.float32)
    ).to(dev)
    cases = _populations(scene, cfg, cam, (-1.5, 4.0, -1.5), (3.0, 3.0),
                         lane_time)
    results = {}
    for name, co, cd, ctmax, mt, any_hit in cases:
        # the domain's local space at each lane's time; t, and so tmax,
        # is the same there
        o_l, d_l, _ = xf.local_ray(scene, scene.ktab_xf[0], co, cd,
                                   lane_time)
        results[name] = _check_population(name, scene, 0, o_l, d_l, ctmax,
                                          mt, any_hit, cfg.ray_tmin)

    _phase("stage-7 frame")
    fr = _frame_phase(f"stage-7 frame (n={MESH_N} stand-in, {WIDTH}x{WIDTH},"
                      " 1 spp, depth 3, shutter 0..1", cfg, frame, card)
    for k in ("fold_small", "analytic_fold"):  # 9 queries on each of 2 bands
        if fr["launches"][k] != 18:
            raise AssertionError(f"stage 7: 18 {k} launches expected")
    # the cube's fold on every query of the first band, kernel against twin
    with _spy_folds() as folds:
        frame(graph=False)
        torch.cuda.synchronize()
    fold = _check_folds("stage-7", folds[:9])
    return {"results": results, "launches": fr["launches"], "frame": fr,
            "fold": fold}


# Lane instructions of one row test of csrc/analytic_fold.cu, counted from
# the SASS (tools/cmj_sass.py --kernels analytic_fold_kernel on sm_90a):
# each kind's row loop's float_loads (float instructions, compares,
# selects, MUFU and FCHK, and loads) less those of the chain loop inside
# it, the same on a closest-hit and an any-hit query; a link of a chain is
# counted at one instruction per flop (XF_FLOPS), as fold_small's; the
# winner's record, the lane's loads and stores, integer, address and
# control work are left out, so the bound stays a lower bound.
AF_INSNS = {"plane": 36, "sphere": 65, "rect": 156}


def _af_work(scene, o, d, time, tmin, tmax, any_hit: bool):
    """(lane instructions, bytes) of one analytic_fold call on this run's
    data: every lane walks every row, a keyed row's chain evaluated where
    the row before had another; on an any-hit query a lane stops at its
    first hit (per-row plain tests give the lanes still open). Bytes: the
    rays, tmax and time read once, the record (t, shape id, material,
    normal, color_mod) or occluded written once."""
    import torch

    from rayito_tpu_torch.ops import transform as xf
    from rayito_tpu_torch.render import trace as tr

    n = tmax.shape[0]
    open_ = torch.ones((n,), dtype=torch.bool, device=tmax.device)
    link = XF_FLOPS["link"] + XF_FLOPS["keyed"] * (
        scene.xf_times.shape[1] > 1)
    kinds = (("plane", scene.pln_xf_host, tr._plane_rows),
             ("sphere", scene.sph_xf_host, tr._sphere_rows),
             ("rect", scene.rect_xf_host,
              lambda *a: tr._rect_rows(*a)[0]))
    insns, cur = 0, None
    for kind, xf_host, rows_t in kinds:
        for row, slot in enumerate(xf_host):
            lanes = int(open_.sum())
            chain = xf.chain_slots(scene, slot)
            if chain and slot != cur:
                insns += lanes * len(chain) * link
            cur = slot if chain else None
            insns += lanes * AF_INSNS[kind]
            if any_hit:
                o_l, d_l, _ = xf.local_ray(scene, slot, o, d, time)
                t = rows_t(scene, row, row + 1, o_l, d_l, tmin, tmax)[0]
                open_ &= ~torch.isfinite(t)
    nbytes = n * 4 * (7 + scene.has_motion) + n * (1 if any_hit else 28)
    return insns, nbytes


def run_analytic(dev, card: str) -> dict:
    """Phase 28 on ``dev``: analytic_fold (csrc/analytic_fold.cu, every
    plane, sphere and rect of a query in one launch) against its plain twin
    on one 131,072-lane band at bounce 0 of stage 6 and of stage 7 (at
    seeded lane times): the camera and bounce rays' closest hit and the
    shadow rays' any hit, every output bit for bit; each timed (20 calls
    in a CUDA graph between events) beside the plain twin, against its
    bound (the larger of the lane instructions counted from the SASS at
    the issue limit and the bytes at 3.35 TB/s). Returns {"<stage>
    <population>": record}."""
    import numpy as np
    import torch

    from rayito_tpu_torch.render import trace as tr

    _phase("analytic folds")
    out = {}
    for label, setup in (("stage-6", stage6_setup), ("stage-7", stage7_setup)):
        scene, cfg, cam, _ = setup(dev)
        lane_time = torch.from_numpy(np.random.default_rng(7).uniform(
            0.0, 1.0, RAYS_PER_PASS).astype(np.float32)).to(dev) \
            if scene.has_motion else None
        cases = _populations(scene, cfg, cam, (-1.5, 4.0, -1.5), (3.0, 3.0),
                             lane_time)
        rows = scene.n_planes + scene.n_spheres + scene.n_rects
        for name, co, cd, ctmax, _, any_hit in cases:
            args = (scene, co, cd, lane_time, cfg.ray_tmin, ctmax)
            got = tr.analytic_fold(*args, any_hit=any_hit)
            want = tr.analytic_fold_plain(*args, any_hit=any_hit)
            torch.cuda.synchronize()
            if any_hit:
                got, want = [got], [want]
            else:
                got, want = ([*r[:3], r[3].x, r[3].y, r[3].z, r[4]]
                             for r in (got, want))
            bad = sum(_differing(g, w) for g, w in zip(got, want))
            hits = int(want[0].sum()) if any_hit else int(
                torch.isfinite(want[0]).sum())
            r = {"lanes": co.x.shape[0], "rows": rows, "hits": hits,
                 "ms": _device_ms(lambda: tr.analytic_fold(
                     *args, any_hit=any_hit)),
                 "plain_ms": _median_ms(lambda: tr.analytic_fold_plain(
                     *args, any_hit=any_hit), 3)}
            insns, nbytes = _af_work(*args, any_hit)
            bounds = {"operations": insns / PEAK_ISSUE * 1e3,
                      "bytes": nbytes / PEAK_BYTES * 1e3}
            r["bound_by"] = max(bounds, key=bounds.get)
            r["bound_ms"] = bounds[r["bound_by"]]
            r["share"] = r["bound_ms"] / r["ms"]
            r["insns_per_lane"] = insns / r["lanes"]
            kind = "any" if any_hit else "closest"
            print(f"{label} analytic_fold {name} ({kind} hit) on {card}: "
                  f"values differing {bad}, " + _fmt(r), flush=True)
            if bad:
                raise AssertionError(f"{label} {name}: analytic_fold "
                                     "disagrees with its plain twin")
            out[f"{label} {name}"] = r
    return out


def _plain_plumbing():
    """Point traverse()'s plumbing at the plain twins of ray_pack,
    ray_reorder and ray_unsort; returns the undo."""
    from rayito_tpu_torch.render import traverse as tv

    names = ("ray_pack", "ray_reorder", "ray_unsort")
    saved = [getattr(tv, k) for k in names]
    for k in names:
        setattr(tv, k, getattr(tv, k + "_plain"))

    def undo():
        for k, fn in zip(names, saved):
            setattr(tv, k, fn)

    return undo


# lanes of one traverse() call in the benchmark's cells: 409 rows of 640
# padded to 128 steps of 2,048 (the stable sort)
PLUMBING_LANES = 1 << 18


def _plumbing_bytes(n, n_tot, stable, want_t):
    """Bytes of each plumbing kernel, each input byte read once and each
    output byte written once: ray_pack reads 7 floats a real lane and
    writes a 32-byte row and the operand a lane; ray_reorder reads the
    lane order (and the sorted operand for the live count) and a row, and
    writes a row and perm; ray_unsort reads perm and prim (and t) a slot
    and writes prim (and t) a real lane."""
    order = 8 + 4 if stable else 4
    t = 4 if want_t else 0
    return {"pack": n * 28 + n_tot * 36,
            "reorder": n_tot * (order + 32) + n_tot * 36 + 4,
            "unsort": n_tot * (8 + t) + n * (4 + t)}


def run_plumbing(dev, card: str) -> dict:
    """Phase 29 on ``dev``: the traversal's plumbing kernels (ray_pack,
    ray_reorder, ray_unsort; csrc/ray_prep.cu) against their plain twins
    on the card, every output bit for bit, on stage 6's bounce and shadow
    rays at the cells' 262,144 lanes (one 512-row band); each timed (20
    calls in a CUDA graph between events, each after an 80 MB write that
    evicts L2, and back to back as warm_ms) beside its plain twin (back to
    back), with the torch.sort between them, the torch calls the kernels
    replaced (the soa8[perm] gather and the index_put unsort) as
    library_ms (after the write), each kernel's bound (bytes at 3.35 TB/s)
    and share, and the whole call's plumbing (back to back) through the
    kernels and through the plain twins; then ray_pack through a domain's
    transform chain (_plumbing_chain). Returns {population: record}."""
    import torch

    from rayito_tpu_torch.render import traverse as tv

    _phase("traversal plumbing")
    scene, cfg, cam, _ = stage6_setup(dev)
    cfg = dataclasses.replace(cfg, max_rays_per_pass=PLUMBING_LANES)
    cases = _populations(scene, cfg, cam, (-1.5, 4.0, -1.5), (3.0, 3.0))
    box = scene.ktab_box[0]
    tmin = cfg.ray_tmin
    flush = torch.empty(80 << 20, dtype=torch.uint8, device=dev)
    flush_ms = _device_ms(flush.zero_)
    out = {}
    for name, o, d, tmax, mt, any_hit in cases:
        if name == "camera":
            continue
        n = o.x.shape[0]
        tri = scene.ktab_tri[0] if mt == "vpu" else scene.ktab_mxu[0]
        soa8, operand = tv.ray_pack(o, d, tmax, box, tmin)
        soa8_p, operand_p = tv.ray_pack_plain(o, d, tmax, box, tmin)
        vals, idx = tv.coherence_sort(operand)
        soat, perm, n_live = tv.ray_reorder(soa8, vals, idx)
        ref = tv.ray_reorder_plain(soa8, vals, idx)
        masks = tv.cluster_masks(soat.view(-1, 2048, 8), box, tmin, n_live)
        t_bn, p_bn = (x.view(-1) for x in tv.traverse_blocks(
            masks, soat.view(-1, 2048, 8), tri, tmin, mt, any_hit, n_live,
            slices=scene.ktab_slice[0]))
        t_in = None if any_hit else t_bn
        un = tv.ray_unsort(p_bn, t_in, perm, n, any_hit)
        un_p = tv.ray_unsort_plain(p_bn, t_in, perm, n, any_hit)
        torch.cuda.synchronize()
        pairs = [(soa8, soa8_p), (operand, operand_p), *zip((soat, perm,
                                                             n_live), ref),
                 (un[1], un_p[1])] + ([] if any_hit else [(un[0], un_p[0])])
        bad = sum(_differing(a, b) for a, b in pairs)
        n_tot = soa8.shape[0]
        p_long = perm.long()

        def index_put():
            prim = torch.empty_like(p_bn)
            prim[p_long] = p_bn
            if t_in is not None:
                t = torch.empty_like(t_in)
                t[p_long] = t_in

        r = {"lanes": n, "slots": n_tot, "live_steps": int(n_live),
             "stable_sort": idx is not None}
        for key, fn, plain, lib in (
                ("pack", lambda: tv.ray_pack(o, d, tmax, box, tmin),
                 lambda: tv.ray_pack_plain(o, d, tmax, box, tmin), None),
                ("sort", lambda: tv.coherence_sort(operand), None, None),
                ("reorder", lambda: tv.ray_reorder(soa8, vals, idx),
                 lambda: tv.ray_reorder_plain(soa8, vals, idx),
                 lambda: soa8[perm]),
                ("unsort", lambda: tv.ray_unsort(p_bn, t_in, perm, n,
                                                 any_hit),
                 lambda: tv.ray_unsort_plain(p_bn, t_in, perm, n, any_hit),
                 index_put)):
            # the cell finds the inputs in L2 (warm_ms: calls back to
            # back); "ms" is each call after an 80 MB write that evicts
            # them, less that write's own time
            r[key + "_warm_ms"] = _device_ms(fn)
            r[key + "_ms"] = _device_ms(
                lambda fn=fn: (flush.zero_(), fn())) - flush_ms
            if plain is not None:
                r[key + "_plain_ms"] = _device_ms(plain)
            if lib is not None:
                r[key + "_library_ms"] = _device_ms(
                    lambda lib=lib: (flush.zero_(), lib())) - flush_ms

        def call():
            s, q, _ = tv.prepare_rays(o, d, tmax, box, tmin)
            tv.ray_unsort(p_bn, t_in, q, n, any_hit)

        r["call_ms"] = _device_ms(call)
        undo = _plain_plumbing()
        try:
            r["call_plain_ms"] = _device_ms(call)
        finally:
            undo()
        for key, nbytes in _plumbing_bytes(n, n_tot, idx is not None,
                                           t_in is not None).items():
            r[key + "_bytes"] = nbytes
            _put_bound(r, key, 0, nbytes)
        print(f"plumbing {name} on {card}: values differing {bad}, "
              + _fmt(r), flush=True)
        if bad:
            raise AssertionError(f"plumbing {name}: a kernel disagrees with "
                                 "its plain twin")
        out[name] = r
    out.update(_plumbing_chain(dev, card, flush, flush_ms))
    return out


def _chain_bytes(n, n_tot, keyed, want_ray, want_rot):
    """Bytes of one ray_pack launch through a domain's chain: the 7 floats
    of a real lane and its time where the tables have keys; a row and the
    operand a slot; the local ray (24 B) and the rotation (16 B) a real
    lane where asked. The slot table and the transform tables, a few
    hundred bytes every lane reads alike, are left out."""
    return (n * (28 + 4 * keyed) + n_tot * 36
            + n * (24 * want_ray + 16 * want_rot))


def _plumbing_chain(dev, card, flush, flush_ms) -> dict:
    """Phase 29's chained populations: ray_pack through a traversal
    domain's transform chain (the scene's ``ktab_chain`` row) against
    ray_pack_plain with the same chain, bit for bit (rows, operand, local
    ray, rotation, the live count the kernel adds to traverse.live_rays),
    on stage 7's rotating domain and on big_instanced's first one-key copy,
    bounce and shadow rays at 262,144 lanes and seeded lane times (some on
    a key, before the first and past the last), asking for what the main
    path asks (trace.py _launch: ray and rotation on a closest hit, the ray
    on a 'bw' any hit, nothing on a 'vpu' one). Each timed as phase 29
    times ray_pack (pack_warm_ms back to back, pack_ms after the L2
    flush, pack_plain_ms the twin) beside torch_chain_ms, the torch chain
    (ops/transform.py local_ray) and the chainless pack it replaced, with
    its bound (_chain_bytes at 3.35 TB/s). Returns {"chain.<domain>.
    <population>": record}."""
    import numpy as np
    import torch

    from portbench import port_scene
    from portbench import run as bench
    from rayito_tpu_torch.ops import transform as xf
    from rayito_tpu_torch.render import traverse as tv
    from rayito_tpu_torch.utils import tracing

    _phase("traversal plumbing through a domain's chain")
    n = PLUMBING_LANES
    rs = np.random.default_rng(11)
    t = rs.uniform(-0.25, 1.25, n).astype(np.float32)
    t[::7], t[1::7], t[2::7] = 0.0, 0.5, 1.0
    lane_time = torch.from_numpy(t).to(dev)
    stage7, cfg, cam, _ = stage7_setup(dev)
    cfg = dataclasses.replace(cfg, max_rays_per_pass=n)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "portbench", "configs",
                           "big_instanced.json")) as f:
        inst = json.load(f)
    big = port_scene.build(inst, {"bumpy": _standin_obj()}).compile(dev)
    tmin = cfg.ray_tmin
    out = {}
    for dom, scene, camera, light in (
            ("stage7", stage7, cam, ((-1.5, 4.0, -1.5), (3.0, 3.0))),
            ("big_instanced", big, bench.camera_of(inst["camera"]),
             ((-4.0, 10.0, -4.0), (8.0, 8.0)))):
        di = next(i for i, sl in enumerate(scene.ktab_chain) if sl.numel())
        slots = scene.ktab_chain[di]
        if slots.tolist() != xf.chain_slots(scene, scene.ktab_xf[di]):
            raise AssertionError(f"{dom}: the scene's slot table is not "
                                 "the domain's chain")
        box = scene.ktab_box[di]
        tables = (scene.xf_times, scene.xf_translate, scene.xf_scale,
                  scene.xf_rotate, scene.xf_nkeys)
        keyed = bool(int(scene.xf_nkeys[slots.long()].max()) > 1)
        for name, o, d, tmax, mt, any_hit in _populations(
                scene, cfg, camera, *light, lane_time):
            if name == "camera":
                continue
            tmax = tmax.contiguous()
            chain = tv.Chain(tables, slots, lane_time,
                             want_ray=not any_hit or mt != "vpu",
                             want_rot=not any_hit)

            def counted(pack):
                """(pack's outputs, the lanes it added to
                traverse.live_rays)."""
                with _tracing():
                    tracing.reset()
                    got = pack(o, d, tmax, box, tmin, chain=chain)
                    torch.cuda.synchronize()
                    live = tracing.counters().get("traverse.live_rays", 0)
                    tracing.reset()
                return got, live

            (ker, live), (ref, live_p) = (
                counted(tv.ray_pack), counted(tv.ray_pack_plain))
            pairs = [(ker[0], ref[0]), (ker[1], ref[1])]
            for a, b in zip(ker[2], ref[2]):
                if (a is None) != (b is None):
                    raise AssertionError(f"chain {dom} {name}: the kernel "
                                         "and its twin hand on different "
                                         "outputs")
                if a is not None:
                    pairs.append((a, b))
            bad = sum(_differing(a, b) for a, b in pairs)
            n_tot = ker[0].shape[0]

            def torch_chain():
                o_l, d_l, _ = xf.local_ray(scene, scene.ktab_xf[di], o, d,
                                           lane_time)
                o_l, d_l = (type(v)(v.x.contiguous(), v.y.contiguous(),
                                    v.z.contiguous()) for v in (o_l, d_l))
                return tv.ray_pack(o_l, d_l, tmax, box, tmin)

            fn = lambda: tv.ray_pack(o, d, tmax, box, tmin, chain=chain)
            r = {"lanes": n, "slots": n_tot, "domain": di,
                 "depth": slots.shape[0], "keyed": keyed,
                 "want_ray": chain.want_ray, "want_rot": chain.want_rot,
                 "live_rays": live, "live_rays_plain": live_p,
                 "pack_warm_ms": _device_ms(fn),
                 "pack_ms": _device_ms(
                     lambda: (flush.zero_(), fn())) - flush_ms,
                 "pack_plain_ms": _device_ms(
                     lambda: tv.ray_pack_plain(o, d, tmax, box, tmin,
                                               chain=chain)),
                 "torch_chain_ms": _device_ms(torch_chain),
                 "pack_bytes": _chain_bytes(n, n_tot, keyed,
                                            chain.want_ray, chain.want_rot)}
            _put_bound(r, "pack", 0, r["pack_bytes"])
            print(f"plumbing chain {dom} {name} on {card}: values "
                  f"differing {bad}, " + _fmt(r), flush=True)
            if bad or live != live_p or not 0 < live < n:
                raise AssertionError(f"plumbing chain {dom} {name}: ray_pack "
                                     "disagrees with its plain twin")
            out[f"chain.{dom}.{name}"] = r
    return out


def run_stage7b(dev, card: str) -> dict:
    """Phase 9 on ``dev``: bench.py's stage-7b frame with the launch counts
    set to 0 just before it and read just after (no traversal kernel: the
    scene has no domain; gather_rows_t fetches the tiny meshes' winners'
    meta rows, fold_small folds the ten cubes once per query, 9 launches,
    cmj draws the samples); the gather's and every fold's inputs of that
    frame against their plain versions; the fold on the one-key and
    nested-chain scenes; a second frame bit-identical; one timed frame."""
    import torch

    from rayito_tpu_torch.render import trace as tr
    from rayito_tpu_torch.utils import cuda_lib

    _phase("stage-7b frame")
    scene, cfg, cam, frame = stage7b_setup(dev)
    print(f"stage-7b scene: {scene.n_spheres} spheres, {scene.n_meshes} "
          f"meshes ({scene.tri_meta_rows.shape[0]} triangle rows), domains "
          f"{scene.ktab_xf}, tiny meshes {scene.ktab_small}")
    with _tracing():
        frame()  # warm-up: captures the pass graph
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        imgs, queries = frame()
        torch.cuda.synchronize()
        launches = cuda_lib.launch_counts()
    frame()  # captures the untraced graph
    print(f"launches in one stage-7b frame: {launches}")
    if any(launches[k] for k in TRAVERSAL_KERNELS) or min(
            launches[k] for k in ("gather_rows_t", "cmj", "fold_small")) <= 0:
        raise AssertionError("stage-7b: expected gather_rows_t, cmj and "
                             "fold_small launches and no traversal launch")
    _check_shade_launches("stage-7b frame", launches, cfg.height // (
        cfg.max_rays_per_pass // cfg.width), cfg.max_depth)
    img = imgs.reshape(cfg.height, cfg.width, 3).cpu().numpy()
    diag = _check_image(img, "stage-7b frame")
    print(f"frame {img.shape}: queries {int(queries)}, {diag}")
    # the same frame through the eager body, its first gather's inputs and
    # every fold's (one per query) kept for the kernel-against-plain checks
    calls = []
    gather = tr.gather_rows_t

    def spy(table, idx):
        if not calls:
            calls.append((table, idx.clone()))
        return gather(table, idx)

    tr.gather_rows_t = spy
    try:
        with _spy_folds() as folds:
            imgs2, q2 = frame(graph=False)
            torch.cuda.synchronize()
    finally:
        tr.gather_rows_t = gather
    if launches["fold_small"] != len(folds) or len(folds) != 9:
        raise AssertionError(f"stage-7b: {launches['fold_small']} fold_small "
                             f"launches for {len(folds)} queries; 9 expected")
    r = {}
    table, idx = calls[0]
    _check_gather_rows("stage-7b meta rows", table, idx, r, "meta")
    print("stage-7b meta rows: " + _fmt(r))
    fold_r = _check_folds("stage-7b", folds)
    fold_r["scenes"] = _check_fold_scenes(dev)
    same = torch.equal(imgs.view(torch.int32), imgs2.view(torch.int32))
    print(f"stage-7b eager frame bit-identical to the replayed {same}, "
          f"queries {int(queries)} / {int(q2)}")
    if not same or int(q2) != int(queries):
        raise AssertionError("stage-7b frame differs between eager and "
                             "replayed")
    frame_s, q_frame = _time_frames(frame, 1)
    mrays = q_frame / frame_s / 1e6
    print(f"stage-7b frame ({cfg.width}x{cfg.height}, 1 spp, depth 3, "
          f"shutter 0..1): {frame_s * 1e3:.1f} ms/frame, {q_frame:.0f} issued "
          f"queries, {mrays:.3f} Mrays/s on {card}", flush=True)
    return {"results": {"meta": r}, "fold": fold_r, "launches": launches,
            "frame": {"frame_ms": frame_s * 1e3, "mrays": mrays,
                      "queries": q_frame}}


@contextlib.contextmanager
def _spy_folds():
    """Collect the inputs of every fold_small call the path makes (render/
    trace.py's two call sites), cloned: a list of (args, kwargs)."""
    from rayito_tpu_torch.ops.quaternion import Quat
    from rayito_tpu_torch.ops.vec3 import V3
    from rayito_tpu_torch.render import trace as tr

    fold, calls = tr.fold_small, []
    c = lambda t: t.clone() if t is not None else None  # noqa: E731
    v3 = lambda v: V3(c(v.x), c(v.y), c(v.z))  # noqa: E731

    def spy(scene, o, d, time, tmin, tmax, best=None, occluded=None):
        kw = {"occluded": c(occluded)}
        if best is not None:
            t, p, b, g, rot = best
            kw = {"best": (c(t), c(p), c(b), c(g), None if rot is None else
                           Quat(c(rot.w), v3(rot.v)))}
        calls.append(((scene, v3(o), v3(d), c(time), tmin, c(tmax)), kw))
        return fold(scene, o, d, time, tmin, tmax, best, occluded)

    tr.fold_small = spy
    try:
        yield calls
    finally:
        tr.fold_small = fold


def _fold_outputs(out) -> list:
    """fold_small's outputs as a flat list of tensors."""
    if not isinstance(out, tuple):
        return [out]
    rot = out[4]
    return list(out[:4]) + ([] if rot is None else
                            [rot.w, rot.v.x, rot.v.y, rot.v.z])


def _fold_work(args, kw):
    """(flops, lane instructions, bytes) of one fold_small call on this
    run's data: every lane walks every mesh (each link's transform, each
    real triangle's test) on a closest-hit query; on an any-hit query a
    lane stops at its first hit, so a mesh that hits it is counted at one
    test (the plain twin's per-mesh hits give the lanes still open)."""
    import torch

    from rayito_tpu_torch.ops import transform as xf
    from rayito_tpu_torch.render import mesh_intersect as mi

    scene, o, d, time, tmin, tmax = args
    n = tmax.shape[0]
    open_ = (torch.ones((n,), dtype=torch.bool, device=tmax.device)
             if kw.get("occluded") is None else ~kw["occluded"])
    flops = insns = 0
    for mi_ in scene.ktab_small:
        count = scene.mesh_tri_ranges[mi_][1]
        depth = len(mi._chain(scene, mi_))
        lanes = int(open_.sum())
        hit_lanes = 0
        if kw.get("occluded") is not None:
            o_l, d_l, _ = xf.local_ray(scene, scene.mesh_xf_host[mi_], o, d,
                                       time)
            tq = torch.where(open_, tmax, 0.0)
            hit = mi.mesh_fold_small(scene, mi_, o_l, d_l, tmin, tq)[1] >= 0
            hit_lanes = int((hit & open_).sum())
            open_ = open_ & ~hit
        tests = (lanes - hit_lanes) * count + hit_lanes
        link = XF_FLOPS["link"] + XF_FLOPS["keyed"] * (
            scene.xf_times.shape[1] > 1)
        flops += lanes * depth * link + tests * TEST_OPS["vpu"]
        insns += lanes * depth * link + tests * FOLD_INSNS[
            "any" if kw.get("occluded") is not None else "closest"]
    n_state = 4 + 4 * scene.has_motion if kw.get("best") else 1
    nbytes = (n * 4 * (7 + scene.has_motion + n_state) * 2
              + 9 * 4 * sum(scene.mesh_tri_ranges[m][1]
                            for m in scene.ktab_small))
    return flops, insns, nbytes


def _check_folds(label, calls) -> dict:
    """fold_small against its plain twin (fold_small_query_plain) on each
    captured call's inputs: every output bit for bit on every lane (t,
    prim, beta, gamma and the rotation on a closest-hit query, occluded
    on an any-hit one); device times (CUDA-graph replays of 20 calls), the
    plain twin's, and the bound of each call's work (flops at 67 TFLOP/s,
    lane instructions from the SASS at the issue limit, or bytes), averaged
    over the calls."""
    import torch

    from rayito_tpu_torch.render import mesh_intersect as mi

    r = {"calls": len(calls), "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
         "err": 0.0}
    for args, kw in calls:
        got = _fold_outputs(mi.fold_small(*args, **kw))
        want = _fold_outputs(mi.fold_small_query_plain(*args, **kw))
        torch.cuda.synchronize()
        bad = sum(_differing(g, w) for g, w in zip(got, want))
        if len(got) > 1:
            fin = torch.isfinite(want[0])
            if bool(fin.any()):
                r["err"] = max(r["err"], float((got[0][fin] - want[0][fin])
                                               .abs().max()))
        kind = "closest" if len(got) > 1 else "any"
        hits = int((want[1] >= 0).sum()) if len(got) > 1 else int(
            want[0].sum())
        print(f"{label} fold_small ({kind} hit): {args[5].shape[0]} lanes, "
              f"{len(args[0].ktab_small)} meshes, {hits} hits, values "
              f"differing {bad}")
        if bad:
            raise AssertionError(f"{label}: fold_small disagrees with its "
                                 "plain twin")
        r["ms"] += _device_ms(lambda: mi.fold_small(*args, **kw))
        r["plain_ms"] += _median_ms(
            lambda: mi.fold_small_query_plain(*args, **kw), 3)
        flops, insns, nbytes = _fold_work(args, kw)
        bounds = {"flops": flops / PEAK_F32 * 1e3,
                  "operations": insns / PEAK_ISSUE * 1e3,
                  "bytes": nbytes / PEAK_BYTES * 1e3}
        by = max(bounds, key=bounds.get)
        r["bound_ms"] += bounds[by]
        r["bound_by"] = "bytes" if by == "bytes" else "operations"
        r["lanes"] = args[5].shape[0]
    for k in ("ms", "plain_ms", "bound_ms"):
        r[k] /= max(len(calls), 1)
    r["share"] = r["bound_ms"] / r["ms"]
    r["library_ms"] = None
    print(f"{label} fold_small per call: " + _fmt(r), flush=True)
    return r


def _check_fold_scenes(dev) -> dict:
    """fold_small against its plain twin on the one-key scene, the nested
    scene, the twin-row mesh (192 rows, 96 triangles twice: every hit must
    go to the lower twin row) and stage 7b's cubes cut into launches of at
    most 3 meshes (four chained launches a query, each folding into the
    last one's outputs): 131,072 seeded rays at the meshes, at seeded lane
    times in [-0.5, 1.5] (outside the keys on either side too), a running
    best of their own and every 9th ray cut short, closest and any hit."""
    import numpy as np
    import torch

    from rayito_tpu_torch.models.demo import (nested_cube_scene,
                                              one_key_cube_scene,
                                              stage7_scene2, twin_mesh_scene)
    from rayito_tpu_torch.ops.quaternion import Quat
    from rayito_tpu_torch.ops.vec3 import V3
    from rayito_tpu_torch.render import mesh_intersect as mi

    rs = np.random.default_rng(12)
    n = RAYS_PER_PASS
    o = np.tile(np.float32([0.3, 0.8, 6.0]), (n, 1))
    d = rs.uniform(-1.2, 1.6, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e30, np.float32)
    tmax[::9] = rs.uniform(1.0, 6.0, tmax[::9].shape)
    time_u = rs.uniform(-0.5, 1.5, n)
    t_run = np.where(rs.random(n) < 0.3, rs.uniform(4.0, 8.0, n), np.inf)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa
    v3 = lambda a: V3(f(a[:, 0]), f(a[:, 1]), f(a[:, 2]))  # noqa: E731
    one = torch.ones((n,), device=dev)
    zero = torch.zeros((n,), device=dev)
    out = {}
    max_meshes = mi.FOLD_MAX_MESHES
    for name, make in (("one_key", one_key_cube_scene),
                       ("nested", nested_cube_scene),
                       ("twins", twin_mesh_scene),
                       ("chained", stage7_scene2)):
        scene = make().compile(dev)
        if name == "chained":
            o_c = np.tile(np.float32([-4.0, 10.0, 30.0]), (n, 1))
            d_c = np.stack([rs.uniform(-10.0, 11.0, n),
                            rs.uniform(-2.0, 11.0, n),
                            rs.uniform(1.0, 4.0, n)], 1) - o_c
            d_c /= np.linalg.norm(d_c, axis=1, keepdims=True)
            rays = (v3(o_c), v3(d_c))
            mi.FOLD_MAX_MESHES = 3
        else:
            rays = (v3(o), v3(d))
        best = (f(t_run), torch.where(f(t_run) < 1e30, 5, -1).to(torch.int32),
                zero + 0.25, zero + 0.5,
                Quat(one, V3(zero, zero, zero)) if scene.has_motion else None)
        calls = [((scene, *rays, f(time_u), 1e-4, f(tmax)), {"best": best}),
                 ((scene, *rays, f(time_u), 1e-4, f(tmax)),
                  {"occluded": torch.from_numpy(rs.random(n) < 0.2).to(dev)})]
        print(f"{name} scene: tiny meshes {scene.ktab_small}, keys per slot "
              f"{scene.xf_times.shape[1]}, chain depth {scene.xf_depth}, "
              f"launches per query {len(mi._fold_specs(scene))}")
        try:
            out[name] = _check_folds(name, calls)
            if name == "twins":
                _check_twin_rows(scene, calls[0])
        finally:
            mi.FOLD_MAX_MESHES = max_meshes
    return out


def _check_twin_rows(scene, call) -> None:
    """On the twin-row mesh, every closest hit of the kernel is the lower
    of its two equal rows (the first minimum)."""
    from rayito_tpu_torch.render import mesh_intersect as mi

    args, kw = call
    prim = mi.fold_small(*args, **kw)[1]
    hit = prim != kw["best"][1]
    row0, count = scene.mesh_tri_ranges[scene.ktab_small[0]]
    rows = scene.tri_vert_rows[row0:row0 + count, :9].cpu().numpy()
    first = {}
    for i, r in enumerate(rows):
        first.setdefault(r.tobytes(), i)
    won = set((prim[hit] - row0).tolist())
    late = [i for i in won if first[rows[i].tobytes()] != i]
    print(f"twins: {int(hit.sum())} hits on {len(won)} rows of {count} "
          f"({len(first)} distinct), won by the upper twin {len(late)}")
    if len(first) != count // 2 or late or int(hit.sum()) < 1000:
        raise AssertionError("twins: a hit went to the upper twin row")


# the kernel each wrapper launches exactly once per call, by its symbol
MARKERS = {"cluster_masks": "cluster_masks_kernel",
           "traverse_blocks": "blocks_init_kernel",
           "gather_rows_t": "gather_rows_t_kernel",
           "traverse_items": "items_init_kernel",
           "build_items": "build_items_kernel",
           "cluster_pipeline": "cluster_pipeline_kernel",
           "cmj": "cmj_draws_kernel",
           "fold_small": "fold_small_kernel",
           "bounce_prepare": "bounce_prepare_kernel",
           "bounce_resolve": "bounce_resolve_kernel",
           "analytic_fold": "analytic_fold_kernel",
           "ray_pack": "ray_pack_kernel",
           "ray_reorder": "ray_reorder_kernel",
           "ray_unsort": "ray_unsort_kernel"}


# idle time inside the profiler's window on each side of a profiled frame:
# late in a long run the profiler has kept all but the last one to six
# sample-kernel records of a frame whose device counters were right (the
# kernels near the window's edge), while the same frame profiled in a
# fresh process matched every time
PROFILE_PAD_S = 0.1


def _profile_frame(frame) -> dict:
    """One frame under torch.profiler: the host's kernel launches (its
    count of cudaLaunchKernel calls) and CUDA-graph launches
    (cudaGraphLaunch), and from the device's records, those inside graph
    replays included: the device ops, the kernel ms summed, each wrapper's
    launches (its ``MARKERS`` kernel), the frame's wall ms under the
    profiler, and the profile itself."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rayito_tpu_torch.utils.profiling import collect_device_ops

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    counts = {e.key: e.count for e in prof.key_averages()}
    ops = collect_device_ops(prof)
    return {
        "host_kernel_launches": sum(counts.get(k, 0) for k in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")),
        "graph_launches": sum(counts.get(k, 0) for k in (
            "cudaGraphLaunch", "cuGraphLaunch")),
        "device_ops": sum(n for _, n in ops.values()),
        "kernel_ms": sum(us for us, _ in ops.values()) / 1e3,
        "wall_ms": wall_ms,
        "by_kernel": {k: sum(n for name, (_, n) in ops.items() if sym in name)
                      for k, sym in MARKERS.items()},
        "prof": prof}


def _host_launches(frame) -> str:
    """The host's launches of one frame: kernels, and graphs beside."""
    p = _profile_frame(frame)
    return (f"{p['host_kernel_launches']} kernel / {p['graph_launches']} "
            "graph")


def _same_frame(label, a, b):
    """Two (images, queries) results must agree bit for bit."""
    import torch

    same = torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    print(f"{label}: bit-identical {same}, queries {int(a[1])} / {int(b[1])}")
    if not same or int(a[1]) != int(b[1]):
        raise AssertionError(f"{label}: the frames differ")


def run_stage5(dev, card: str) -> dict:
    """Phase 10 on ``dev``: the stage-5 frame with the launch counts set to
    0 just before it and read just after (no mesh: the sample streams'
    kernel must launch, no other kernel of the port may); the eager frame
    bit-identical; host launches; one timed frame."""
    import torch

    from rayito_tpu_torch.utils import cuda_lib

    _phase("stage-5 frame")
    scene, cfg, cam, frame = stage5_setup(dev)
    print(f"stage-5 scene: {scene.n_planes} plane, {scene.n_spheres} spheres, "
          f"{scene.n_rects} rect, {scene.n_meshes} meshes, {scene.n_lights} "
          f"lights (kinds {scene.light_kinds_host})")
    with _tracing():
        frame()  # warm-up: captures the pass graph
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        first = frame()
        torch.cuda.synchronize()
        launches = cuda_lib.launch_counts()
    frame()  # captures the untraced graph
    print(f"launches in one stage-5 frame: {launches}")
    if min(launches[k] for k in ("cmj", "analytic_fold")) <= 0 or any(
            v for k, v in launches.items() if k not in ("cmj", "analytic_fold")
            + SHADE_KERNELS):
        raise AssertionError("stage 5 has no mesh: expected cmj, analytic_fold "
                             "and shading launches and no other kernel")
    _check_shade_launches("stage-5 frame", launches, cfg.height // (
        cfg.max_rays_per_pass // cfg.width), cfg.max_depth)
    img = first[0].reshape(cfg.height, cfg.width, 3).cpu().numpy()
    diag = _check_image(img, "stage-5 frame")
    print(f"frame {img.shape}: queries {int(first[1])}, {diag}")
    _same_frame("stage-5 eager frame against the replayed", first,
                frame(graph=False))
    host = _host_launches(frame)
    frame_s, q_frame = _time_frames(frame, 1)
    mrays = q_frame / frame_s / 1e6
    print(f"stage-5 frame ({cfg.width}x{cfg.height}, 1 spp, depth 3): "
          f"{host} host launches, {frame_s * 1e3:.1f} ms/frame, {q_frame:.0f} "
          f"queries, {mrays:.3f} Mrays/s on {card}", flush=True)
    return {"launches": launches, "host_launches": host,
            "frame": {"frame_ms": frame_s * 1e3, "mrays": mrays,
                      "queries": q_frame}}


def _captured_launches(fn):
    """Run ``fn`` and return what it handed to the traversal: [(domain, o,
    d, tmax, mt_mode, any_hit)], rays in the domain's space (the world
    rays ``_launch`` takes, through the domain's chain where it has one)."""
    from rayito_tpu_torch.ops import transform as xf
    from rayito_tpu_torch.render import trace as tr

    seen = []
    launch = tr._launch

    def spy(scene, di, o, d, time, tmax, tmin, mt, sort_rays, any_hit,
            **want):
        o_l, d_l, _ = xf.local_ray(scene, scene.ktab_xf[di], o, d, time)
        seen.append((di, o_l, d_l, tmax.clone(), mt, any_hit))
        return launch(scene, di, o, d, time, tmax, tmin, mt, sort_rays,
                      any_hit, **want)

    tr._launch = spy
    try:
        fn()
    finally:
        tr._launch = launch
    return seen


def _mesh_light_populations(scene, cfg, cam, li):
    """The three traversal launches of one band's first bounce when light
    ``li`` is a mesh light, exactly as the path tracer makes them
    (captured at the launch): camera rays; the BRDF-side closest-hit rays
    (BRDF-sampled directions from the camera hits, dead lanes at
    tmax = tmin, capped at the analytic winner); the light-side shadow rays
    toward sampled points of the mesh light (tmax = dist - tmin, rounded
    down one key bucket). Returns ([(name, o, d, tmax, mt, any_hit)], the
    shading points V3, the sample's u1 u2 u3)."""
    import numpy as np
    import torch

    from rayito_tpu_torch.ops.brdf import KIND_EMITTER, KIND_REFLECTION, sample_sa
    from rayito_tpu_torch.ops.vec3 import RAY_TMAX, dot
    from rayito_tpu_torch.render import lights as L
    from rayito_tpu_torch.render import shade
    from rayito_tpu_torch.render import trace as tr
    from rayito_tpu_torch.render.integrator import _pixel_grid, screen_uv

    dev, tmin = scene.device, cfg.ray_tmin
    band = cfg.max_rays_per_pass // cfg.width
    px, py = _pixel_grid(cfg.width, band, dev)
    half = torch.full(px.shape, 0.5, device=dev)
    xu, yu = screen_uv(cfg, px, py, half, half)
    o, d, _ = cam.to(xu.device).make_rays(xu, yu, half, half, half)
    n = px.shape[0]
    out = {}
    hits = []
    out["camera"] = _captured_launches(lambda: hits.append(
        tr.scene_intersect(scene, o, d, None, tmin, 1e30)))
    hit = hits[0]
    kind, _, exponent = shade._mat_lookup(scene, hit.mat)
    nee = hit.valid & (kind != KIND_EMITTER) & (kind != KIND_REFLECTION)
    pos = o + d * hit.t
    u = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 1.0, (5, n)).astype(np.float32)).to(dev)
    # light side
    lp, _, lpdf = L.sample_light(scene, li, pos, hit.normal, None, u[0],
                                 u[1], u[2], tmin)
    inc = pos - lp
    dist = torch.sqrt(torch.clamp_min(dot(inc, inc), 1e-37))
    ok_l = nee & (lpdf > 0.0)
    out["shadow"] = _captured_launches(lambda: tr.scene_occluded(
        scene, pos, -(inc / dist), None, tmin,
        torch.where(ok_l, dist - tmin, 0.0)))
    # BRDF side
    b_in, f_b, pdf_b = sample_sa(kind, exponent, -d, hit.normal, u[3], u[4])
    ok_b = nee & (pdf_b > 0.0) & (f_b > 0.0)
    tmax_b = torch.where(ok_b, RAY_TMAX, tmin)
    out["brdf"] = _captured_launches(lambda: tr.scene_intersect(
        scene, pos, -b_in, None, tmin, tmax_b))
    cases = []
    for name in ("camera", "brdf", "shadow"):
        (di, co, cd, ctmax, mt, any_hit), = out[name]
        dead = int((ctmax <= tmin).sum())
        print(f"{name}: {n} lanes, {dead} dead (tmax <= tmin: "
              f"{int((ctmax == tmin).sum())} at tmin, "
              f"{int((ctmax == 0).sum())} at 0), mt {mt}, any_hit {any_hit}")
        cases.append((name, co, cd, ctmax, mt, any_hit))
    return cases, pos, u[:3]


def _check_mesh_light_sampling(scene, on_cpu, li, pos, u, tmin):
    """sample_light of mesh light ``li`` on the card against the same call
    on the CPU, on the same inputs: identical triangle picks, positions to
    1e-5, the same rejected samples away from the facing edge, pdf to 1e-5
    relative."""
    import torch

    from rayito_tpu_torch.ops.vec3 import V3, dot
    from rayito_tpu_torch.render import lights as L

    mi = scene.light_indices_host[li]
    tri0 = scene.mesh_tri_ranges[mi][0]
    n_padded = scene.mesh_cl_ranges[mi][1] * 48
    picks = [torch.searchsorted(
        sd.tri_area_cdf[tri0:tri0 + n_padded],
        u3 * sd.mesh_total_area[mi], right=True).cpu()
        for sd, u3 in ((scene, u[2]), (on_cpu, u[2].cpu()))]
    bad_picks = int((picks[0] != picks[1]).sum())
    cpu = lambda v: V3(v.x.cpu(), v.y.cpu(), v.z.cpu())
    fin = (torch.isfinite(pos.x) & torch.isfinite(pos.y)
           & torch.isfinite(pos.z)).cpu()
    g_pos, g_nrm, g_pdf = L.sample_light(scene, li, pos, None, None, u[0],
                                         u[1], u[2], tmin)
    r_pos, r_nrm, r_pdf = L.sample_light(on_cpu, li, cpu(pos), None, None,
                                         u[0].cpu(), u[1].cpu(), u[2].cpu(),
                                         tmin)
    g_pos, g_pdf = cpu(g_pos), g_pdf.cpu()
    pos_err = max(float((a - b).abs()[fin].max()) for a, b in
                  zip((g_pos.x, g_pos.y, g_pos.z), (r_pos.x, r_pos.y, r_pos.z)))
    clear = fin & (dot(r_nrm, cpu(pos) - r_pos).abs() > 1e-4)
    bad_zero = int(((g_pdf == 0) != (r_pdf == 0))[clear].sum())
    lit = clear & (r_pdf > 0) & (g_pdf > 0)
    pdf_err = float(((g_pdf - r_pdf).abs() / r_pdf)[lit].max())
    print(f"sample_light of the mesh light, card vs CPU on {int(fin.sum())} "
          f"shading points: CDF of {n_padded} triangles, "
          f"{int(picks[1].unique().numel())} distinct picks, picks differing "
          f"{bad_picks}, position max abs diff {pos_err:.3e}, rejected-sample "
          f"masks differing {bad_zero} (of {int(clear.sum())} lanes off the "
          f"facing edge), pdf max relative diff {pdf_err:.3e} over "
          f"{int(lit.sum())} lit lanes")
    if bad_picks or bad_zero or pos_err > 1e-5 or pdf_err > 1e-5:
        raise AssertionError("mesh-light sampling on the card differs from "
                             "the CPU's")


def run_mesh_light(dev, card: str) -> dict:
    """Phases 11-12 on ``dev``: mesh-light sampling against the CPU; the
    camera, BRDF-side and light-side populations through the stage-6
    kernels, and once through the item route; the mesh-light frame.
    Returns {"results", "launches", "frame", "items_route_differing"}."""
    import torch

    from rayito_tpu_torch.models.scene import LIGHT_MESH
    from rayito_tpu_torch.render import trace as tr
    from rayito_tpu_torch.render import traverse as tv

    _phase("mesh-light scene")
    t0 = time.perf_counter()
    scene, on_cpu, cfg, cam, frame = mesh_light_setup(dev)
    li = scene.light_kinds_host.index(LIGHT_MESH)
    mi = scene.light_indices_host[li]
    print(f"mesh-light scene (stage-6 geometry, the n={MESH_N} stand-in as a "
          f"ShapeLight): lights {scene.light_kinds_host}, mesh {mi} of "
          f"{scene.n_meshes} is the light: {scene.mesh_tri_ranges[mi][1]} "
          f"triangles, cluster range {scene.mesh_cl_ranges[mi]}, area CDF of "
          f"{scene.tri_area_cdf.shape[0]} entries, local area "
          f"{float(scene.mesh_total_area[mi]):.6g}; domains {scene.ktab_xf}; "
          f"{time.perf_counter() - t0:.1f} s")

    _phase("mesh-light kernels")
    tmin = cfg.ray_tmin
    cases, pos, u = _mesh_light_populations(scene, cfg, cam, li)
    _check_mesh_light_sampling(scene, on_cpu, li, pos, u, tmin)
    results, differing = {}, 0
    box = scene.ktab_box[0]
    c_pad = box.shape[1]
    n_blocks = RAYS_PER_PASS // scene.traverse_b
    for name, co, cd, ctmax, mt, any_hit in cases:
        results[name] = _check_population(f"mesh-light {name}", scene, 0, co,
                                          cd, ctmax, mt, any_hit, tmin)
        # once through the item route, at the budget that never overflows
        tri = scene.ktab_tri[0] if mt == "vpu" else scene.ktab_mxu[0]
        kw = dict(want_t=not any_hit, mt_mode=mt, any_hit=any_hit,
                  slices=scene.ktab_slice[0])
        t_r, p_r = tv.traverse(co, cd, ctmax, box, tri, tmin, **kw)
        t_i, p_i = tv.traverse(co, cd, ctmax, box, tri, tmin, items=True,
                               items_w=4, items_max=n_blocks * c_pad,
                               items_cap=c_pad, **kw)
        torch.cuda.synchronize()
        bad = int((p_i != p_r).sum())
        if not any_hit:
            bad += int((t_i.view(torch.int32) != t_r.view(torch.int32)).sum())
        print(f"mesh-light {name}: traverse(items=True) vs the scan route: "
              f"{bad} lanes differ")
        differing += bad
    if differing:
        raise AssertionError("mesh-light: item route != scan route")
    cam_pairs = results["camera"]["pairs"]
    for name in ("brdf", "shadow"):
        print(f"mesh-light {name}: {results[name]['pairs']} (block, cluster) "
              f"pairs listed, {results[name]['pairs'] / cam_pairs:.3f}x the "
              f"camera population's {cam_pairs}")

    _phase("mesh-light frame")
    modes = [mt for _, _, _, _, mt, _ in _captured_launches(
        lambda: frame(graph=False))]
    tally = {mt: modes.count(mt) for mt in sorted(set(modes))}
    print(f"traversal launches of one mesh-light frame by triangle test: "
          f"{tally} (closest-hit launches are 'bw', any-hit 'vpu')")
    fr = _frame_phase(f"mesh-light frame (n={MESH_N} stand-in as the light, "
                      f"{WIDTH}x{WIDTH}, 1 spp, depth 3", cfg, frame, card)
    if fr["launches"]["gather_rows_t"] != tally.get("bw", 0):
        raise AssertionError("mesh-light frame: one winner-row gather per "
                             "closest-hit launch expected")
    fr["by_test"] = tally
    return {"results": results, "launches": fr["launches"], "frame": fr,
            "items_route_differing": differing}


def _check_chosen_light(scene, label: str) -> None:
    """Each lane's chosen light (``lights.*_rolled``) against the per-light
    functions evaluated for every light and selected, on seeded inputs on
    the scene's device: bit for bit."""
    import numpy as np
    import torch

    from rayito_tpu_torch.ops.vec3 import V3
    from rayito_tpu_torch.render import lights as L

    n, dev = RAYS_PER_PASS, scene.device
    rs = np.random.default_rng(17)

    def lanes(lo, hi, cols=None):
        a = rs.uniform(lo, hi, (n,) if cols is None else (cols, n))
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    pos = V3(*lanes(-6.0, 6.0, 3))
    d = V3(*lanes(-1.0, 1.0, 3))
    d = d / torch.sqrt(d.x * d.x + d.y * d.y + d.z * d.z)
    u1, u2, u3, time = lanes(0.0, 1.0, 4)
    t = lanes(0.5, 9.0)
    light_idx = torch.from_numpy(
        rs.integers(0, scene.n_lights, n).astype(np.int32)).to(dev)
    tmin = 1e-4
    chosen = (*L.sample_chosen_light_rolled(scene, light_idx, pos, time, u1,
                                            u2, u3, tmin),
              *L.light_hit_analytic_rolled(scene, light_idx, pos, d, time,
                                           tmin),
              L.light_intersect_pdf_rolled(scene, light_idx, pos, d, t, d,
                                           time))
    bad = 0
    for li in range(scene.n_lights):
        per = (*L.sample_light(scene, li, pos, None, time, u1, u2, u3, tmin),
               *L.light_hit_analytic(scene, li, pos, d, time, tmin),
               L.light_intersect_pdf(scene, li, pos, d, t, d, time))
        mine = light_idx == li
        for got, want in zip(chosen, per):
            for g, w in (((got.x, want.x), (got.y, want.y), (got.z, want.z))
                         if isinstance(got, V3) else ((got, want),)):
                # the same bits; a NaN (an unhit light's normal) equals a NaN
                same = (g == w) | (torch.isnan(g) & torch.isnan(w))
                bad += int((mine & ~same).sum())
    print(f"{label}: each lane's chosen light vs all {scene.n_lights} "
          f"per-light evaluations over {n} lanes (sample, analytic hit, "
          f"hit pdf): {bad} values differ")
    if bad:
        raise AssertionError(f"{label}: chosen-light form != per-light form")


def run_many(dev, card: str) -> None:
    """Phase 13 on ``dev``: the 40-sphere and 16-light frames through
    analytic_fold against the same frames through its plain twin with one
    row per batch (the fold shape by shape), bit for bit, with the host
    launches and one timed frame of each; and the 16-light scene's
    chosen-light forms against its per-light functions."""
    import torch

    from rayito_tpu_torch.render import trace as tr
    from rayito_tpu_torch.utils import cuda_lib

    _phase("many-shape frames")
    for label, setup in (("40 spheres", many_spheres_setup),
                         ("16 lights", sixteen_lights_setup)):
        scene, cfg, cam, frame = setup(dev)
        print(f"{label}: {scene.n_spheres} spheres, {scene.n_rects} rects, "
              f"{scene.n_lights} lights; ROLL_CHUNK = {tr.ROLL_CHUNK}")
        with _tracing():
            frame()  # warm-up
            torch.cuda.synchronize()
            cuda_lib.reset_launch_counts()
            batched = frame()
            torch.cuda.synchronize()
            launches = cuda_lib.launch_counts()
        frame()  # captures the untraced graph
        _check_shade_launches(label, launches, cfg.height // (
            cfg.max_rays_per_pass // cfg.width), cfg.max_depth)
        img = batched[0].reshape(cfg.height, cfg.width, 3).cpu().numpy()
        diag = _check_image(img, label)
        print(f"{label} frame {img.shape}: queries {int(batched[1])}, {diag}")
        stats = {"batched": (_host_launches(frame), *_time_frames(frame, 1))}
        chunk, fold = tr.ROLL_CHUNK, tr.analytic_fold
        tr.ROLL_CHUNK, tr.analytic_fold = 1, tr.analytic_fold_plain
        try:  # the eager body with the plain fold, one row per batch
            by_row = frame(graph=False)
            stats["row-by-row"] = ("not counted", *_time_frames(
                lambda: frame(graph=False), 1))
        finally:
            tr.ROLL_CHUNK, tr.analytic_fold = chunk, fold
        _same_frame(f"{label}, analytic_fold vs the plain fold one row per "
                    "batch", batched, by_row)
        for form, (host, frame_s, q) in stats.items():
            print(f"{label}, {form} form: {host} host launches, "
                  f"{frame_s * 1e3:.1f} ms/frame, {q:.0f} queries, "
                  f"{q / frame_s / 1e6:.3f} Mrays/s on {card}", flush=True)
        if scene.n_lights > 1:
            _check_chosen_light(scene, label)


def _stage3_no_sphere_light(pkg):
    """Stage 3 with its sphere light as a plain diffuse sphere: every
    shading path of the direct integrator but the knife-edged light."""
    s = pkg.Scene()
    blueish = pkg.DiffuseMaterial((0.9, 0.9, 1.0))
    s.add(pkg.Plane(position=(0.0, -2.0, 0.0), normal=(0.0, 1.0, 0.0),
                    material=blueish, bullseye=True))
    s.add(pkg.Sphere(position=(3.0, -1.0, 0.0), radius=1.0,
                     material=pkg.DiffuseMaterial((0.9, 0.7, 0.8))))
    s.add(pkg.Sphere(position=(-3.0, 0.0, -2.0), radius=2.0,
                     material=pkg.PhongMaterial((0.7, 0.9, 0.7), 16.0)))
    s.add(pkg.Sphere(position=(0.0, 0.0, 2.0), radius=1.0, material=blueish))
    s.add(pkg.RectangleLight(corner=(-2.5, 4.0, -2.5), side1=(5.0, 0.0, 0.0),
                             side2=(0.0, 0.0, 5.0), color=(1.0, 1.0, 1.0),
                             power=1.0))
    return s


@_once
def direct_setup(dev, stage: str):
    """(scene, config, camera spec, frame) of a stage-1, 2 or 3 frame at
    CONFIG_STAGE123, 512x512 (stage 2: 64 unstratified samples; stage 3:
    4x4 pixel x 4x4 light samples); ``frame()`` returns (image, 0)."""
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.render import integrator as ig
    from rayito_tpu_torch.utils.config import CONFIG_STAGE123

    if stage == "stage1":
        scene = demo.stage1_scene().compile(dev)
        return scene, CONFIG_STAGE123, demo.STAGE1_CAMERA, lambda: (
            ig.render_color(scene, CONFIG_STAGE123, fov=demo.STAGE1_FOV,
                            camera=demo.STAGE1_CAMERA), 0)
    cfg, spp = CONFIG_STAGE123, 64
    if stage == "stage3":
        cfg = dataclasses.replace(cfg, pixel_samples=4, light_samples=4)
        spp = None
    scene = getattr(demo, stage + "_scene")().compile(dev)
    return scene, cfg, demo.STAGE23_CAMERA, lambda: (ig.render_direct(
        scene, cfg, fov=demo.STAGE23_FOV, camera=demo.STAGE23_CAMERA,
        spp=spp), 0)


@_once
def cli_setup(dev):
    """(scene, config, camera, frame) of the CLI's stage-6 render at its
    defaults (640x480, 2x2 samples, depth 3, the n=64 stand-in);
    ``frame()`` is render_path_with_stats: (image, queries)."""
    from rayito_tpu_torch.render import pathtracer as pt

    scene, cfg, cam = _cli_inputs(dev, _standin_obj())

    def frame():
        img, _, q = pt.render_path_with_stats(scene, cfg, cam)
        return img, q

    return scene, cfg, cam, frame


def run_direct(dev, card: str) -> dict:
    """Phase 14 on ``dev``: stages 1-4 through render_color and
    render_direct at CONFIG_STAGE123, the launch counts set to 0 just
    before the 512x512 frames and read just after (only the sample
    streams' kernel may launch, and must: stages 2-3 draw samples), each
    frame timed; stage 4 (the stage-3 render again) bit-identical; the CPU
    comparisons."""
    import numpy as np
    import torch

    import rayito_tpu_torch as rt
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.render import integrator as ig
    from rayito_tpu_torch.utils import cuda_lib
    from rayito_tpu_torch.utils.config import CONFIG_STAGE123
    from rayito_tpu_torch.utils.image import quantize_ppm

    _phase("stages 1-4")
    cpu = torch.device("cpu")
    golden3 = dataclasses.replace(CONFIG_STAGE123, pixel_samples=4,
                                  light_samples=4)
    cam23 = dict(fov=demo.STAGE23_FOV, camera=demo.STAGE23_CAMERA)
    setups = {k: direct_setup(dev, k) for k in ("stage1", "stage2",
                                                "stage3")}
    with _tracing():
        for _, _, _, frame in setups.values():
            frame()  # warm-up
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        imgs, frame_ms = {}, {}
        for k, (_, _, _, frame) in setups.items():
            t0 = time.perf_counter()  # each frame ends in its readback
            imgs[k] = frame()[0]
            frame_ms[k] = (time.perf_counter() - t0) * 1e3
        launches = cuda_lib.launch_counts()
    print(f"launches in the stage 1-3 frames: {launches}")
    if min(launches[k] for k in ("cmj", "analytic_fold")) <= 0 or any(
            v for k, v in launches.items() if k not in ("cmj", "analytic_fold")):
        raise AssertionError("stages 1-4 have no mesh: expected cmj "
                             "launches (stages 2-3), analytic_fold launches "
                             "and no other kernel")
    out = {"launches": launches}
    for k, img in imgs.items():
        diag = _check_image(img, k)
        cfg = setups[k][1]
        spp = 64 if k == "stage2" else cfg.pixel_samples ** 2
        print(f"{k} frame ({cfg.width}x{cfg.height}, {spp} spp, "
              f"{cfg.light_samples ** 2} light samples): {frame_ms[k]:.1f} "
              f"ms/frame on {card}; {diag}", flush=True)
        out[k + "_frame_ms"] = frame_ms[k]
    render2 = lambda sd, cfg: ig.render_direct(sd, cfg, spp=64, **cam23)
    render3 = lambda sd, cfg: ig.render_direct(sd, cfg, **cam23)
    stage4 = ig.render_direct(demo.stage3_scene().compile(dev), golden3,
                              **cam23)
    if not np.array_equal(stage4, imgs["stage3"]):
        raise AssertionError("stage 4 (the stage-3 scene) differs from "
                             "stage 3")

    ppm_card = quantize_ppm(imgs["stage1"])
    ppm_cpu = quantize_ppm(ig.render_color(
        demo.stage1_scene().compile(cpu), CONFIG_STAGE123,
        fov=demo.STAGE1_FOV, camera=demo.STAGE1_CAMERA))
    same = np.array_equal(ppm_card, ppm_cpu)
    print(f"stage 1, 512x512: quantised PPM byte-equal to the CPU's {same}")
    if not same:
        raise AssertionError("stage 1 on the card differs from the CPU")

    def against_cpu(label, make, cfg, render):
        card_img = render(make().compile(dev), cfg)
        t0 = time.perf_counter()
        cpu_img = render(make().compile(cpu), cfg)
        cpu_s = time.perf_counter() - t0
        rel = _rel_rmse(card_img, cpu_img)
        close = np.abs(card_img - cpu_img).max(axis=2) <= 1e-3
        means = card_img.mean(axis=(0, 1)) / cpu_img.mean(axis=(0, 1))
        print(f"{label} ({cfg.width}x{cfg.height}), card vs CPU: relative "
              f"RMSE {rel:.3e}, {close.mean():.2%} of pixels within 1e-3 "
              f"({int((~close).sum())} differ), channel means / CPU's "
              f"{np.round(means, 5).tolist()}; CPU {cpu_s:.1f} s",
              flush=True)
        return rel, close.mean(), means

    cfg2 = dataclasses.replace(CONFIG_STAGE123, width=128, height=128)
    rel2, _, _ = against_cpu("stage 2", demo.stage2_scene, cfg2, render2)
    cfg3 = dataclasses.replace(golden3, width=128, height=128)
    _, close3, means3 = against_cpu("stage 3", demo.stage3_scene, cfg3,
                                    render3)
    rel3v, _, _ = against_cpu(
        "stage 3 without the sphere light, epsilon 1e-2",
        lambda: _stage3_no_sphere_light(rt),
        dataclasses.replace(cfg3, ray_tmin=1e-2), render3)
    if rel2 > 0.005 or rel3v > 0.005:
        raise AssertionError("a direct-lighting render on the card is more "
                             "than 0.5% from the CPU's")
    if np.any(np.abs(means3 - 1.0) > 0.01) or close3 < 0.25:
        raise AssertionError("stage 3 on the card: channel means beyond 1% "
                             "or under 25% of pixels agree with the CPU")
    return out


def _cli_inputs(dev, obj):
    """The scene, config and camera cli.main builds for ``--scene stage6``
    at its defaults."""
    from rayito_tpu_torch.models.camera import PerspectiveCamera
    from rayito_tpu_torch.models.demo import STAGE6_CAMERA, stage6_scene
    from rayito_tpu_torch.utils.config import RenderConfig

    scene = stage6_scene(obj).compile(dev)
    cfg = RenderConfig(width=640, height=480, pixel_samples=2,
                       light_samples=1, max_depth=3, gamma=2.2, exposure=0.0,
                       seed=1)
    cam = PerspectiveCamera.make(30.0, *STAGE6_CAMERA, focal_distance=16.0,
                                 lens_radius=0.0, shutter_open=0.0,
                                 shutter_close=1.0)
    return scene, cfg, cam


def run_cli(dev, card: str) -> dict:
    """Phase 15 on ``dev``: the CLI's stage-6 render, counted and checked
    bit for bit against render_path_with_stats, --sharded and a resumed
    run."""
    import numpy as np
    import torch

    from rayito_tpu_torch import cli
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.render import progressive
    from rayito_tpu_torch.utils import cuda_lib
    from rayito_tpu_torch.utils.image import read_pfm

    _phase("cli")
    obj = _standin_obj()
    outdir = os.path.join(cuda_lib.BUILD_DIR, "cli")
    os.makedirs(outdir, exist_ok=True)
    args = ["--scene", "stage6", "--obj", obj, "--pfm"]
    pfm = {k: os.path.join(outdir, k + ".pfm")
           for k in ("cli", "sharded", "resumed")}
    torch.cuda.synchronize()
    with _tracing():
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        cli.main(args + ["-o", pfm["cli"]])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        main_launches = cuda_lib.launch_counts()
    print(f"launches in cli.main (640x480, 4 spp, depth 3, 2 bands per "
          f"sample; the capture's warm-up pass included): {main_launches}; "
          f"{cli_s:.2f} s with the scene build")
    if min(main_launches[k] for k in STAGE6_KERNELS) <= 0:
        raise AssertionError("the CLI's render never launched a kernel of "
                             "its path")

    scene, cfg, cam = _cli_inputs(dev, obj)
    with _tracing():
        pt.render_path_with_stats(scene, cfg, cam)  # warm-up: captures
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        ref, _, queries = pt.render_path_with_stats(scene, cfg, cam)
        launches = cuda_lib.launch_counts()
    pt.render_path_with_stats(scene, cfg, cam)  # captures untraced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, _, queries = pt.render_path_with_stats(scene, cfg, cam)
    render_s = time.perf_counter() - t0
    print(f"launches in one replayed render_path_with_stats frame at the "
          f"CLI's inputs: {launches}")
    if min(launches[k] for k in STAGE6_KERNELS) <= 0:
        raise AssertionError("the CLI's frame never launched a kernel of "
                             "its path")
    _check_image(ref, "CLI stage-6 frame")
    print(f"render_path_with_stats, CLI inputs: {queries} queries, "
          f"{render_s:.3f} s, {queries / render_s / 1e6:.3f} Mrays/s on "
          f"{card}", flush=True)

    cli.main(args + ["--sharded", "-o", pfm["sharded"]])
    ck = os.path.join(outdir, "ck.npz")
    if os.path.exists(ck):
        os.remove(ck)
    real = progressive.render_progressive

    def stop(st):
        raise KeyboardInterrupt

    progressive.render_progressive = (
        lambda *a, **kw: real(*a, **dict(kw, on_progress=stop)))
    try:
        cli.main(args + ["-o", pfm["resumed"], "--checkpoint", ck])
        raise AssertionError("the interrupted CLI run did not stop")
    except KeyboardInterrupt:
        pass
    finally:
        progressive.render_progressive = real
    with np.load(ck) as saved:
        done = int(saved["samples_done"])
    cli.main(args + ["-o", pfm["resumed"], "--checkpoint", ck])
    for k, path in pfm.items():
        same = np.array_equal(read_pfm(path).view(np.int32),
                              ref.view(np.int32))
        print(f"{k} PFM bit-identical to render_path_with_stats: {same}"
              + (f" (resumed after {done} of 4 samples)"
                 if k == "resumed" else ""))
        if not same:
            raise AssertionError(f"the {k} run's image differs")
    return {"launches": launches, "main_launches": main_launches,
            "queries": queries, "render_ms": render_s * 1e3}

# ---------------------------------------------------------------------------
# traversal='xla': the two-level cluster pipeline
# ---------------------------------------------------------------------------

XLA_SUBSET = 16384  # rays per population held card against CPU
XLA_KERNELS_OFF = ("cluster_masks", "traverse_blocks", "traverse_items",
                   "build_items", "fold_small") + PLUMBING_KERNELS


XLA_KERNELS = ("cluster_pipeline", "gather_rows_t", "cmj") + SHADE_KERNELS


def _xla_launches(label):
    """The launch counts of the run just made: cluster_pipeline,
    gather_rows_t and cmj must have launched, and no kernel of the other
    route nor fold_small (the route takes tiny meshes down the
    pipeline)."""
    from rayito_tpu_torch.utils import cuda_lib

    launches = cuda_lib.launch_counts()
    print(f"launches in {label}: {launches}")
    if min(launches[k] for k in XLA_KERNELS) <= 0 or any(
            launches[k] for k in XLA_KERNELS_OFF):
        raise AssertionError(f"{label}: expected cluster_pipeline, "
                             "gather_rows_t and cmj launches and no kernel "
                             "of the other route (nor fold_small)")
    return launches


def _pipeline_work(args):
    """This run's work in a cluster_pipeline call, phase 2 recounted in
    plain torch: (slab tests: 16 per kept supercluster, triangle tests: 48
    per kept cluster, warp instructions: per active slot its slab-loop
    iterations (one per two kept superclusters) and its triangle tests per
    warp (48 per kept cluster over 32 lanes), at PIPE_INSNS each)."""
    import torch

    from rayito_tpu_torch.ops.vec3 import V3
    from rayito_tpu_torch.render import traverse as tv

    n_act = int(args["n_active"])
    lanes = args["ray_of_slot"][:n_act].long()
    t_sc = args["t_sc"][lanes]
    t1, sc_idx = tv.nearest_k(t_sc, args["k1"])
    kept = t1 < float("inf")
    finite = torch.isfinite(t_sc).sum(1)
    n1 = torch.clamp_max(finite, args["k1"])
    o, d = args["o"][lanes], args["d"][lanes]
    entered = torch.zeros_like(finite)
    for c0 in range(0, n_act, 16384):  # [chunk, k1, 128] row gathers
        c = slice(c0, c0 + 16384)
        rows = args["sc_rows"][sc_idx[c]]
        col = lambda k: rows[:, :, k * 16:(k + 1) * 16]  # noqa: E731
        dc = d[c]
        t_cl = tv.box_slab(o[c], V3(1.0 / dc.x, 1.0 / dc.y, 1.0 / dc.z),
                           args["tmin"], args["tmax"][lanes[c]],
                           V3(col(0), col(1), col(2)),
                           V3(col(3), col(4), col(5)))
        entered[c] = ((t_cl < float("inf")) & kept[c, :, None]).sum((1, 2))
    n2 = torch.clamp_max(entered, args["k2"])
    slabs = 16 * int(n1.sum())
    tests = 48 * int(n2.sum())
    warp = (int(((n1 + 1) // 2).sum()) * PIPE_INSNS["slab"]
            + int(((48 * n2 + 31) // 32).sum()) * PIPE_INSNS["test"])
    return slabs, tests, warp


def _check_pipeline(name, scene, m, o, d, tmax, tmin):
    """cluster_pipeline on mesh ``m``'s query of one population against
    its plain version on the card, bit for bit (t, prim, per-slot
    overflow); device times of both; the bound of this run's work, the
    largest of: the warp instructions issued (``_pipeline_work``, counted
    from the SASS) at the issue limit; 24 flops per slab test and 46 per
    Möller-Trumbore test at 67 TFLOP/s; the bytes (the slot order, the
    active lanes' rays and phase-1 rows, both tables and the outputs, once
    each) at 3.35 TB/s."""
    import torch

    from rayito_tpu_torch.render import mesh_intersect as mi
    from rayito_tpu_torch.render import traverse as tv

    args, _ = mi.pipeline_inputs(scene, m, o, d, tmin, tmax)
    got = tv.cluster_pipeline(**args)
    ref = tv.cluster_pipeline_plain(**args)
    torch.cuda.synchronize()
    bad = {k: int((g.view(torch.int32) != p.view(torch.int32)).sum())
           for k, g, p in zip(("t", "prim", "overflow"), got, ref)}
    n, s = args["t_sc"].shape
    n_act = int(args["n_active"])
    print(f"{name}, mesh {m}: cluster_pipeline on {n} slots, {n_act} "
          f"active, k1 {args['k1']}, k2 {args['k2']}, overflow "
          f"{int(ref[2].sum())}, hits {int((ref[1][:n_act] >= 0).sum())}; "
          f"differing from its plain version {bad}")
    if any(bad.values()):
        raise AssertionError(f"{name}: cluster_pipeline disagrees")
    fin = torch.isfinite(ref[0])
    r = {"pipe_err": float((got[0][fin] - ref[0][fin]).abs().max())
         if bool(fin.any()) else 0.0, "active": n_act,
         "overflow": int(ref[2].sum())}
    r["pipe_ms"] = _device_ms(lambda: tv.cluster_pipeline(**args))
    r["pipe_call_ms"] = _median_ms(lambda: tv.cluster_pipeline(**args), 20)
    r["pipe_plain_ms"] = _median_ms(
        lambda: tv.cluster_pipeline_plain(**args), 3)
    r["pipe_library_ms"] = None  # no PyTorch call computes it
    slabs, tests, warp = _pipeline_work(args)
    r["slab_tests"], r["tri_tests"], r["warp_insns"] = slabs, tests, warp
    nbytes = (n * 4 + 4 + n_act * (7 + s) * 4 + args["sc_rows"].numel() * 4
              + args["tri_rows"].numel() * 4 + n * 12)
    bounds = {"flops": (slabs * SLAB_OPS + tests * TEST_OPS["vpu"])
              / PEAK_F32 * 1e3,
              "operations": warp * 32 / PEAK_ISSUE * 1e3,
              "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(bounds, key=bounds.get)
    r["pipe_flops_bound_ms"] = bounds["flops"]
    r["pipe_bound_ms"] = bounds[by]
    r["pipe_bound_by"] = "bytes" if by == "bytes" else "operations"
    r["pipe_share"] = r["pipe_bound_ms"] / r["pipe_ms"]
    print(f"{name}, mesh {m}: " + _fmt(r), flush=True)
    return r


def _layers_scene(pkg, n_layers=420, g=4, dz=0.05):
    """n_layers square layers of g x g quads stacked along z with seeded
    jitter (13,440 triangles, 18 superclusters), a floor, a sphere and a
    rect light: rays that cross the stack end-on truncate at both levels
    of the 'xla' pipeline."""
    import numpy as np

    rs = np.random.default_rng(5)
    verts, idx = [], []
    for k in range(n_layers):
        z = k * dz + rs.uniform(-0.001, 0.001)
        base = len(verts)
        verts += [(i / g * 2 - 1, j / g * 2 - 1, z) for j in range(g + 1)
                  for i in range(g + 1)]
        for j in range(g):
            for i in range(g):
                a = base + j * (g + 1) + i
                idx += [(a, a + 1, a + g + 2), (a, a + g + 2, a + g + 1)]
    s = pkg.Scene()
    s.add(pkg.TriangleMesh(np.asarray(verts, np.float32),
                           np.asarray(idx, np.int32),
                           pkg.DiffuseMaterial((0.6, 0.5, 0.4))))
    s.add(pkg.Plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0),
                    pkg.DiffuseMaterial((0.7, 0.7, 0.9))))
    s.add(pkg.Sphere((2.0, 0.0, 10.0), 0.8,
                     pkg.DiffuseMaterial((0.8, 0.3, 0.7))))
    s.add(pkg.RectangleLight((-2.0, 4.0, 0.0), (4.0, 0.0, 0.0),
                             (0.0, 0.0, 4.0), (1.0, 1.0, 1.0), 6.0))
    return s


def _layers_rays(dev, n=RAYS_PER_PASS):
    """n seeded rays from below the stack crossing it end-on, every 10th
    straight up the z axis (o, d, tmax)."""
    import numpy as np
    import torch

    from rayito_tpu_torch.ops.vec3 import V3

    rs = np.random.default_rng(7)
    o = np.stack([rs.uniform(-0.9, 0.9, n), rs.uniform(-0.9, 0.9, n),
                  np.full(n, -3.0)], 1)
    d = rs.normal(0.0, 0.05, (n, 3))
    d[:, 2] = 1.0
    d[::10] = (0.0, 0.0, 1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v3 = lambda a: V3(*(torch.from_numpy(a[:, k].astype(np.float32)).to(dev)
                        for k in range(3)))
    return v3(o), v3(d), torch.full((n,), 1e30, device=dev)


def _tied_rays(dev, n=RAYS_PER_PASS):
    """n seeded rays from z = -2 straight up the z axis over the square
    (o, d, tmax): every box they enter, they enter at t = 2."""
    import numpy as np
    import torch

    from rayito_tpu_torch.ops.vec3 import V3

    rs = np.random.default_rng(8)
    o = np.stack([rs.uniform(-0.9, 0.9, n), rs.uniform(-0.9, 0.9, n),
                  np.full(n, -2.0)], 1)
    d = np.zeros((n, 3))
    d[:, 2] = 1.0
    v3 = lambda a: V3(*(torch.from_numpy(a[:, k].astype(np.float32)).to(dev)
                        for k in range(3)))
    return v3(o), v3(d), torch.full((n,), 1e30, device=dev)


def _check_xla_populations(scene, cases, tmin):
    """Every k-th ray of each population, XLA_SUBSET in all (the band's
    first rows miss the meshes), through mesh_intersect_clusters for every
    mesh, on the card and on the CPU: t, beta and gamma bits, prim and
    overflow must agree."""
    import torch

    from rayito_tpu_torch.ops.vec3 import V3
    from rayito_tpu_torch.render import mesh_intersect as mi

    on_cpu = scene.to("cpu")
    out = {}
    for name, co, cd, ctmax, _, any_hit in cases:
        k = slice(0, None, co.x.shape[0] // XLA_SUBSET)
        o, d, tmax = co[k], cd[k], ctmax[k]
        cpu = lambda v: V3(v.x.cpu(), v.y.cpu(), v.z.cpu())
        r = {"overflow": 0, "hits": 0}
        for m in range(scene.n_meshes):
            t0 = time.perf_counter()
            got = mi.mesh_intersect_clusters(scene, m, o, d, tmin, tmax,
                                             any_hit)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            ref = mi.mesh_intersect_clusters(on_cpu, m, cpu(o), cpu(d), tmin,
                                             tmax.cpu(), any_hit)
            bad = {key: int((g.cpu().view(torch.int32)
                             != c.view(torch.int32)).sum())
                   for key, g, c in zip(("t", "prim", "beta", "gamma"),
                                        got[:4], ref[:4])}
            ovf = (int(got[4]), int(ref[4]))
            hits = int((ref[1] >= 0).sum())
            print(f"xla {name}, mesh {m}: {XLA_SUBSET} rays, {hits} hits, "
                  f"overflow card/CPU {ovf[0]}/{ovf[1]}, lanes differing "
                  f"{bad}; card call {card_s * 1e3:.2f} ms")
            if any(bad.values()) or ovf[0] != ovf[1]:
                raise AssertionError(f"xla {name}: the card differs from the "
                                     "CPU")
            r["overflow"] += ovf[0]
            r["hits"] += hits
        out[name] = r
    return out


def _xla_gathers(scene, cfg, cam, r):
    """The [T, 16] vertex and meta rows the route gathers for one band's
    camera rays (the winner re-test and the shading), through
    gather_rows_t against its plain version, timed and bounded."""
    import torch

    from rayito_tpu_torch.render import mesh_intersect as mi
    from rayito_tpu_torch.render import trace as tr
    from rayito_tpu_torch.render.integrator import _pixel_grid, screen_uv

    band = cfg.max_rays_per_pass // cfg.width
    px, py = _pixel_grid(cfg.width, band, scene.device)
    half = torch.full(px.shape, 0.5, device=scene.device)
    o, d, _ = cam.to(scene.device).make_rays(
        *screen_uv(cfg, px, py, half, half), half, half, half)
    calls = {}
    saved = (mi.gather_rows_t, tr.gather_rows_t)

    def spy(key, fn):
        def gather(table, idx):
            calls.setdefault(key, []).append((table, idx.clone()))
            return fn(table, idx)
        return gather

    mi.gather_rows_t = spy("xla_vert", saved[0])
    tr.gather_rows_t = spy("xla_meta", saved[1])
    try:
        tr.scene_intersect(scene, o, d, None, cfg.ray_tmin, 1e30)
        torch.cuda.synchronize()
    finally:
        mi.gather_rows_t, tr.gather_rows_t = saved
    # the bumpy mesh's re-test (the largest), the shading's one gather
    table, idx = max(calls["xla_vert"], key=lambda c: int((c[1] > 0).sum()))
    _check_gather_rows("xla camera, vertex rows", table, idx, r, "xla_vert")
    table, idx = calls["xla_meta"][0]
    _check_gather_rows("xla camera, meta rows", table, idx, r, "xla_meta")


def _xla_frame(label, frame, scene, cfg, card, other=None, timed=1):
    """One 'xla' frame, its passes replayed graphs, with the launch counts
    set to 0 just before it and read just after; the same frame through
    the eager pass body with the plain versions (cluster_pipeline_plain,
    the plain gather), bit for bit with its overflow and queries; ``other``
    (a frame function of the kernel route), the relative RMSE against it
    (at most 0.5% when nothing overflowed); then ``timed`` timed frames
    (phase 22 profiles the stage-6 frame)."""
    import torch

    from rayito_tpu_torch.utils import cuda_lib

    with _tracing():
        frame(scene)  # warm-up: captures the pass graph
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        imgs, q = frame(scene)
        torch.cuda.synchronize()
        ovf = int(frame.overflow)
        launches = _xla_launches(label)
    frame(scene)  # captures the untraced graph
    img = imgs.reshape(cfg.height, cfg.width, 3).cpu().numpy()
    diag = _check_image(img, label)
    print(f"{label}: queries {int(q)}, overflow {ovf} ({ovf / int(q):.3e} "
          f"of the queries), {diag}")
    undo = _swap_plain()
    try:
        plain = frame(scene, graph=False)
        plain_ovf = int(frame.overflow)
    finally:
        undo()
    _same_frame(f"{label} vs its plain-version eager twin", (imgs, q), plain)
    print(f"{label}: overflow replayed / plain eager {ovf} / {plain_ovf}")
    if plain_ovf != ovf:
        raise AssertionError(f"{label}: the overflow differs")
    out = {"launches": launches, "queries": int(q), "overflow": ovf}
    if other is not None:
        imgs_o, _ = other()
        rel = _rel_rmse(img, imgs_o.reshape(cfg.height, cfg.width,
                                            3).cpu().numpy())
        print(f"{label} vs the kernel route: relative RMSE {rel:.3e} "
              f"(overflow {ovf})")
        out["rel_rmse_vs_kernels"] = rel
        if ovf == 0 and rel > 0.005:
            raise AssertionError(f"{label}: {rel} from the kernel route")
    frame_s, q_frame = _time_frames(lambda: frame(scene), timed)
    out.update(frame_ms=frame_s * 1e3)
    print(f"{label}: {frame_s * 1e3:.1f} ms/frame (mean of {timed}), "
          f"{q_frame / frame_s / 1e6:.3f} Mrays/s on {card}", flush=True)
    return out


def run_xla(dev, card: str) -> dict:
    """Phases 16-20 on ``dev``: the 'xla' route on stage 6 (the
    cluster_pipeline kernel against its plain version on full-band
    populations and the layered stack, populations card against CPU, the
    route's row gathers, the frame), the big scene, stage 7 and the CLI
    under RAYITO_TRAVERSAL=xla."""
    import numpy as np
    import torch

    import rayito_tpu_torch as rt
    from rayito_tpu_torch import cli
    from rayito_tpu_torch.models.demo import tied_slivers_scene
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils import cuda_lib, graphs
    from rayito_tpu_torch.utils.image import read_pfm

    _phase("xla stage-6 populations")
    scene, cfg, cam, kernel_frame = stage6_setup(dev)
    xla = dataclasses.replace(scene, traversal="xla")
    print(f"stage-6 scene under 'xla': {xla.cl_min.shape[0]} clusters of "
          f"48, {xla.sc_min.shape[0]} superclusters, per mesh "
          f"{xla.mesh_sc_ranges}")
    cases = _populations(xla, cfg, cam, (-1.5, 4.0, -1.5), (3.0, 3.0))
    pipeline = {}
    for name, co, cd, ctmax, _, _ in cases:
        pipeline[name] = {m: _check_pipeline(f"xla {name}", xla, m, co, cd,
                                             ctmax, cfg.ray_tmin)
                          for m in range(xla.n_meshes)}
    layers = _layers_scene(rt).compile(dev, traversal="xla")
    pipeline["layers"] = {0: _check_pipeline(
        "xla layers (end-on)", layers, 0, *_layers_rays(dev), cfg.ray_tmin)}
    tied = tied_slivers_scene().compile(dev, traversal="xla")
    pipeline["ties"] = {0: _check_pipeline(
        "xla ties (box t tied)", tied, 0, *_tied_rays(dev), cfg.ray_tmin)}
    pops = _check_xla_populations(xla, cases, cfg.ray_tmin)
    gathers = {}
    _xla_gathers(xla, cfg, cam, gathers)
    print("xla row gathers: " + _fmt(gathers))

    _phase("xla stage-6 frame")
    frame = _frame_fn(xla, cfg, cam)
    s6 = _xla_frame(f"stage-6 frame under 'xla' (n={MESH_N} stand-in, "
                    f"{WIDTH}x{WIDTH}, sample 0, depth 3)", frame, xla, cfg,
                    card, other=kernel_frame)

    _phase("xla big-scene frame")
    big_scan, _, _, bcfg, bcam, _ = big_setup(dev)
    big_xla = dataclasses.replace(big_scan, traversal="xla")
    bframe = _frame_fn(big_xla, bcfg, bcam)
    big = _xla_frame(f"big-scene frame under 'xla' (five n={MESH_N} "
                     f"stand-ins, {WIDTH}x{WIDTH}, 1 spp, depth 3)", bframe,
                     big_xla, bcfg, card, other=lambda: bframe(big_scan))

    _phase("xla stage-7 frame")
    s7_scene, s7_cfg, s7_cam, _ = stage7_setup(dev)
    s7_xla = dataclasses.replace(s7_scene, traversal="xla")
    s7 = _xla_frame(f"stage-7 frame under 'xla' (n={MESH_N} stand-in, "
                    f"{WIDTH}x{WIDTH}, 1 spp, depth 3, shutter 0..1)",
                    _frame_fn(s7_xla, s7_cfg, s7_cam), s7_xla, s7_cfg, card,
                    other=_frame_fn(s7_scene, s7_cfg, s7_cam))

    _phase("xla cli")
    obj = _standin_obj()
    out = os.path.join(cuda_lib.BUILD_DIR, "cli", "xla.pfm")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    saved_env = os.environ.get("RAYITO_TRAVERSAL")
    os.environ["RAYITO_TRAVERSAL"] = "xla"
    err = io.StringIO()
    captured, real_capture = [], graphs.capture

    def spy(*a, **kw):
        captured.append(real_capture(*a, **kw))
        return captured[-1]

    graphs.capture = spy
    try:
        torch.cuda.synchronize()
        with _tracing():
            cuda_lib.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                cli.main(["--scene", "stage6", "--obj", obj, "--pfm", "-o",
                          out])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            cli_launches = _xla_launches(
                "cli.main under RAYITO_TRAVERSAL=xla")
    finally:
        graphs.capture = real_capture
        if saved_env is None:
            del os.environ["RAYITO_TRAVERSAL"]
        else:
            os.environ["RAYITO_TRAVERSAL"] = saved_env
    print(err.getvalue().strip())
    replays = sum(g.replays for g in captured)
    print(f"cli.main under RAYITO_TRAVERSAL=xla: {len(captured)} graph(s) "
          f"captured, {replays} replays")
    if not captured or replays <= 0:
        raise AssertionError("the CLI's 'xla' passes were not replayed")
    c_scene, c_cfg, c_cam = _cli_inputs(dev, obj)
    c_xla = dataclasses.replace(c_scene, traversal="xla")
    stats = [ln for ln in err.getvalue().splitlines() if "clusters=" in ln]
    want = (f"clusters={c_xla.cl_min.shape[0]} ", "traversal=xla")
    if not stats or not all(w in stats[0] for w in want):
        raise AssertionError("the CLI's stats line does not name the 'xla' "
                             "route and its cluster count")
    ref, ovf, queries = pt.render_path_with_stats(c_xla, c_cfg, c_cam)
    same = np.array_equal(read_pfm(out).view(np.int32), ref.view(np.int32))
    print(f"cli.main under RAYITO_TRAVERSAL=xla: {cli_s:.2f} s with the scene "
          f"build; its PFM bit-identical to render_path_with_stats under "
          f"'xla' {same} ({queries} queries, overflow {ovf})")
    if not same:
        raise AssertionError("the CLI's 'xla' render differs")
    return {"populations": pops, "gathers": gathers, "pipeline": pipeline,
            "stage6": s6, "big": big, "stage7": s7,
            "cli": {"launches": cli_launches, "seconds": cli_s,
                    "overflow": ovf, "queries": queries,
                    "replays": replays}}


@contextlib.contextmanager
def _eager_passes():
    """Every pass through ``utils/graphs.run`` runs its body eagerly, as on
    the CPU, so a TorchDispatchMode sees its ops (a capture would not)."""
    from rayito_tpu_torch.utils import graphs

    run = graphs.run
    graphs.run = lambda key, scene, device, body, inputs, label="pass", \
        keep=(): tuple(body(**inputs))
    try:
        yield
    finally:
        graphs.run = run


@contextlib.contextmanager
def _card_libm(dev):
    """torch.sin, torch.cos and torch.pow of CPU tensors evaluated by the
    card's library (the inputs copied over, the results back): neither
    PyTorch's CPU nor its CUDA float32 transcendentals are correctly
    rounded, so the two differ in the last bit of some values."""
    import torch

    saved = {k: getattr(torch, k) for k in ("sin", "cos", "pow")}

    def on_card(f):
        def g(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.device.type == "cpu"
                   for a in args):
                args = [a.to(dev) if isinstance(a, torch.Tensor) else a
                        for a in args]
                return f(*args, **kw).cpu()
            return f(*args, **kw)
        return g

    for k, f in saved.items():
        setattr(torch, k, on_card(f))
    try:
        yield
    finally:
        for k, f in saved.items():
            setattr(torch, k, f)


def _check_pass_radiance(dev, obj) -> None:
    """One replayed stage-6 pass (128x128, sample 1 of 2x2, depth 3, the
    n=64 stand-in) on the card against the same pass on the CPU: its
    radiance bit for bit with the CPU's sin, cos and pow taken from the
    card's library (every root, division, draw and kernel of the pass
    agreeing), queries equal; the values that differ with the CPU's own
    library printed."""
    import torch

    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.render import pathtracer as pt

    scene, cfg, cam, _ = stage6_setup(dev)
    w = 128
    cfg = dataclasses.replace(cfg, width=w, height=w,
                              max_rays_per_pass=w * w)
    on_cpu = demo.stage6_scene(obj).compile("cpu")
    for _ in range(2):  # the capture, then a replay
        card = pt._render_path_pass(scene, cfg, cam, [1], 0, w)
    img = card[0].cpu()
    raw = pt._render_path_pass(on_cpu, cfg, cam, [1], 0, w)
    with _card_libm(dev):
        same_libm = pt._render_path_pass(on_cpu, cfg, cam, [1], 0, w)
    bad = _differing(img, same_libm[0])
    print(f"a replayed stage-6 pass ({w}x{w}, depth 3) card against CPU: "
          f"radiance values differing {bad} of {img.numel()} with the "
          f"card's sin, cos and pow on both, {_differing(img, raw[0])} with "
          f"the CPU's own; queries {int(card[2])} / {int(same_libm[2])} / "
          f"{int(raw[2])}")
    if bad or int(card[2]) != int(same_libm[2]):
        raise AssertionError("the card's stage-6 pass differs from the CPU's")


def run_divisions(dev, card: str) -> None:
    """Phase 26: the scalar divisions on the card. The CLI's 640x480 camera
    rays (its 2x2 samples, 1,228,800 lanes: screen coordinates divided by
    640 and 480, the sample streams, the lens and the time) on the card
    against the same function on the CPU, bit for bit; how many seeded
    square roots PyTorch's sqrt takes off the IEEE root every root of the
    port takes, on the card and on the CPU (printed; the IEEE root must be
    the same on both); one replayed stage-6 pass's radiance against the
    CPU's (``_check_pass_radiance``); then
    utils/div_audit.ScalarDivisions over one eager pass of every path this
    script drives, at 64x32 (the same code as at full size): stage 6 on
    the kernel route and under 'xla', the big scene's item route, stages
    7, 7b and 5, the mesh light, 40 spheres, 16 lights, stages 1-3 and
    cli.main (plain and --sharded). No division by a Python scalar or a
    CPU scalar may be left on any of them."""
    import torch

    import numpy as np

    from rayito_tpu_torch import cli
    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.ops.vec3 import sqrt_ieee
    from rayito_tpu_torch.render import integrator as ig
    from rayito_tpu_torch.render import pathtracer as pt
    from rayito_tpu_torch.utils.div_audit import ScalarDivisions

    _phase("scalar divisions")
    obj = _standin_obj()
    scene, cfg, cam = _cli_inputs(dev, obj)
    si = torch.arange(4, dtype=torch.int32)
    rays = {}
    for where in (dev, torch.device("cpu")):
        px, py = ig._pixel_grid(cfg.width, cfg.height, where)
        n = px.shape[0]
        rays[where.type] = pt._camera_rays(
            cfg, cam.to(where), px.repeat(4), py.repeat(4),
            si.to(where).repeat_interleave(n))
    (o_c, d_c, t_c), (o_h, d_h, t_h) = rays["cuda"], rays["cpu"]
    bad = sum(_differing(a.cpu(), b) for a, b in zip(
        (o_c.x, o_c.y, o_c.z, d_c.x, d_c.y, d_c.z, t_c),
        (o_h.x, o_h.y, o_h.z, d_h.x, d_h.y, d_h.z, t_h)))
    print(f"the CLI's camera rays ({cfg.width}x{cfg.height}, 2x2 samples, "
          f"{t_h.shape[0]} lanes), card against CPU: values differing {bad}")
    if bad:
        raise AssertionError("the card's camera rays differ from the CPU's")
    # the square root the rays take (ops/vec3.sqrt_ieee) against PyTorch's
    # on each device
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0.01, 100.0, 1 << 20).astype(np.float32))
    ieee = sqrt_ieee(x)
    off_card = _differing(torch.sqrt(x.to(dev)).cpu(), ieee)
    off_cpu = _differing(torch.sqrt(x), ieee)
    print(f"torch.sqrt against the IEEE root, {1 << 20} seeded float32 values "
          f"in [0.01, 100]: {off_card} differ on the card, {off_cpu} on the "
          "CPU")
    if _differing(sqrt_ieee(x.to(dev)).cpu(), ieee):
        raise AssertionError("sqrt_ieee on the card differs from the CPU's")
    _check_pass_radiance(dev, obj)

    small = dict(width=64, height=32, max_rays_per_pass=2048)
    paths = []
    for name, setup in (("stage6", stage6_setup), ("stage7", stage7_setup),
                        ("stage7b", stage7b_setup), ("stage5", stage5_setup),
                        ("spheres40", many_spheres_setup),
                        ("lights16", sixteen_lights_setup)):
        sc, c, cm, _ = setup(dev)
        paths.append((name, sc, dataclasses.replace(c, **small), cm))
    sc, c, cm, _ = stage6_setup(dev)
    paths.append(("stage6_xla", dataclasses.replace(sc, traversal="xla"),
                  dataclasses.replace(c, **small), cm))
    _, items, _, c, cm, _ = big_setup(dev)
    paths.append(("big_items", items, dataclasses.replace(c, **small), cm))
    sc, _, c, cm, _ = mesh_light_setup(dev)
    paths.append(("mesh_light", sc, dataclasses.replace(c, **small), cm))
    sites = {}
    out = os.path.join(os.path.dirname(obj), "div_audit.pfm")
    with _eager_passes():
        for name, sc, c, cm in paths:
            with ScalarDivisions() as audit:
                pt.render_path_with_stats(sc, c, cm)
                torch.cuda.synchronize()
            sites[name] = audit
        for stage in ("stage1", "stage2", "stage3"):
            sc, c, spec, _ = direct_setup(dev, stage)
            c = dataclasses.replace(c, width=64, height=32)
            with ScalarDivisions() as audit:
                if stage == "stage1":
                    ig.render_color(sc, c, fov=demo.STAGE1_FOV, camera=spec)
                else:
                    ig.render_direct(sc, c, fov=demo.STAGE23_FOV, camera=spec,
                                     spp=4 if stage == "stage2" else None)
                torch.cuda.synchronize()
            sites[stage] = audit
        for flag in ((), ("--sharded",)):
            argv = ["--scene", "stage6", "--obj", obj, "--width", "64",
                    "--height", "32", "--pfm", "-o", out, *flag]
            with ScalarDivisions() as audit, \
                    contextlib.redirect_stderr(io.StringIO()):
                if cli.main(argv) != 0:
                    raise AssertionError(f"cli.main {argv} failed")
            sites["cli" + "".join(flag)] = audit
    for name, audit in sites.items():
        print(f"{name}: " + audit.summary().replace("\n", "; "))
    left = {n: dict(a.found) for n, a in sites.items() if a.found}
    if left:
        raise AssertionError(f"scalar divisions on the card's path: {left}")
    roots = {n: dict(a.sqrts) for n, a in sites.items() if a.sqrts}
    if roots:
        raise AssertionError(f"float32 roots outside sqrt_ieee: {roots}")
    print(f"scalar divisions: none on {len(sites)} paths", flush=True)


def run_cli_subprocess() -> None:
    """Phase 21: ``python -m rayito_tpu_torch.cli --scene stage1`` with no
    --device, in a subprocess: it renders on cuda."""
    from rayito_tpu_torch.utils import cuda_lib

    _phase("cli subprocess")
    out = os.path.join(cuda_lib.BUILD_DIR, "cli", "stage1.ppm")
    proc = subprocess.run(
        [sys.executable, "-m", "rayito_tpu_torch.cli", "--scene", "stage1",
         "-o", out], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    print(proc.stderr.strip())
    if proc.returncode != 0 or "device=cuda" not in proc.stderr:
        raise AssertionError("the CLI subprocess did not render on cuda")


def _bits(img):
    import numpy as np
    import torch

    if isinstance(img, torch.Tensor):
        img = img.cpu().numpy()
    return np.ascontiguousarray(img, np.float32).view(np.int32)


def _pool_mb(gs) -> float:
    """Device memory the caching allocator holds for the pools of the
    graphs ``gs``."""
    import torch

    pools = {tuple(g.graph.pool()) for g in gs}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools) / 2**20


def _graph_phase(label: str, eager, replayed, card: str, kernels=(),
                 profiled: bool = True, depth: int = 3) -> dict:
    """One frame through the dispatch. ``eager()`` and ``replayed()``
    return (images, issued queries): the eager pass body per launch, and
    the entry point whose passes replay CUDA graphs. With the graphs
    cleared, the first replayed frame captures its graphs (capture ms:
    each capture with its warm-up run, timed on the host around
    ``graphs.capture``) and must equal the eager frame bit for bit,
    queries included (and, where they return a third element, the 'xla'
    route's overflow). Then: pool MB; one frame with the launch counts set
    to 0 just before it and read just after (each of ``kernels`` must have
    run: the launch counters move with every replay of the traced
    graphs, captured here with tracing on); 3 timed
    frames (host clock, and CUDA events around each); and, if
    ``profiled``, one frame under the profiler: host kernel and graph
    launches, device ops, kernel ms and wall ms of that same frame (busy
    share = their ratio; the profiler lengthens the frame, so the share
    reads low rather than high), and each wrapper's launches counted again
    from the device records, which must equal its counter."""
    import numpy as np
    import torch

    from rayito_tpu_torch.utils import cuda_lib, graphs

    graphs.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = eager()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    capture_ms = []
    real = graphs.capture

    def timed_capture(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = real(*a, **kw)
        torch.cuda.synchronize()
        capture_ms.append((time.perf_counter() - t1) * 1e3)
        return g

    graphs.capture = timed_capture
    try:
        got = replayed()
        torch.cuda.synchronize()
    finally:
        graphs.capture = real
    same = np.array_equal(_bits(got[0]), _bits(ref[0]))
    print(f"{label}: replayed frame bit-identical to the eager frame {same}, "
          f"queries {int(got[1])} / {int(ref[1])}")
    if not same or int(got[1]) != int(ref[1]):
        raise AssertionError(f"{label}: the replayed frame differs")
    if len(got) > 2:  # an 'xla' frame: its overflow too
        ovf = (int(got[2]), int(ref[2]))
        print(f"{label}: overflow replayed / eager {ovf[0]} / {ovf[1]}")
        if ovf[0] != ovf[1]:
            raise AssertionError(f"{label}: the overflow differs")
    gs = graphs.graphs()
    with _tracing():  # the launch counters count with tracing on
        replayed()  # captures the traced twins
        torch.cuda.synchronize()
        traced = [g for g in graphs.graphs() if g.template is not None]
        before = [g.replays for g in traced]
        cuda_lib.reset_launch_counts()
        replayed()
        torch.cuda.synchronize()
        launches = cuda_lib.launch_counts()
    if any(launches[k] <= 0 for k in kernels):
        raise AssertionError(f"{label}: a kernel of the path never launched "
                             f"in the replayed frame: {launches}")
    per_frame = sum(g.replays - b for g, b in zip(traced, before))
    _check_shade_launches(label, launches, per_frame, depth)
    frame_s, _ = _time_frames(replayed)
    ev = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        replayed()
        end.record()
        torch.cuda.synchronize()
        ev.append(start.elapsed_time(end))
    r = {"eager_ms": eager_ms, "frame_ms": frame_s * 1e3,
         "event_ms": sum(ev) / len(ev), "graphs": len(gs),
         "replays_per_frame": per_frame, "capture_ms": sum(capture_ms),
         "pool_mb": _pool_mb(gs), "queries": int(got[1])}
    if len(got) > 2:
        r["overflow"] = int(got[2])
    if profiled:
        # an untraced frame's device records against the traced frame's
        # launch counters: the same kernels, the markers apart
        p = _profile_frame(replayed)
        if p["by_kernel"] != launches:
            raise AssertionError(f"{label}: device records {p['by_kernel']} "
                                 f"!= launch counters {launches}")
        r.update(kernel_ms=p["kernel_ms"], profiled_ms=p["wall_ms"],
                 busy=p["kernel_ms"] / p["wall_ms"],
                 device_ops=p["device_ops"],
                 host_kernel_launches=p["host_kernel_launches"],
                 graph_launches=p["graph_launches"])
    print(f"{label}: " + _fmt(r))
    print(f"{label}: kernel launches in one replayed frame {launches} on "
          f"{card}", flush=True)
    r["launches"] = launches
    graphs.clear()
    return r


def _stage3_frames(dev):
    """(eager, replayed) frames of stage 3 at its golden configuration:
    render_direct, and its chunks through the eager pass body added in the
    same order."""
    import numpy as np
    import torch

    from rayito_tpu_torch.models import demo
    from rayito_tpu_torch.render import integrator as ig

    scene, cfg, spec, frame = direct_setup(dev, "stage3")
    spp = cfg.pixel_samples ** 2
    chunk = max(1, min(spp, cfg.max_rays_per_pass
                       // (cfg.width * cfg.height)))

    def eager():
        acc = np.zeros((cfg.height, cfg.width, 3), np.float32)
        for s0 in range(0, spp, chunk):
            si = torch.arange(s0, min(s0 + chunk, spp), dtype=torch.int32,
                              device=dev)
            acc += ig._direct_pass_body(
                scene, cfg, float(demo.STAGE23_FOV), ig._camera_spec(spec),
                cfg.pixel_samples, cfg.pixel_samples, si).cpu().numpy()
        return acc / np.float32(spp), 0

    return eager, frame


def _cli_frames(dev, xla: bool = False):
    """(eager, replayed) frames of the CLI's render: render_path_with_stats
    at its inputs, and its bands (the last shifted up and cropped) through
    the eager pass body added in the same order. With ``xla`` on the
    'xla' route, each returning its overflow as a third element."""
    import numpy as np
    import torch

    from rayito_tpu_torch.render import pathtracer as pt

    scene, cfg, cam, frame = cli_setup(dev)
    w, h, spp = cfg.width, cfg.height, cfg.pixel_samples ** 2
    band = cfg.max_rays_per_pass // w
    r0s = [min(b * band, h - band) for b in range(-(-h // band))]
    if xla:
        scene = dataclasses.replace(scene, traversal="xla")

        def frame():
            img, ovf, q = pt.render_path_with_stats(scene, cfg, cam)
            return img, q, ovf

    def eager():
        acc = np.zeros((h, w, 3), np.float32)
        q = ovf = 0
        cam_d = cam.to(dev)
        for s0 in range(spp):
            si = torch.full((1,), s0, dtype=torch.int32, device=dev)
            for b, r0 in enumerate(r0s):
                img, ovf1, q1 = pt._path_pass_body(
                    scene, cfg, cam_d, si,
                    torch.full((), r0, dtype=torch.int32, device=dev), band)
                skip = max(0, b * band - r0)
                acc[r0 + skip:r0 + band] += img.cpu().numpy()[skip:]
                q += int(q1)
                ovf += int(ovf1)
        return (acc / np.float32(spp), q) + ((ovf,) if xla else ())

    return eager, frame


def _xla_frames(setup):
    """(eager, replayed) 'xla' frames of a setup's scene (the traversal
    switched, the same config and camera), each returning (images,
    queries, overflow)."""
    scene, cfg, cam = setup[0], setup[-3], setup[-2]
    xla = dataclasses.replace(scene, traversal="xla")
    frame = _frame_fn(xla, cfg, cam)

    def run(graph):
        imgs, q = frame(xla, graph)
        return imgs, q, frame.overflow

    return functools.partial(run, False), functools.partial(run, True)


def run_graphs(dev, card: str) -> dict:
    """Phase 23: the reference's dispatch, each pass a replayed CUDA graph,
    on every frame above: stage 6, the big scene on the item and the scan
    route, stage 7, stage 7b, stage 5, the mesh light, 40 spheres, 16
    lights, stage 3 at its golden configuration, the CLI's render, and
    under 'xla' stage 6, the big scene, stage 7 and the CLI's render
    (``_graph_phase``)."""
    _phase("graphs")
    s6 = stage6_setup(dev)
    scan, items, _, _, _, bframe = big_setup(dev)
    frames = [
        ("stage6", s6[3], STAGE6_KERNELS),
        ("big_items", bframe, ("cluster_masks", "build_items",
                               "traverse_items", "gather_rows_t")
         + SHADE_KERNELS),
        ("big_scan", lambda scene=scan, graph=True: bframe(scan, graph),
         STAGE6_KERNELS),
        ("stage7", stage7_setup(dev)[3], STAGE6_KERNELS),
        ("stage7b", stage7b_setup(dev)[3],
         ("gather_rows_t", "cmj", "fold_small") + SHADE_KERNELS),
        ("stage5", stage5_setup(dev)[3], ("cmj",) + SHADE_KERNELS),
        ("mesh_light", mesh_light_setup(dev)[4], STAGE6_KERNELS),
        ("spheres40", many_spheres_setup(dev)[3], ("cmj",) + SHADE_KERNELS),
        ("lights16", sixteen_lights_setup(dev)[3], ("cmj",) + SHADE_KERNELS),
    ]
    out = {}
    for name, frame, kernels in frames:
        t0 = time.perf_counter()
        out[name] = _graph_phase(f"graph {name}",
                                 functools.partial(frame, graph=False),
                                 frame, card, kernels)
        print(f"-- graph {name} done in {time.perf_counter() - t0:.1f} s")
    # its 16 replays of 26,574 device ops each take minutes to profile
    out["stage3"] = _graph_phase("graph stage3 (golden config)",
                                 *_stage3_frames(dev), card, ("cmj",),
                                 profiled=False, depth=0)
    out["cli_stage6"] = _graph_phase("graph cli_stage6 (640x480, 4 spp)",
                                     *_cli_frames(dev), card, STAGE6_KERNELS)
    for name, frames in (("stage6_xla", _xla_frames(s6)),
                         ("big_xla", _xla_frames(big_setup(dev))),
                         ("stage7_xla", _xla_frames(stage7_setup(dev))),
                         ("cli_stage6_xla", _cli_frames(dev, xla=True))):
        t0 = time.perf_counter()
        out[name] = _graph_phase(f"graph {name}", *frames, card, XLA_KERNELS)
        print(f"-- graph {name} done in {time.perf_counter() - t0:.1f} s")
    return out


def run_frame_profile(dev) -> None:
    """Phase 22: one profiled, replayed stage-6 frame on each route: host
    kernel and graph launches, kernel ms and the share of that frame's
    wall ms they fill, and its twelve costliest kernels by name
    (utils/profiling.collect_device_ops; the 'xla' frame's
    cluster_pipeline kernel must have device time)."""
    import torch

    from rayito_tpu_torch.utils.profiling import collect_device_ops

    _phase("frame profile")
    scene, _, _, frame = stage6_setup(dev)
    for traversal in ("pallas", "xla"):
        sd = dataclasses.replace(scene, traversal=traversal)
        frame(sd)  # captures the pass graph
        torch.cuda.synchronize()
        p = _profile_frame(lambda: frame(sd))
        ops = sorted(collect_device_ops(p["prof"]).items(),
                     key=lambda kv: -kv[1][0])
        print(f"stage-6 frame, traversal={traversal!r}: "
              f"{p['host_kernel_launches']} host kernel launches "
              f"({p['graph_launches']} graph launches), {p['kernel_ms']:.1f} "
              f"ms of kernels in a {p['wall_ms']:.1f} ms profiled frame "
              f"(busy {p['kernel_ms'] / p['wall_ms']:.1%})")
        for name, (us, count) in ops[:12]:
            print(f"  {us / 1e3:9.3f} ms {count:6d}x  {name[:110]}")
        if not ops:
            raise AssertionError("the profiler recorded no device kernel")
        if traversal == "xla" and not any(
                "cluster_pipeline_kernel" in name and us > 0
                for name, (us, _) in ops):
            raise AssertionError("no device time in the 'xla' frame's "
                                 "cluster_pipeline kernel")


if __name__ == "__main__":
    sys.exit(main())
