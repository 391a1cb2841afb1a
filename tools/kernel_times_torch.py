"""Device times of the traversal kernels of one tree of this repository.

Builds the tree's kernels and, on chip_smoke.py's six populations (camera,
bounce and shadow rays of one 131,072-ray band of the stage-6 frame and of
the big-scene frame), times ``cluster_masks`` and ``traverse_blocks`` (and,
on the big scene, ``traverse_items`` and ``build_items`` at the list budget
that never overflows, and ``build_items`` at the reference's 24,576 / 64)
two ways: on the device (20 calls captured in a CUDA graph and replayed
between two events, median of 5 replays, per call) and, for the first two,
around one call with CUDA events (median of 20 calls, the host's enqueue
included).
Prints one JSON line per population, with the card's name and power limit
and the (ray block, cluster) pairs its masks list; on a tree with the
fold's slice cull also the slices its warps ran (``runs``, the counter
``traverse.slices``). On stage 6 each population is timed once more in a
seeded random order, unsorted (``shuffled_trav_ms``, ``shuffled_pairs``,
``shuffled_runs``): the cull's worst case, every warp's rays incoherent.

``--scenes`` picks the scenes (default ``stage6,big_scene``); ``stage7`` is
chip_smoke.py's stage-7 populations in the rotating mesh's local space at
seeded lane times, ``stage7_shared`` the same rays with every lane at time
0.5, which shows what the spread of lane times costs the traversal.
``xla`` times ``cluster_pipeline`` on the stage-6 populations under
traversal='xla' (every mesh) and on the 420-layer stack crossed end-on
(``pipe_ms``). ``tiny`` times the tiny-mesh part of a query on stage 7b's
camera, bounce (closest hit) and shadow (any hit) populations at seeded
lane times: ``query_ms`` is the whole part (each cube's transform chain,
its fold and the merges; a tree with the per-query ``fold_small`` runs it
as one call), ``fold_ms`` the fold kernels alone (the per-mesh tree's ten
launches on rays already in local space; the per-query tree's one).
``draws`` times the sample streams' draw sets at stage 6's shapes (the
first band's 131,072 lanes, sample 0): the camera's, one bounce's, and
stage 3's direct-lighting light loop (two lights, 4x4 light samples), as
the tree's renderers build them: ``set_ms`` is one set (one
``cmj_draws`` launch per set, ``launches`` of them).

``chain`` times ``ray_pack`` through a traversal domain's transform chain
at the cells' 262,144 lanes, on chip_smoke.py's stage-7 populations at
seeded lane times (the rotating mesh: three keys) and on the same
populations of one of ``big_instanced``'s one-key copies (its camera): the
kernel with the chain's outputs the query wants (``chain_ms``: the local
ray and the rotation on closest hits, none on any hits), against the
plain-torch chain (``ops/transform.py`` ``local_ray``) and the pack of
the local ray (``torch_chain_ms``), and the pack of the world ray alone
(``pack_ms``); the rows, operand and local ray compared bit for bit
(``differing``), the kernel's bytes and its bound at 3.35 TB/s. It needs
a tree whose ``ray_pack`` takes a chain.

``--root`` names the tree whose ``chip_smoke.py`` and ``rayito_tpu_torch``
are imported (default: this checkout), so two commits can be compared in
one run: unpack the other with ``git archive`` under ``build/`` and run

    python3 tools/kernel_times_torch.py --root build/parent --label parent
    python3 tools/kernel_times_torch.py --label change

in turns (parent, change, change, parent) on one GPU, from the repo root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _runs(fn):
    """The slices ``fn``'s fold ran (the counter ``traverse.slices``, read
    with tracing on); None on a tree without it."""
    import torch

    from rayito_tpu_torch.utils import tracing

    with tracing.on():
        tracing.reset()
        fn()
        torch.cuda.synchronize()
        runs = tracing.counters().get("traverse.slices")
    return None if runs is None else int(runs)


def _median_ms(fn, reps: int) -> float:
    import torch

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


def _device_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _median_ms(graph.replay, 5) / reps


def _xla_records(cs, dev):
    """cluster_pipeline's device ms per population and mesh."""
    import dataclasses

    import rayito_tpu_torch as rt
    from rayito_tpu_torch.render import mesh_intersect as mi
    from rayito_tpu_torch.render import traverse as tv

    scene, cfg, cam, _ = cs.stage6_setup(dev)
    xla = dataclasses.replace(scene, traversal="xla")
    pops = [(name, xla, m, o, d, tmax) for name, o, d, tmax, _, _ in
            cs._populations(xla, cfg, cam, (-1.5, 4.0, -1.5), (3.0, 3.0))
            for m in range(xla.n_meshes)]
    layers = cs._layers_scene(rt).compile(dev, traversal="xla")
    pops.append(("layers", layers, 0, *cs._layers_rays(dev)))
    for name, sc, m, o, d, tmax in pops:
        args, _ = mi.pipeline_inputs(sc, m, o, d, cfg.ray_tmin, tmax)
        yield {"scene": "xla", "population": name, "mesh": m,
               "active": int(args["n_active"]),
               "pipe_ms": _device_ms(lambda: tv.cluster_pipeline(**args))}


def _tiny_records(cs, dev):
    """The tiny-mesh part of stage 7b's queries, per population."""
    import numpy as np
    import torch

    from rayito_tpu_torch.render import mesh_intersect as mi
    from rayito_tpu_torch.render import trace as tr

    scene, cfg, cam, _ = cs.stage7b_setup(dev)
    n = cfg.max_rays_per_pass
    lane_time = torch.from_numpy(np.random.default_rng(7).uniform(
        0.0, 1.0, n).astype(np.float32)).to(dev)
    per_query = hasattr(mi, "fold_small_query_plain")
    tmin = cfg.ray_tmin
    for name, o, d, tmax, _, any_hit in cs._populations(
            scene, cfg, cam, (-1.0, 15.0, 1.0), (2.0, 2.0), lane_time):
        tmax = tmax.contiguous()
        occ = torch.zeros((n,), dtype=torch.bool, device=dev)
        best = (torch.full((n,), float("inf"), device=dev),
                torch.full((n,), -1, dtype=torch.int32, device=dev),
                torch.zeros((n,), device=dev), torch.zeros((n,), device=dev),
                tr._identity_rot(n, dev))
        kw = {"occluded": occ} if any_hit else {"best": best}
        if per_query:
            def query():
                return mi.fold_small(scene, o, d, lane_time, tmin, tmax, **kw)
            fold = query
        else:
            local = [tr._shape_local_ray(scene, scene.mesh_xf_host[m], o, d,
                                         lane_time) for m in scene.ktab_small]

            def query():  # render/trace.py's loop in the per-mesh tree
                if any_hit:
                    occluded = occ
                    for m in scene.ktab_small:
                        o_l, d_l, _ = tr._shape_local_ray(
                            scene, scene.mesh_xf_host[m], o, d, lane_time)
                        prim = mi.mesh_fold_small(
                            scene, m, o_l, d_l, tmin,
                            torch.where(occluded, 0.0, tmax))[1]
                        occluded = occluded | (prim >= 0)
                    return occluded
                t_b, p_b, b_b, g_b, rot_b = best
                for m in scene.ktab_small:
                    o_l, d_l, rot = tr._shape_local_ray(
                        scene, scene.mesh_xf_host[m], o, d, lane_time)
                    t_m, p_m, b_m, g_m = mi.mesh_fold_small(
                        scene, m, o_l, d_l, tmin, torch.minimum(t_b, tmax))
                    c = p_m >= 0
                    t_b, p_b = torch.where(c, t_m, t_b), torch.where(c, p_m,
                                                                     p_b)
                    b_b, g_b = torch.where(c, b_m, b_b), torch.where(c, g_m,
                                                                     g_b)
                    rot_b = tr._where_quat(c, rot, rot_b)
                return t_b, p_b, b_b, g_b, rot_b

            def fold():
                return [mi.mesh_fold_small(scene, m, o_l, d_l, tmin, tmax)
                        for m, (o_l, d_l, _) in zip(scene.ktab_small, local)]
        yield {"scene": "tiny", "population": name, "lanes": n,
               "meshes": len(scene.ktab_small),
               "query_ms": _device_ms(query), "fold_ms": _device_ms(fold)}


def _draws_records(cs, dev):
    """The draw sets at stage 6's shapes, one ``cmj_draws`` call a set."""
    import torch

    from rayito_tpu_torch.ops import rng
    from rayito_tpu_torch.render import integrator as ig
    from rayito_tpu_torch.render import pathtracer as pt

    scene, cfg, _, _ = cs.stage6_setup(dev)
    n = cfg.max_rays_per_pass
    px, py = ig._pixel_grid(cfg.width, n // cfg.width, dev)
    si = torch.zeros((n,), dtype=torch.int32, device=dev)
    cfg3 = cfg.__class__(width=cfg.width, height=cfg.height,
                         light_samples=4, seed=cfg.seed)
    plans = {"camera": pt.camera_draws(cfg),
             "bounce": pt.bounce_draws(cfg, scene.n_lights, 1),
             "direct_lights": ig.direct_light_draws(cfg3, 2)}
    for name, plan in plans.items():
        plan = tuple(plan)
        yield {"scene": "draws", "set": name, "lanes": n,
               "draws": len(plan), "seeds": len({d.seed for d in plan}),
               "launches": len(rng._encode(plan)[0]),
               "set_ms": _device_ms(lambda: rng.cmj_draws(plan, px, py,
                                                          si))}


def _chain_records(cs, dev):
    """ray_pack through a domain's chain against the torch chain and the
    pack, per population (see the module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from portbench import port_scene, run
    from rayito_tpu_torch.ops import transform as xf
    from rayito_tpu_torch.render import traverse as tv

    n = cs.PLUMBING_LANES
    lane_time = torch.from_numpy(np.random.default_rng(7).uniform(
        0.0, 1.0, n).astype(np.float32)).to(dev)
    stage7, cfg, cam, _ = cs.stage7_setup(dev)
    cfg = dataclasses.replace(cfg, max_rays_per_pass=n)
    with open(os.path.join(HERE, "portbench", "configs",
                           "big_instanced.json")) as f:
        inst = json.load(f)
    big = port_scene.build(inst, {"bumpy": cs._standin_obj()}).compile(dev)
    cases = [("stage7", stage7, cam, ((-1.5, 4.0, -1.5), (3.0, 3.0))),
             ("big_instanced", big, run.camera_of(inst["camera"]),
              ((-4.0, 10.0, -4.0), (8.0, 8.0)))]
    tmin = cfg.ray_tmin
    for scene_name, scene, camera, light in cases:
        di = next(i for i, x in enumerate(scene.ktab_xf)
                  if xf.chain_slots(scene, x))
        slots = scene.ktab_chain[di]
        box = scene.ktab_box[di]
        k = scene.xf_times.shape[1]
        for name, o, d, tmax, _, any_hit in cs._populations(
                scene, cfg, camera, *light, lane_time):
            tmax = tmax.contiguous()
            chain = tv.Chain((scene.xf_times, scene.xf_translate,
                              scene.xf_scale, scene.xf_rotate,
                              scene.xf_nkeys), slots, lane_time,
                             want_ray=not any_hit, want_rot=not any_hit)

            def kernel():
                return tv.ray_pack(o, d, tmax, box, tmin, chain=chain)

            def torch_chain():
                o_l, d_l, _ = xf.local_ray(scene, scene.ktab_xf[di], o, d,
                                           lane_time)
                o_l, d_l = (type(v)(v.x.contiguous(), v.y.contiguous(),
                                    v.z.contiguous()) for v in (o_l, d_l))
                return o_l, d_l, tv.ray_pack(o_l, d_l, tmax, box, tmin)

            soa8, operand, (ray, _) = kernel()
            o_l, d_l, (soa8_t, operand_t) = torch_chain()
            pairs = [(soa8, soa8_t), (operand, operand_t)]
            if ray is not None:
                pairs.append((ray, torch.stack((o_l.x, o_l.y, o_l.z, d_l.x,
                                                d_l.y, d_l.z))))
            differing = sum(int((a.view(torch.int32)
                                 != b.view(torch.int32)).sum())
                            if a.dtype == torch.float32
                            else int((a != b).sum()) for a, b in pairs)
            n_tot = soa8.shape[0]
            nbytes = (n * (28 + 4 * (k > 1)) + n_tot * 36
                      + (0 if any_hit else n * 40))
            rec = {"scene": "chain", "domain": scene_name,
                   "population": name, "lanes": n, "depth": slots.shape[0],
                   "keys": k, "chain_ms": _device_ms(kernel),
                   "torch_chain_ms": _device_ms(torch_chain),
                   "pack_ms": _device_ms(
                       lambda: tv.ray_pack(o, d, tmax, box, tmin)),
                   "bytes": nbytes, "bound_ms": nbytes / 3.35e9,
                   "differing": differing}
            rec["share"] = rec["bound_ms"] / rec["chain_ms"]
            yield rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="change")
    ap.add_argument("--scenes", default="stage6,big_scene")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from rayito_tpu_torch.ops import transform as xf
    from rayito_tpu_torch.render import traverse as tv

    if not os.path.abspath(tv.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {tv.__file__}, not the tree {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    runs = []
    for scene_name in args.scenes.split(","):
        if scene_name in ("xla", "tiny", "draws", "chain"):
            timed = {"xla": _xla_records, "tiny": _tiny_records,
                     "draws": _draws_records,
                     "chain": _chain_records}[scene_name]
            for rec in timed(cs, dev):
                rec.update(tree=args.label, card=card)
                print(json.dumps(rec), flush=True)
            continue
        if scene_name == "stage6":
            scene, cfg, cam, _ = cs.stage6_setup(dev)
            runs.append((scene_name, scene, cfg, cam, None))
        elif scene_name == "big_scene":
            scan, items, defaults, cfg, cam, _ = cs.big_setup(dev)
            runs.append((scene_name, scan, cfg, cam, None))
        else:
            import numpy as np

            scene, cfg, cam, _ = cs.stage7_setup(dev)
            n = cfg.max_rays_per_pass
            lane_time = (np.random.default_rng(7).uniform(0.0, 1.0, n)
                         if scene_name == "stage7" else np.full(n, 0.5))
            runs.append((scene_name, scene, cfg, cam, torch.from_numpy(
                lane_time.astype(np.float32)).to(dev)))
    lights = {"big_scene": ((-4.0, 10.0, -4.0), (8.0, 8.0))}
    for scene_name, scene, cfg, cam, lane_time in runs:
        box = scene.ktab_box[0]
        tmin = cfg.ray_tmin
        corner, sides = lights.get(scene_name, ((-1.5, 4.0, -1.5), (3.0, 3.0)))
        for name, o, d, tmax, mt, any_hit in cs._populations(
                scene, cfg, cam, corner, sides, lane_time):
            if lane_time is not None:  # the moving domain's local space
                o, d, _ = xf.local_ray(scene, scene.ktab_xf[0], o, d,
                                       lane_time)
            tri = scene.ktab_tri[0] if mt == "vpu" else scene.ktab_mxu[0]
            # a tree with the slice cull takes the domain's slice boxes
            sl = ({"slices": scene.ktab_slice[0]}
                  if hasattr(scene, "ktab_slice") else {})
            soat, _, n_live = tv.prepare_rays(o, d, tmax, box, tmin)
            masks = tv.cluster_masks(soat, box, tmin, n_live)

            def mask_fn():
                return tv.cluster_masks(soat, box, tmin, n_live)

            def trav_fn():
                return tv.traverse_blocks(masks, soat, tri, tmin, mt,
                                          any_hit, n_live, **sl)

            rec = {"tree": args.label, "scene": scene_name,
                   "population": name,
                   "mask_ms": _device_ms(mask_fn),
                   "mask_call_ms": _median_ms(mask_fn, 20),
                   "trav_ms": _device_ms(trav_fn),
                   "trav_call_ms": _median_ms(trav_fn, 20),
                   "pairs": cs._listed(masks, tri.shape[0])[0],
                   "runs": _runs(trav_fn)}
            if scene_name == "stage6":
                g = torch.Generator().manual_seed(o.x.shape[0])
                perm = torch.randperm(o.x.shape[0], generator=g).to(dev)
                so, sd = (type(v)(v.x[perm], v.y[perm], v.z[perm])
                          for v in (o, d))
                soat_s, _, _ = tv.prepare_rays(so, sd, tmax[perm], box, tmin,
                                               sort_rays=False)
                masks_s = tv.cluster_masks(soat_s, box, tmin)

                def shuffled_fn():
                    return tv.traverse_blocks(masks_s, soat_s, tri, tmin, mt,
                                              any_hit, **sl)

                rec["shuffled_trav_ms"] = _device_ms(shuffled_fn)
                rec["shuffled_pairs"] = cs._listed(masks_s, tri.shape[0])[0]
                rec["shuffled_runs"] = _runs(shuffled_fn)
            if scene_name == "big_scene":
                w = items.items_w
                il, steps, _, _ = tv.build_items(masks, w, items.items_max,
                                                 items.items_cap)
                soab = soat.view(masks.shape[0], scene.traverse_b, 8)
                rec["items_ms"] = _device_ms(lambda: tv.traverse_items(
                    il, steps, soab, tri, tmin, mt, w, **sl))
                for key, sd in (("build_items_ms", items),
                                ("build_items_ref_ms", defaults)):
                    rec[key] = _device_ms(lambda: tv.build_items(
                        masks, w, sd.items_max, sd.items_cap))
            rec["card"] = card
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
