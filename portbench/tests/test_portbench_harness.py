"""The harness end to end on the CPU at a tiny size: a new cell, traffic
mix and metric added as new files run without an edit; each fault the
timed path can have turns ``correct`` false; the control (the reference in
bfloat16) fails the comparison; the reference agrees with the program's
CPU path on both scenes; nothing of JAX or the JAX package is loaded, and
the reference loads nothing of the program."""

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import compare, run, standin
from portbench.reference import scene as rscene
from portbench.reference import tracer

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
TINY = {"why": "a test frame", "loop": "closed", "users": 1, "width": 24,
        "height": 16, "pixel_samples": 1, "light_samples": 1,
        "max_depth": 3, "max_rays_per_pass": 200}


def _copy(tmp_path, cells):
    """A checkout holding BENCHMARK.json and the benchmark's folder, with
    a tiny traffic mix, each config at an 8x8x6-quad stand-in, and
    ``cells`` [(config, traffic)] added as new cells."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    (root / "portbench" / "traffic" / "tiny_test.json").write_text(
        json.dumps(TINY))
    for name in ("stage6_bumpy", "stage7_motion"):
        cfg = json.loads((root / "portbench" / "configs" /
                          f"{name}.json").read_text())
        for m in cfg.get("meshes", {}).values():
            m["n"] = 8
        (root / "portbench" / "configs" / f"{name}_n8.json").write_text(
            json.dumps(cfg))
    for config, traffic in cells:
        bench["workloads"].append({"name": f"{config}.{traffic}",
                                   "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, cell, trace=0, seed=2**31 + 3):
    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.05", "--trace", str(trace)], device="cpu",
                  root=str(root), here=str(root / "portbench"), out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_and_metric_are_files_of_their_own(tmp_path):
    root = _copy(tmp_path, [("stage6_bumpy_n8", "tiny_test")])
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "passes_per_render", "unit": "passes", "better": "lower",
        "source": "program_counter", "layer": "entry point",
        "moves": "msamples_per_s", "workloads": ["stage6_bumpy_n8.tiny_test"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench" / "metrics" / "passes_per_render.py").write_text(
        "def read(ctx):\n    return ctx.trace.passes\n")
    before = {k: v for k, v in _digests(root).items()
              if "passes_per_render" not in k and "n8" not in k
              and "tiny_test" not in k and k != "BENCHMARK.json"}
    res = _run(root, "stage6_bumpy_n8.tiny_test", trace=1)
    assert res["correct"] and res["attempted"] >= 2 and res["failed"] == 0
    assert res["metrics"]["passes_per_render"] == {"value": 1.0,
                                                   "unit": "passes"}
    assert res["metrics"]["queries_per_sample"]["value"] > 1.0
    # no device on the CPU: the device readers find nothing and say so
    assert "shade_roofline" not in res["metrics"]
    assert list(res)[-1] == "checks"
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
    res = _run(root, "stage6_bumpy_n8.tiny_test", trace=0)
    assert set(res["metrics"]) == {"msamples_per_s", "pass_ms_p95",
                                   "setup_s"}


@pytest.mark.parametrize("config", ["stage6_bumpy_n8", "stage7_motion_n8"])
def test_reference_agrees_with_the_programs_cpu_path(tmp_path, config):
    root = _copy(tmp_path, [(config, "tiny_test")])
    res = _run(root, f"{config}.tiny_test")
    assert res["correct"]
    assert res["checks"]["mismatch_share"]["value"] <= 0.01


def _pass_fault(kind):
    from rayito_tpu_torch.render import progressive

    real = progressive._render_path_pass

    def broken(scene, config, camera, si, row0=0, rows=0):
        img, ovf, q = real(scene, config, camera, si, row0, rows)
        s = int(si[0])
        if kind == "unchanged" and s == 0:
            img = torch.zeros_like(img)  # the pass adds nothing
        elif kind == "half":  # odd samples left out, the rest doubled
            img = torch.zeros_like(img) if s % 2 else img * 2.0
        elif kind == "altered" and s == 0:
            img = img * 1.01  # the answer changed where it is produced
        return img, ovf, q

    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_each_fault_makes_correct_false(tmp_path, monkeypatch, kind):
    from rayito_tpu_torch.render import progressive

    root = _copy(tmp_path, [("stage6_bumpy_n8", "tiny_test")])
    traffic = dict(TINY, pixel_samples=2)
    (root / "portbench" / "traffic" / "tiny_test.json").write_text(
        json.dumps(traffic))
    monkeypatch.setattr(progressive, "_render_path_pass", _pass_fault(kind))
    res = _run(root, "stage6_bumpy_n8.tiny_test")
    assert not res["correct"]
    assert res["failed"] == res["attempted"]
    assert (res["checks"]["mismatch_share"]["value"]
            > res["checks"]["mismatch_share"]["limit"])


@pytest.mark.parametrize("config", ["stage6_bumpy", "stage7_motion"])
def test_control_in_bfloat16_fails(tmp_path, config):
    with open(os.path.join(HERE, "configs", config + ".json")) as f:
        cfg = json.load(f)
    paths = {k: standin.cached(str(tmp_path), dict(m, n=8))
             for k, m in cfg["meshes"].items()}
    flat = rscene.flatten(cfg, paths)
    rc = dict(width=32, height=24, pixel_samples=2, light_samples=1,
              max_depth=3, seed=2**31 + 17)
    pix = np.arange(32 * 24)
    ref = tracer.render_pixels(flat, cfg["camera"], rc, pix, "cpu")
    low = tracer.render_pixels(flat, cfg["camera"], rc, pix, "cpu",
                               torch.bfloat16)
    assert compare.mismatch_share(low, ref) > 3 * compare.MISMATCH_LIMIT


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    import types

    assert run.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "rayito_tpu_torch_like",
                        types.ModuleType("rayito_tpu_torch_like"))
    monkeypatch.setitem(sys.modules, "jaxish", types.ModuleType("jaxish"))
    assert "rayito_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rayito_tpu.models",
                        types.ModuleType("rayito_tpu.models"))
    assert "rayito_tpu" in run.forbidden_modules()


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax_and_the_reference_none_of_the_program():
    names = _modules_after(
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import run, compare, spec, standin, stats, trace, "
        "port_scene, calibrate\n"
        "import rayito_tpu_torch.render.progressive\n"
        "import rayito_tpu_torch.utils.cuda_lib\n")
    assert "rayito_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "rayito_tpu"}
    names = _modules_after(
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench.reference import cmj, scene, tracer\n")
    assert not names & {"jax", "jaxlib", "flax", "rayito_tpu",
                        "rayito_tpu_torch"}


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """One cell for two seconds on the card: a result line, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "stage6_bumpy.square512", "--seed", str(2**31 + 99), "--seconds",
         "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
