"""The benchmark of rayito_tpu_torch on one NVIDIA H100: progressive renders
of demo scenes at the app's sizes (``run.py``), judged against the plain
reference of ``reference/``. Driven by data: ``BENCHMARK.json`` names the
cells; ``configs/``, ``traffic/``, ``metrics/`` and ``rooflines/`` hold one
file per configuration, traffic mix, per-layer metric and kernel."""
