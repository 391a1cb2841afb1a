"""Multiple-importance-sampling heuristics (counterpart of
``rayito_tpu/ops/mis.py``)."""

from __future__ import annotations

import torch


def balance_heuristic(n1, pdf1, n2, pdf2):
    w1 = n1 * pdf1
    w2 = n2 * pdf2
    return w1 / torch.clamp_min(w1 + w2, 1e-37)


def power_heuristic(n1, pdf1, n2, pdf2):
    """beta=2 power heuristic — the path tracer's choice."""
    w1 = n1 * pdf1
    w2 = n2 * pdf2
    return (w1 * w1) / torch.clamp_min(w1 * w1 + w2 * w2, 1e-37)
