"""List the divisions that round differently on the card than on the CPU.

On a CUDA tensor PyTorch computes ``x / s``, for a divisor ``s`` that is a
Python number or a 0-d tensor on the CPU, as ``x * (1 / s)``: two roundings
where the CPU, and the reference, round once. A 0-d divisor on ``x``'s own
device divides as IEEE on both (``ops/rng.py`` ``_div``).

``ScalarDivisions`` is a ``TorchDispatchMode`` that records, while it is
active, every floating-point ``aten.div`` / ``aten.floor_divide`` whose
divisor is such a scalar (``found``), every ``aten.reciprocal``
(``reciprocals``: ``1.0 / t`` is one IEEE reciprocal on both devices, so it
is listed, not a fault) and every float32 ``aten.sqrt`` taken outside ``ops/vec3.sqrt_ieee``
(``sqrts``: PyTorch's float32 root is correctly rounded on the card but
not on the CPU, so such a root may differ between the two in the last
bit; ``sqrt_ieee`` is correctly rounded on both, and is the only root the
port takes). Each entry is the call site in the port, as ``file:line``. It sees the same ops on the CPU as on the card, so a CPU
run lists what the card would round twice::

    with ScalarDivisions() as audit:
        pass_body(...)
    assert not audit.found, audit.summary()
"""

from __future__ import annotations

import collections
import os
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)

_DIVS = {"div", "div_", "floor_divide", "floor_divide_", "true_divide",
         "true_divide_"}


def _port_frame():
    """The innermost frame of the port (this module excluded), or None."""
    for fr in reversed(traceback.extract_stack()):
        path = os.path.abspath(fr.filename)
        if path.startswith(_PKG) and path != _HERE:
            return fr
    return None


def _site(fr=None) -> str:
    """``file:line`` of the innermost frame of the port, or '?'."""
    fr = fr or _port_frame()
    if fr is None:
        return "?"
    rel = os.path.relpath(os.path.abspath(fr.filename),
                          os.path.dirname(_PKG))
    return f"{rel}:{fr.lineno}"


def _scalar_divisor(dividend, divisor) -> bool:
    """True where the card multiplies by the divisor's reciprocal."""
    if isinstance(divisor, (int, float)) and not isinstance(divisor, bool):
        return True
    return (torch.is_tensor(divisor) and divisor.dim() == 0
            and torch.is_tensor(dividend)
            and divisor.device.type == "cpu"
            and dividend.device.type != "cpu")


class ScalarDivisions(TorchDispatchMode):
    """Records scalar divisions, reciprocals and float32 square roots
    outside ``sqrt_ieee`` by call site (Counters of ``file:line``)."""

    def __init__(self):
        super().__init__()
        self.found = collections.Counter()
        self.reciprocals = collections.Counter()
        self.sqrts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _DIVS and len(args) >= 2:
            res = out[0] if isinstance(out, (tuple, list)) else out
            if (torch.is_tensor(res) and res.is_floating_point()
                    and _scalar_divisor(args[0], args[1])):
                self.found[_site()] += 1
        elif name in ("reciprocal", "reciprocal_"):
            self.reciprocals[_site()] += 1
        elif (name in ("sqrt", "sqrt_") and torch.is_tensor(args[0])
              and args[0].dtype == torch.float32):
            fr = _port_frame()
            if fr is None or fr.name != "sqrt_ieee":
                self.sqrts[_site(fr)] += 1
        return out

    def summary(self) -> str:
        lines = [f"scalar divisions: {sum(self.found.values())} at "
                 f"{len(self.found)} sites"]
        lines += [f"  {site} x{n}" for site, n in sorted(self.found.items())]
        lines.append(f"reciprocals (1.0 / t, IEEE on both devices): "
                     f"{sum(self.reciprocals.values())} at "
                     f"{len(self.reciprocals)} sites")
        lines.append(f"float32 square roots outside sqrt_ieee (not "
                     f"correctly rounded on the CPU): "
                     f"{sum(self.sqrts.values())} at {len(self.sqrts)} sites")
        lines += [f"  {site} x{n}" for site, n in sorted(self.sqrts.items())]
        return "\n".join(lines)
