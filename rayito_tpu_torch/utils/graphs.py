"""CUDA graphs: the port's counterpart of ``jax.jit``'s executable cache.

In the reference every pass is one compiled executable per set of static
arguments (``jax.jit``'s ``static_argnames``), and its traced arguments
are device buffers. On a CUDA device the port captures a pass once per key
as a CUDA graph and replays it (``run``):

  * the key is the reference's static arguments plus the device and the
    scene's identity. The cache holds the scene weakly: when the scene is
    collected its graphs and their pools go with it (a graph reads the
    scene's tensors, so it must not outlive them);
  * the traced arguments (sample indices, first row, camera) are static
    device buffers, filled before every replay from the caller's tensors;
  * ``run`` returns copies of the graph's output tensors, which every
    replay overwrites (an output that is not a tensor is a constant of the
    capture);
  * before capture the body runs once eagerly, on a side stream as PyTorch
    requires and under the sync debug mode ``"error"`` (so an op that would
    read the device back names itself). That run builds and loads the
    kernel library and fills the kernels' first-call caches;
  * each graph has its own memory pool; ``clear()`` frees every graph and
    pool;
  * whether tracing is on (``utils/tracing.py``) is part of the key: a
    graph captured with tracing on holds its device spans' markers and
    counter adds, and its ``Template`` books them at every replay; one
    captured with tracing off holds neither. ``run`` is the host span
    ``band.replay`` (the input copies and the replay).

A capture failure raises: nothing falls back to eager on the card. ``run``
runs the body eagerly on the CPU only, because the caller asked for the
CPU. Both mesh routes are captured: the kernel route and
``traversal='xla'``, whose compaction keeps its count on the device.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import torch

from . import tracing


@dataclasses.dataclass
class Graph:
    """One captured pass: its static inputs and outputs."""

    label: str
    device: torch.device
    graph: Any  # torch.cuda.CUDAGraph
    inputs: dict
    outputs: tuple
    keep: tuple  # objects besides the scene whose tensors the graph reads
    template: Any = None  # tracing.Template of a graph captured traced
    replays: int = 0

    def replay(self, inputs: dict) -> tuple:
        """Copy ``inputs`` (name -> tensor) into the static buffers and
        replay; returns the static outputs (overwritten by the next
        replay)."""
        for name, value in inputs.items():
            self.inputs[name].copy_(value)
        self.graph.replay()
        tracing.replayed(self.template)
        self.replays += 1
        return self.outputs


_GRAPHS: dict = {}  # (id(scene), device, key) -> Graph
_WATCHED: set = set()  # ids of the scenes whose collection drops graphs


def capture(label: str, body: Callable, inputs: dict, device,
            keep: tuple = ()) -> Graph:
    """Capture ``body(**inputs)`` on ``device`` as a CUDA graph whose static
    inputs are ``inputs`` (device tensors holding the first call's values)
    and whose static outputs are what the captured call returned."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{label}: a CUDA graph needs a CUDA device, got "
                         f"{device}")
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                body(**inputs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with tracing.capturing(device) as template:
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
                outputs = body(**inputs)
    return Graph(label=label, device=device, graph=graph, inputs=inputs,
                 outputs=tuple(outputs), keep=tuple(keep), template=template)


def _drop(scene_id: int) -> None:
    """Free the graphs of a collected scene."""
    _WATCHED.discard(scene_id)
    for key in [k for k in _GRAPHS if k[0] == scene_id]:
        _GRAPHS.pop(key).graph.reset()


def run(key, scene, device, body: Callable, inputs: dict,
        label: str = "pass", keep: tuple = ()) -> tuple:
    """``body(**inputs)`` for a pass of ``scene`` on ``device``: on a CUDA
    device, a replay of the graph of ``key`` (the pass's static
    arguments), captured on the key's first use with buffers holding these
    inputs, its outputs copied; on the CPU, the body itself, eagerly.
    ``keep``: other objects whose tensors the body reads (held while the
    graph lives; the scene itself is held weakly). Returns a tuple of
    tensors on ``device``."""
    with tracing.span("band.replay"):
        return _run(key, scene, torch.device(device), body, inputs, label,
                    keep)


def full_key(key, scene, device) -> tuple:
    """The cache key of the graph of ``key`` for ``scene`` on ``device``:
    the scene's identity, the device, the pass's static arguments and
    whether tracing is on."""
    return (id(scene), torch.device(device), key, tracing.enabled())


def _run(key, scene, device, body, inputs, label, keep) -> tuple:
    if device.type != "cuda":
        return tuple(body(**inputs))
    full = full_key(key, scene, device)
    g = _GRAPHS.get(full)
    if g is None:
        static = {k: v.detach().to(device, copy=True)
                  for k, v in inputs.items()}
        g = capture(label, body, static, device,
                    tuple(k for k in keep if k is not scene))
        _GRAPHS[full] = g
        if id(scene) not in _WATCHED:
            _WATCHED.add(id(scene))
            weakref.finalize(scene, _drop, id(scene)).atexit = False
        inputs = {}
    return tuple(o.clone() if isinstance(o, torch.Tensor) else o
                 for o in g.replay(inputs))


def graphs() -> list:
    """The captured graphs, oldest first."""
    return list(_GRAPHS.values())


def clear() -> None:
    """Free every graph and its memory pool."""
    for g in _GRAPHS.values():
        g.graph.reset()
    _GRAPHS.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
