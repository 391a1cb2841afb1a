"""Spans and counters of rayito_tpu_torch that survive CUDA-graph replay.

Tracing is off by default. ``enable(bool)`` or the context manager
``on()`` switches it; the port reads no environment variable for it. Off,
``span``, ``device_span``, ``requesting`` and ``count`` cost one flag
check, and a pass graph captured while it is off holds no node of it. The
state is part of every graph key (``utils/graphs.run``): switching tracing
on captures traced twins of the passes once, switching it off goes back
to the untraced graphs.

Host spans (``span``) time the host: a render, a pass, a band's replay,
read-back and host add, a checkpoint, the progress callbacks. Each is also
a ``torch.profiler.record_function`` range, so a profile shows it on the
profiler's clock.

Device spans (``device_span``) time the device's work between their begin
and their end. On a CUDA device each begin and each end is one launch of
``csrc/trace_mark.cu``, which writes (code, %globaltimer) to the device's
log at the next slot. Under ``utils/graphs.capture`` the markers become
nodes of the pass graph and the graph's ``Template`` lists them, so each
replay's spans are rebuilt on the host from the log: a replay runs no
Python. On the CPU a device span is timed on the host clock, since the
eager pass is the device's work there.

The port's device spans: ``camera_rays``, ``bounce[i]`` ⊃ {``query.closest``,
``draws``, ``shading.prepare``, ``query.shadow[i]``, ``shading.resolve``}
and ``image`` (``render/pathtracer.py``); in a query ``analytic_folds`` and
``mesh`` ⊃ {``domain`` ⊃ {``traversal_plumbing``, ``domain_merge``},
``tiny_mesh_fold``} (``render/trace.py``: one ``domain`` per traversal
domain, around its ``traverse()`` call, whose ``ray_pack`` takes the lanes
into the domain's space, its winner re-test and its merge into the
query's best; ``domain_merge`` around the re-test and the merge, on the
closest-hit and the any-hit path; ``traversal_plumbing`` in
``render/traverse.py``; ``transforms`` around every keyed chain that
``ops/transform.py`` evaluates in torch: the 'xla' route's, the folds'
plain twins', the lights');
``readback`` (``render/progressive.py``).

Every span has an id, a name, a parent (the innermost span open when it
opened; a replayed span's root parent is the host span open at the
replay) and the request it serves: the one ``requesting`` sets for the
spans opened inside it, (render, first sample of the pass, band) in
``render/progressive.py``, else its parent's.

Counters (``count``) add to named int64 totals: a Python number on the
host (under a capture, once per replay of the graph), a device tensor with
one add on its device (captured with the pass). ``counter_ptr`` hands a
kernel the address of a counter's int64 slot on the device. The port's
counters: ``launches.<kernel>`` (``utils/cuda_lib.py``),
``query.rays.closest`` and ``query.rays.shadow`` (``render/pathtracer.py``),
``traverse.pairs``, ``traverse.live_rays`` and ``traverse.slices``
(``render/traverse.py``, added by ``cluster_masks_kernel``,
``ray_pack_kernel`` and the mesh fold's kernels), ``traverse.lanes`` (the
lanes handed to each ``traverse()`` call, a Python number),
``traverse.chain_lanes`` (those of them ``ray_pack`` took through a
domain's transform chain, a Python number, added only by calls with a
chain), and the
tiny-mesh fold's
``fold_small.tests.closest`` / ``.any``, ``fold_small.lanes.closest`` /
``.any`` and ``fold_small.links`` (``render/mesh_intersect.py``, added by
``fold_small_kernel`` once per block), and the analytic fold's
``analytic_fold.tests.plane`` / ``.sphere`` / ``.rect`` (the row tests
its lanes ran, an any-hit lane's up to its first hit) and
``analytic_fold.lanes.closest`` / ``.any`` (a query's lanes)
(``render/trace.py``, added by ``analytic_fold_kernel`` once per block).

``snapshot()`` reads it all back (it waits for the devices) and
``reset()`` starts anew; nothing is written out unless asked.
``on_trace`` puts the spans of a snapshot on the clock of a
``torch.profiler`` Chrome trace taken over the same work: the k-th marker
kernel of a device in the trace is the k-th entry of its log, and the k-th
host range of a name is the k-th host span of that name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

MARKER_KERNEL = "trace_mark_kernel"
LOG_ENTRIES = 1 << 20  # markers a device's log holds (16 MB)
COUNTER_SLOTS = 512  # named counters a device holds

_ON = False
_NULL = contextlib.nullcontext()


def enable(flag: bool = True) -> None:
    """Switch tracing on or off. On, the current CUDA device's log is made
    at once, if CUDA is in use, so that a capture after it may use it."""
    global _ON
    _ON = bool(flag)
    if _ON and torch.cuda.is_initialized() and not (
            torch.cuda.is_current_stream_capturing()):
        _log(_device("cuda"))


def enabled() -> bool:
    """Whether tracing is on (a part of every pass graph's key)."""
    return _ON


@contextlib.contextmanager
def on(flag: bool = True):
    """Tracing switched to ``flag`` inside, as it was after."""
    prev = _ON
    enable(flag)
    try:
        yield
    finally:
        enable(prev)


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span. ``start`` and ``end`` are nanoseconds: the
    host's ``perf_counter_ns`` for host spans and for device spans timed on
    the CPU, a CUDA device's %globaltimer for its device spans;
    microseconds on the trace's clock after ``on_trace``."""

    id: int
    name: str
    kind: str  # "host" or "device"
    device: str  # "host", or the device whose work a device span times
    start: float
    end: float
    parent: Optional[int]
    request: Optional[tuple]
    marks: Optional[tuple] = None  # (begin, end) entries of the device log


@dataclasses.dataclass
class Snapshot:
    host: list  # host spans, by start
    device: list  # device spans, by device and begin
    counters: dict  # name -> total
    marks: dict  # CUDA device -> entries its log holds


class Template:
    """The markers and Python-number counts of one captured pass graph,
    added to the log's bookkeeping and the totals at every replay."""

    def __init__(self, device):
        self.device = device
        # [name, parent (its index here; -1: the root), begin, end]
        self.spans = []
        self.codes = []  # marker codes, in enqueue order
        self.counts = {}  # name -> count per replay
        self.adds = 0  # counter adds on the device that the graph holds


class _Log:
    """A CUDA device's marker log and counter slots."""

    def __init__(self, dev):
        self.buf = torch.zeros((LOG_ENTRIES, 2), dtype=torch.int64,
                               device=dev)
        self.cursor = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.counts = torch.zeros((COUNTER_SLOTS,), dtype=torch.int64,
                                  device=dev)
        self.slots = {}  # counter name -> slot
        self.marks = 0  # markers enqueued since the last reset
        self.eager = []  # (id, name, parent, request, begin, end)
        self.replays = []  # [template, base, request, parent, first id]


@dataclasses.dataclass
class _Open:
    id: int  # -1 for a span of a template
    name: str
    start: int
    parent: Optional[int]
    request: Optional[tuple]
    local: int = -1  # its index in ``template``
    template: Optional[Template] = None


_next_id = 0
_stack: list = []  # open spans, innermost last
_host: list = []  # finished host spans
_cpu: list = []  # finished device spans timed on the host
_counts: dict = {}  # host totals
_logs: dict = {}  # CUDA device -> _Log
_template = None  # (device, Template) while a pass graph is captured
_request = None
_codes: dict = {}  # span name -> code (even: begin; + 1: end)


def _new_ids(n: int = 1) -> int:
    global _next_id
    _next_id += n
    return _next_id - n


def _parent() -> Optional[int]:
    return _stack[-1].id if _stack and _stack[-1].id >= 0 else None


def _current_request() -> Optional[tuple]:
    """The request set by ``requesting``, else the innermost open span's."""
    if _request is not None or not _stack:
        return _request
    return _stack[-1].request


def _device(where) -> torch.device:
    dev = where.device if isinstance(where, torch.Tensor) else torch.device(
        where)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _log(dev) -> _Log:
    log = _logs.get(dev)
    if log is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"tracing: the first use of {dev} was made "
                               "under a capture")
        log = _logs[dev] = _Log(dev)
    return log


def _code(name: str) -> int:
    code = _codes.get(name)
    if code is None:
        code = _codes[name] = 2 * len(_codes)
    return code


def _mark(log: _Log, dev, code: int) -> None:
    from . import cuda_lib

    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_lib.check(cuda_lib.library().rt_trace_mark(
        log.buf.data_ptr(), log.cursor.data_ptr(), LOG_ENTRIES, code, stream),
        "trace_mark")


def span(name: str, request: Optional[tuple] = None):
    """A host span named ``name`` around the block (its id is the
    ``with`` target); ``request``, or else the current one, is its
    request."""
    return _host_span(name, request) if _ON else _NULL


@contextlib.contextmanager
def _host_span(name, request):
    op = _Open(_new_ids(), name, 0, _parent(),
               _current_request() if request is None else request)
    _stack.append(op)
    with torch.profiler.record_function(name):
        op.start = time.perf_counter_ns()
        try:
            yield op.id
        finally:
            end = time.perf_counter_ns()
            _stack.pop()
            _host.append(Span(op.id, name, "host", "host", op.start, end,
                              op.parent, op.request))


def device_span(name: str, where):
    """A device span named ``name`` around the work the block enqueues on
    ``where`` (a device, or a tensor on it)."""
    return _device_span(name, _device(where)) if _ON else _NULL


@contextlib.contextmanager
def _device_span(name, dev):
    if dev.type != "cuda":
        op = _Open(_new_ids(), name, time.perf_counter_ns(), _parent(),
                   _current_request())
        _stack.append(op)
        try:
            yield
        finally:
            _stack.pop()
            _cpu.append(Span(op.id, name, "device", str(dev), op.start,
                             time.perf_counter_ns(), op.parent, op.request))
        return
    tpl = _template[1] if _template is not None and _template[0] == dev \
        else None
    if tpl is None and torch.cuda.is_current_stream_capturing():
        # a capture that is no pass graph's: its replays are not seen
        yield
        return
    code = _code(name)
    log = _log(dev)
    if tpl is not None:
        top = _stack[-1] if _stack else None
        parent = top.local if top is not None and top.template is tpl else -1
        op = _Open(-1, name, 0, None, None, len(tpl.spans), tpl)
        tpl.spans.append([name, parent, len(tpl.codes), -1])
        tpl.codes.append(code)
    else:
        op = _Open(_new_ids(), name, log.marks, _parent(),
                   _current_request())
        log.marks += 1
    _mark(log, dev, code)
    _stack.append(op)
    try:
        yield
    finally:
        _stack.pop()
    # a span whose block raised has no end: its begin stays unread
    if tpl is not None:
        tpl.spans[op.local][3] = len(tpl.codes)
        tpl.codes.append(code + 1)
    else:
        log.eager.append((op.id, name, op.parent, op.request, op.start,
                          log.marks))
        log.marks += 1
    _mark(log, dev, code + 1)


class _Requesting:
    def __init__(self, request):
        self.request = request

    def __enter__(self):
        global _request
        self.prev, _request = _request, self.request

    def __exit__(self, *exc):
        global _request
        _request = self.prev


def requesting(request: tuple):
    """The spans opened inside serve ``request``."""
    return _Requesting(request) if _ON else _NULL


def _slot(log: _Log, name: str) -> int:
    s = log.slots.get(name)
    if s is None:
        if len(log.slots) >= COUNTER_SLOTS:
            raise RuntimeError(f"tracing: more than {COUNTER_SLOTS} counters")
        s = log.slots[name] = len(log.slots)
    return s


def count(name: str, value, where=None) -> None:
    """Add ``value`` to counter ``name``: a tensor on its device (one add,
    captured with the pass), a Python number on the host, or, under a
    pass graph's capture on ``where``, once per replay."""
    if not _ON:
        return
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            dev = _device(value)
            if _template is not None and _template[0] == dev:
                _template[1].adds += 1
            log = _log(dev)
            log.counts[_slot(log, name)].add_(value.reshape(()))
            return
        value = int(value)
    elif where is not None:
        dev = _device(where)
        if dev.type == "cuda":
            if _template is not None and _template[0] == dev:
                c = _template[1].counts
                c[name] = c.get(name, 0) + value
                return
            if torch.cuda.is_current_stream_capturing():
                log = _log(dev)
                log.counts[_slot(log, name)].add_(value)
                return
    _counts[name] = _counts.get(name, 0) + value


def counter_ptr(name: str, where) -> Optional[int]:
    """The address of counter ``name``'s int64 slot on ``where``'s CUDA
    device, for a kernel to add to; None when tracing is off."""
    if not _ON:
        return None
    log = _log(_device(where))
    return log.counts[_slot(log, name)].data_ptr()


@contextlib.contextmanager
def capturing(device):
    """Around a pass graph's capture on ``device``: yields the Template
    that records its markers and Python-number counts (None when tracing
    is off)."""
    global _template
    if not _ON:
        yield None
        return
    dev = _device(device)
    _log(dev)  # the log exists before the capture
    prev, _template = _template, (dev, Template(dev))
    try:
        yield _template[1]
    finally:
        _template = prev


def replayed(template: Optional[Template]) -> None:
    """One replay of a graph captured with ``template``: its counts are
    added and its markers booked under the current request and span."""
    if template is None:
        return
    for name, v in template.counts.items():
        _counts[name] = _counts.get(name, 0) + v
    if template.codes:
        log = _log(template.device)
        log.replays.append([template, log.marks, _current_request(),
                            _parent(), None])
        log.marks += len(template.codes)


def reset() -> None:
    """Drop every span and set every counter to 0."""
    if _stack:
        raise RuntimeError("tracing.reset: spans are open")
    _host.clear()
    _cpu.clear()
    _counts.clear()
    for log in _logs.values():
        log.cursor.zero_()
        log.counts.zero_()
        log.marks = 0
        log.eager.clear()
        log.replays.clear()


def reset_counts(prefix: str) -> None:
    """Set the counters whose names start with ``prefix`` to 0."""
    for name in [k for k in _counts if k.startswith(prefix)]:
        del _counts[name]
    for log in _logs.values():
        for name, s in log.slots.items():
            if name.startswith(prefix):
                log.counts[s].zero_()


def counters() -> dict:
    """{name: total} of every counter (reads the devices back)."""
    out = dict(_counts)
    for log in _logs.values():
        if log.slots:
            vals = log.counts.tolist()
            for name, s in log.slots.items():
                out[name] = out.get(name, 0) + vals[s]
    return dict(sorted(out.items()))


def _entry(data, k: int, code: int, dev) -> int:
    if data[k][0] != code:
        raise RuntimeError(f"tracing: entry {k} of the log of {dev} is not "
                           "the marker the host enqueued there")
    return data[k][1]


def snapshot() -> Snapshot:
    """Every span finished since the last reset, and the counters."""
    if _stack:
        raise RuntimeError("tracing.snapshot: spans are open")
    device, marks = list(_cpu), {}
    for dev, log in _logs.items():
        n = int(log.cursor.item())
        if n != log.marks:
            raise RuntimeError(f"tracing: the log of {dev} holds {n} "
                               f"markers, the host enqueued {log.marks}")
        if n > LOG_ENTRIES:
            raise RuntimeError(f"tracing: {n} markers overflow the log of "
                               f"{dev} ({LOG_ENTRIES}); reset more often")
        marks[str(dev)] = n
        data = log.buf[:n].tolist() if n else []
        rows = [(sid, name, parent, req, b, e)
                for sid, name, parent, req, b, e in log.eager]
        for rep in log.replays:
            tpl, base, req, parent, first = rep
            if first is None:
                first = rep[4] = _new_ids(len(tpl.spans))
            rows += [(first + j, name, parent if p < 0 else first + p, req,
                      base + b, base + e)
                     for j, (name, p, b, e) in enumerate(tpl.spans)]
        for sid, name, parent, req, b, e in rows:
            code = _codes[name]
            device.append(Span(sid, name, "device", str(dev),
                               _entry(data, b, code, dev),
                               _entry(data, e, code + 1, dev), parent, req,
                               (b, e)))
    device.sort(key=lambda s: (s.device, s.marks[0] if s.marks else s.start))
    return Snapshot(host=sorted(_host, key=lambda s: s.start), device=device,
                    counters=counters(), marks=marks)


def on_trace(snap: Snapshot, events: list) -> list:
    """The host spans and the CUDA device spans of ``snap`` with start and
    end in microseconds on the clock of ``events``, the Chrome-trace
    events of a profile taken over the same work since the last reset.
    A device span runs from the end of its begin marker to the start of
    its end marker. Raises where the trace holds another number of markers
    of a device than its log, or of host ranges of a name than spans."""
    marks, ranges = {}, {}
    names = {s.name for s in snap.host}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "kernel" and MARKER_KERNEL in name:
            dev = f"cuda:{int(e.get('args', {}).get('device', 0))}"
            marks.setdefault(dev, []).append(
                (float(e["ts"]), float(e.get("dur", 0.0))))
        elif cat == "user_annotation" and name in names:
            ranges.setdefault(name, []).append(
                (float(e["ts"]), float(e.get("dur", 0.0))))
    for dev in set(marks) | {d for d, n in snap.marks.items() if n}:
        got, need = len(marks.get(dev, ())), snap.marks.get(dev, 0)
        if got != need:
            raise ValueError(f"tracing: the trace holds {got} markers of "
                             f"{dev}, its log {need}")
    out = []
    for name in sorted(names):
        spans = [s for s in snap.host if s.name == name]
        got = sorted(ranges.get(name, ()))
        if len(got) != len(spans):
            raise ValueError(f"tracing: the trace holds {len(got)} ranges "
                             f"{name!r}, the host {len(spans)} spans")
        out += [dataclasses.replace(s, start=ts, end=ts + dur)
                for s, (ts, dur) in zip(spans, got)]
    for m in marks.values():
        m.sort()
    for s in snap.device:
        if s.marks is not None:
            m = marks[s.device]
            b, e = s.marks
            out.append(dataclasses.replace(s, start=m[b][0] + m[b][1],
                                           end=m[e][0]))
    return out
