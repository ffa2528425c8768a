"""Profiling helpers (counterpart of ``apex_tpu/utils/profiling.py``): a
context manager around a ``torch.profiler`` trace, a wall-clock section
timer with a Ceres-style report, a decorator that names a span, and the
port's tracer. Nothing runs unless asked for.

**Spans.** ``span(name)`` names a stretch of the program. Under the torch
profiler it opens ``record_function(name)``, so ``trace`` and the CLIs'
``--profile`` show it. With tracing on (``set_tracing(True)``) it also
records the span: on the host, its start and end on ``perf_counter_ns``,
its parent and the id of its root span (every span of one ``optimize``
call shares the id of ``lm.solve``), in a bounded buffer. With tracing off
it records nothing and costs one check.

The tracer's own bookkeeping is timed too: what a host span spends in the
tracer when it opens and when it closes is a span of its own, ``tracer``
(``TRACER_SPAN``), inside the span around it, so that the program's spans
hold only the program's time.

**Device phase stamps.** Under capture or warm-up (``optim.graphs`` says
which, through ``set_form``) a host time would only time the capture. So
there, with tracing on at capture time, a span enqueues a one-thread CUDA
kernel (``csrc/trace_stamp.cu``) at its start and at its end that reads
``%globaltimer`` and adds the phase's nanoseconds and one occurrence to a
row of a device buffer, one row per phase (its path of stamped spans, as
``schur.assemble>camera.jacobians``). Nodes of a captured stream run in
order, so the stamps bound the phase, and they sum over every trip of an IF
or WHILE body. The buffer is read once, by ``collect_trace``; a solve reads
nothing more. A graph captured with tracing off holds no stamp, and keeps
none when tracing is switched on later.

**One clock.** Switching tracing on, and each ``reset_trace``, takes an
anchor per device: a synchronize, then ``perf_counter_ns`` before and after
a CUDA event and a ``%globaltimer`` stamp (the best of a few tries). Every
device time is put on the host clock from it, within its uncertainty (half
the round trip, in the trace). Device times are the tracer's own CUDA events
around each parent-graph launch (``optim.graphs``) and the stamps' first and
last times.

**What a trace holds.** ``collect_trace()``: host spans, the launches'
device intervals, the stamped phases (summed time, occurrences, first and
last time), the change since the reset of each work counter that the code
counting it named (``watch``: ``optim.graphs`` names those it counts), the
anchors and what the bounded buffers dropped.
``idle_by_span`` attributes the device's idle time (outside parent-graph
launches) to the innermost host span over each stretch.
``export_chrome_trace(path)`` writes spans, launches and phases on that
one timeline as a Chrome trace, for Perfetto or chrome://tracing. The
pose-graph CLI's ``--profile`` with ``--jit`` writes one in place of a
``torch.profiler`` trace, which cannot name kernels inside conditional
graph bodies.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import itertools
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..kernels import trace_stamp

TRACE_NAME = "trace.json"
# host spans and parent-graph launches kept; the oldest go first
MAX_SPANS = 1 << 17
MAX_LAUNCHES = 1 << 16
# phase rows of a device's stamp buffer; row 0 takes the warm-up's stamps
MAX_PHASES = 512
NO_SPAN = "(no span)"
# Python's garbage collector, as a host span where it pauses the host
GC_SPAN = "python.gc"
# the tracer's own bookkeeping where a host span opens or closes
TRACER_SPAN = "tracer"

_on = False
_spans = collections.deque(maxlen=MAX_SPANS)
_launches = collections.deque(maxlen=MAX_LAUNCHES)
_open = []  # the spans open now, innermost last
_ids = itertools.count(1)
_stamps = {}  # device index -> _Stamps
_anchors = {}  # device index -> _Anchor
_watched = {}  # work counter name -> the dict that holds it (a module's globals())
_base = {}  # the counters at the reset
_dropped = {"spans": 0, "launches": 0, "phases": 0}
_gc_starts = []
# how steps run, as optim.graphs sets it: "eager", "warmup" or "capture"
_form = "eager"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, name: str = TRACE_NAME):
    """Capture a ``torch.profiler`` trace of the block (host, and the card's
    kernels where CUDA is available) and write it as a Chrome trace to
    ``log_dir/name`` (default: ``apex_tpu_torch_profile/trace.json`` under
    the system's temporary directory), saying where on stderr. The block
    gets the ``torch.profiler.profile`` object. View the file in Perfetto
    or chrome://tracing."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "apex_tpu_torch_profile")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    print(f"[apex-tpu] profiler trace written to {path}", file=sys.stderr)


class SectionTimer:
    """Accumulating wall-clock timer: timer.section('assemble'): ..."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'section':>20} {'calls':>7} {'total':>10} {'mean':>10}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:>20} {n:>7} {t*1e3:>9.2f}m {t/n*1e3:>9.3f}m")
        return "\n".join(lines)


def annotate(name: Optional[str] = None):
    """Decorator running the function inside a ``span`` of that name (the
    function's own by default), as the solvers' spans are."""

    def deco(fn):
        scope = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with span(scope):
                return fn(*args, **kw)

        return wrapper

    return deco


class span:
    """``with span(name):`` names the block: a ``record_function`` under the
    torch profiler, and with tracing on a host span, or under capture or
    warm-up a pair of device stamps."""

    __slots__ = ("name", "_rf", "_entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = (record_function(self.name).__enter__()
                    if torch._C._autograd._profiler_enabled() else None)
        self._entry = _enter(self.name) if _on else None
        return self

    def __exit__(self, *exc):
        if self._entry is not None:
            _exit(self._entry)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class _Entry:
    """An open span: a host span (``row`` None) or a stamped phase."""

    __slots__ = ("name", "id", "parent", "solve", "start", "path", "row", "device")

    def __init__(self, name, parent):
        self.name, self.start, self.row, self.device = name, None, None, None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.solve = parent.solve if parent is not None else self.id
        self.path = name


def _enter(name):
    t0 = time.perf_counter_ns()
    parent = _open[-1] if _open else None
    entry = _Entry(name, parent)
    if _form != "eager":
        if parent is not None and parent.device is not None:
            entry.path = f"{parent.path}>{name}"
        if torch.cuda.is_available():
            entry.device = torch.cuda.current_device()
            entry.row = _stamp_row(entry.device, entry.path, _form == "warmup")
            if entry.row is not None:
                trace_stamp.open_(entry.row, entry.device)
        _open.append(entry)
        return entry
    _open.append(entry)
    entry.start = time.perf_counter_ns()
    _record(TRACER_SPAN, t0, entry.start, next(_ids), entry.parent, entry.solve)
    return entry


def _exit(entry):
    end = time.perf_counter_ns()
    while _open and _open.pop() is not entry:
        pass
    if entry.row is not None:
        trace_stamp.close(entry.row, entry.device)
    if entry.start is not None:
        _record(entry.name, entry.start, end, entry.id, entry.parent, entry.solve)
        _record(TRACER_SPAN, end, time.perf_counter_ns(), next(_ids), entry.parent,
                entry.solve)


def _record(name, start, end, id_, parent, solve):
    if len(_spans) == _spans.maxlen:
        _dropped["spans"] += 1
    _spans.append((name, start, end, id_, parent, solve))


def _gc_callback(phase, info):
    """A collection by Python's garbage collector as a host span inside
    the innermost open host span: its pause stalls the host wherever an
    allocation set it off."""
    if phase == "start":
        _gc_starts.append(time.perf_counter_ns())
    elif _gc_starts:
        start = _gc_starts.pop()
        host = [e for e in _open if e.start is not None]
        id_ = next(_ids)
        _record(GC_SPAN, start, time.perf_counter_ns(), id_, host[-1].id if host else None,
                host[-1].solve if host else id_)


class _Stamps:
    """A device's phase rows: {path: row} and the int64 buffer."""

    def __init__(self, device):
        self.buf = torch.zeros((MAX_PHASES, trace_stamp.ROW), dtype=torch.int64,
                               device=f"cuda:{device}")
        self.rows = {}

    def ptr(self, row):
        return self.buf.data_ptr() + row * self.buf.stride(0) * self.buf.element_size()


def _stamp_row(device, path, warmup):
    """The address of the row that stamps ``path`` (the scratch row in
    the warm-up), None when there is none to give."""
    stamps = _stamps.get(device)
    if stamps is None:
        if not warmup:
            # a buffer allocated under capture would live in its pool
            _dropped["phases"] += 1
            return None
        stamps = _stamps[device] = _Stamps(device)
    if warmup:
        return stamps.ptr(0)
    row = stamps.rows.get(path)
    if row is None:
        if len(stamps.rows) + 1 >= MAX_PHASES:
            _dropped["phases"] += 1
            return None
        row = stamps.rows[path] = len(stamps.rows) + 1
    return stamps.ptr(row)


def tracing() -> bool:
    """Whether spans are recorded."""
    return _on


def set_form(form: str) -> None:
    """How steps run from now on, as ``optim.graphs`` decides it:
    ``"eager"``, or ``"warmup"`` / ``"capture"``, where a span stamps the
    device instead of timing the host."""
    global _form
    _form = form


def watch(owner: dict, name: str) -> None:
    """Report the work counter ``owner[name]`` (``owner`` a module's
    ``globals()``) in every trace from now on. The code that counts calls
    it before it first adds; the names are unique across the port."""
    if name not in _watched:
        _watched[name] = owner
        _base.setdefault(name, owner[name])


def set_tracing(on: bool) -> None:
    """Switch tracing on (a reset, which takes the clock anchors) or off
    (what was recorded stays, for ``collect_trace``)."""
    global _on
    if on and not _on:
        _on = True
        reset_trace()
        gc.callbacks.append(_gc_callback)
    elif not on and _on:
        gc.callbacks.remove(_gc_callback)
        _gc_starts.clear()
    _on = bool(on)


class _Anchor:
    """A device moment on the host clock: ``host_ns`` (the middle of the
    best round trip), ``uncertainty_ns`` (half of it), and the CUDA event
    and ``%globaltimer`` value recorded at it."""

    TRIES = 5

    def __init__(self, device):
        stream = torch.cuda.current_stream(device)
        out = torch.zeros(1, dtype=torch.int64, device=f"cuda:{device}")
        best = None
        for _ in range(self.TRIES):
            event = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter_ns()
            event.record(stream)
            trace_stamp.now(out.data_ptr(), device)
            torch.cuda.synchronize(device)
            t1 = time.perf_counter_ns()
            if best is None or t1 - t0 < best[1] - best[0]:
                best = (t0, t1, event, int(out[0]))
        t0, t1, self.event, self.gtimer = best
        self.host_ns = (t0 + t1) // 2
        self.uncertainty_ns = (t1 - t0) // 2

    def of_event(self, event) -> int:
        return self.host_ns + round(self.event.elapsed_time(event) * 1e6)

    def of_gtimer(self, ns) -> int:
        return self.host_ns + (ns - self.gtimer)


def _counters() -> dict:
    return {name: owner[name] for name, owner in _watched.items()}


def reset_trace() -> None:
    """Forget what was recorded (spans, launches, stamped time), keep the
    phase rows that captured graphs stamp, and take the anchors anew."""
    global _base
    _spans.clear()
    _launches.clear()
    for key in _dropped:
        _dropped[key] = 0
    devices = set(_stamps) | set(_anchors)
    if torch.cuda.is_available():
        devices.add(torch.cuda.current_device())
    for device in sorted(devices):
        torch.cuda.synchronize(device)
        if device in _stamps:
            _stamps[device].buf.zero_()
        _anchors[device] = _Anchor(device)
    _base = _counters()


def _anchor(device) -> "_Anchor":
    """The device's anchor, taken now where there is none (never under
    capture: a launch or a collection asks)."""
    if device not in _anchors:
        _anchors[device] = _Anchor(device)
    return _anchors[device]


def launch_interval(launch, device) -> None:
    """``launch()`` between two CUDA events on the current stream of
    ``device``, kept as a device interval while tracing is on."""
    if not _on:
        return launch()
    _anchor(device)
    stream = torch.cuda.current_stream(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    launch()
    end.record(stream)
    if len(_launches) == _launches.maxlen:
        _dropped["launches"] += 1
    _launches.append((device, start, end, _open[0].solve if _open else None))


def collect_trace() -> dict:
    """What was recorded since the last reset, on the host clock (ns of
    ``perf_counter_ns``): ``spans`` (name, start_ns, end_ns, id, parent,
    solve), ``launches`` (device, start_ns, end_ns, solve), ``phases``
    (device, path, name, parent, total_ns, count, first_ns, last_ns; one
    read of each stamp buffer), ``counters`` (the change of each watched
    counter; one that has never counted is not there), ``anchors``
    (device: host_ns, uncertainty_ns) and ``dropped``."""
    for device in sorted(set(_anchors) | set(_stamps)):
        _anchor(device)
        torch.cuda.synchronize(device)
    # a collection set off while the buffer is read would add its span to it
    spans = list(_spans)
    spans = [dict(zip(("name", "start_ns", "end_ns", "id", "parent", "solve"), s))
             for s in spans]
    launches = [dict(device=d, start_ns=_anchors[d].of_event(s), end_ns=_anchors[d].of_event(e),
                     solve=solve) for d, s, e, solve in _launches]
    phases = []
    for device, stamps in _stamps.items():
        if not stamps.rows:
            continue
        rows = stamps.buf.tolist()
        anchor = _anchors[device]
        for path, row in stamps.rows.items():
            total, count, _, first, last, _ = rows[row]
            if count:
                parent, _, name = path.rpartition(">")
                phases.append(dict(device=device, path=path, name=name, parent=parent or None,
                                   total_ns=total, count=count, first_ns=anchor.of_gtimer(first),
                                   last_ns=anchor.of_gtimer(last)))
    now = _counters()
    return {"spans": spans, "launches": launches, "phases": phases,
            "counters": {k: now[k] - _base.get(k, 0) for k in now},
            "anchors": {d: dict(host_ns=a.host_ns, uncertainty_ns=a.uncertainty_ns)
                        for d, a in _anchors.items()},
            "dropped": dict(_dropped)}


def idle_by_span(trace: Optional[dict] = None) -> Dict[str, float]:
    """Seconds the device was idle (no parent-graph launch running on it)
    from the first recorded span or launch to the last, by the innermost
    host span over each stretch; ``NO_SPAN`` holds what no span covers.
    ``trace`` defaults to ``collect_trace()``."""
    trace = trace if trace is not None else collect_trace()
    spans = trace["spans"]
    depth = {}
    by_id = {s["id"]: s for s in spans}

    def depth_of(s):
        if s["id"] not in depth:
            parent = by_id.get(s["parent"])
            depth[s["id"]] = 0 if parent is None else depth_of(parent) + 1
        return depth[s["id"]]

    # (time, order, depth, key): closes and launch ends before opens and
    # launch starts at one time; a parent opens before its child
    events = []
    for s in spans:
        events.append((s["start_ns"], 1, depth_of(s), s["id"]))
        events.append((s["end_ns"], 0, 0, s["id"]))
    for launch in trace["launches"]:
        events.append((launch["start_ns"], 1, -1, None))
        events.append((launch["end_ns"], 0, -1, None))
    events.sort(key=lambda e: (e[0], e[1], e[2]))
    idle = defaultdict(float)
    stack, busy, prev = [], 0, None
    for t, opens, _, key in events:
        if prev is not None and t > prev and busy == 0:
            idle[by_id[stack[-1]]["name"] if stack else NO_SPAN] += (t - prev) * 1e-9
        prev = t
        if key is None:
            busy += 1 if opens else -1
        elif opens:
            stack.append(key)
        elif key in stack:
            stack.remove(key)
    return dict(idle)


def export_chrome_trace(path: str, trace: Optional[dict] = None) -> str:
    """Write ``trace`` (default: ``collect_trace()``) as a Chrome trace at
    ``path``: host spans on the host's row, parent-graph launches and each
    stamped phase (from its first to its last time, its sum and count in
    its arguments) on the device's, all on the host clock. Returns
    ``path``."""
    trace = trace if trace is not None else collect_trace()
    times = ([s["start_ns"] for s in trace["spans"]] + [x["start_ns"] for x in trace["launches"]]
             + [p["first_ns"] for p in trace["phases"]])
    t0 = min(times) if times else 0

    def us(ns):
        return (ns - t0) / 1e3

    events = [{"name": s["name"], "ph": "X", "ts": us(s["start_ns"]),
               "dur": (s["end_ns"] - s["start_ns"]) / 1e3, "pid": "host", "tid": "spans",
               "args": {"solve": s["solve"]}} for s in trace["spans"]]
    events += [{"name": "parent CUDA graph", "ph": "X", "ts": us(x["start_ns"]),
                "dur": (x["end_ns"] - x["start_ns"]) / 1e3, "pid": f"cuda:{x['device']}",
                "tid": "graph launches", "args": {"solve": x["solve"]}}
               for x in trace["launches"]]
    events += [{"name": p["path"], "ph": "X", "ts": us(p["first_ns"]),
                "dur": (p["last_ns"] - p["first_ns"]) / 1e3, "pid": f"cuda:{p['device']}",
                "tid": f"stamps {p['path']}",
                "args": {"total_ms": p["total_ns"] / 1e6, "count": p["count"]}}
               for p in trace["phases"]]
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"anchors": {str(k): v for k, v in trace["anchors"].items()},
                         "counters": trace["counters"], "dropped": trace["dropped"]}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
