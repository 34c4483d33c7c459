"""Profiling and timing (port of ``utils/profiling.py``).

- :func:`span`, :func:`count`, :func:`backward_span`: the program's spans
  and counters, kept in memory by a :class:`Recording` while one is open
  (:func:`recording`; :func:`recording_if_profiled` in ``run_pgd``);
  :func:`last_recording` returns the newest; :func:`spans_paused` keeps
  spans shut over a block whose counts still go to the spans around it;
- :func:`trace`: ``torch.profiler`` over a block with a recording open; the
  Chrome trace (the spans as ``record_function`` ranges) and one line a
  span (``spans.jsonl``) go into a directory;
- :func:`measure_seed`: a process-salted seed for measured calls;
- :func:`sync`: wait for the device and read one element;
- :class:`StepTimer`: step times by CUDA events on the card, by the host
  clock on the CPU, the first (warm-up) step kept apart;
- :func:`device_memory_stats`: the card's allocated bytes now and at peak,
  and its size (``{}`` on the CPU).

Spans and the clock.  With no recording open, :func:`span` reads one
module-level name and returns a shared no-op context: no span object, no
CUDA event, no ``record_function``.  While one is open, a span keeps its id,
its parent (the innermost open span of its thread; on a thread with none
open, the open span that waits for that thread: autograd's device thread
runs the backward while ``tid.eot.backward`` waits), its thread, its name and
attributes, the ``iteration`` of the ``tid.pgd.iteration`` it falls in, its
host start and end on ``time.time_ns()`` (the clock ``torch.profiler``
converts its events to), and on a card a start and an end CUDA event on the
current stream.  When the recording closes it waits for the device once and
puts the events on the same host clock through two anchors, events recorded
on the idle device right after a synchronize at its start and at its close
(an H100's event timer ran 2-5 ppm off the host clock): ``device_ms`` is a
span's extent on the stream, and ``lead_ms`` the time from the host
enqueuing the span's end mark to the device reaching it (how long its work
waited in the queue; near 0 the device had run dry).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

#: the span of one PGD iteration; every span under it carries its ``iteration``
ITERATION = "tid.pgd.iteration"


class Span:
    """One recorded span.  Times in ns on ``time.time_ns()``'s clock; the
    device times and ``lead_ms`` are None off the card and until the
    recording closes."""

    __slots__ = ("name", "attrs", "waits", "id", "parent", "thread", "iteration", "nth",
                 "host_start_ns", "host_end_ns", "device_start_ns", "device_end_ns",
                 "device_ms", "lead_ms", "counts", "_rec", "_marks", "_range", "_stack")

    def __init__(self, rec: "Recording", name: str, attrs: dict, waits: bool = False):
        self._rec, self.name, self.attrs, self.waits = rec, name, attrs, waits
        self.id = self.parent = self.thread = self.iteration = self.nth = None
        self.host_start_ns = self.host_end_ns = None
        self.device_start_ns = self.device_end_ns = self.device_ms = self.lead_ms = None
        self.counts: Dict[str, int] = {}
        self._marks = self._range = self._stack = None

    def __enter__(self):
        self._rec._begin(self)
        return self

    def __exit__(self, *exc):
        self._rec._end(self)
        return False

    @property
    def closed(self) -> bool:
        return self.host_end_ns is not None

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.host_end_ns is None else (self.host_end_ns - self.host_start_ns) / 1e6

    def row(self) -> dict:
        """The span as one JSON object (a line of ``spans.jsonl``)."""
        return {"id": self.id, "parent": self.parent, "thread": self.thread, "name": self.name,
                "iteration": self.iteration, "nth": self.nth,
                "attrs": {k: _plain(v) for k, v in self.attrs.items()},
                "host_start_ns": self.host_start_ns, "host_end_ns": self.host_end_ns,
                "host_ms": self.host_ms, "device_start_ns": self.device_start_ns,
                "device_end_ns": self.device_end_ns, "device_ms": self.device_ms,
                "lead_ms": self.lead_ms, "counts": self.counts, "closed": self.closed}


def _plain(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    return str(v)


#: idle CUDA events by device index, reused from one recording to the next
_EVENT_POOL: Dict[int, list] = {}


class Recording:
    """The spans and counts of one recording, in the order they opened.
    ``device``: where the recorded work runs (CUDA events only on a card);
    ``ranges``: also open a ``record_function`` range a span (for a
    profiler that records the host's activity)."""

    def __init__(self, device=None, ranges: bool = False):
        self.device = torch.device("cpu" if device is None else device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.ranges = ranges
        self.spans: List[Span] = []
        self.totals: Dict[str, int] = {}
        self.anchor_ns: Optional[int] = None
        #: the host clock's ns a device ns, from the anchors at the start and the close
        self.clock_rate: Optional[float] = None
        self.is_open = True
        #: no span opens while set (:func:`spans_paused`)
        self.paused = False
        self._ids = itertools.count()
        self._stacks: Dict[int, List[Span]] = {}   # thread -> its open spans, innermost last
        self._waiting: List[Span] = []              # open spans that wait for another thread
        self._nth: Dict[tuple, int] = {}
        self._events: list = []
        self._anchor = None
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self._anchor = self._event()
            self._anchor.record(torch.cuda.current_stream(self.device))
            self.anchor_ns = time.time_ns()

    def _event(self):
        pool = _EVENT_POOL.setdefault(self.device.index, [])
        ev = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        self._events.append(ev)
        return ev

    def _innermost(self, stack):
        if stack:
            return stack[-1]
        return self._waiting[-1] if self._waiting else None

    def _begin(self, sp: Span) -> None:
        tid = threading.get_native_id()
        stack = self._stacks.get(tid)
        if stack is None:
            stack = self._stacks[tid] = []
        parent = self._innermost(stack)
        sp.id, sp.thread = next(self._ids), tid
        sp.parent = None if parent is None else parent.id
        sp.iteration = (sp.attrs.get("iteration") if sp.name == ITERATION
                        else None if parent is None else parent.iteration)
        key = (sp.parent, sp.name)
        sp.nth = self._nth.get(key, 0)
        self._nth[key] = sp.nth + 1
        stack.append(sp)
        sp._stack = stack
        if sp.waits:
            self._waiting.append(sp)
        self.spans.append(sp)
        if self.ranges:
            sp._range = torch.profiler.record_function(sp.name)
            sp._range.__enter__()
        sp.host_start_ns = time.time_ns()
        if self.cuda:
            ev = self._event()
            ev.record()
            sp._marks = [ev, None]

    def _end(self, sp: Span) -> None:
        if sp.host_end_ns is not None or sp._stack is None:
            return
        sp.host_end_ns = time.time_ns()
        if sp._marks is not None:
            ev = self._event()
            ev.record()
            sp._marks[1] = ev
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        sp._stack.remove(sp)
        if sp.waits:
            self._waiting.remove(sp)

    def count(self, name: str, n: int = 1) -> None:
        self.totals[name] = self.totals.get(name, 0) + n
        sp = self._innermost(self._stacks.get(threading.get_native_id()))
        if sp is not None:
            sp.counts[name] = sp.counts.get(name, 0) + n

    def close(self) -> None:
        """Stop recording; on a card wait for the device once and read the
        events.  Spans still open stay unclosed (``closed`` false)."""
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None
        self.is_open = False
        for sp in self.spans:
            if sp._range is not None:
                sp._range.__exit__(None, None, None)
                sp._range = None
        if not self.cuda:
            return
        torch.cuda.synchronize(self.device)
        last = self._event()
        last.record(torch.cuda.current_stream(self.device))
        last_ns = time.time_ns()
        last.synchronize()
        # the device's timer and the host clock may run at rates a few ppm
        # apart: scale elapsed device time by the two anchors
        span_ms = self._anchor.elapsed_time(last)
        self.clock_rate = (last_ns - self.anchor_ns) / (span_ms * 1e6) if span_ms > 0 else 1.0

        def host_ns(ev):
            return self.anchor_ns + round(self._anchor.elapsed_time(ev) * 1e6 * self.clock_rate)

        for sp in self.spans:
            if sp._marks is None:
                continue
            start, end = sp._marks
            sp.device_start_ns = host_ns(start)
            if end is not None:
                sp.device_end_ns = host_ns(end)
                sp.device_ms = start.elapsed_time(end)
                sp.lead_ms = (sp.device_end_ns - sp.host_end_ns) / 1e6
            sp._marks = None
        _EVENT_POOL.setdefault(self.device.index, []).extend(self._events)
        self._events, self._anchor = [], None

    def iterations(self) -> List[Span]:
        return [s for s in self.spans if s.name == ITERATION]

    def write_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for sp in self.spans:
                f.write(json.dumps(sp.row()) + "\n")


_ACTIVE: Optional[Recording] = None
_LAST: Optional[Recording] = None


class _Noop:
    """The shared context :func:`span` returns with no recording open."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def span(name: str, *, waits: bool = False, **attrs):
    """``with span("tid.unet", rows=2): ...``: a span of the open recording,
    else a shared no-op.  ``waits``: the span waits for another thread (the
    backward), whose spans opened with nothing open take it as parent."""
    rec = _ACTIVE
    if rec is None or rec.paused:
        return _NOOP
    return Span(rec, name, attrs, waits)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span and of
    the recording's totals (nothing with no recording open)."""
    rec = _ACTIVE
    if rec is not None:
        rec.count(name, n)


@contextlib.contextmanager
def spans_paused():
    """No span opens in the block and no module's backward is marked (a
    CUDA graph's capture may not take their CUDA events); the block's counts
    still go to the spans open around it."""
    rec = _ACTIVE
    if rec is None or rec.paused:
        yield
        return
    rec.paused = True
    try:
        yield
    finally:
        rec.paused = False


def last_recording() -> Optional[Recording]:
    """The newest recording (open or closed), until the next one opens."""
    return _LAST


@contextlib.contextmanager
def recording(device=None, ranges: bool = False):
    """Record the block's spans (a recording already open is joined, and
    closes with its own block)."""
    global _ACTIVE, _LAST
    if _ACTIVE is not None:
        yield _ACTIVE
        return
    rec = Recording(device, ranges)
    _ACTIVE = _LAST = rec
    try:
        yield rec
    finally:
        rec.close()


def recording_if_profiled(device=None):
    """A recording over the block where ``torch.profiler`` runs or one is
    already open (``trace``), else a no-op: ``run_pgd``'s rule, so that the
    program records under any profiler and costs nothing without one."""
    if _ACTIVE is None and not torch.autograd._profiler_enabled():
        return _NOOP
    return recording(device)


class _Token:
    """The span of one module's backward, opened by the backward of its
    output marker and closed by that of its input marker."""

    __slots__ = ("rec", "name", "attrs", "span")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs, self.span = rec, name, attrs, None

    def open(self):
        if self.span is None and self.rec.is_open and not self.rec.paused:
            self.span = Span(self.rec, self.name, self.attrs)
            self.rec._begin(self.span)

    def close(self):
        if self.span is not None:
            self.rec._end(self.span)


class _OutputMarker(torch.autograd.Function):
    """Identity on a module's outputs; its backward opens the span."""

    @staticmethod
    def forward(ctx, token, *outs):
        ctx.token = token
        ctx.set_materialize_grads(False)
        return tuple(o.view_as(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.token.open()
        return (None, *grads)


class _InputMarker(torch.autograd.Function):
    """Identity on a module's input; its backward closes the span."""

    @staticmethod
    def forward(ctx, token, x):
        ctx.token = token
        ctx.set_materialize_grads(False)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.token.close()
        return None, g


def backward_span(name: str, fn, x: torch.Tensor, *args, **attrs):
    """``fn(x, *args)``; while recording, with gradients on and ``x``
    requiring one, identity markers at ``x`` and at the outputs (a tensor or
    a tuple of tensors) make a span ``name`` of the module's backward: from
    the gradient reaching its outputs to the gradient leaving ``x``.
    Values and gradients are those of ``fn`` alone."""
    rec = _ACTIVE
    if rec is None or rec.paused or not torch.is_grad_enabled() or not x.requires_grad:
        return fn(x, *args)
    token = _Token(rec, name, attrs)
    out = fn(_InputMarker.apply(token, x), *args)
    if isinstance(out, tuple):
        return _OutputMarker.apply(token, *out)
    return _OutputMarker.apply(token, out)[0]


@contextlib.contextmanager
def trace(log_dir):
    """``with trace(dir) as prof: step(...)``: ``torch.profiler`` over the
    block (CPU and, where there is a card, CUDA activity) with a recording
    open; the Chrome trace, which shows the spans as ``record_function``
    ranges beside the operators and kernels, goes to ``dir/trace.json`` and
    the spans, one JSON object a line with their device times and counts,
    to ``dir/spans.jsonl``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with recording("cuda" if cuda else "cpu", ranges=True) as rec:
            yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    rec.write_jsonl(log_dir / "spans.jsonl")


_ENTROPY = int(time.time_ns()) & 0x7FFFFFFF


def measure_seed(i: int) -> int:
    """A seed for the ``i``-th measured call, salted by the process's start
    time, so that no two runs time the same draws (JAX profiling.py:52-61)."""
    return _ENTROPY ^ ((0x9E3779B9 * (i + 1)) & 0x7FFFFFFF)


def sync(x: torch.Tensor) -> float:
    """Wait for the work that produces ``x`` and return its first element:
    the last statement of a timed region."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.reshape(-1)[0])


class StepTimer:
    """Accumulates step times; the first step (kernel builds, cuDNN's
    algorithm search, allocator growth) is kept apart.  On the card a step
    is timed by CUDA events recorded around it on the current stream (the
    exit waits for the end event); on the CPU by the host clock.

        timer = StepTimer("cuda")
        for _ in range(3):
            with timer:
                step(...)
        timer.summary()
    """

    def __init__(self, device=None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.first_time: Optional[float] = None
        self.times = []
        self._start = None

    def __enter__(self):
        if self.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._start
        if self.first_time is None:
            self.first_time = dt
        else:
            self.times.append(dt)

    @property
    def last(self) -> Optional[float]:
        """The seconds of the last step timed."""
        return self.times[-1] if self.times else self.first_time

    @property
    def steady_state(self) -> Optional[float]:
        return min(self.times) if self.times else None

    def summary(self) -> Dict[str, float]:
        out = {"first_s": self.first_time or 0.0, "n_steps": len(self.times),
               "device": str(self.device)}
        if self.times:
            out.update(steady_min_s=min(self.times),
                       steady_mean_s=sum(self.times) / len(self.times))
        return out


def device_memory_stats(device=None) -> Dict[str, int]:
    """Bytes allocated by tensors on the card now (``bytes_in_use``) and at
    the peak since the last ``torch.cuda.reset_peak_memory_stats``
    (``peak_bytes_in_use``), and the card's memory (``bytes_limit``); ``{}``
    on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory)}
