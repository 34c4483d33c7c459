"""The traced run's reading of the device: ``torch.profiler`` over a few
whole iterations, kept in memory and reduced to a :class:`Trace` (no trace
file is written).

Device busy time is the union of the device operations' spans; the idle
gaps between them are named by the innermost ``portbench.*`` host span
(:func:`span`, put by the driver around its own calls) in which each gap
starts.  Without the host's operators in the profile (the default: they
slow the host), those spans are the benchmark's own wall-clock records,
used where the device's timestamps fall inside them.  Kernels are grouped by
name as the port's on-card smoke test groups them (:func:`kernel_group`).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

WINDOW_SPAN = "portbench.window"
TOP = 10
#: (name, start_ns, end_ns) of the benchmark's spans while a profile runs,
#: on the wall clock (``time.time_ns``)
_SPANS: List[Tuple[str, int, int]] = []
_RECORDING = [False]


@contextlib.contextmanager
def span(name: str):
    """A ``portbench.*`` span: a ``record_function`` range, and while
    :func:`profile` runs a wall-clock record of its own."""
    import torch

    t0 = time.time_ns()
    with torch.profiler.record_function(name):
        yield
    if _RECORDING[0]:
        _SPANS.append((name, t0, time.time_ns()))

CONV, MATMUL, NORM, ATTENTION = ("convolution (cuDNN)", "matmul (cuBLAS)", "group/layer norm",
                                 "flash attention K1-K3")


def kernel_group(name: str) -> str:
    """The layer a device operation belongs to, from its name."""
    n = name.lower()
    if "flash_" in n:
        return ATTENTION
    if "pgd_l2" in n:
        return "L2 update K4"
    if "pgd_linf" in n:
        return "Linf update K5"
    # cuDNN's FFT algorithms run complex (float2 / cf32) gemm and gemv
    # kernels; its bf16 convolutions run on NHWC copies of the NCHW tensors,
    # which it makes and undoes itself (nchwToNhwc, nhwcToNchw)
    if any(s in n for s in ("conv", "dgrad", "fprop", "wgrad", "implicit", "winograd", "fft",
                            "cf32", "float2", "nchwtonhwc", "nhwctonchw")):
        return CONV
    # cuBLAS's Hopper kernels are named nvjet_*
    if any(s in n for s in ("gemm", "cutlass", "xmma", "cublas", "nvjet")):
        return MATMUL
    # group norm's statistics (RowwiseMoments) and its fused backward parameters
    if any(s in n for s in ("norm", "rowwisemoments", "fusedparams", "internalgradients")):
        return NORM
    if n.startswith("memcpy") or n.startswith("memset"):
        return "memcpy and memset"
    return "elementwise and other"


@dataclass
class Trace:
    """What the traced iterations read.  Times in seconds."""

    steps: int                       # whole iterations profiled
    units: int                       # their image-iterations
    window_s: float
    busy_s: float
    device_ops: int
    group_s: Dict[str, float]
    kernel_s: Dict[str, float]
    gaps: List[Tuple[str, float]]    # the longest idle gaps, longest first
    host_mb: float = 0.0             # host memory the profile held
    #: filled by the harness: the untraced window's record and the driver's
    #: count of the work of one unit
    run: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)

    def per_step_ms(self, seconds: float) -> float:
        return 1e3 * seconds / self.steps

    def breakdown(self) -> dict:
        groups = sorted(self.group_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in groups],
                "idle_gaps": [[k, v] for k, v in self.gaps[:TOP]]}


DEVICE, HOST, ANNOTATION = "device", "host", "annotation"


def _events(prof):
    """(kind, start_ns, end_ns, name) of every recorded event, from the
    profiler's raw records (its Python event list is far slower to build).
    ``kind``: DEVICE work, a HOST event, or an ANNOTATION, the device
    timeline's copy of a host ``record_function`` range (no device work)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = HOST
        if str(e.device_type()).endswith("CUDA"):
            kind = ANNOTATION if e.is_user_annotation() else DEVICE
        out.append((kind, e.start_ns(), e.end_ns(), e.name()))
    return out


OUTSIDE = "before the first or after the last device operation"


def summarize(events, steps: int, units: int, wall_s: float = 0.0) -> Trace:
    """Reduce ``events`` to a :class:`Trace`.  The window is the host's
    ``portbench.window`` span where the host's operators were recorded;
    else it runs from the first device operation to the last, and the rest
    of ``wall_s`` counts as one idle gap outside them.  Idle gaps are named
    by the innermost ``portbench.*`` span (host or annotation) they start in."""
    window = [(s, e) for k, s, e, n in events if k == HOST and n == WINDOW_SPAN]
    dev_all = [(s, e, n) for k, s, e, n in events if k == DEVICE]
    if window:
        w0, w1 = window[0]
    elif dev_all:
        w0, w1 = min(s for s, _, _ in dev_all), max(e for _, e, _ in dev_all)
    else:
        raise RuntimeError(f"no {WINDOW_SPAN} span and no device operation in the trace")
    # a device event may be listed twice: keep one per (start, end, name)
    dev = sorted({(s, e, n) for s, e, n in dev_all if s >= w0 and e <= w1})
    spans = sorted((s, e, n) for k, s, e, n in events
                   if k != DEVICE and n.startswith("portbench.") and n != WINDOW_SPAN)
    kernel_s: Dict[str, float] = {}
    merged: List[List[int]] = []
    for s, e, n in dev:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) / 1e9
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [x for m in merged for x in m] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    starts = [s for s, _, _ in spans]

    def span_at(t):
        i = bisect.bisect_right(starts, t)
        inner = [(s, e, n) for s, e, n in spans[max(0, i - 64):i] if s <= t < e]
        return max(inner)[2] if inner else "portbench.window (between calls)"

    named = [(span_at(a) if spans else "no span recorded", (b - a) / 1e9) for a, b in gaps]
    window_s = (w1 - w0) / 1e9
    if not window and wall_s > window_s:
        named.append((OUTSIDE, wall_s - window_s))
        window_s = wall_s
    group_s: Dict[str, float] = {}
    for n, s in kernel_s.items():
        group_s[kernel_group(n)] = group_s.get(kernel_group(n), 0.0) + s
    return Trace(steps=steps, units=units, window_s=window_s, busy_s=busy / 1e9,
                 device_ops=len(dev), group_s=group_s, kernel_s=kernel_s,
                 gaps=sorted(named, key=lambda g: -g[1])[:TOP])


def _rss_mb() -> float:
    """This process's resident memory now, from ``/proc/self/statm``."""
    import os

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def _aligned(events, spans):
    """The benchmark's own spans as HOST events where the device's
    timestamps fall inside its window span (the same clock), else none."""
    win = [(s, e) for n, s, e in spans if n == WINDOW_SPAN]
    dev = [(s, e) for k, s, e, _ in events if k == DEVICE]
    if not win or not dev:
        return []
    slack = 2_000_000                                   # 2 ms
    w0, w1 = win[0]
    if min(s for s, _ in dev) < w0 - slack or max(e for _, e in dev) > w1 + slack:
        return []
    return [(HOST, s, e, n) for n, s, e in spans]


def profile(fn: Callable[[], None], steps: int, units: int, sync: Callable[[], None]) -> Trace:
    """``fn()`` (``steps`` whole iterations, ``units`` image-iterations)
    under the profiler inside the window span, which ends after ``sync()``.
    On a card only the device's activity is recorded: recording the host's
    operators too lengthened an iteration by 20-90 %."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    rss0 = _rss_mb()
    sync()
    _SPANS.clear()
    _RECORDING[0] = True
    try:
        with torch_profile(activities=activities) as prof:
            t0 = time.perf_counter()
            with span(WINDOW_SPAN):
                fn()
                sync()
            wall = time.perf_counter() - t0
    finally:
        _RECORDING[0] = False
    t0 = time.perf_counter()
    events = _events(prof)
    rss1 = _rss_mb()
    del prof
    if not any(k == HOST and n == WINDOW_SPAN for k, _, _, n in events):
        events += _aligned(events, _SPANS)
    trace = summarize(events, steps, units, wall)
    trace.host_mb = rss1 - rss0
    trace.run["reduce_s"] = time.perf_counter() - t0
    trace.run["profiled_wall_s"] = wall
    trace.run["own_spans_on_the_trace_clock"] = bool(_aligned(events, _SPANS))
    return trace
