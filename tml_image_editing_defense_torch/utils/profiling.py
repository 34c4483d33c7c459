"""Profiling and timing (port of ``utils/profiling.py``).

- :func:`trace`: ``torch.profiler`` over a block, its Chrome trace written
  into a directory;
- :func:`measure_seed`: a process-salted seed for measured calls;
- :func:`sync`: wait for the device and read one element;
- :class:`StepTimer`: step times by CUDA events on the card, by the host
  clock on the CPU, the first (warm-up) step kept apart;
- :func:`device_memory_stats`: the card's allocated bytes now and at peak,
  and its size (``{}`` on the CPU).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir):
    """``with trace(dir) as prof: step(...)``: ``torch.profiler`` over the
    block (CPU and, where there is a card, CUDA activity); the Chrome trace
    goes to ``dir/trace.json``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


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
