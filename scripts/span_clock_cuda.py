#!/usr/bin/env python3
"""The program's spans against the profiler's own events, and what the
recorder costs, on one NVIDIA card at a benchmark cell's full size.

Run from the repository root on a machine with the card and nvcc:

    python3 scripts/span_clock_cuda.py [--workload sd15-diff-l2-b4] [--seed N]
        [--pairs 4] [--clock-runs 2] [--report build/span_clock.json]

It builds the cell's program state as ``portbench`` does (the cell's
weights, data and warm iteration), then:

- the clock, in ``--clock-runs`` runs of two whole iterations under
  ``torch.profiler`` (device activity only, as the benchmark's traced run):
  the share of the flash kernels' time inside the device extents of the
  ``tid.attention*`` spans and of their launches inside those spans' host
  intervals, of all kernel time inside the ``tid.pgd.iteration`` spans and
  of this thread's launch calls inside their host intervals, each K4
  kernel's place in its ``tid.pgd.update`` span, whether the spans' device
  times ever precede their enqueue, and the profiler's own wander (its
  kernels' starts against its launch calls, by 250 ms window), with the
  flash share read again over the windows where the profiler's device
  times hold; the flash calls and launches an iteration beside the count
  from the configuration;
- the per-layer readings of that recording (``portbench/metrics``);
- the recorder's cost: the same traced iterations with the recorder on and
  with it off (``run_pgd`` then opens no recording, as in the program before
  it), in turns, and untraced iterations with a recording forced open and
  with none; the host time inside the recorder's calls; one CUDA event
  record with the device idle and busy; and the off path's cost a site.

It prints one JSON object and writes it to ``--report``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: the largest least kernel-minus-launch delay of a window in which the
#: profiler's device timestamps count as on its host clock (launch latency
#: read 4-10 us where they held)
HOLDS_NS = 50_000
READERS = ("host_issue_ms_per_iter", "queue_lead_ms", "unet_ms_per_iter", "vae_ms_per_iter",
           "attn_span_ms_per_iter")


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30).stdout.strip()


def union(extents):
    """Sorted, merged [(start, end)]."""
    out = []
    for s, e in sorted(extents):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def inside(a0, a1, merged) -> int:
    return sum(max(0, min(a1, e) - max(a0, s)) for s, e in merged)


def profiled(fn, sync):
    """``fn()`` under the profiler (device activity only); (wall s, events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    return wall, list(prof.profiler.kineto_results.events())


def thread_ids():
    """The ids this thread may carry in the profiler's runtime events."""
    ident = threading.get_ident()
    low = ident & 0xFFFFFFFF
    return {threading.get_native_id(), ident, low, low - (1 << 32) if low >= 1 << 31 else low}


def wander(kernels, launch_at, window_ns=250_000_000):
    """The profiler's device timestamps against its own host ones: the least
    kernel-start-minus-launch delay of each window of launches (the launch
    latency where the conversion holds).  Returns ({window: least}, the
    global least)."""
    least = {}
    for c, (s, _, _) in kernels.items():
        if c in launch_at:
            w = launch_at[c] // window_ns
            least[w] = min(least.get(w, s - launch_at[c]), s - launch_at[c])
    return least, (min(least.values()) if least else 0)


def clock_check(rec, events, flash_expected: int) -> dict:
    me = thread_ids()
    kernels, launch_at, mine, records, ids = {}, {}, [], 0, {}
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                kernels[e.correlation_id()] = (e.start_ns(), e.end_ns(), e.name())
        else:
            if "EventRecord" in e.name():
                records += 1
            if "Launch" in e.name():
                rid = e.device_resource_id()
                ids[rid] = ids.get(rid, 0) + 1
                launch_at[e.correlation_id()] = e.start_ns()
                if rid in me:
                    mine.append(e.start_ns())
    spans = rec.spans
    its = rec.iterations()
    steps = len(its)
    attn_spans = [s for s in spans if s.name in ("tid.attention", "tid.attention.backward")]
    iter_dev = union((s.device_start_ns, s.device_end_ns) for s in its)
    iter_host = union((s.host_start_ns, s.host_end_ns) for s in its)
    attn_dev = union((s.device_start_ns, s.device_end_ns) for s in attn_spans)
    attn_host = union((s.host_start_ns, s.host_end_ns) for s in attn_spans)
    least, floor = wander(kernels, launch_at)
    window = 250_000_000

    def holds(c):
        """Whether the profiler's device time of kernel ``c`` is on its host
        clock: launched in a window whose least delay is a launch latency."""
        return c in launch_at and 0 <= least[launch_at[c] // window] <= HOLDS_NS

    flash = {c: k for c, k in kernels.items() if "flash_" in k[2]}
    flash_ns = sum(e - s for s, e, _ in flash.values())
    busy = sum(e - s for s, e, _ in kernels.values())
    updates = [s for s in spans if s.name == "tid.pgd.update"]
    margins = []
    for c, (s, e, n) in sorted(kernels.items(), key=lambda kv: kv[1][0]):
        if "pgd_l2" in n:
            u = min(updates, key=lambda u: abs(u.device_start_ns - s))
            margins.append([s - u.device_start_ns, u.device_end_ns - e, holds(c)])
    flash_held = {c: k for c, k in flash.items() if holds(c)}
    per_iter = lambda n: n / steps                                        # noqa: E731
    counts = {}
    for s in spans:
        for k, v in s.counts.items():
            counts[k] = counts.get(k, 0) + v
    flash_launches = [launch_at[c] for c in flash if c in launch_at]
    return {
        "iterations": steps,
        "spans": len(spans),
        "spans_closed": all(s.closed for s in spans),
        "spans_with_iteration": all(s.iteration is not None for s in spans),
        "clock_rate_ppm": (rec.clock_rate - 1) * 1e6,
        "least_device_start_after_host_start_ns": min(s.device_start_ns - s.host_start_ns
                                                      for s in spans),
        "least_lead_ms": min(s.lead_ms for s in spans),
        "device_ops": len(kernels),
        "flash_kernels": len(flash),
        "flash_time_inside_attention_spans": inside_share(
            [(s, e) for s, e, _ in flash.values()], attn_dev, flash_ns),
        "flash_kernels_where_profiler_holds": len(flash_held),
        "flash_time_inside_attention_spans_where_profiler_holds": inside_share(
            [(s, e) for s, e, _ in flash_held.values()], attn_dev,
            sum(e - s for s, e, _ in flash_held.values())),
        "flash_launches_inside_attention_host_spans": (
            sum(inside(t, t + 1, attn_host) for t in flash_launches) / len(flash_launches)
            if flash_launches else None),
        "profiler_wander_ns": (max(least.values()) - floor) if least else None,
        "profiler_least_delay_by_250ms": [[w, d] for w, d in sorted(least.items())],
        "kernel_time_inside_iterations": sum(inside(s, e, iter_dev)
                                             for s, e, _ in kernels.values()) / busy,
        "launches_on_this_thread": len(mine),
        "launches_inside_iteration_host_spans": (
            sum(inside(t, t + 1, iter_host) for t in mine) / len(mine) if mine else None),
        "launch_threads_seen": {str(k): v for k, v in ids.items()},
        "k4_margins_ns_and_profiler_holds": margins,
        "event_records": records,
        "flash_forward_calls_per_iter": per_iter(sum(
            1 for s in spans if s.name == "tid.attention" and s.attrs.get("route") == "flash")),
        "flash_backward_calls_per_iter": per_iter(sum(
            1 for s in spans if s.name == "tid.attention.backward"
            and s.attrs.get("route") == "flash")),
        "flash_forward_expected_per_iter": flash_expected,
        "counts_per_iter": {k: v / steps for k, v in sorted(counts.items())},
        "totals_match_spans": counts == rec.totals,
    }


def inside_share(extents, merged, total):
    return sum(inside(s, e, merged) for s, e in extents) / total if total else None


def flash_calls_expected(cell, unet_calls: int) -> int:
    """Forward flash calls an iteration from the configuration: the UNet's
    self-attentions at its top level (the latent's tokens) in each of
    ``unet_calls`` calls a chunk, the VAE's mid-block in each chunk's decode,
    and the one encode, where the route rule sends them to the kernels."""
    from tml_image_editing_defense_torch.models.layers import (KERNEL_HEAD_DIMS,
                                                               MIN_CHUNKED_SEQ)

    unet, vae, tr = cell.config["unet"], cell.config["vae"], cell.traffic
    train = tr["train"]
    tokens = (tr["image_size"] // 2 ** (len(vae["block_out_channels"]) - 1)) ** 2
    long = tokens >= max(2 * tr["attn_kv_chunk"], MIN_CHUNKED_SEQ)
    top = unet["block_out_channels"][0]
    heads = unet["attention_head_dim"]
    head_dim = top // (heads if isinstance(heads, int) else heads[0])
    n_top = 0
    if unet["down_block_types"][0].startswith("CrossAttn"):
        n_top += unet["layers_per_block"]
    if unet["up_block_types"][-1].startswith("CrossAttn"):
        n_top += unet["layers_per_block"] + 1
    unet_flash = n_top if long and head_dim in KERNEL_HEAD_DIMS else 0
    vae_flash = int(long and vae["block_out_channels"][-1] in KERNEL_HEAD_DIMS)
    chunks = train["grad_reps"] // train.get("eot_chunk", 1)
    return chunks * (unet_calls * unet_flash + vae_flash) + vae_flash


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="sd15-diff-l2-b4")
    ap.add_argument("--seed", type=int, default=2**31 + 1901)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--clock-runs", type=int, default=2)
    ap.add_argument("--report", default="build/span_clock.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    from portbench import cells, run
    from tml_image_editing_defense_torch.utils import profiling

    run.set_cache_dirs(cells.ROOT)
    cell = cells.load_cell(args.workload)
    drv_mod = cells.driver(cell)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    drv = drv_mod.Driver(cell, args.seed, dev)
    sync = lambda: torch.cuda.synchronize(dev)                            # noqa: E731
    steps = cell.traffic["trace_steps"]
    out = {"card": card_line(), "torch": torch.__version__, "workload": args.workload,
           "seed": args.seed, "setup_s": time.perf_counter() - t0}

    def traced_run(start):
        def fn():
            drv._run(drv.iterates[0], start, start + steps)
        return fn

    # the profiler's first run starts CUPTI: not compared
    profiled(traced_run(1), sync)
    expected = flash_calls_expected(cell, drv.plan.num_steps)
    trace = type("T", (), {"steps": steps})()
    out["clock"], out["readings"] = [], []
    for _ in range(args.clock_runs):
        wall, events = profiled(traced_run(1), sync)
        rec = profiling.last_recording()
        out["clock"].append(dict(clock_check(rec, events, expected), profiled_wall_s=wall))
        del events
        out["readings"].append({n: cells.reader("metrics", n).read(trace) for n in READERS})

    # the recorder's cost: traced iterations with it on and off, in turns
    real = profiling.recording_if_profiled
    off = lambda device=None: profiling._NOOP                            # noqa: E731
    costs = {"traced_on_s": [], "traced_off_s": [], "traced_on_ops": [], "traced_off_ops": [],
             "traced_on_records": [], "traced_off_records": [],
             "untraced_on_s": [], "untraced_off_s": []}
    for i in range(args.pairs):
        for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
            profiling.recording_if_profiled = real if side == "on" else off
            try:
                w, ev = profiled(traced_run(1), sync)
            finally:
                profiling.recording_if_profiled = real
            costs[f"traced_{side}_s"].append(w / steps)
            costs[f"traced_{side}_ops"].append(
                sum(str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()
                    for e in ev) / steps)
            costs[f"traced_{side}_records"].append(
                sum("EventRecord" in e.name() for e in ev) / steps)
            del ev
        for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
            sync()
            t = time.perf_counter()
            if side == "on":
                with profiling.recording(dev):
                    traced_run(1)()
            else:
                traced_run(1)()
            sync()
            costs[f"untraced_{side}_s"].append((time.perf_counter() - t) / steps)
    # host seconds inside the recorder's own calls, one untraced run
    begin, end = profiling.Recording._begin, profiling.Recording._end
    inside_s = [0.0]

    def timed(fn):
        def wrapped(self, sp):
            t = time.perf_counter()
            fn(self, sp)
            inside_s[0] += time.perf_counter() - t
        return wrapped

    profiling.Recording._begin, profiling.Recording._end = timed(begin), timed(end)
    try:
        with profiling.recording(dev):
            traced_run(1)()
    finally:
        profiling.Recording._begin, profiling.Recording._end = begin, end
    costs["recorder_host_s"] = [inside_s[0] / steps]
    out["cost"] = {k: v for k, v in costs.items()}
    out["cost"]["medians"] = {k: statistics.median(v) for k, v in costs.items() if v}

    # one CUDA event record, with the device idle and with work queued
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(5000)]
    for busy in (False, True):
        sync()
        if busy:
            torch.cuda._sleep(2_000_000_000)
        t = time.perf_counter()
        for ev in evs:
            ev.record()
        out["cost"][f"event_record_us_{'busy' if busy else 'idle'}"] = (
            (time.perf_counter() - t) / len(evs) * 1e6)
        sync()

    # the off path, a site at a time
    n = 200_000
    t = time.perf_counter()
    for _ in range(n):
        with profiling.span("tid.attention", route="plain", shape=None):
            profiling.count("attention.plain")
    site_ns = (time.perf_counter() - t) / n * 1e9
    sites = out["clock"][0]["spans"] / steps + sum(out["clock"][0]["counts_per_iter"].values())
    out["off_path"] = {"ns_a_site": site_ns, "sites_per_iter": sites,
                       "ms_per_iter": site_ns * sites / 1e6}
    text = json.dumps(out)
    Path(args.report).parent.mkdir(parents=True, exist_ok=True)
    Path(args.report).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
