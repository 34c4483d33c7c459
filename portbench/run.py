"""The benchmark of the PyTorch port on one NVIDIA card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the cell named in ``BENCHMARK.json``
(``portbench/cells.py``), measures it for ``--seconds`` after its set-up,
checks what the timed path produced against the plain reference, and prints
one JSON line last on stdout: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics; with ``--trace 1`` the per-layer
metrics of a profiled run after the window), ``device``, and last
``checks``, each number compared with its limit (also the last lines on
stderr).

It exits with an error and prints no result where CUDA is missing or has
fewer cards than the cell asks for, where the program
(``tml_image_editing_defense_torch``) is not in the checkout, and where
``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: top-level modules that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "tml_image_editing_defense_tpu")
#: the program under test, which has to come from the checkout
PROGRAM = "tml_image_editing_defense_torch"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def program_in(root: Path) -> bool:
    """Whether the program's package would be imported from under ``root``."""
    spec = importlib.util.find_spec(PROGRAM)
    if spec is None or spec.origin is None:
        return False
    return Path(spec.origin).resolve().is_relative_to(Path(root).resolve())


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernel library builds into ``build/kernels`` there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                     ("TRITON_CACHE_DIR", "build/triton")):
        os.environ[var] = str(root / sub)
    os.environ["USE_FLAX"] = "0"


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda", root=None,
             step_factory=None, start: float = PROCESS_START) -> dict:
    """One run of ``cell`` on ``device`` (no look for a card): the result
    line's dict."""
    import torch

    from portbench import cells as cells_mod
    from portbench import trace as trace_mod

    root = root or cells_mod.ROOT
    drv_mod = cells_mod.driver(cell, root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    drv = drv_mod.Driver(cell, seed, dev, step_factory=step_factory)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.time() - start
    phases = {"imports": setup_s - sum(drv.phases.values()), **drv.phases}
    log(f"[portbench] {cell.name} seed {seed}: set-up {setup_s:.3f} s "
        f"({', '.join(f'{k} {v:.3f}' for k, v in phases.items())})")
    mallocs = _device_mallocs(dev)
    win = drv.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    record = {"setup_s": setup_s, "seconds": win["seconds"], "units": win["units"],
              "steps": win["steps"], "peak_bytes": peak}
    log(f"[portbench] window {win['seconds']:.3f} s, {win['steps']} iterations, "
        f"{win['units']} image-iterations, peak {peak} bytes, "
        f"{_device_mallocs(dev) - mallocs} device allocations; host seconds to issue each "
        f"iteration {[round(t, 3) for t in win['issued_s']]}")
    summary = None
    if trace:
        fn, steps, units = drv.traced(cell.traffic["trace_steps"])
        summary = trace_mod.profile(fn, steps, units, lambda: drv_mod.sync(dev))
        summary.run.update(record)
        summary.run["image_iters_per_s"] = win["units"] / win["seconds"]
        summary.work = drv.work()
        log(f"[portbench] traced {steps} iterations: window {summary.window_s:.3f} s, busy "
            f"{summary.busy_s:.3f} s, {summary.device_ops} device ops, profile held "
            f"{summary.host_mb:.0f} MB of host memory, reduced in {summary.run['reduce_s']:.1f} s")
    drv.release()
    t0 = time.time()
    checks = drv.check(cell.limits)
    fails = drv.failures()
    log(f"[portbench] reference check of iterations {checks['iterations']} in "
        f"{time.time() - t0:.1f} s; readings {checks['readings']}")
    numbers = dict(checks["numbers"])
    numbers["failed"] = {"value": fails["failed"], "limit": 0}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    if trace:
        metrics = cells_mod.read_metrics(cell.per_layer, "metrics", summary, root)
    else:
        metrics = cells_mod.read_metrics(cell.end_to_end, "end_to_end", record, root)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": fails["attempted"], "failed": fails["failed"],
           "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        out["breakdown"] = summary.breakdown()
    out["checks"] = numbers
    return out


def _device_mallocs(dev) -> int:
    """The caching allocator's calls to cudaMalloc so far (0 off the card)."""
    import torch

    if dev.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(dev).get("num_device_alloc", 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import cells as cells_mod

    cell = cells_mod.load_cell(args.workload)
    if not program_in(cells_mod.ROOT):
        log(f"[portbench] the program {PROGRAM} is not in the checkout {cells_mod.ROOT}")
        return 2
    set_cache_dirs(cells_mod.ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"[portbench] {args.workload} needs {cell.chips} CUDA card(s); "
            f"cuda available: {torch.cuda.is_available()}")
        return 2
    log(f"[portbench] card: {card_line()}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"[portbench] forbidden modules loaded: {found}")
        return 3
    for name, v in out["checks"].items():
        log(f"[check] {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
