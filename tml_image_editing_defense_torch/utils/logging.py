"""Metrics logging (port of ``utils/logging.py``).

The reference hard-wires Weights & Biases (``main.py:54-59, 105-135``).
Here the logger is a small multiplexer: console and ``metrics.jsonl`` sinks
always work; a wandb sink attaches only if wandb is importable, and the loop
hands it scalars at visualization intervals only.
"""

from __future__ import annotations

import json
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np


def _init_wandb(wandb, **kwargs) -> Optional[str]:
    """``wandb.init(**kwargs)`` on a thread of its own; the repr of what it
    raised, or None.  wandb keeps the exception of a failed init, and the
    exception's frames reach, through their callers, every caller's locals:
    called on this thread, a failed init kept ``immunize``'s model alive
    after the call (4.3 GB on the card at SD-1.5).  A thread's stack ends
    at the thread, and the exception never reaches this one."""
    outcome = {}

    def run():
        try:
            wandb.init(**kwargs)
        except Exception as e:
            outcome["error"] = repr(e)

    thread = threading.Thread(target=run, name="wandb-init")
    thread.start()
    thread.join()
    return outcome.get("error")


class MetricsLogger:
    def __init__(
        self,
        project: str = "tml-image-editing-defense-torch",
        name: Optional[str] = None,
        config: Optional[dict] = None,
        output_dir: Optional[Path] = None,
        use_wandb: bool = True,
        verbose: bool = True,
    ):
        self.name = name
        self.verbose = verbose
        self._step = 0
        self._jsonl = None
        self._t0 = time.time()
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(output_dir / "metrics.jsonl", "a")
            # run-context archival (the reference's wandb.save(__file__)
            # self-archival, main.py:59, minus the network): config + code rev
            try:
                rev = subprocess.run(
                    ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                    cwd=Path(__file__).resolve().parents[2],
                ).stdout.strip()
            except OSError:           # no git on this machine
                rev = "unknown"
            (output_dir / "run_context.json").write_text(
                json.dumps({"config": config or {}, "git_rev": rev,
                            "name": name, "t0": time.time()}, default=str, indent=1)
            )
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # optional dependency
            except ImportError:
                wandb = None
            if wandb is not None:
                error = _init_wandb(wandb, project=project, config=config or {}, name=name)
                if error is None:
                    self._wandb = wandb
                else:                     # offline or misconfigured: keep the local sinks
                    print(f"wandb sink disabled: {error}", flush=True)

    def log(self, metrics: dict, step: Optional[int] = None, images: Optional[dict] = None):
        step = self._step if step is None else step
        self._step = step + 1
        scalars = {
            k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float, np.floating, np.integer)) or getattr(v, "ndim", None) == 0
        }
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, "t": time.time() - self._t0, **scalars}) + "\n")
            self._jsonl.flush()
        if self.verbose and scalars:
            parts = " ".join(f"{k}={v:.4f}" for k, v in scalars.items())
            print(f"[{self.name or 'run'} step {step}] {parts}", flush=True)
        if self._wandb is not None:
            payload = dict(scalars)
            if images:
                payload.update({k: self._wandb.Image(v) for k, v in images.items()})
            self._wandb.log(payload, step=step)

    def log_history(self, history, start_step: int = 0, skip=()):
        """Backfill one scalar record per iteration from a PGD loss history
        whose first entry is iteration ``start_step`` (a resumed run's).

        The reference logs avg/rec/pert every iteration (``main.py:105-107``);
        the loop only syncs scalars to the host at visualization intervals,
        so the full per-iteration history (fetched once after the loop) is
        flushed here.  Steps in ``skip`` were already written live by the vis
        callback, and the preemption marker that closes a stopped run's
        history is no iteration; rows carry explicit step numbers, so order
        in the file is not significant.  Backfilled rows carry ``backfilled:
        true`` and NO ``t`` field: their per-iteration wall-clock was never
        observed on the host, and a shared flush-time stamp would corrupt
        t-delta throughput analysis.  For the wandb sink, backfilled rows are
        logged without the monotonic ``step=`` kwarg (wandb drops
        out-of-order steps); the explicit ``step`` field in the payload
        carries the iteration.
        """
        skip = set(skip)
        for i, entry in enumerate(history):
            step = start_step + i
            if step in skip or "avg_loss" not in entry:
                continue
            scalars = {k: float(v) for k, v in entry.items()}
            if self._jsonl is not None:
                self._jsonl.write(
                    json.dumps({"step": step, "backfilled": True, **scalars})
                    + "\n"
                )
            if self._wandb is not None:
                self._wandb.log({"step": step, **scalars})
        if self._jsonl is not None:
            self._jsonl.flush()

    def log_image(self, tag: str, image, caption: str = "", step: Optional[int] = None):
        if self._wandb is not None:
            self._wandb.log({tag: self._wandb.Image(image, caption=caption)},
                            step=self._step if step is None else step)

    def finish(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
