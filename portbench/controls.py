"""Whole runs of a cell with the timed step broken underneath, or with the
fp8 control in the program's place: each has to come out not ``correct``.

    python3 -m portbench.controls --workload <name> --seeds 1 2 3 \
        [--kinds fp8 unchanged half_batch altered] [--seconds 1] [--report out.json]

Each run is :func:`portbench.run.run_cell` at the cell's own size, the look
for a card aside, with ``step_factory`` set to one of :data:`KINDS`:

- ``unchanged``: the program's step runs and its state is handed back as it
  came in;
- ``half_batch``: the step runs on the first half of the batch, the rest
  is left where it was and given the mean loss of the half that ran;
- ``altered``: one image's update comes out doubled;
- ``fp8``: the reference, every product's operands and incoming gradients
  rounded to fp8 e4m3 (``reference/models.py``), takes the program's place.

It exits with 0 only where every run reads ``correct`` false.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench.run import log, run_cell, set_cache_dirs

LOSS_KEYS = ("avg_loss", "rec_loss", "pert_loss")


def _program(drv):
    from portbench.drivers.pgd import program_step

    return program_step(drv)


def unchanged(drv):
    step = _program(drv)

    def broken(x, batched, draws):
        _, aux = step(x, batched, draws)
        return x.detach().clone(), aux
    return broken


def half_batch(drv):
    import torch

    step = _program(drv)
    cut = ("source", "target", "target_latent", "noise_pool", "mask")

    def broken(x, batched, draws):
        h = x.shape[0] // 2
        part = type(batched)(**{k: (v[:h] if k in cut and v is not None else v)
                                for k, v in vars(batched).items()})
        x_h, aux = step(x[:h], part, draws[:h])
        rest = aux["avg_loss"].mean().expand(x.shape[0] - h)
        aux = dict(aux, **{k: torch.cat([aux[k], rest]) for k in LOSS_KEYS})
        return torch.cat([x_h, x[h:]]), aux
    return broken


def altered(drv):
    step = _program(drv)

    def broken(x, batched, draws):
        x_new, aux = step(x, batched, draws)
        x_new = x_new.clone()
        x_new[-1] = x[-1] + 2 * (x_new[-1] - x[-1])
        return x_new, aux
    return broken


def fp8(drv):
    """The reference at fp8 as the step: iteration ``it`` of every image
    from the iterate handed in, with the benchmark's draws of ``it``."""
    import torch

    models = drv.reference()
    calls = [0]

    def control(x, batched, draws):
        it = calls[0]
        calls[0] += 1
        x_new, losses = drv.reference_iteration(models, it, x, quant="fp8")
        loss = torch.tensor(losses, device=x.device)
        return x_new, {k: loss for k in LOSS_KEYS}
    return control


KINDS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered, "fp8": fp8}


def run_kind(cell, kind: str, seed: int, seconds: float, device="cuda", root=None) -> dict:
    """One run of ``cell`` with ``kind`` in the step's place: its
    ``correct`` and the numbers compared."""
    out = run_cell(cell, seed, seconds, False, device=device, root=root,
                   step_factory=KINDS[kind], start=time.time())
    return {"kind": kind, "seed": seed, "correct": out["correct"], "failed": out["failed"],
            "checks": out["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=["fp8", "unchanged"], choices=sorted(KINDS))
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)

    from portbench import cells

    cell = cells.load_cell(args.workload)
    set_cache_dirs(cells.ROOT)
    import torch

    if not torch.cuda.is_available():
        log("[controls] needs a CUDA card")
        return 2
    rows = []
    for kind in args.kinds:
        for seed in args.seeds:
            rows.append(run_kind(cell, kind, seed, args.seconds))
            log(f"[controls] {json.dumps(rows[-1])}")
            gc.collect()
            torch.cuda.empty_cache()
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0), "rows": rows}
    if args.report:
        with open(args.report, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0 if rows and not any(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
