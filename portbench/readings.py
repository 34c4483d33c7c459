"""The readings that the limits of the correctness check are set from.

    python3 -m portbench.readings --workload <name> --seeds 1 2 3 ... \
        [--control fp8] [--witness float32] [--report out.json]

For each seed, in one process: the cell's set-up, a window of ``--steps``
whole iterations, and the check the benchmark's runs make, at iteration 0
and at the window's last iteration, every image: the program's numbers,
the lower readings.  With ``--control``, the reference at the lower
precision in the program's place at the same iterations, from the same
iterates, against the reference: the upper readings.  With ``--witness``,
a second witness: the reference with its networks in that dtype, against
which the program and the reference are each measured, image by image.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench.run import log, set_cache_dirs


def control_numbers(drv, models, quant: str, iterations) -> dict:
    """The control's loss and update gaps at ``iterations``, each from the
    program's iterate before it, against the reference from the same
    iterate (the check's own answers)."""
    from portbench.drivers.pgd import loss_gaps, update_gaps

    out = {"loss_gap": 0.0, "update_gap": 0.0}
    for it in iterations:
        x_in = drv.src if it == 0 else drv.iterates[it - 1]
        x_c, l_c = drv.reference_iteration(models, it, x_in, quant=quant)
        x_r, l_r = drv.reference_out[it]
        out["loss_gap"] = max(out["loss_gap"], loss_gaps(l_c, l_r))
        out["update_gap"] = max(out["update_gap"],
                                update_gaps(x_in, x_c, x_r, drv.nominal_step()))
    return out


def per_image(drv, x_a, x_b) -> list:
    """||a's update - b's update|| of each image (the same iterate before
    both) over one unprojected step."""
    import torch

    d = (x_a.float() - x_b.float()).flatten(1)
    return (torch.linalg.vector_norm(d, dim=1) / drv.nominal_step()).tolist()


def witness_numbers(drv, models, dtype: str, iterations) -> dict:
    """By iteration: the gaps of the program and of the reference to the
    reference with its networks in ``dtype``, image by image."""
    import torch

    for net in models[:2]:
        net.to(getattr(torch, dtype))
    out = {}
    for it in iterations:
        x_in = drv.src if it == 0 else drv.iterates[it - 1]
        x_w, _ = drv.reference_iteration(models, it, x_in)
        out[it] = {"program": per_image(drv, drv.iterates[it], x_w),
                   "reference": per_image(drv, drv.reference_out[it][0], x_w)}
    return out


def read_seed(cell, seed: int, device, control=None, steps: int = 1, witness=None) -> dict:
    """A window of ``steps`` iterations; the check at iteration 0 and the
    window's last (the furthest into the eps-ball's projection)."""
    from portbench import cells

    drv = cells.driver(cell).Driver(cell, seed, device)
    drv.window(3600.0, max_steps=steps)
    drv.release()
    models = drv.reference()
    its = [0, drv.window_iterations]
    t0 = time.time()
    checks = drv.check(cell.limits, models=models, iterations=its)
    row = {"seed": seed, "iterations": its, **checks["readings"], **drv.failures(),
           "reference_s": time.time() - t0,
           "per_image": {it: per_image(drv, drv.iterates[it], drv.reference_out[it][0])
                         for it in its}}
    if control:
        row["control"] = control_numbers(drv, models, control, its)
    if witness:
        row["witness"] = witness_numbers(drv, models, witness, its)
    del models, drv
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default=None, help="e.g. fp8")
    ap.add_argument("--steps", type=int, default=1, help="iterations in the window")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first N seeds only")
    ap.add_argument("--witness", default=None, help="e.g. float32")
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)

    from portbench import cells

    cell = cells.load_cell(args.workload)
    set_cache_dirs(cells.ROOT)
    import torch

    if not torch.cuda.is_available():
        log("[readings] needs a CUDA card")
        return 2
    rows = []
    for k, seed in enumerate(args.seeds):
        ctl = args.control if args.control_seeds is None or k < args.control_seeds else None
        rows.append(read_seed(cell, seed, "cuda", ctl, steps=args.steps, witness=args.witness))
        log(f"[readings] {json.dumps(rows[-1])}")
        torch.cuda.empty_cache()
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0), "rows": rows}
    if args.report:
        with open(args.report, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
