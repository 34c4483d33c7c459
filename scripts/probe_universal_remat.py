#!/usr/bin/env python3
"""Peak device memory of one universal-attack step on SDXL at its native
1024x1024 without rematerialisation (``--remat-policy none``), on one
card: does the reference's universal configuration fit on an 80 GB H100
without the checkpointing that ``chip_smoke.py`` runs it with?

    python3 scripts/probe_universal_remat.py [--policy none] [--report PATH]

Runs ``universal_attack.main`` (SDXL, TAESD preview, 4 reps) for one step
on one synthetic 1024x1024 image and prints the peak allocated above the
start, the step's seconds and the card's name and power limit; an
out-of-memory error is reported as such, with what was allocated.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", default="none", choices=["none", "full", "dots", "conv_dots"])
    ap.add_argument("--report", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from tml_image_editing_defense_torch import universal_attack
    from tml_image_editing_defense_torch.ops import _lib

    if not torch.cuda.is_available():
        print("probe_universal_remat: CUDA is not available", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    _lib.library()
    out = {"card": card, "policy": args.policy, "family": "sdxl", "image_size": 1024}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "ds").mkdir()
        chip_smoke.synthetic_image(tmp / "ds" / "u0.png", 200, (1024, 1024))
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            run = universal_attack.main(["--dataset-dir", str(tmp / "ds"), "--output",
                                         str(tmp / "out"), "--family", "sdxl", "--steps", "1",
                                         "--remat-policy", args.policy])
            torch.cuda.synchronize()
            out.update(fits=True, loss=run.losses[0])
            del run
        except torch.cuda.OutOfMemoryError as err:
            out.update(fits=False, error=str(err).splitlines()[0],
                       allocated_at_failure_gb=torch.cuda.memory_allocated() / 1e9)
        out["seconds_with_build"] = time.perf_counter() - t0
        out["peak_gb_above_start"] = (torch.cuda.max_memory_allocated() - before) / 1e9
    print(f"[probe] universal sdxl 1024x1024 f32, remat {args.policy}, one step of 4 reps: "
          + json.dumps(out), flush=True)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(out, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
