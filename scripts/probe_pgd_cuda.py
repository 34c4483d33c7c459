#!/usr/bin/env python3
"""K4's two paths, timed against each other on one NVIDIA card.

Run from the repository root on a machine with the card and nvcc:

    python3 scripts/probe_pgd_cuda.py [--report PATH]

K4, the fused L2 update in ``csrc/pgd_update.cu``, runs one cooperative
kernel where its grid fits on the card at once and two kernels elsewhere
(the chunks' partial sums, then the write, launched with programmatic
dependent launch).  This probe builds the source as it is and a variant
with the one-kernel path turned off, holds both against the plain version
(``chip_smoke.check_l2``), and times both at ``chip_smoke.py``'s timed K4
cases by device time (``chip_smoke.device_ms``: medians of the kernels'
own spans, warm and cold) in turns: as built, two kernels, two kernels,
as built.  It prints JSON lines: the card, then one line per case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the selection of the one-kernel path in launch_l2; without it K4 takes two
ONE_KERNEL = "if (vectorized && C <= kL2ResidentC) err = grid_resident<E, MASK>(grid, resident);"


def build_two_kernels(lib_mod, pk, out_dir: Path) -> dict:
    """K4's C entries (without and with a mask) built with the one-kernel
    path turned off, by the wrapper's kernel object that calls each."""
    src = (lib_mod.CSRC / "pgd_update.cu").read_text()
    if ONE_KERNEL not in src:
        raise RuntimeError("pgd_update.cu no longer selects its one-kernel path as expected")
    (out_dir / "two_kernels.cu").write_text(src.replace(ONE_KERNEL, ""))
    subprocess.run([lib_mod._nvcc(), *lib_mod.NVCC_FLAGS, "-shared",
                    str(out_dir / "two_kernels.cu"), "-o", str(out_dir / "two_kernels.so")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out_dir / "two_kernels.so"))
    fns = {}
    for kern in (pk.PGD_L2_UPDATE, pk.PGD_L2_UPDATE_MASKED):
        fn = getattr(lib, kern.symbol)
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        fns[kern] = fn
    return fns


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, help="also write the results here as JSON")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("probe_pgd_cuda: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tml_image_editing_defense_torch.ops import _lib
    from tml_image_editing_defense_torch.ops import pgd_kernels as pk

    results = {"card": cs.card_line(), "cases": []}
    print(json.dumps({"card": results["card"]}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"two_kernels": build_two_kernels(_lib, pk, Path(tmp))}
        zeros = [torch.zeros(1, 3, 8, 8, device="cuda") for _ in range(3)]
        for m in (None, torch.ones(1, 1, 8, 8, device="cuda")):
            pk.pgd_l2_update(*zeros, 1.0, 1.0, -1.0, 1.0, mask=m)
        fns["as_built"] = {kern: kern._fn for kern in fns["two_kernels"]}
        for key, shape, dtype, mask, case in cs.K4_TIMED:
            x, g, src, m = cs.l2_inputs(gen, shape, case, mask)
            x, g, src = (t.to(getattr(torch, dtype)) for t in (x, g, src))
            row = {"case": key, "shape": list(shape), "dtype": dtype, "mask": mask, "err": {},
                   "warm_ms": {}, "cold_ms": {}, "kernels": {}}
            for name in ("as_built", "two_kernels", "two_kernels", "as_built"):
                for kern, fn in fns[name].items():
                    kern._fn = fn
                if name not in row["err"]:
                    row["err"][name] = cs.check_l2(pk, gen, shape, getattr(torch, dtype), mask,
                                                   case)["err"]
                call = lambda: pk.pgd_l2_update(x, g, src, *cs.L2.values(), mask=m)  # noqa: E731
                warm, cold = (cs.device_ms(call, cs.K4_KERNELS, cold=c) for c in (False, True))
                row["warm_ms"].setdefault(name, []).append(warm["ms"])
                row["cold_ms"].setdefault(name, []).append(cold["ms"])
                row["kernels"][name] = list(warm["kernels_ms"])
            for kern, fn in fns["as_built"].items():
                kern._fn = fn
            results["cases"].append(row)
            print(json.dumps(row), flush=True)
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
