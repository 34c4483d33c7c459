#!/usr/bin/env python3
"""Peak device memory and seconds of one PGD iteration under the attack
step's memory and batching knobs, on one card.

    python3 scripts/probe_remat_cuda.py [--reps 2] [--report PATH]

1. SDXL at its native 1024x1024 in bf16 (chip_smoke.py's xl1k
   configuration, the EOT reps cut from 10 to ``--reps``, 2 by default, so
   that every row is quick): ``remat_policy`` in {none, dots, conv_dots,
   full} x ``remat_vae`` in {False, True}.  An out-of-memory error is a row
   of the table, with what was allocated when it struck.
2. xl1k itself (10 reps, remat "full" with ``remat_vae``): ``eot_chunk``
   in {1, 2, 5}.  Its iteration is bound by the host's launches (the
   device idles half of it, ``PERF.md`` §5), and a chunk of reps issues
   one chain for the chunk.
3. SD-1.5 at 512x512 in f32 (chip_smoke.py's path d, the ``TrainConfig``
   defaults, 10 reps): ``eot_chunk`` in {1, 2, 5}.

Each row runs the iteration twice on the same draws and reports the second
(the first pays cuDNN's algorithm choice for new shapes): its seconds by
CUDA events and its peak allocated above what was allocated before it
(``utils/profiling.py``), the model's weights not counted.  The card's
name and power limit come last.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(model, cfg, inputs) -> dict:
    """One row: the iteration twice, the second timed and its peak taken."""
    import torch

    from tml_image_editing_defense_torch.attack.pgd import make_pgd_step
    from tml_image_editing_defense_torch.utils.profiling import StepTimer, device_memory_stats

    sampler, plan, data, draws = inputs
    row = {"remat_policy": cfg.remat_policy, "remat_vae": cfg.remat_vae,
           "eot_chunk": cfg.eot_chunk, "grad_reps": cfg.grad_reps}
    before = device_memory_stats()["bytes_in_use"]
    timer = StepTimer("cuda")
    try:
        step = make_pgd_step(model, sampler, plan, cfg, decode_vis=False)
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            with timer:
                x, aux = step(data.source, data, draws)
        row.update(fits=True, s_per_iteration=timer.last, first_s=timer.first_time,
                   avg_loss=aux["avg_loss"].item(),
                   peak_gb=(device_memory_stats()["peak_bytes_in_use"] - before) / 1e9)
        del x, aux
    except torch.cuda.OutOfMemoryError as err:
        row.update(fits=False, error=str(err).splitlines()[0],
                   allocated_at_failure_gb=(torch.cuda.memory_allocated() - before) / 1e9)
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2, help="EOT reps of the SDXL 1024x1024 rows")
    ap.add_argument("--report", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("probe_remat_cuda: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from tml_image_editing_defense_torch.api import _train_attn_chunk
    from tml_image_editing_defense_torch.configs import TrainConfig
    from tml_image_editing_defense_torch.core.image_ops import load_image
    from tml_image_editing_defense_torch.models.model_zoo import build_model
    from tml_image_editing_defense_torch.ops import _lib

    card = chip_smoke.card_line()
    _lib.library()
    out = {"card": card, "sdxl_1024_bf16": [], "sdxl_1024_bf16_chunks": [], "sd15_512_f32": []}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, size, seed in (("xl_src", 1024, 101), ("xl_tgt", 1024, 102),
                                 ("src", 512, 1), ("tgt", 512, 2)):
            chip_smoke.synthetic_image(tmp / f"{name}.png", seed, (size, size))

        def images(src, tgt, size, dtype):
            return tuple(torch.from_numpy(load_image(tmp / f"{n}.png", size)).to("cuda", dtype)
                         for n in (src, tgt))

        # 1. SDXL 1024x1024 bf16: the remat policies
        cfg = TrainConfig(use_sdxl=True, image_size=1024, dtype="bfloat16",
                          derive_norm_hyperparams=False, eps=32.0, step_size=7.5,
                          grad_reps=args.reps)
        model = build_model("sdxl", image_size=1024, device="cuda", dtype="bfloat16",
                            generator=torch.Generator(device="cuda").manual_seed(cfg.seed),
                            attn_kv_chunk=_train_attn_chunk(1024))
        inputs = chip_smoke.one_iteration_inputs(model, cfg,
                                                 *images("xl_src", "xl_tgt", 1024, torch.bfloat16))
        for remat_vae in (True, False):
            for policy in ("full", "conv_dots", "dots", "none"):
                row = measure(model, dataclasses.replace(cfg, remat_policy=policy,
                                                         remat_vae=remat_vae), inputs)
                out["sdxl_1024_bf16"].append(row)
                print(f"[probe] sdxl 1024x1024 bf16, {args.reps} reps: {json.dumps(row)}",
                      flush=True)

        # 2. xl1k's 10 reps: the EOT chunk
        cfg = dataclasses.replace(cfg, grad_reps=10, remat_policy="full", remat_vae=True)
        inputs = chip_smoke.one_iteration_inputs(model, cfg,
                                                 *images("xl_src", "xl_tgt", 1024, torch.bfloat16))
        for chunk in (1, 2, 5):
            row = measure(model, dataclasses.replace(cfg, eot_chunk=chunk), inputs)
            out["sdxl_1024_bf16_chunks"].append(row)
            print(f"[probe] sdxl 1024x1024 bf16, 10 reps: {json.dumps(row)}", flush=True)
        del model, inputs
        gc.collect()
        torch.cuda.empty_cache()

        # 3. SD-1.5 512x512 f32 (path d): the EOT chunk
        cfg = TrainConfig()
        model = build_model("sd15", image_size=512, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(cfg.seed),
                            attn_kv_chunk=_train_attn_chunk(512))
        inputs = chip_smoke.one_iteration_inputs(model, cfg,
                                                 *images("src", "tgt", 512, torch.float32))
        for chunk in (1, 2, 5):
            row = measure(model, dataclasses.replace(cfg, eot_chunk=chunk), inputs)
            out["sd15_512_f32"].append(row)
            print(f"[probe] sd15 512x512 f32, 10 reps: {json.dumps(row)}", flush=True)
        del model, inputs
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(out, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
