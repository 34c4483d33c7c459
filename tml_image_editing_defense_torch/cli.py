"""Command-line interface of the port (port of ``cli.py``).

Flags are made from the ``TrainConfig``, ``InferenceConfig`` and
``SweepConfig`` fields, one ``--field-name`` each; ``--device`` (default
``cuda``) picks the device.

    python -m tml_image_editing_defense_torch.cli immunize --source-image-path img.jpg ...
    python -m tml_image_editing_defense_torch.cli immunize-batch --images a.jpg b.jpg ...
    python -m tml_image_editing_defense_torch.cli evaluate \\
        --adversarial-image out/adversarial_image.png --noise-pool out/noise.npz ...
    python -m tml_image_editing_defense_torch.cli sweep --images-dir ./images \\
        --n-prompts-grid 1 10 all --n-noises-grid 1 none ...

``immunize-batch`` immunizes the images as one batch (each image's
artifacts in ``--output-path``/<stem>); ``sweep`` runs the grid of the
reference's ``run_all.py`` ("all" or "none" in a grid is None: every
prompt, fresh noise); its ``--model-family`` and
``--image-size`` set the cells' model (on the CPU: ``--device cpu
--model-family tiny --image-size 32``).

SDXL: ``--use-sdxl true`` (immunize at the default 512x512; evaluate at its
native ``--image-size 1024``); on the CPU the tiny test family,
``--device cpu --model-family tiny-sdxl``.  SDXL immunize at 1024x1024:
``--use-sdxl true --image-size 1024 --dtype bfloat16 --remat-policy full
--remat-vae true`` (``--eot-chunk N`` batches N reps through the chain).

Real weights: ``--params-path W.msgpack`` (a bundle of
``prepare_real_weights``, of either package) and ``--tokenizer-paths DIR``
(one CLIP tokenizer directory; the second SDXL encoder keeps the hash
tokenizer).

Several GPUs: launch one rank per card under torchrun, e.g. ``torchrun
--nproc-per-node N -m tml_image_editing_defense_torch.cli immunize
--eot-shards N ...``; with ``WORLD_SIZE`` above 1 the process group starts
from torchrun's environment (NCCL on the cards).  ``immunize`` spreads the
EOT reps over the ranks (``--eot-shards``, by default the largest divisor
of ``--grad-reps`` that divides the ranks), ``immunize-batch`` and ``sweep``
the images (and with ``--eot-shards`` each image's reps), ``evaluate`` its
cells (``--eval-shards``, by default every rank).  The first rank writes the
files.  Several machines sweep disjoint image lists with
``tml_image_editing_defense_torch.launch_host``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import get_args, get_origin

from tml_image_editing_defense_torch.configs import (
    INFERENCE_PROMPTS,
    InferenceConfig,
    SweepConfig,
    TrainConfig,
)

_SKIP_FIELDS = {"prompts", "n_prompts_grid", "n_noises_grid"}


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        if f.name in _SKIP_FIELDS:
            continue
        name = "--" + f.name.replace("_", "-")
        default = f.default if f.default is not dataclasses.MISSING else None
        # The annotation, not the default, picks the type: an Optional[int]
        # with a None default must still parse as int.  The configs use
        # `from __future__ import annotations`, so f.type is a string.
        ann = f.type
        if isinstance(ann, str):
            ann = {"int": int, "float": float, "str": str, "bool": bool,
                   "Path": Path}.get(ann.replace("Optional[", "").rstrip("]"), str)
        elif get_origin(ann) is not None:
            args = [a for a in get_args(ann) if a is not type(None)]
            ann = args[0] if args else str
        if ann is bool:
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default, metavar="BOOL")
        elif ann in (int, float, Path):
            parser.add_argument(name, type=ann, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def _build_cfg(cls, args: argparse.Namespace):
    names = {f.name for f in dataclasses.fields(cls)} - _SKIP_FIELDS
    kwargs = {n: getattr(args, n) for n in names if getattr(args, n, None) is not None}
    return cls(**kwargs)


def _parse_grid(values):
    """A sweep grid from the command line: integers, "all" / "none" for None."""
    return tuple(None if v.lower() in ("all", "none") else int(v) for v in values)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tml-immunize-torch",
        description="PhotoGuard-style image immunization on NVIDIA GPUs (PyTorch/CUDA)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_imm = sub.add_parser("immunize", help="PGD-immunize an image (Trainer.run)")
    _add_dataclass_args(p_imm, TrainConfig)
    p_imm.add_argument("--prompts", nargs="*", default=None,
                       help="override the EOT prompt bank")
    p_imm.add_argument("--resume-from", type=Path, default=None,
                       help="attack_state.npz to continue from")

    p_eval = sub.add_parser("evaluate", help="clean-vs-adversarial comparison (Inference)")
    _add_dataclass_args(p_eval, InferenceConfig)
    p_eval.add_argument("--adversarial-image", type=Path, required=True)
    p_eval.add_argument("--noise-pool", type=Path, default=None,
                        help="noise.npz saved by immunize (of either package)")
    p_eval.add_argument("--prompts", nargs="*", default=None)

    p_batch = sub.add_parser("immunize-batch",
                             help="immunize many images as one batch")
    _add_dataclass_args(p_batch, TrainConfig)
    p_batch.add_argument("--images", nargs="+", type=Path, required=True)
    p_batch.add_argument("--prompts", nargs="*", default=None)

    p_sweep = sub.add_parser("sweep", help="grid sweep (run_all)")
    _add_dataclass_args(p_sweep, SweepConfig)
    p_sweep.add_argument("--n-prompts-grid", nargs="*", type=str, default=None,
                         help="e.g. 1 10 25 all")
    p_sweep.add_argument("--n-noises-grid", nargs="*", type=str, default=None,
                         help="e.g. 1 3 5 none")
    # the cells' TrainConfig overrides (api.sweep's train_overrides)
    p_sweep.add_argument("--model-family", default=None, help="e.g. tiny on the CPU")
    p_sweep.add_argument("--image-size", type=int, default=None)

    for p in (p_imm, p_eval, p_batch, p_sweep):
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    args = parser.parse_args(argv)
    from tml_image_editing_defense_torch import api
    from tml_image_editing_defense_torch.parallel.mesh import init_if_launched, is_writer

    init_if_launched(args.device)
    say = print if is_writer() else (lambda *a, **k: None)

    if args.command == "immunize":
        cfg = _build_cfg(TrainConfig, args)
        if args.prompts:
            cfg.prompts = list(args.prompts)
        api.immunize(cfg, device=args.device, resume_from=args.resume_from)
        say(f"adversarial image -> {Path(cfg.output_path) / 'adversarial_image.png'}")
        return 0

    if args.command == "immunize-batch":
        cfg = _build_cfg(TrainConfig, args)
        if args.prompts:
            cfg.prompts = list(args.prompts)
        results = api.immunize_batch(cfg, args.images, device=args.device)
        say(f"{len(results)} images immunized -> {cfg.output_path}")
        return 0

    if args.command == "sweep":
        cfg = _build_cfg(SweepConfig, args)
        if args.n_prompts_grid:
            cfg.n_prompts_grid = _parse_grid(args.n_prompts_grid)
        if args.n_noises_grid:
            cfg.n_noises_grid = _parse_grid(args.n_noises_grid)
        overrides = {k: getattr(args, k) for k in ("model_family", "image_size")
                     if getattr(args, k) is not None}
        results = api.sweep(cfg, device=args.device, train_overrides=overrides or None)
        say(f"{len(results)} sweep cells -> {cfg.output_root}")
        return 0

    from PIL import Image

    from tml_image_editing_defense_torch.core.rng import load_noise_pool

    cfg = _build_cfg(InferenceConfig, args)
    adv = Image.open(args.adversarial_image).convert("RGB")
    noises = load_noise_pool(args.noise_pool) if args.noise_pool else None
    prompts = list(args.prompts) if args.prompts else INFERENCE_PROMPTS
    api.evaluate(cfg, adv, prompts, device=args.device, noises=noises)
    say(f"grids -> {cfg.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
