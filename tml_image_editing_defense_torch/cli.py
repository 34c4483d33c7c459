"""Command-line interface of the port (port of ``cli.py``).

Flags are made from the ``TrainConfig`` and ``InferenceConfig`` fields, one
``--field-name`` each; ``--device`` (default ``cuda``) picks the device.

    python -m tml_image_editing_defense_torch.cli immunize --source-image-path img.jpg ...
    python -m tml_image_editing_defense_torch.cli evaluate \\
        --adversarial-image out/adversarial_image.png --noise-pool out/noise.npz ...

SDXL: ``--use-sdxl true`` (immunize at the default 512x512; evaluate at its
native ``--image-size 1024``); on the CPU the tiny test family,
``--device cpu --model-family tiny-sdxl``.  SDXL immunize at 1024x1024:
``--use-sdxl true --image-size 1024 --dtype bfloat16 --remat-policy full
--remat-vae true`` (``--eot-chunk N`` batches N reps through the chain).

The JAX package's ``immunize-batch`` and ``sweep`` come with the multi-GPU
slice of the port.
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
    TrainConfig,
)

_SKIP_FIELDS = {"prompts"}


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tml-immunize-torch",
        description="PhotoGuard-style image immunization on one NVIDIA GPU (PyTorch/CUDA)",
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

    for p in (p_imm, p_eval):
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    args = parser.parse_args(argv)
    from tml_image_editing_defense_torch import api

    if args.command == "immunize":
        cfg = _build_cfg(TrainConfig, args)
        if args.prompts:
            cfg.prompts = list(args.prompts)
        api.immunize(cfg, device=args.device, resume_from=args.resume_from)
        print(f"adversarial image -> {Path(cfg.output_path) / 'adversarial_image.png'}")
        return 0

    from PIL import Image

    from tml_image_editing_defense_torch.core.rng import load_noise_pool

    cfg = _build_cfg(InferenceConfig, args)
    adv = Image.open(args.adversarial_image).convert("RGB")
    noises = load_noise_pool(args.noise_pool) if args.noise_pool else None
    prompts = list(args.prompts) if args.prompts else INFERENCE_PROMPTS
    api.evaluate(cfg, adv, prompts, device=args.device, noises=noises)
    print(f"grids -> {cfg.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
