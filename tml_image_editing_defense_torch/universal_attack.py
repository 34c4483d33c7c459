"""Universal-perturbation training entry point of the port (port of the JAX
package's ``examples/universal_attack.py``; reference C16,
``old/train_noise.py``, a pyrallis CLI there).

Trains one perturbation over a folder of images so that any covered image,
once perturbed, resists 1-step LCM editing; the loss-side decode runs
through the TAESD preview decoder (old/train_noise.py:82, 151) unless
``--no-preview`` is given.  Random weights from ``--seed``, or the params
bundle ``--params`` (``prepare_real_weights``) and the TAESD directory
``--preview-params``.

    python -m tml_image_editing_defense_torch.universal_attack --family sd15 \\
        --dataset-dir images/ --steps 100
    python -m tml_image_editing_defense_torch.universal_attack --device cpu \\
        --family tiny --image-size 32 --dataset-dir images/ --steps 2

Writes ``perturbation.npy`` (NHWC float32 [1, H, W, 3], the JAX package's
layout), ``perturbed_example.png`` and, with ``--vis-every k``,
``validation_<step>.png`` every k steps.

``--eot-shards N`` spreads each step's EOT reps over N ranks
(``parallel/eot.py::make_sharded_universal_step``); launch N ranks, e.g.
``torchrun --nproc-per-node N -m tml_image_editing_defense_torch.universal_attack
--eot-shards N ...``: the process group starts from torchrun's environment,
every rank trains the same perturbation and the first writes the files.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

@dataclass
class UniversalRun:
    """What :func:`main` trained, on what: the perturbation [1, 3, H, W],
    the loss of every step, and the models (for callers that go on)."""

    pert: torch.Tensor
    losses: List[float]
    model: object
    preview: Optional[torch.nn.Module]
    cfg: object
    images: List[torch.Tensor]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset-dir", type=Path, required=True,
                    help="folder of images (old/train_noise.py:22)")
    ap.add_argument("--output", type=Path, default=Path("./output/universal"))
    ap.add_argument("--family", type=str, default="sd15", help="sd15|sdxl|tiny|tiny-sdxl")
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100, dest="max_steps")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--grad-reps", type=int, default=4)
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--step-size", type=float, default=0.006)
    ap.add_argument("--optimizer", type=str, default=None, choices=["adam"],
                    help="step the Adam the reference configured but never stepped "
                         "(old/train_noise.py:96); default: the normalized-gradient rule")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--eot-shards", type=int, default=1,
                    help="spread each step's EOT reps over this many ranks (must divide "
                         "--grad-reps and the ranks launched)")
    ap.add_argument("--remat-policy", type=str, default="none",
                    choices=["none", "full", "dots", "conv_dots"],
                    help="checkpoint each rep's stages; 'full' for SDXL at 1024²")
    ap.add_argument("--default-prompt", type=str, default="")
    ap.add_argument("--edit-prompts", type=str, nargs="*", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vis-every", type=int, default=None,
                    help="save a [perturbed|source|validation] collage every k steps "
                         "(old/train_noise.py:196-214)")
    ap.add_argument("--params", type=Path, default=None,
                    help="a params bundle from prepare_real_weights (either package's)")
    ap.add_argument("--no-preview", action="store_true",
                    help="decode the loss through the full VAE, not the TAESD preview")
    ap.add_argument("--preview-params", type=Path, default=None,
                    help="a madebyollin/taesd[xl] directory")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    return ap


def main(argv=None) -> UniversalRun:
    args = _parser().parse_args(argv)

    from tml_image_editing_defense_torch.api import _train_attn_chunk
    from tml_image_editing_defense_torch.attack.universal import (
        UniversalConfig,
        train_universal_perturbation,
    )
    from tml_image_editing_defense_torch.core.image_ops import to_pil
    from tml_image_editing_defense_torch.data import ImagePromptDataset
    from tml_image_editing_defense_torch.models.model_zoo import _FAMILIES, build_model
    from tml_image_editing_defense_torch.models.tiny_vae import (
        build_tiny_autoencoder,
        load_taesd_checkpoint,
    )
    from tml_image_editing_defense_torch.parallel.mesh import (
        REPS_AXIS,
        init_if_launched,
        is_writer,
        make_mesh,
    )
    from tml_image_editing_defense_torch.utils.device import resolve_device

    init_if_launched(args.device)
    mesh = make_mesh({REPS_AXIS: args.eot_shards}) if args.eot_shards > 1 else None
    writer = is_writer()
    device = resolve_device(args.device)
    if args.family not in _FAMILIES:
        raise ValueError(f"unknown family {args.family!r}; have {sorted(_FAMILIES)}")
    size = args.image_size or _FAMILIES[args.family][3]
    # long self-attention goes to the flash kernels, as in immunize's builds
    model = build_model(args.family, image_size=size, device=device, dtype=args.dtype,
                        generator=torch.Generator(device=device).manual_seed(args.seed),
                        attn_kv_chunk=_train_attn_chunk(size))
    if args.params is not None:
        # no dtype cast, as examples/universal_attack.py:89-93 loads it
        from tml_image_editing_defense_torch.models.checkpoint_io import load_params

        load_params(args.params, model)

    cfg_kw = dict(eps=args.eps, step_size=args.step_size, grad_reps=args.grad_reps,
                  epochs=args.epochs, max_steps=args.max_steps, image_size=size,
                  default_prompt=args.default_prompt, optimizer=args.optimizer, lr=args.lr,
                  remat_policy=args.remat_policy)
    if args.edit_prompts:
        cfg_kw["edit_prompts"] = tuple(args.edit_prompts)
    cfg = UniversalConfig(**cfg_kw)

    preview = None
    if not args.no_preview and args.preview_params is not None:
        preview = load_taesd_checkpoint(args.preview_params, dtype=args.dtype, device=device)
    elif not args.no_preview:
        # the preset by the main VAE's downsampling factor: "taesd" is 8x
        # (sd15, sdxl), "tiny" 2x (the test families); any other geometry
        # decodes through the full VAE
        factor = 2 ** (len(model.vae.config.block_out_channels) - 1)
        preset = {8: "taesd", 2: "tiny"}.get(factor)
        if preset is not None:
            preview = build_tiny_autoencoder(
                preset, device=device, dtype=args.dtype,
                generator=torch.Generator(device=device).manual_seed(args.seed + 1))
        else:
            print(f"no preview preset for a {factor}x VAE; using the full VAE decode",
                  flush=True)

    ds = ImagePromptDataset(str(args.dataset_dir), args.default_prompt, size=size)
    if len(ds) == 0:
        raise SystemExit(f"no images under {args.dataset_dir}")
    images = [torch.from_numpy(ds[i][0][None]).to(device, model.dtype) for i in range(len(ds))]

    def log_fn(step, loss):
        if writer:
            print(f"step {step}: loss {loss:.4f}", flush=True)

    if writer:
        args.output.mkdir(parents=True, exist_ok=True)

    def vis_fn(step, collage):
        # every rank validates (the draws stay in step); the first saves
        if writer:
            from PIL import Image

            Image.fromarray(collage).save(args.output / f"validation_{step:05d}.png")

    pert, losses = train_universal_perturbation(
        model, images, cfg, generator=torch.Generator(device=device).manual_seed(args.seed + 2),
        log_fn=log_fn, preview=preview, vis_every=args.vis_every,
        vis_fn=vis_fn if args.vis_every else None, mesh=mesh)

    if writer:
        host = pert.detach().to("cpu", torch.float32)
        np.save(args.output / "perturbation.npy", host.permute(0, 2, 3, 1).contiguous().numpy())
        to_pil((images[0].to("cpu", torch.float32) + host).clamp(-1.0, 1.0)).save(
            args.output / "perturbed_example.png")
        print(f"final loss {losses[-1]:.4f}; artifacts in {args.output}", flush=True)
    return UniversalRun(pert, losses, model, preview, cfg, images)


if __name__ == "__main__":
    main()
