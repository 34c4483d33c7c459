"""Real-weight preparation: a diffusers model directory -> one params bundle
(port of the JAX package's ``scripts/prepare_real_weights.py``).

    python -m tml_image_editing_defense_torch.prepare_real_weights \\
        --model-dir ckpts/stable-diffusion-v1-5 \\
        --vae-dir   ckpts/sd-vae-ft-mse \\
        --lora      ckpts/lcm-lora-sdv1-5/pytorch_lora_weights.safetensors \\
        --out       ckpts/sd15_lcm.msgpack --smoke

then ``python -m tml_image_editing_defense_torch.cli immunize --params-path
ckpts/sd15_lcm.msgpack --tokenizer-paths ckpts/stable-diffusion-v1-5/tokenizer
...``.  Each step is the offline counterpart of ``Trainer.load_models``
(reference main.py:278-309): base checkpoint (``load_sd_checkpoint``,
strict), VAE swap (sd-vae-ft-mse / sdxl-vae-fp16-fix, main.py:290, 302),
LCM-LoRA fused into the UNet (main.py:292-295, 305-308), then
``save_params``.  The bundle is the JAX package's format, so either
package's ``params_path`` reads it.  ``--rmbg-dir`` loads and smoke-runs
RMBG-1.4 (no file is written: pass the directory as
``segmentation_model_path``).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def log(msg: str) -> None:
    print(f"[prepare] {msg}", flush=True)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", type=Path, default=None,
                    help="diffusers-layout dir: unet/ vae/ text_encoder/ [text_encoder_2/] "
                         "*.safetensors")
    ap.add_argument("--rmbg-dir", type=Path, default=None,
                    help="briaai/RMBG-1.4 checkpoint dir: loaded and smoke-run, no file "
                         "written (pass it as segmentation_model_path)")
    ap.add_argument("--family", default="sd15", choices=["sd15", "sdxl", "tiny", "tiny-sdxl"])
    ap.add_argument("--image-size", type=int, default=512,
                    help="training resolution (the reference trains SDXL at 512 too)")
    ap.add_argument("--vae-dir", type=Path, default=None,
                    help="VAE override dir (sd-vae-ft-mse / sdxl-vae-fp16-fix, main.py:290,302)")
    ap.add_argument("--lora", type=Path, default=None,
                    help="LCM-LoRA .safetensors to fuse into the UNet (main.py:292-295,305-308)")
    ap.add_argument("--lora-scale", type=float, default=1.0)
    ap.add_argument("--out", type=Path, default=None, help="output params bundle (.msgpack)")
    ap.add_argument("--smoke", action="store_true",
                    help="encode -> one UNet call -> decode on the loaded weights, all finite")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _rmbg(args, device) -> None:
    import numpy as np

    from tml_image_editing_defense_torch.models.isnet import load_rmbg_checkpoint, salient_mask

    t0 = time.time()
    log(f"loading RMBG-1.4 from {args.rmbg_dir} (strict; tests/manifests/rmbg_isnet.json)...")
    net = load_rmbg_checkpoint(args.rmbg_dir, device=device)
    img = np.zeros((256, 256, 3), np.float32)
    img[64:192, 64:192] = 0.8
    mask = salient_mask(net, img, out_size=512)
    assert mask.shape == (512, 512) and np.isfinite(mask).all()
    log(f"RMBG OK in {time.time() - t0:.1f}s; use it with TrainConfig(use_segmentation_mask="
        f"True, segmentation_model_path='{args.rmbg_dir}')")


def _smoke(model, image_size: int) -> None:
    """Encode a blank image, one UNet call at t=519, decode: all finite."""
    import torch

    from tml_image_editing_defense_torch.attack.forward import make_time_ids

    dev, dt = model.device, model.dtype
    with torch.no_grad():
        img = torch.zeros(1, 3, image_size, image_size, device=dev, dtype=model.vae_dtype)
        z = model.encode_image(img).to(dt)
        bank = model.embed_prompt_bank(["a photo"])
        kw = {}
        if model.base_family == "sdxl":
            kw = {"text_embeds": bank.pooled[:1],
                  "time_ids": make_time_ids(image_size, dt, dev)[:1]}
        eps = model.apply_unet(z, torch.tensor([519], device=dev), bank.embeds[:1], **kw)
        out = model.decode_latent(z, scaled=False)
    for name, t in (("latent", z), ("eps", eps), ("decode", out)):
        assert torch.isfinite(t).all(), f"{name} has non-finite values"
    log(f"smoke OK: latent {tuple(z.shape)}, eps {tuple(eps.shape)}, decode {tuple(out.shape)}")


def main(argv=None):
    """Returns the loaded ``DiffusionModel`` (None with ``--rmbg-dir``
    alone)."""
    ap = _parser()
    args = ap.parse_args(argv)
    from tml_image_editing_defense_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.rmbg_dir is not None:
        _rmbg(args, device)
        if args.model_dir is None:
            return None
    if args.model_dir is None or args.out is None:
        ap.error("--model-dir and --out are required (unless only --rmbg-dir)")

    from tml_image_editing_defense_torch.api import EVAL_ATTN_CHUNK
    from tml_image_editing_defense_torch.models.checkpoint_io import save_params
    from tml_image_editing_defense_torch.models.convert import (
        load_safetensors,
        load_safetensors_dir,
        load_sd_checkpoint,
        load_state,
    )
    from tml_image_editing_defense_torch.models.lora import fuse_lora
    from tml_image_editing_defense_torch.models.model_zoo import build_model

    t0 = time.time()
    log(f"building the {args.family} template on {device} (no weights yet)...")
    # every weight is loaded strictly over the template, so it is built on
    # meta and only given memory
    model = build_model(args.family, image_size=args.image_size, device="meta",
                        attn_kv_chunk=EVAL_ATTN_CHUNK)
    for net in (model.unet, model.vae, *model.text_models):
        net.to_empty(device=device)
    model.device = device

    log(f"loading {args.model_dir} ...")
    load_sd_checkpoint(args.model_dir, model, strict=True)
    if args.vae_dir is not None:
        log(f"swapping the VAE from {args.vae_dir} (main.py:290,302)...")
        load_state(model.vae, load_safetensors_dir(args.vae_dir), strict=True)
    if args.lora is not None:
        log(f"fusing LCM-LoRA {args.lora} (scale {args.lora_scale})...")
        fuse_lora(model.unet, load_safetensors(args.lora), scale=args.lora_scale)

    log(f"saving {args.out} ...")
    save_params(args.out, model)
    log(f"done in {time.time() - t0:.1f}s ({args.out.stat().st_size / 1e9:.2f} GB)")

    if args.smoke:
        log("smoke test: encode -> 1 UNet step -> decode ...")
        _smoke(model, args.image_size)

    toks = [t for t in (args.model_dir / "tokenizer", args.model_dir / "tokenizer_2")
            if t.exists()]
    log("next steps:")
    log(f"  python -m tml_image_editing_defense_torch.cli immunize --params-path {args.out} "
        f"--tokenizer-paths {toks[0] if toks else '<tokenizer dir>'} ...")
    return model


if __name__ == "__main__":
    main()
