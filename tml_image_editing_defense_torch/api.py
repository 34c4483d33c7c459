"""Top-level API of the port: :func:`immunize` (port of ``api.immunize``,
reference ``Trainer.run``, main.py:47-142).

It covers ``attack_mode="diffusion"`` (the reference's live path) and
``attack_mode="inpaint"`` (PhotoGuard's attack on the 9-channel inpaint
UNet, attack/inpaint.py) on one device.  Both write the reference's
artifacts: ``adversarial_image.png`` (the uint8 round-trip is
part of the measured defense, main.py:618-621), ``noise.npz`` (in the JAX
package's layout, so its ``evaluate`` can read it) and ``metrics.jsonl``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import torch
from PIL import Image

from tml_image_editing_defense_torch.attack.inpaint import (
    make_inpaint_pgd_step,
    sample_inpaint_draws,
)
from tml_image_editing_defense_torch.attack.pgd import make_attack_data, run_pgd
from tml_image_editing_defense_torch.configs import TrainConfig, format_prompt
from tml_image_editing_defense_torch.core import image_ops
from tml_image_editing_defense_torch.core.rng import make_noise_pool, save_noise_pool
from tml_image_editing_defense_torch.core.samplers import make_sampler
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel, build_model
from tml_image_editing_defense_torch.utils.device import resolve_device, set_numerics
from tml_image_editing_defense_torch.utils.logging import MetricsLogger
from tml_image_editing_defense_torch.utils.vis import create_table_plot


@dataclass
class ImmunizeResult:
    adversarial_image: Image.Image
    x_adv: torch.Tensor                # NCHW in [-1, 1], before quantization
    noise_pool: Optional[torch.Tensor]
    history: list
    model: DiffusionModel


def _default_family(cfg: TrainConfig) -> str:
    if cfg.model_family:
        return cfg.model_family
    if cfg.attack_mode == "inpaint":
        # PhotoGuard's attack targets the 9-channel SD-1.5 inpaint UNet
        # (old/yuval_playground.py:331-340); there is no SDXL inpaint family
        if cfg.use_sdxl:
            raise ValueError("attack_mode='inpaint' has no SDXL variant (the reference's "
                             "inpaint attack is SD-1.5 only); unset use_sdxl or pick "
                             "model_family explicitly")
        return "sd15-inpaint"
    if cfg.use_sdxl:
        raise NotImplementedError("SDXL comes with the SDXL slice of the port")
    return "sd15"


def _train_attn_chunk(image_size: int) -> Optional[int]:
    """Training builds route long self-attention to the flash kernels from
    512x512 up (api.py:94-99 of the JAX package)."""
    return 512 if image_size >= 512 else None


_LATER = {
    "checkpoint_interval": "checkpoint/resume slice",
    "use_segmentation_mask": "aux-models slice (ISNet salient mask)",
    "add_image_caption_to_prompts": "aux-models slice (BLIP-2 caption)",
    "params_path": "real-weight slice",
    "tokenizer_paths": "real-weight slice",
}


def _check_supported(cfg: TrainConfig, resume_from) -> None:
    if cfg.attack_mode not in ("diffusion", "inpaint"):
        raise ValueError(f"unknown attack_mode {cfg.attack_mode!r}")
    if resume_from is not None:
        raise NotImplementedError("resume_from comes with the checkpoint/resume slice of the port")
    for name, later in _LATER.items():
        if getattr(cfg, name):
            raise NotImplementedError(f"{name} comes with the {later} of the port")
    if not cfg.use_lcm:
        raise NotImplementedError("the PLMS training sampler comes with the evaluation slice")


def immunize(
    cfg: TrainConfig,
    device: Union[str, torch.device, None] = "cuda",
    model: Optional[DiffusionModel] = None,
    logger: Optional[MetricsLogger] = None,
    resume_from: Optional[Path] = None,
) -> ImmunizeResult:
    """PGD immunization of one image (reference Trainer.run, main.py:47-142).

    Runs on the card unless ``device="cpu"``; raises when CUDA is absent and
    the CPU was not asked for.  ``model`` defaults to ``cfg``'s family with
    random weights made on the device from ``cfg.seed``."""
    _check_supported(cfg, resume_from)
    device = resolve_device(device)
    dtype = set_numerics(cfg.dtype)
    setup = torch.Generator(device=device).manual_seed(cfg.seed)
    if model is None:
        model = build_model(_default_family(cfg), image_size=cfg.image_size, device=device,
                            dtype=dtype, generator=setup,
                            attn_kv_chunk=_train_attn_chunk(cfg.image_size))
    is_inpaint = cfg.attack_mode == "inpaint"
    in_ch = model.unet.config.in_channels
    if is_inpaint and in_ch != 9:
        raise ValueError(f"attack_mode='inpaint' needs a 9-channel inpaint UNet family "
                         f"(sd15-inpaint / tiny-inpaint); model_family={model.family!r} has "
                         f"in_channels={in_ch}")
    if not is_inpaint and in_ch == 9:
        raise ValueError(f"model_family={model.family!r} is an inpaint UNet; set "
                         "attack_mode='inpaint' to drive it")

    def load(path):
        arr = image_ops.load_image(path, cfg.image_size)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    source, target = load(cfg.source_image_path), load(cfg.target_image_path)
    caption = cfg.default_source_image_caption
    if caption:
        print(f"Running with prefix: {caption}")
    bank = model.embed_prompt_bank([format_prompt(p, caption) for p in cfg.prompts],
                                   cfg.negative_prompt)
    lat_shape = model.latent_shape
    noise_pool = make_noise_pool(setup, max(cfg.n_noise, 1), lat_shape, dtype, device)
    target_eps = torch.randn(lat_shape, generator=setup, device=device, dtype=dtype)

    sampler = make_sampler("lcm", model.schedule)
    if is_inpaint:
        # the legacy window 100 < t < 800 (old/yuval_playground.py:106)
        plan = sampler.plan(cfg.n_denoising_steps_per_iteration, limit_t=800, min_t=101)
    else:
        plan = sampler.plan(cfg.n_denoising_steps_per_iteration,
                            limit_t=700 if cfg.limit_timesteps else None)
    if plan.num_steps == 0:
        raise ValueError("empty denoising plan: limit_timesteps filtered out every step "
                         f"(K={cfg.n_denoising_steps_per_iteration})")
    data = make_attack_data(model, cfg, source, target, bank, noise_pool,
                            target_latent_eps=target_eps)

    step_fn = draw_sampler = None
    if is_inpaint:
        step_fn = make_inpaint_pgd_step(model, sampler, plan, cfg)

        def draw_sampler(gen):
            return sample_inpaint_draws(gen, cfg, len(cfg.prompts), lat_shape, plan.num_steps,
                                        dtype)

    logged_steps = set()

    def vis_callback(it, x_adv, aux):
        logged_steps.add(it)
        images = None
        if cfg.enable_visualization:
            grid = create_table_plot(
                images=[image_ops.to_pil(x_adv), image_ops.to_pil(source - x_adv),
                        image_ops.to_pil(aux["output_image"])],
                captions=["Current Adversarial Image", "Difference Image", "Edited Image"],
            )
            images = {"train_images": grid}
        logger.log({k: aux[k].item() for k in ("avg_loss", "rec_loss", "pert_loss")},
                   step=it, images=images)

    own_logger = logger is None
    if own_logger:
        logger = MetricsLogger(name=cfg.experiment_name, config=cfg.asdict(),
                               output_dir=cfg.output_path)
    try:
        x_adv, history = run_pgd(model, sampler, plan, cfg, data, cfg.seed,
                                 vis_callback=vis_callback,
                                 vis_needs_image=cfg.enable_visualization,
                                 step_fn=step_fn, draw_sampler=draw_sampler)
        # one scalar row per iteration (main.py:105-107); vis rows were written live
        logger.log_history(history, skip=logged_steps)

        adv_pil = image_ops.to_pil(x_adv)
        out_dir = Path(cfg.output_path)
        out_dir.mkdir(parents=True, exist_ok=True)
        adv_pil.save(out_dir / "adversarial_image.png")
        pool_to_save = noise_pool if cfg.use_fixed_noise else None
        if pool_to_save is not None:
            save_noise_pool(out_dir / "noise.npz", pool_to_save)
        logger.log_image("final_adversarial_image", adv_pil)
    finally:
        if own_logger:
            logger.finish()
    return ImmunizeResult(adv_pil, x_adv, pool_to_save, history, model)
