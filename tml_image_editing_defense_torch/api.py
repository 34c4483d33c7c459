"""Top-level API of the port (port of ``api.py``):

- :func:`immunize` (reference ``Trainer.run``, main.py:47-142), with
  ``attack_mode="diffusion"`` (the reference's live path) and
  ``attack_mode="inpaint"`` (PhotoGuard's attack on the 9-channel inpaint
  UNet, attack/inpaint.py), checkpoint/resume and preemption;
- :func:`immunize_batch`: many images as one batch through the chain on
  one card (the JAX ``immunize_batch`` with no mesh), each image with the
  draws of its own one-image run;
- :func:`evaluate` (reference ``Inference.run_inference``,
  main.py:431-589) and :func:`transfer_perturbation` (main.py:413-429);
- :func:`sweep`, the grid of the reference's ``run_all.py``: images x
  n_prompts x n_noises, each cell immunized, then evaluated.

Both take the caption prefix (main.py:64-72, 324-332); ``immunize`` also
the salient-region mask (main.py:311-322), through ``aux_models``.

``immunize`` writes the reference's artifacts: ``adversarial_image.png``
(the uint8 round-trip is part of the measured defense, main.py:618-621),
``noise.npz`` (in the JAX package's layout, so either package's
``evaluate`` reads it), ``metrics.jsonl``, and ``attack_state.npz`` when it
checkpoints or is preempted.

Not replicated from the reference: its inference prompt loop re-appends the
caption prefix and ", detailed" once per noise index (main.py:481-482
mutate the loop variable); the prompt is formatted once, as the JAX
package does.
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from PIL import Image

from tml_image_editing_defense_torch.attack.inpaint import (
    make_inpaint_pgd_step,
    sample_inpaint_draws,
)
from tml_image_editing_defense_torch.attack.pgd import eot_chunk_size, make_attack_data, run_pgd
from tml_image_editing_defense_torch.configs import (
    INFERENCE_PROMPTS,
    PROMPTS_LIST,
    InferenceConfig,
    SweepConfig,
    TrainConfig,
    format_prompt,
)
from tml_image_editing_defense_torch.core import image_ops
from tml_image_editing_defense_torch.core.rng import (
    EVAL_STREAM,
    SETUP_STREAM,
    load_noise_pool,
    make_noise_pool,
    save_noise_pool,
    stream_generator,
)
from tml_image_editing_defense_torch.core.samplers import make_sampler
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel, build_model
from tml_image_editing_defense_torch.parallel.sweep import batch_attack_data, run_batched_pgd
from tml_image_editing_defense_torch.pipelines import Img2ImgPipeline
from tml_image_editing_defense_torch.utils.checkpoint import load_attack_state, save_attack_state
from tml_image_editing_defense_torch.utils.device import resolve_device, set_numerics
from tml_image_editing_defense_torch.utils.logging import MetricsLogger
from tml_image_editing_defense_torch.utils.preemption import preemption_guard
from tml_image_editing_defense_torch.utils.vis import create_table_plot


@dataclass
class ImmunizeResult:
    adversarial_image: Image.Image
    x_adv: torch.Tensor                # NCHW in [-1, 1], before quantization
    noise_pool: Optional[torch.Tensor]
    history: list
    model: DiffusionModel
    #: the route that gave the salient mask ("isnet", "pipeline" or
    #: "heuristic"; ``aux_models.segment.salient_mask_and_route``), None
    #: without ``use_segmentation_mask``
    mask_route: Optional[str] = None


def training_sampler_kind(family: str, use_lcm: bool) -> str:
    """The scheduler of ``Trainer.load_models`` (main.py:278-309): LCM when
    fused, else PLMS for the ``sd15`` base family and Euler for the others,
    as the JAX package picks it (api.py:56-62).  ``family`` is the base
    family (``DiffusionModel.base_family``): "sd15" for SD-1.5-inpaint too,
    "sdxl" for every SDXL family, as the JAX ``model.family`` holds it."""
    if use_lcm:
        return "lcm"
    return "plms" if family == "sd15" else "euler"


def _default_family(cfg) -> str:
    if cfg.model_family:
        return cfg.model_family
    if getattr(cfg, "attack_mode", "diffusion") == "inpaint":
        # PhotoGuard's attack targets the 9-channel SD-1.5 inpaint UNet
        # (old/yuval_playground.py:331-340); there is no SDXL inpaint family
        if cfg.use_sdxl:
            raise ValueError("attack_mode='inpaint' has no SDXL variant (the reference's "
                             "inpaint attack is SD-1.5 only); unset use_sdxl or pick "
                             "model_family explicitly")
        return "sd15-inpaint"
    return "sdxl" if cfg.use_sdxl else "sd15"


def _train_attn_chunk(image_size: int) -> Optional[int]:
    """Training builds route long self-attention to the flash kernels from
    512x512 up (api.py:94-99 of the JAX package)."""
    return 512 if image_size >= 512 else None


def _cfg_model(cfg, device, dtype, attn_kv_chunk: Optional[int]) -> DiffusionModel:
    """The model a config describes (JAX ``_cfg_model``, api.py:102-133):
    ``cfg``'s family with random weights made on ``device`` from
    ``cfg.seed``, its tokenizers from ``cfg.tokenizer_paths`` (one string is
    a list of one), and with ``cfg.params_path`` the bundle's weights loaded
    over it, cast through ``dtype`` (``models/checkpoint_io.py``; the file of
    ``prepare_real_weights`` in either package)."""
    tok_paths = cfg.tokenizer_paths
    if isinstance(tok_paths, (str, Path)):         # the CLI passes one string
        tok_paths = [tok_paths]
    model = build_model(_default_family(cfg), image_size=cfg.image_size, device=device,
                        dtype=dtype,
                        generator=torch.Generator(device=device).manual_seed(cfg.seed),
                        attn_kv_chunk=attn_kv_chunk, tokenizer_paths=tok_paths)
    if cfg.params_path is not None:
        from tml_image_editing_defense_torch.models.checkpoint_io import load_params

        load_params(cfg.params_path, model, dtype=dtype)
    return model


def _caption_prefix(cfg, image: Image.Image, device) -> str:
    """The prompts' prefix (main.py:64-72): ``default_source_image_caption``,
    else with ``add_image_caption_to_prompts`` the BLIP-2 caption of
    ``image`` from ``caption_model_path`` ("" when none loads), else ""."""
    if cfg.default_source_image_caption:
        return cfg.default_source_image_caption
    if not cfg.add_image_caption_to_prompts:
        return ""
    from tml_image_editing_defense_torch.aux_models.caption import get_image_caption

    return get_image_caption(image.convert("RGB"), model_path=cfg.caption_model_path,
                             device=device)


def _check_supported(cfg: TrainConfig) -> None:
    if cfg.attack_mode not in ("diffusion", "inpaint"):
        raise ValueError(f"unknown attack_mode {cfg.attack_mode!r}")
    if cfg.eot_shards not in (None, 1):
        raise NotImplementedError(f"eot_shards={cfg.eot_shards} comes with the multi-GPU slice "
                                  "of the port (one card: None or 1)")
    if cfg.attack_mode == "diffusion":
        # eot_mode "shard" and an eot_chunk that does not divide the reps
        # are refused before a model is built
        eot_chunk_size(cfg)


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
    random weights made on the device from ``cfg.seed``, or with the
    weights of the bundle ``cfg.params_path`` and the tokenizers of
    ``cfg.tokenizer_paths`` (:func:`_cfg_model`); a model handed in is used
    as it is.  The set-up draws
    (noise pool, target posterior noise) come from a stream of their own
    (``core.rng.stream_generator``), so they do not depend on whether the
    model was built here.

    ``resume_from``: an ``attack_state.npz`` this package wrote; when the
    file exists the run continues from its iterate, iteration, seed and
    noise pool (a missing file starts afresh, so a relaunch may always pass
    it).  With ``cfg.checkpoint_interval`` the state goes to
    ``output_path/attack_state.npz`` on that schedule; SIGTERM or SIGUSR1
    stop the loop after the running iteration and save the state there.

    ``use_segmentation_mask`` restricts the L2 step to the source's salient
    region (main.py:260-261, 311-322): ISNet from the RMBG-1.4 checkpoint
    directory ``segmentation_model_path`` on ``device``, else the JAX
    package's fallbacks (``aux_models.segment.get_salient_mask``); the
    result's ``mask_route`` names the route that gave the mask.  The
    L-inf step ignores the mask, as in the reference.  A resumed run
    computes the mask again; the state does not hold it.
    ``add_image_caption_to_prompts`` prefixes the prompts with the source's
    BLIP-2 caption (``caption_model_path``) unless
    ``default_source_image_caption`` is set.

    The attack step's knobs reach the step through ``cfg``:
    ``remat_policy`` and ``remat_vae`` (what the backward recomputes),
    ``eot_chunk`` and ``eot_mode`` (reps batched through the chain);
    ``eot_shards`` above 1 and ``eot_mode="shard"`` wait for the multi-GPU
    slice.  SDXL at its native 1024x1024 trains with
    ``TrainConfig(use_sdxl=True, image_size=1024, dtype="bfloat16",
    remat_policy="full", remat_vae=True)``, as the JAX package runs it."""
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = set_numerics(cfg.dtype)
    if model is None:
        model = _cfg_model(cfg, device, dtype, _train_attn_chunk(cfg.image_size))
    setup = stream_generator(cfg.seed, SETUP_STREAM, device)
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
    with Image.open(cfg.source_image_path) as img:
        caption = _caption_prefix(cfg, img, device)
    if caption:
        print(f"Running with prefix: {caption}")
    # the salient-region mask (main.py:311-322), before the set-up draws; the
    # ISNet it loads is dropped when salient_mask_and_route returns
    mask = mask_route = None
    if cfg.use_segmentation_mask:
        from tml_image_editing_defense_torch.aux_models.segment import salient_mask_and_route

        m, mask_route = salient_mask_and_route(cfg.source_image_path, cfg.image_size,
                                               model_path=cfg.segmentation_model_path,
                                               device=device)
        print(f"[immunize] salient mask from the {mask_route} route, foreground share "
              f"{float(m.mean()):.4f}", flush=True)
        mask = torch.from_numpy(m).to(device=device, dtype=dtype)[None, None]
    bank = model.embed_prompt_bank([format_prompt(p, caption) for p in cfg.prompts],
                                   cfg.negative_prompt)
    lat_shape = model.latent_shape
    noise_pool = make_noise_pool(setup, max(cfg.n_noise, 1), lat_shape, dtype, device)
    target_eps = torch.randn(lat_shape, generator=setup, device=device, dtype=dtype)

    sampler = make_sampler(training_sampler_kind(model.base_family, cfg.use_lcm), model.schedule)
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
                            target_latent_eps=target_eps, mask=mask)

    x_init, start_it, seed = None, 0, cfg.seed
    if resume_from is not None and Path(resume_from).exists():
        x_init, start_it, seed, pool = load_attack_state(resume_from, device)
        if pool is not None:
            noise_pool = data.noise_pool = pool.to(dtype)
    ckpt_path = Path(cfg.output_path) / "attack_state.npz"

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

    def ckpt_callback(it, x_adv):
        save_attack_state(ckpt_path, x_adv, it + 1, seed, noise_pool)

    own_logger = logger is None
    if own_logger:
        logger = MetricsLogger(name=cfg.experiment_name, config=cfg.asdict(),
                               output_dir=cfg.output_path)
    try:
        with preemption_guard() as preempted:
            x_adv, history = run_pgd(model, sampler, plan, cfg, data, seed,
                                     vis_callback=vis_callback,
                                     vis_needs_image=cfg.enable_visualization,
                                     step_fn=step_fn, draw_sampler=draw_sampler,
                                     x_init=x_init, start_iteration=start_it,
                                     stop_flag=preempted, ckpt_callback=ckpt_callback,
                                     ckpt_interval=cfg.checkpoint_interval)
        if history and "preempted_at" in history[-1]:
            # the handling the reference's SLURM --signal=USR1@120 never got
            # (tml_project.slurm:7): save, so that a relaunch resumes
            stop_it = history[-1]["preempted_at"]
            save_attack_state(ckpt_path, x_adv, stop_it, seed, noise_pool)
            print(f"[immunize] preempted at iteration {stop_it}; state -> {ckpt_path}",
                  flush=True)
        # one scalar row per iteration (main.py:105-107); vis rows were written live
        logger.log_history(history, start_step=start_it, skip=logged_steps)

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
    return ImmunizeResult(adv_pil, x_adv, pool_to_save, history, model, mask_route)


def immunize_batch(
    cfg: TrainConfig,
    image_paths: Sequence[Union[str, Path]],
    device: Union[str, torch.device, None] = "cuda",
    model: Optional[DiffusionModel] = None,
    logger: Optional[MetricsLogger] = None,
    targets: Optional[Sequence[Union[str, Path]]] = None,
    seeds: Optional[Sequence[int]] = None,
    out_dirs: Optional[Sequence[Union[str, Path]]] = None,
) -> List[ImmunizeResult]:
    """Immunize many images as one batch on one card (JAX ``immunize_batch``,
    api.py:378-562, with no mesh): ``cfg``'s attack, the images through the
    chain together (``parallel.sweep.make_batched_pgd_step``), the
    iterations in a host loop with no visualization and no host round trip.

    Runs on the card unless ``device="cpu"``; raises when CUDA is absent and
    the CPU was not asked for.  ``model`` defaults to ``cfg``'s family
    built as :func:`immunize` builds it.  ``targets`` default to the images
    themselves (run_all.py:45-46).

    ``seeds``: one per image, each replaying :func:`immunize`'s draws in its
    order: ``stream_generator(seed_i, SETUP_STREAM)`` gives the noise pool,
    then the target's posterior noise, and the loop draws iteration ``it``
    from ``iteration_generator(seed_i, it)``; so image i ends where
    ``immunize(replace(cfg, seed=seed_i))`` ends.  Without ``seeds`` one
    set-up stream of ``cfg.seed`` serves every image in image order, as the
    JAX package's single ``KeyStream`` does, and the loop seed of image i is
    the i-th of ``len(image_paths)`` integers drawn from that stream after
    every image's set-up draws: each image draws its own, so identical
    sources give different results.

    Artifacts: ``adversarial_image.png`` and ``noise.npz`` (with
    ``use_fixed_noise``) in ``out_dirs[i]``, by default
    ``cfg.output_path/<stem>``; one ``MetricsLogger`` named
    ``<experiment_name>_batch`` in ``cfg.output_path`` logs each image's
    ``final_avg_loss``.  Each result's ``history`` is ``[{"avg_loss": ...}]``
    per iteration.

    As in the JAX function, neither the salient mask nor the caption prefix
    applies: the prompts are formatted without a caption and no mask is
    made.  ``attack_mode="inpaint"`` (no batched inpaint step) and
    ``eot_shards`` above 1 (the multi-GPU slice) are refused."""
    if cfg.attack_mode != "diffusion":
        raise ValueError(f"attack_mode={cfg.attack_mode!r}: immunize_batch runs the diffusion "
                         "attack only (there is no batched inpaint step)")
    if cfg.eot_shards not in (None, 1):
        raise ValueError(f"eot_shards={cfg.eot_shards}: immunize_batch runs on one card "
                         "(None or 1); reps over cards come with the multi-GPU slice")
    eot_chunk_size(cfg)
    image_paths = [Path(p) for p in image_paths]
    targets = image_paths if targets is None else [Path(t) for t in targets]
    if seeds is not None and len(seeds) != len(image_paths):
        raise ValueError(f"{len(seeds)} seeds for {len(image_paths)} images")
    device = resolve_device(device)
    dtype = set_numerics(cfg.dtype)
    if model is None:
        model = _cfg_model(cfg, device, dtype, _train_attn_chunk(cfg.image_size))
    device = model.device
    if model.unet.config.in_channels == 9:
        raise ValueError(f"model_family={model.family!r} is an inpaint UNet; immunize_batch "
                         "runs the diffusion attack only")
    sampler = make_sampler(training_sampler_kind(model.base_family, cfg.use_lcm), model.schedule)
    plan = sampler.plan(cfg.n_denoising_steps_per_iteration,
                        limit_t=700 if cfg.limit_timesteps else None)
    if plan.num_steps == 0:
        raise ValueError("empty denoising plan: limit_timesteps filtered out every step "
                         f"(K={cfg.n_denoising_steps_per_iteration})")
    bank = model.embed_prompt_bank([format_prompt(p) for p in cfg.prompts], cfg.negative_prompt)

    def load(path):
        arr = image_ops.load_image(path, cfg.image_size)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    shared = stream_generator(cfg.seed, SETUP_STREAM, device)
    lat_shape = model.latent_shape
    datas, pools = [], []
    for i, (path, target_path) in enumerate(zip(image_paths, targets)):
        setup = shared if seeds is None else stream_generator(seeds[i], SETUP_STREAM, device)
        pool = make_noise_pool(setup, max(cfg.n_noise, 1), lat_shape, dtype, device)
        target_eps = torch.randn(lat_shape, generator=setup, device=device, dtype=dtype)
        datas.append(make_attack_data(model, cfg, load(path), load(target_path), bank, pool,
                                      target_latent_eps=target_eps))
        pools.append(pool)
    if seeds is None:
        seeds = torch.randint(0, 2**62, (len(image_paths),), generator=shared,
                              device=device).tolist()
    batched = batch_attack_data(datas)
    del datas

    own_logger = logger is None
    if own_logger:
        logger = MetricsLogger(name=f"{cfg.experiment_name}_batch", config=cfg.asdict(),
                               output_dir=cfg.output_path)
    results = []
    try:
        x_advs, histories = run_batched_pgd(model, sampler, plan, cfg, batched, seeds)
        for i, path in enumerate(image_paths):
            out_dir = Path(out_dirs[i]) if out_dirs is not None else Path(cfg.output_path) / path.stem
            out_dir.mkdir(parents=True, exist_ok=True)
            x_adv = x_advs[i:i + 1]
            adv_pil = image_ops.to_pil(x_adv)
            adv_pil.save(out_dir / "adversarial_image.png")
            pool = pools[i] if cfg.use_fixed_noise else None
            if pool is not None:
                save_noise_pool(out_dir / "noise.npz", pool)
            history = [{"avg_loss": h["avg_loss"]} for h in histories[i]]
            if history:
                logger.log({"final_avg_loss": history[-1]["avg_loss"]}, step=i)
            results.append(ImmunizeResult(adv_pil, x_adv, pool, history, model))
    finally:
        if own_logger:
            logger.finish()
    return results


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

#: Evaluation builds route the long self-attentions to K1, as training
#: builds do; see :func:`evaluate`.
EVAL_ATTN_CHUNK = 512


def transfer_perturbation(
    original_perturbation: np.ndarray,
    original_image: np.ndarray,
    new_image: np.ndarray,
    max_perturbation_value: float = 20.0,
) -> np.ndarray:
    """sigma-ratio-scaled transfer of a perturbation to an unseen image
    (main.py:413-429).  The reference *subtracts* the scaled perturbation
    (main.py:426) and clips it to +-20 uint8 levels."""
    std_ratio = float(np.std(new_image)) / float(np.std(original_image))
    scale = min(1.0, std_ratio)
    scaled = np.clip(original_perturbation * scale, -max_perturbation_value, max_perturbation_value)
    out = np.clip(new_image - scaled, 0, 255)
    return out.astype(np.uint8)


def _check_eval_supported(cfg: InferenceConfig) -> None:
    if cfg.eval_shards not in (None, 1):
        raise NotImplementedError(f"eval_shards={cfg.eval_shards} comes with the multi-GPU "
                                  "slice of the port (one card: None or 1)")


def evaluate(
    cfg: InferenceConfig,
    adversarial_image: Image.Image,
    inference_prompts: Optional[Sequence[str]] = None,
    device: Union[str, torch.device, None] = "cuda",
    model: Optional[DiffusionModel] = None,
    noises: Optional[torch.Tensor] = None,
    training_prompts: Optional[Sequence[str]] = None,
    logger: Optional[MetricsLogger] = None,
    batch_edits: Optional[bool] = None,
    eval_batch_size: int = 2,
) -> List[Image.Image]:
    """Clean-against-adversarial edit comparison (Inference.run_inference,
    main.py:431-589): for each (prompt x noise) cell a 5-image grid on the
    source image, then the perturbation transferred to each validation
    image with a 4-image grid each.  Returns the source image's grids.

    Runs on the card unless ``device="cpu"`` (or ``model`` lies elsewhere);
    ``model`` defaults to ``cfg``'s family with random weights made from
    ``cfg.seed`` (or ``cfg.params_path``'s and ``cfg.tokenizer_paths``',
    :func:`_cfg_model`), built with ``attn_kv_chunk=512``, so that the long
    self-attentions run in K1.  The JAX package keeps XLA's fused attention
    for evaluation below 1024x1024 (its api.py:94-99, :604), which computes
    the same function; on the card that slot is K1's, and plain attention
    at ``eval_batch_size=2`` would build an [8 x 8, 4096, 4096] f32 score
    tensor, 4.3 GB, in every 64x64 self-attention layer.

    ``noises`` ([N, 1, C, h, w], e.g. ``core.rng.load_noise_pool`` of either
    package's ``noise.npz``) pins the adversarial edit's noise, the clean
    edit takes a fresh draw; without it each prompt draws ``cfg.n_noise``
    noises.  Draws come from ``cfg.seed``'s evaluation stream
    (``core.rng.stream_generator``) in the JAX package's order: each
    prompt's noises, then per cell the fresh noise and the pipeline's draws
    (posterior noise, step noise), so that batched and sequential edits
    give the same images.
    ``batch_edits`` (default: below 1024x1024) runs the cells in batches of
    ``eval_batch_size`` (each 2 images x CFG through the UNet), the last
    batch padded with copies of its last cell so every batch has one shape;
    each batch's seconds (each cell's, when they run one at a time) go to
    ``metrics.jsonl`` as ``edit_dispatch_s``."""
    del training_prompts  # accepted for signature parity; unused (main.py:469)
    _check_eval_supported(cfg)
    if batch_edits is None:
        batch_edits = cfg.image_size < 1024
    dtype = set_numerics(cfg.dtype)
    if model is None:
        model = _cfg_model(cfg, resolve_device(device), dtype, EVAL_ATTN_CHUNK)
    device = model.device
    inference_prompts = list(inference_prompts or INFERENCE_PROMPTS)
    pipeline = Img2ImgPipeline(model,
                               sampler=training_sampler_kind(model.base_family, cfg.use_lcm))
    plan = pipeline.plan(cfg.n_steps, cfg.strength, None, cfg.denoising_end)
    gen = stream_generator(cfg.seed, EVAL_STREAM, device)
    size = cfg.image_size
    lat = model.latent_shape
    if noises is not None:
        noises = noises.to(device=device, dtype=model.dtype)

    source_pil = image_ops.resize_crop_pil(Image.open(cfg.source_image_path).convert("RGB"), size)
    target_pil = image_ops.resize_crop_pil(Image.open(cfg.target_image_path).convert("RGB"), size)
    perturbation = np.asarray(adversarial_image, np.float32) - np.asarray(source_pil, np.float32)
    caption = _caption_prefix(cfg, source_pil, device)
    out_dir = Path(cfg.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=model.dtype)

    def collect_cells():
        """(prompt, noise index, pair noise [2, C, h, w], posterior noise
        [2, C, h, w], step noise [K, 2, C, h, w] or None) per cell."""
        cells = []
        for raw_prompt in inference_prompts:
            prompt = format_prompt(raw_prompt, caption)
            pinned = (list(noises) if noises is not None
                      else [randn(*lat) for _ in range(cfg.n_noise)])
            for noise_idx, noise in enumerate(pinned):
                fresh = randn(*lat)
                vae_eps = randn(2, *lat[1:])
                step_noise = (randn(plan.num_steps, 2, *lat[1:])
                              if pipeline.sampler.uses_step_noise else None)
                cells.append((prompt, noise_idx, torch.cat([fresh, noise]), vae_eps, step_noise))
        return cells

    def run_cells(cells, clean_img, adv_img):
        """The (clean, adv) edits of every cell, in cell order, as PIL pairs."""
        pair = pipeline.prepare_image([clean_img, adv_img])
        kw = dict(num_inference_steps=cfg.n_steps, guidance_scale=cfg.guidance_scale,
                  strength=cfg.strength, negative_prompt=cfg.negative_prompt,
                  denoising_end=cfg.denoising_end, aesthetic_score=cfg.aesthetic_score,
                  negative_aesthetic_score=cfg.negative_aesthetic_score)
        if not batch_edits:
            outs = []
            for prompt, _, pair_noise, vae_eps, step_noise in cells:
                t0 = time.perf_counter()
                outs.append(tuple(pipeline(prompt, [clean_img, adv_img], noise=pair_noise,
                                           vae_eps=vae_eps, step_noise=step_noise, **kw)))
                logger.log({"edit_dispatch_s": time.perf_counter() - t0, "edit_pairs": 1})
            return outs
        b = max(1, min(eval_batch_size, len(cells)))
        outs = []
        for i in range(0, len(cells), b):
            part = cells[i:i + b]
            padded = part + [part[-1]] * (b - len(part))
            stack = lambda j: (None if padded[0][j] is None                  # noqa: E731
                               else torch.stack([c[j] for c in padded]))
            t0 = time.perf_counter()
            o = pipeline.edit_pairs([c[0] for c in padded], pair.expand(b, *pair.shape),
                                    stack(2), stack(3), stack(4), **kw)
            o = o[:len(part)].cpu()
            logger.log({"edit_dispatch_s": time.perf_counter() - t0, "edit_pairs": len(part)})
            outs.extend(o)
        return [(image_ops.to_pil(o[0], denormalize=False),
                 image_ops.to_pil(o[1], denormalize=False)) for o in outs]

    own_logger = logger is None
    if own_logger:
        logger = MetricsLogger(name=cfg.experiment_name, config=cfg.asdict(),
                               output_dir=cfg.output_path)
    output_images: List[Image.Image] = []
    try:
        cells = collect_cells()
        for (prompt, noise_idx, *_), (out_clean, out_adv) in zip(
                cells, run_cells(cells, source_pil, adversarial_image)):
            grid = create_table_plot(
                images=[source_pil.resize((size, size)), target_pil.resize((size, size)),
                        adversarial_image.resize((size, size)),
                        out_clean.resize((size, size)), out_adv.resize((size, size))],
                captions=["Source Image", "Target Image", "Adversarial Image",
                          f"Edit on Original ({prompt})", f"Edit on Adversarial ({prompt})"],
            )
            save_name = "-".join(prompt[:30].split()) if prompt else "empty_prompt"
            if cfg.save_images:
                grid.save(out_dir / f"{save_name}_noise_{noise_idx}.png")
            logger.log_image("Train Images - Validation Prompts", grid, caption=prompt)
            output_images.append(grid)

        val_list = cfg.validation_images_path
        val_paths = []
        if val_list is not None and Path(val_list).exists():
            val_paths = [Path(line.strip()) for line in Path(val_list).read_text().splitlines()
                         if line.strip()]
        for val_path in val_paths:
            val_pil = image_ops.resize_crop_pil(Image.open(val_path).convert("RGB"), size)
            val_adv = Image.fromarray(transfer_perturbation(
                perturbation, np.asarray(source_pil, np.float32), np.asarray(val_pil, np.float32)))
            val_cells = collect_cells()
            for (prompt, noise_idx, *_), (out_clean, out_adv) in zip(
                    val_cells, run_cells(val_cells, val_pil, val_adv)):
                grid = create_table_plot(
                    images=[val_pil.resize((size, size)), val_adv.resize((size, size)),
                            out_clean.resize((size, size)), out_adv.resize((size, size))],
                    captions=["Val Original Image", "Val Adversarial Image",
                              f"Edit on Original ({prompt})", f"Edit on Adversarial ({prompt})"],
                )
                save_name = "-".join(prompt[:30].split()) if prompt else "empty_prompt"
                if cfg.save_images:
                    grid.save(out_dir / f"val_{val_path.stem}_{save_name}_noise_{noise_idx}.png")
                logger.log_image("Val Images - Validation Prompt", grid, caption=prompt)
    finally:
        if own_logger:
            logger.finish()
    return output_images


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------


def _sweep_cells(cfg: SweepConfig, image_paths: Sequence[Path],
                 train_overrides: Optional[dict] = None) -> List[dict]:
    """The sweep grid (run_all.py:23-55) as cell descriptors, in image-major
    order.  Each (image, n_prompts) pair draws its prompts from one unseeded
    ``random.Random()`` (run_all.py:28-33): ``[""]`` for 1 prompt, ``""``
    and ``n - 1`` sampled prompts for n, every prompt for None.  A cell's
    seed is ``cfg.seed``, or a draw of that generator when it is None; a
    cell with n_noises None trains on fresh noise.  ``train_overrides``
    replace ``TrainConfig`` fields last."""
    rng = _pyrandom.Random()
    cells = []
    for image_path in image_paths:
        image_path = Path(image_path)
        image_out = Path(cfg.output_root) / image_path.stem
        for n_prompts in cfg.n_prompts_grid:
            if n_prompts is None:
                prompts = list(PROMPTS_LIST)
            elif n_prompts == 1:
                prompts = [""]
            else:
                prompts = [""] + rng.sample(PROMPTS_LIST, n_prompts - 1)
            for n_noises in cfg.n_noises_grid:
                cell_dir = image_out / f"n_noises_{n_noises}" / f"n_prompts_{n_prompts}"
                seed = cfg.seed if cfg.seed is not None else rng.randint(0, 2**32 - 1)
                train_cfg = TrainConfig(
                    experiment_name=f"{image_path.stem}_n_noises_{n_noises}_n_prompts_{n_prompts}",
                    source_image_path=image_path,
                    target_image_path=image_path,
                    output_path=cell_dir,
                    n_optimization_steps=cfg.n_optimization_steps,
                    n_noise=n_noises if n_noises is not None else 1,
                    use_fixed_noise=n_noises is not None,
                    prompts=prompts,
                    seed=seed,
                    guidance_scale=3.0,
                    use_sdxl=cfg.use_sdxl,
                    use_lcm=cfg.use_lcm,
                )
                if train_overrides:
                    train_cfg = dataclasses.replace(train_cfg, **train_overrides)
                cells.append({
                    "image": image_path, "n_prompts": n_prompts, "prompts": prompts,
                    "n_noises": n_noises, "seed": seed, "dir": cell_dir,
                    "train_cfg": train_cfg,
                })
    return cells


def sweep(
    cfg: SweepConfig,
    device: Union[str, torch.device, None] = "cuda",
    model: Optional[DiffusionModel] = None,
    image_paths: Optional[Sequence[Path]] = None,
    data_parallel: Optional[bool] = None,
    train_overrides: Optional[dict] = None,
) -> List[dict]:
    """Grid sweep {images} x {n_prompts} x {n_noises} (run_all.py:23-93):
    every cell of :func:`_sweep_cells` immunized into its directory
    ``<output_root>/<stem>/n_noises_<n>/n_prompts_<p>``, then, with
    ``cfg.run_inference``, evaluated there (LCM with ``inference_n_steps``
    at ``inference_strength`` over ``INFERENCE_PROMPTS``, at the geometry
    and family the cell trained at).  One model, built once, serves every
    cell.  ``image_paths`` default to ``list_sweep_images(cfg.images_dir)``.

    Runs on the card unless ``device="cpu"``.  ``data_parallel`` None means
    False: the port uses one card and runs the cells one after another.
    True groups the cells that share a prompt bank and a pool size (the same
    grid point on different images) and runs each group of two or more as
    one batch through :func:`immunize_batch` on the card, with each cell's
    seed, so the artifacts are the serial ones; a group of one runs through
    :func:`immunize`.  Data parallelism over several cards comes with the
    multi-GPU slice.  A cell runs with ``eot_shards=1`` unless
    ``train_overrides`` name it.  Returns one entry per cell (image,
    n_prompts, n_noises, seed, output directory), evaluated or not."""
    if image_paths is None:
        from tml_image_editing_defense_torch.parallel.hosts import list_sweep_images

        image_paths = list_sweep_images(cfg.images_dir)
    cells = _sweep_cells(cfg, image_paths, train_overrides)
    for cell in cells:
        cell["dir"].mkdir(parents=True, exist_ok=True)
    forced_eot = ({} if (train_overrides and "eot_shards" in train_overrides)
                  else {"eot_shards": 1})

    if data_parallel:
        groups: dict = {}
        for cell in cells:
            groups.setdefault((tuple(cell["prompts"]), cell["n_noises"]), []).append(cell)
        for group in groups.values():
            if len(group) == 1:
                res = immunize(dataclasses.replace(group[0]["train_cfg"], **forced_eot),
                               device=device, model=model)
                model = res.model
                continue
            batch_cfg = dataclasses.replace(group[0]["train_cfg"], **forced_eot)
            if model is None:
                model = _cfg_model(batch_cfg, resolve_device(device), set_numerics(batch_cfg.dtype),
                                   _train_attn_chunk(batch_cfg.image_size))
            immunize_batch(batch_cfg, [c["image"] for c in group], device=device, model=model,
                           seeds=[c["seed"] for c in group], out_dirs=[c["dir"] for c in group])
    else:
        for cell in cells:
            res = immunize(dataclasses.replace(cell["train_cfg"], **forced_eot), device=device,
                           model=model)
            model = res.model

    results = []
    for cell in cells:
        cell_dir, image_path, n_noises = cell["dir"], cell["image"], cell["n_noises"]
        entry = {"image": str(image_path), "n_prompts": cell["n_prompts"],
                 "n_noises": n_noises, "seed": cell["seed"], "output": str(cell_dir)}
        if cfg.run_inference:
            adv = Image.open(cell_dir / "adversarial_image.png").convert("RGB")
            noise_file = cell_dir / "noise.npz"
            pool = load_noise_pool(noise_file) if noise_file.exists() else None
            train_cfg = cell["train_cfg"]
            inf_cfg = InferenceConfig(
                experiment_name=train_cfg.experiment_name,
                source_image_path=image_path,
                target_image_path=image_path,
                output_path=cell_dir,
                image_size=train_cfg.image_size,
                model_family=train_cfg.model_family,
                n_steps=cfg.inference_n_steps,
                guidance_scale=cfg.inference_guidance_scale,
                strength=cfg.inference_strength,
                use_fixed_noise=n_noises is not None,
                n_noise=n_noises if n_noises is not None else 1,
                validation_images_path=None,
                use_sdxl=cfg.use_sdxl,
                use_lcm=cfg.use_lcm,
                seed=cell["seed"],
            )
            evaluate(inf_cfg, adv, INFERENCE_PROMPTS, device=device, model=model, noises=pool,
                     training_prompts=cell["prompts"])
        results.append(entry)
    return results
