"""Top-level API of the port (port of ``api.py``):

- :func:`immunize` (reference ``Trainer.run``, main.py:47-142), with
  ``attack_mode="diffusion"`` (the reference's live path) and
  ``attack_mode="inpaint"`` (PhotoGuard's attack on the 9-channel inpaint
  UNet, attack/inpaint.py), checkpoint/resume and preemption;
- :func:`immunize_batch`: many images as one batch through the chain,
  each image with the draws of its own one-image run, the images over the
  ranks of a ``data`` axis and each image's reps over a ``reps`` axis when
  several ranks run (the JAX ``immunize_batch`` and its meshes);
- :func:`evaluate` (reference ``Inference.run_inference``,
  main.py:431-589) and :func:`transfer_perturbation` (main.py:413-429);
- :func:`sweep`, the grid of the reference's ``run_all.py``: images x
  n_prompts x n_noises, each cell immunized, then evaluated.

Both take the caption prefix (main.py:64-72, 324-332); ``immunize`` also
the salient-region mask (main.py:311-322), through ``aux_models``.

Several ranks (``torch.distributed``, ``parallel/mesh.py``): every rank
calls the same entry point with the same arguments (SPMD).  ``immunize``
spreads the EOT reps over them (``cfg.eot_shards``), ``immunize_batch``
and ``sweep`` the images (and with ``eot_shards`` each image's reps),
``evaluate`` its cells (``cfg.eval_shards``).  The meshes span the ranks of
one machine (``mesh.local_world_size``), as the JAX package's span
``jax.local_devices()``.  The first rank of each machine writes the
artifacts, the same files as one rank writes; every rank returns what one
rank returns.

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
from tml_image_editing_defense_torch.parallel.dp_eot import gather_images, make_dp_eot_pgd_step
from tml_image_editing_defense_torch.parallel.eot import make_sharded_eot_pgd_step
from tml_image_editing_defense_torch.parallel.mesh import (
    DATA_AXIS,
    REPS_AXIS,
    AnyRankFlag,
    gather_blocks,
    is_writer,
    local_world_size,
    machine_barrier,
    make_mesh,
)
from tml_image_editing_defense_torch.parallel.sweep import batch_attack_data
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
    if cfg.attack_mode == "diffusion":
        # an unknown eot_mode and an eot_chunk that does not divide the reps
        # are refused before a model is built
        eot_chunk_size(cfg)
    elif cfg.eot_shards and cfg.eot_shards > 1:
        raise ValueError("attack_mode='inpaint' has no reps-sharded step yet; set eot_shards "
                         "to 1/None")


def _own_logger(name: str, cfg, output_dir) -> MetricsLogger:
    """The logger an entry point makes for itself: the full one on the
    writing rank, one that records nothing on the others."""
    if is_writer():
        return MetricsLogger(name=name, config=cfg.asdict(), output_dir=output_dir)
    return MetricsLogger(name=name, use_wandb=False, verbose=False)


def _check_eot_shards(cfg: TrainConfig, shards: int, local: int) -> None:
    """``ValueError``, with the JAX package's words (api.py:164-171), unless
    ``shards`` divides ``grad_reps`` and the machine's ``local`` ranks hold
    them."""
    if cfg.grad_reps % shards:
        raise ValueError(f"eot_shards={shards} must divide grad_reps={cfg.grad_reps}")
    if shards > local:
        raise ValueError(f"eot_shards={shards} exceeds local device count {local} (the ranks "
                         "of this machine)")


def _reps_sharding(cfg: TrainConfig, mesh=None):
    """The ``reps`` mesh of :func:`immunize` (JAX api.py:136-173), as
    ``(mesh, n_shards)``; ``n_shards == 1`` is the serial step.

    A mesh handed in must have a ``reps`` axis.  Otherwise
    ``cfg.eot_shards`` None takes the largest divisor of ``grad_reps`` that
    divides the machine's ranks (1 without a process group: nothing
    changes); an explicit N must divide ``grad_reps`` and not exceed the
    machine's ranks, else ``ValueError`` with the JAX package's words."""
    if mesh is not None:
        if REPS_AXIS not in mesh.shape:
            raise ValueError(f"immunize() needs a mesh with a '{REPS_AXIS}' axis (got axes "
                             f"{tuple(mesh.shape)}); data-axis meshes belong to immunize_batch()")
        return mesh, mesh.shape[REPS_AXIS]
    want, local = cfg.eot_shards, local_world_size()
    if want is None:
        want = max(d for d in range(1, min(local, cfg.grad_reps) + 1)
                   if cfg.grad_reps % d == 0 and local % d == 0)
    if want <= 1:
        return None, 1
    _check_eot_shards(cfg, want, local)
    return make_mesh({REPS_AXIS: want}), want


def immunize(
    cfg: TrainConfig,
    device: Union[str, torch.device, None] = "cuda",
    model: Optional[DiffusionModel] = None,
    logger: Optional[MetricsLogger] = None,
    resume_from: Optional[Path] = None,
    mesh=None,
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
    ``eot_chunk`` and ``eot_mode`` (reps batched through the chain; "shard"
    is "scan"), and ``eot_shards``: the EOT reps over that many ranks of
    the process group (``parallel/eot.py``; None takes what
    :func:`_reps_sharding` finds, 1 without a process group), or over the
    ``reps`` axis of ``mesh``.  Every rank of the group calls ``immunize``
    alike; the first writes the artifacts, metrics and checkpoints, and a
    stop signal on any rank stops every rank after the same iteration.
    ``attack_mode="inpaint"`` has no sharded step (``ValueError``, as in
    JAX).  SDXL at its native 1024x1024 trains with
    ``TrainConfig(use_sdxl=True, image_size=1024, dtype="bfloat16",
    remat_policy="full", remat_vae=True)``, as the JAX package runs it."""
    _check_supported(cfg)
    reps_mesh, n_shards = (None, 1) if cfg.attack_mode == "inpaint" else _reps_sharding(cfg, mesh)
    writer = is_writer()
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
    elif n_shards > 1:
        step_fn = make_sharded_eot_pgd_step(model, sampler, plan, cfg, reps_mesh,
                                            decode_vis=False)

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
        logger = _own_logger(cfg.experiment_name, cfg, cfg.output_path)
    try:
        # every rank keeps the guard: a rank without it would die on the
        # signal and leave the others waiting in a collective
        with preemption_guard() as preempted:
            stop = preempted if reps_mesh is None else AnyRankFlag(preempted, reps_mesh)
            x_adv, history = run_pgd(model, sampler, plan, cfg, data, seed,
                                     vis_callback=vis_callback if writer else None,
                                     vis_needs_image=cfg.enable_visualization,
                                     step_fn=step_fn, draw_sampler=draw_sampler,
                                     x_init=x_init, start_iteration=start_it,
                                     stop_flag=stop,
                                     ckpt_callback=ckpt_callback if writer else None,
                                     ckpt_interval=cfg.checkpoint_interval)
        if history and "preempted_at" in history[-1] and writer:
            # the handling the reference's SLURM --signal=USR1@120 never got
            # (tml_project.slurm:7): save, so that a relaunch resumes
            stop_it = history[-1]["preempted_at"]
            save_attack_state(ckpt_path, x_adv, stop_it, seed, noise_pool)
            print(f"[immunize] preempted at iteration {stop_it}; state -> {ckpt_path}",
                  flush=True)
        # one scalar row per iteration (main.py:105-107); vis rows were written live
        logger.log_history(history, start_step=start_it, skip=logged_steps)

        adv_pil = image_ops.to_pil(x_adv)
        pool_to_save = noise_pool if cfg.use_fixed_noise else None
        if writer:
            out_dir = Path(cfg.output_path)
            out_dir.mkdir(parents=True, exist_ok=True)
            adv_pil.save(out_dir / "adversarial_image.png")
            if pool_to_save is not None:
                save_noise_pool(out_dir / "noise.npz", pool_to_save)
        logger.log_image("final_adversarial_image", adv_pil)
    finally:
        if own_logger:
            logger.finish()
    return ImmunizeResult(adv_pil, x_adv, pool_to_save, history, model, mask_route)


def _batch_mesh(cfg: TrainConfig, mesh=None):
    """The mesh of :func:`immunize_batch` (JAX api.py:418-461): the one
    handed in, else over the machine's ranks when there are several, a
    ``data`` axis over all of them, or with ``eot_shards`` above 1 a
    (``data``, ``reps``) mesh of ``eot_shards`` reps ranks an image; None on
    one rank, where ``eot_shards`` above 1 raises."""
    local, shards = local_world_size(), cfg.eot_shards or 1
    if mesh is not None:
        return mesh
    if shards > 1:
        _check_eot_shards(cfg, shards, local)
        if local % shards:
            raise ValueError(f"eot_shards={shards} must divide the local device count {local} "
                             "for the 2-D batch mesh")
        return make_mesh({DATA_AXIS: local // shards, REPS_AXIS: shards})
    return make_mesh({DATA_AXIS: local}) if local > 1 else None


def immunize_batch(
    cfg: TrainConfig,
    image_paths: Sequence[Union[str, Path]],
    device: Union[str, torch.device, None] = "cuda",
    model: Optional[DiffusionModel] = None,
    logger: Optional[MetricsLogger] = None,
    targets: Optional[Sequence[Union[str, Path]]] = None,
    seeds: Optional[Sequence[int]] = None,
    out_dirs: Optional[Sequence[Union[str, Path]]] = None,
    mesh=None,
) -> List[ImmunizeResult]:
    """Immunize many images as one batch (JAX ``immunize_batch``,
    api.py:378-562): ``cfg``'s attack, the images through the chain
    together (``attack.pgd.make_batched_pgd_step``), the iterations in a
    host loop with no visualization and no host round trip.

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

    Several ranks (:func:`_batch_mesh`, or ``mesh``): the images split into
    blocks over the ``data`` axis, the list padded with copies of the last
    image to a multiple of its size (their results dropped, JAX
    :503-510), and with a ``reps`` axis each image's reps over it
    (``parallel/dp_eot.py``).  Each rank makes the set-up draws of every
    image, so that the streams are those of one rank, and the attack data
    of its own; the iterates and histories are gathered on every rank.

    Artifacts: ``adversarial_image.png`` and ``noise.npz`` (with
    ``use_fixed_noise``) in ``out_dirs[i]``, by default
    ``cfg.output_path/<stem>``; one ``MetricsLogger`` named
    ``<experiment_name>_batch`` in ``cfg.output_path`` logs each image's
    ``final_avg_loss``.  Each result's ``history`` is ``[{"avg_loss": ...}]``
    per iteration.

    As in the JAX function, neither the salient mask nor the caption prefix
    applies: the prompts are formatted without a caption and no mask is
    made.  ``attack_mode="inpaint"`` (no batched inpaint step) is refused."""
    if cfg.attack_mode != "diffusion":
        raise ValueError(f"attack_mode={cfg.attack_mode!r}: immunize_batch runs the diffusion "
                         "attack only (there is no batched inpaint step)")
    eot_chunk_size(cfg)
    mesh = _batch_mesh(cfg, mesh)
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
    pools, target_eps = [], []
    for i in range(len(image_paths)):
        setup = shared if seeds is None else stream_generator(seeds[i], SETUP_STREAM, device)
        pools.append(make_noise_pool(setup, max(cfg.n_noise, 1), lat_shape, dtype, device))
        target_eps.append(torch.randn(lat_shape, generator=setup, device=device, dtype=dtype))
    if seeds is None:
        seeds = torch.randint(0, 2**62, (len(image_paths),), generator=shared,
                              device=device).tolist()
    # the images this rank attacks: a block of the list padded to the data axis
    order = list(range(len(image_paths)))
    step_fn = None
    if mesh is not None:
        order += order[-1:] * ((-len(order)) % mesh.size(DATA_AXIS))
        order = [order[i] for i in mesh.block(DATA_AXIS, len(order))]
        if mesh.size(REPS_AXIS) > 1:
            step_fn = make_dp_eot_pgd_step(model, sampler, plan, cfg, mesh)
    batched = batch_attack_data([
        make_attack_data(model, cfg, load(image_paths[i]), load(targets[i]), bank, pools[i],
                         target_latent_eps=target_eps[i]) for i in order])

    own_logger = logger is None
    if own_logger:
        logger = _own_logger(f"{cfg.experiment_name}_batch", cfg, cfg.output_path)
    results = []
    try:
        x_advs, histories = run_pgd(model, sampler, plan, cfg, batched, [seeds[i] for i in order],
                                    step_fn=step_fn)
        del batched
        if mesh is not None:
            x_advs, histories = gather_images(mesh, x_advs, histories)
        for i, path in enumerate(image_paths):
            out_dir = Path(out_dirs[i]) if out_dirs is not None else Path(cfg.output_path) / path.stem
            x_adv = x_advs[i:i + 1]
            adv_pil = image_ops.to_pil(x_adv)
            pool = pools[i] if cfg.use_fixed_noise else None
            if is_writer():
                out_dir.mkdir(parents=True, exist_ok=True)
                adv_pil.save(out_dir / "adversarial_image.png")
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


def _eval_shards(cfg: InferenceConfig) -> int:
    """The ranks :func:`evaluate` splits its cells over (JAX api.py:655-664):
    ``cfg.eval_shards``, None for every rank of the machine (1 without a
    process group); more than the machine's ranks raise ``ValueError``."""
    local = local_world_size()
    if cfg.eval_shards is None:
        return local
    if cfg.eval_shards > local:
        raise ValueError(f"eval_shards={cfg.eval_shards} exceeds local device count {local} (the "
                         "ranks of this machine)")
    return cfg.eval_shards


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
    ``metrics.jsonl`` as ``edit_dispatch_s``.

    ``cfg.eval_shards`` (:func:`_eval_shards`) above 1 splits each batch of
    ``eval_batch_size`` cells a rank over that many ranks of a ``data``
    axis (JAX api.py:655-700): the batch is padded to ``eval_batch_size``
    times the ranks, each rank edits its block and the edits are gathered on
    every rank.  Every rank draws every cell's noises from the same stream,
    so the split changes no draw; the first rank writes the grids.  Edits one
    at a time (``batch_edits`` off) are not split, as in JAX."""
    del training_prompts  # accepted for signature parity; unused (main.py:469)
    n_shards = _eval_shards(cfg)
    if batch_edits is None:
        batch_edits = cfg.image_size < 1024
    eval_mesh = make_mesh({DATA_AXIS: n_shards}) if batch_edits and n_shards > 1 else None
    writer = is_writer()
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
    if writer:
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
        per = b * (1 if eval_mesh is None else n_shards)
        outs = []
        for i in range(0, len(cells), per):
            part = cells[i:i + per]
            padded = part + [part[-1]] * (per - len(part))
            if eval_mesh is not None:
                padded = [padded[j] for j in eval_mesh.block(DATA_AXIS, per)]
            stack = lambda j: (None if padded[0][j] is None                  # noqa: E731
                               else torch.stack([c[j] for c in padded]))
            t0 = time.perf_counter()
            o = pipeline.edit_pairs([c[0] for c in padded], pair.expand(b, *pair.shape),
                                    stack(2), stack(3), stack(4), **kw)
            if eval_mesh is not None:
                o = gather_blocks(eval_mesh, o, DATA_AXIS)
            o = o[:len(part)].cpu()
            logger.log({"edit_dispatch_s": time.perf_counter() - t0, "edit_pairs": len(part)})
            outs.extend(o)
        return [(image_ops.to_pil(o[0], denormalize=False),
                 image_ops.to_pil(o[1], denormalize=False)) for o in outs]

    own_logger = logger is None
    if own_logger:
        logger = _own_logger(cfg.experiment_name, cfg, cfg.output_path)
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
            if cfg.save_images and writer:
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
                if cfg.save_images and writer:
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
    True when the machine has several ranks (JAX: several local devices),
    else False, the cells one after another.  True groups the cells that
    share a prompt bank and a pool size (the same grid point on different
    images) and runs each group of two or more as one batch through
    :func:`immunize_batch`, with each cell's seed, so the artifacts are the
    serial ones: over the machine's ranks, the images split over them.  A
    group of one runs through :func:`immunize`.  A cell runs with
    ``eot_shards=1`` unless ``train_overrides`` name it.  The evaluations
    split their cells over the ranks (``InferenceConfig.eval_shards`` None).
    Returns one entry per cell (image, n_prompts, n_noises, seed, output
    directory), evaluated or not."""
    if image_paths is None:
        from tml_image_editing_defense_torch.parallel.hosts import list_sweep_images

        image_paths = list_sweep_images(cfg.images_dir)
    cells = _sweep_cells(cfg, image_paths, train_overrides)
    for cell in cells:
        cell["dir"].mkdir(parents=True, exist_ok=True)
    forced_eot = ({} if (train_overrides and "eot_shards" in train_overrides)
                  else {"eot_shards": 1})
    if data_parallel is None:
        data_parallel = local_world_size() > 1

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

    # the evaluations read the cells' files, which the first rank wrote
    machine_barrier()
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
