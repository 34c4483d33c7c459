"""Universal-perturbation trainer (port of ``attack/universal.py``; reference
C16, ``old/train_noise.py``).

One perturbation trained over a dataset so that any covered image, once
perturbed, resists 1-step LCM editing: in each EOT rep the perturbed image is
VAE-encoded, noised to a random timestep t in [300, 800), denoised in one
LCM step under a random edit prompt, decoded (through the TAESD preview when
one is given) and held close to the clean image (L2 + L-inf image losses,
old/train_noise.py:141-158); the normalized mean gradient updates the
perturbation, then the eps-box clip and the re-anchor into [-1, 1]
(:166-185).

Deviations from the reference, as in the JAX package: the decoded preview
does not overwrite the source (reference :151), and
``UniversalConfig(optimizer="adam")`` steps the Adam the reference built but
never stepped (:96), followed by the same projections.

Randomness is explicit.  A step takes a :class:`UniversalDraws`;
:class:`UniversalDrawSampler` makes the epoch orders and the draws from a
``torch.Generator``.  JAX's threefry streams cannot be reproduced in torch;
the tests hand in a sampler that replays the JAX key tree.  Perturbations
are NCHW here; the entry point writes ``perturbation.npy`` in the JAX
package's NHWC layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tml_image_editing_defense_torch.attack.forward import (
    CondInputs,
    apply_remat,
    make_time_ids,
    select_cond,
)
from tml_image_editing_defense_torch.attack.losses import lp_distance
from tml_image_editing_defense_torch.attack.pgd import rep_grad_mean
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel, PromptBank
from tml_image_editing_defense_torch.models.tiny_vae import AutoencoderTiny
from tml_image_editing_defense_torch.parallel.mesh import REPS_AXIS


@dataclass
class UniversalConfig:
    """Mirrors ``old/train_noise.py:20-48``."""

    eps: float = 0.1
    step_size: float = 0.006
    grad_reps: int = 4
    epochs: int = 1
    max_steps: int = 100
    timestep_range: Tuple[int, int] = (300, 800)
    guidance_scale: float = 1.0            # LCM editing runs guidance-free
    edit_prompts: Tuple[str, ...] = ("a photo", "an oil painting", "a sketch")
    default_prompt: str = ""
    l2_image_coeff: float = 1.0
    l_inf_image_coeff: float = 0.0
    apply_image_perturbation: bool = True  # re-anchor so source+pert stays in [-1,1]
    image_size: int = 512
    #: None: the reference's update rule (normalized-gradient step,
    #: old/train_noise.py:173-177); "adam": the Adam the reference built with
    #: ``lr`` but never stepped (:96, :39), then the same projections
    optimizer: Optional[str] = None
    lr: float = 1e-2
    #: activation checkpointing of each rep's encode, denoise and decode
    #: (attack/forward.py ``apply_remat``): "none" fits SD-1.5 at 512²; the
    #: reference's SDXL at 1024² (old/train_noise.py:94) uses "full"
    remat_policy: str = "none"


def lcm_denoise_single_step(
    model: DiffusionModel,
    noisy_latents: torch.Tensor,          # [B, C, h, w]
    t,                                    # int or 0-d integer tensor
    cond: CondInputs,
    guidance_scale: float,
    timestep_scaling: float = 10.0,
    sigma_data: float = 0.5,
) -> torch.Tensor:
    """One LCM consistency step at timestep ``t`` (the
    ``num_inference_steps=1, timesteps=[t]`` call of
    old/train_noise.py:143-149): the CFG batch of two copies, the guided
    epsilon, x0, and ``c_skip`` / ``c_out`` at ``s = 10 t`` in f32."""
    b = noisy_latents.shape[0]
    t = torch.as_tensor(t, device=noisy_latents.device)
    eps = model.apply_unet(torch.cat([noisy_latents, noisy_latents], dim=0), t, cond.ctx,
                           cond.text_embeds, cond.time_ids)
    eps_u, eps_c = eps[:b], eps[b:]
    guided = eps_u + guidance_scale * (eps_c - eps_u)
    abar = torch.take(model.schedule.alphas_cumprod_on(t.device), t).to(noisy_latents.dtype)
    x0 = (noisy_latents - torch.sqrt(1.0 - abar) * guided) / torch.sqrt(abar)
    s = t.to(torch.float32) * timestep_scaling
    sd2 = sigma_data ** 2
    c_skip = (sd2 / (s ** 2 + sd2)).to(noisy_latents.dtype)
    c_out = (s / torch.sqrt(s ** 2 + sd2)).to(noisy_latents.dtype)
    return c_out * x0 + c_skip * noisy_latents     # one step: the denoised output


@dataclass
class UniversalDraws:
    """Every random number of one universal step, one row per rep."""

    vae_eps: torch.Tensor       # [R, C, h, w] posterior noise of the encode
    noise: torch.Tensor         # [R, C, h, w] the noise added at t
    t: torch.Tensor             # [R] timesteps in cfg.timestep_range
    prompt_idx: torch.Tensor    # [R] rows of the edit-prompt bank


def sample_universal_draws(generator: torch.Generator, reps: int, n_prompts: int,
                           latent_shape: Sequence[int], timestep_range=(300, 800),
                           dtype=torch.float32) -> UniversalDraws:
    """One step's draws on the generator's device, in the order of the JAX
    rep key's split (universal.py:130-139 there): posterior noise, noise,
    timestep, prompt."""
    dev = generator.device
    shape = (reps, *latent_shape)
    vae_eps = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
    noise = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
    t = torch.randint(timestep_range[0], timestep_range[1], (reps,), generator=generator,
                      device=dev)
    prompt_idx = torch.randint(0, n_prompts, (reps,), generator=generator, device=dev)
    return UniversalDraws(vae_eps, noise, t, prompt_idx)


class UniversalDrawSampler:
    """The randomness of :func:`train_universal_perturbation`, from one
    generator, in the loop's order: each epoch's image order
    (``permutation``), each step's draws (``step``, ``cfg.grad_reps``
    rows) and each validation's (``validation``, one row).  A replacement
    (the tests' replay of the JAX key tree) has these three methods."""

    def __init__(self, generator: torch.Generator, cfg: UniversalConfig, n_prompts: int,
                 latent_shape: Sequence[int], dtype=torch.float32):
        self.generator, self.cfg = generator, cfg
        self.n_prompts, self.latent_shape, self.dtype = n_prompts, tuple(latent_shape), dtype

    def permutation(self, n: int) -> List[int]:
        gen = self.generator
        return torch.randperm(n, generator=gen, device=gen.device).tolist()

    def _draws(self, reps: int) -> UniversalDraws:
        return sample_universal_draws(self.generator, reps, self.n_prompts, self.latent_shape,
                                      self.cfg.timestep_range, self.dtype)

    def step(self) -> UniversalDraws:
        return self._draws(self.cfg.grad_reps)

    def validation(self) -> UniversalDraws:
        return self._draws(1)


def _edit_latents(model: DiffusionModel, cfg: UniversalConfig, bank: PromptBank,
                  time_ids, wrap: Callable, image: torch.Tensor, draws: UniversalDraws,
                  r: int) -> torch.Tensor:
    """Rep ``r``'s edit of ``image`` up to the decode: the encode with its
    posterior draw, the noise-add at its t, its prompt row and one LCM
    step, with the encode and the denoise each wrapped by ``wrap``."""
    t = draws.t[r]
    z = wrap(lambda img: model.encode_image(img, draws.vae_eps[r][None]))(image)
    noisy = model.schedule.add_noise(z, draws.noise[r][None], t)
    cond = select_cond(bank.embeds, bank.uncond, draws.prompt_idx[r], bank.pooled,
                       bank.uncond_pooled, time_ids)
    return wrap(lambda nz: lcm_denoise_single_step(model, nz, t, cond, cfg.guidance_scale))(noisy)


def _bank_time_ids(model: DiffusionModel, cfg: UniversalConfig, bank: PromptBank):
    """The SDXL time ids at ``cfg.image_size`` for a pooled bank, else None."""
    if bank.pooled is None:
        return None
    return make_time_ids(cfg.image_size, model.dtype, model.device)


def _universal_rep_loss(model: DiffusionModel, cfg: UniversalConfig, bank: PromptBank,
                        preview: Optional[AutoencoderTiny] = None) -> Callable:
    """Per-rep loss ``rep_loss(pert, source, draws, r) -> loss``.

    The encode, the denoise and the decode are checkpointed separately
    (``cfg.remat_policy``), so the backward's peak is that of the largest
    stage, not of their sum (universal.py:115-121 of the JAX package)."""
    def wrap(f):
        return apply_remat(f, cfg.remat_policy)

    time_ids = _bank_time_ids(model, cfg, bank)
    if preview is not None:
        # TAESD reads the UNet's scaled latents as they are (scaling factor
        # 1.0; the reference's division at old/train_noise.py:151 is a no-op)
        decode = preview.decode
    else:
        def decode(z):
            return model.decode_latent(z, scaled=True)

    def rep_loss(pert, source, draws: UniversalDraws, r: int):
        out_latents = _edit_latents(model, cfg, bank, time_ids, wrap, source + pert, draws, r)
        out_image = wrap(decode)(out_latents)
        loss = torch.zeros((), dtype=out_image.dtype, device=out_image.device)
        if cfg.l2_image_coeff:
            loss = loss + cfg.l2_image_coeff * lp_distance(out_image, source, 2)
        if cfg.l_inf_image_coeff:
            loss = loss + cfg.l_inf_image_coeff * lp_distance(out_image, source, float("inf"))
        return loss

    return rep_loss


@dataclass
class AdamState:
    """optax ``ScaleByAdamState``: first and second moments, step count."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: int = 0


def adam_init(pert: torch.Tensor) -> AdamState:
    return AdamState(torch.zeros_like(pert), torch.zeros_like(pert))


def adam_update(grad: torch.Tensor, state: AdamState, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8) -> Tuple[torch.Tensor, AdamState]:
    """``optax.adam(lr).update``: the moments, their bias corrections
    ``1 - b**count`` in f32, and the update ``-lr mu_hat / (sqrt(nu_hat) + eps)``."""
    count = state.count + 1
    mu = (1 - b1) * grad + b1 * state.mu
    nu = (1 - b2) * (grad * grad) + b2 * state.nu
    mu_hat = mu / float(np.float32(1) - np.float32(b1) ** count)
    nu_hat = nu / float(np.float32(1) - np.float32(b2) ** count)
    return -lr * (mu_hat / (torch.sqrt(nu_hat) + eps)), AdamState(mu, nu, count)


def make_universal_step(model: DiffusionModel, cfg: UniversalConfig, bank: PromptBank,
                        preview: Optional[AutoencoderTiny] = None,
                        mean_grad: Optional[Callable] = None) -> Callable:
    """One optimization step over one source image [1, 3, H, W]:
    ``step(pert, source, draws) -> (pert', avg_loss)``; with
    ``cfg.optimizer="adam"``, ``step(pert, opt_state, source, draws) ->
    (pert', opt_state', avg_loss)`` and ``step.init(pert)`` the first state.

    The gradient is the mean over ``cfg.grad_reps`` reps, one rep's graph at
    a time.  ``preview``: the TAESD autoencoder for the loss-side decode, as
    the reference decodes (old/train_noise.py:82, 151); without it, the full
    VAE decode.  ``mean_grad(pert, source, draws) -> (grad, avg_loss)``
    replaces that mean (JAX universal.py:185-205); the reps over ranks pass
    theirs (``parallel/eot.py::make_sharded_universal_step``)."""
    if cfg.optimizer is not None and cfg.optimizer != "adam":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; have: adam")
    if mean_grad is None:
        rep_loss = _universal_rep_loss(model, cfg, bank, preview)

        def mean_grad(pert, source, draws):
            grad, avg_loss, _ = rep_grad_mean(lambda x, r: (rep_loss(x, source, draws, r),),
                                              pert, cfg.grad_reps)
            return grad, avg_loss

    def project(pert, source):
        pert = torch.clamp(pert, -cfg.eps, cfg.eps)           # old/train_noise.py:180
        if cfg.apply_image_perturbation:
            # re-anchor so that the perturbed image is representable (:183-185)
            pert = torch.clamp(source + pert, -1.0, 1.0) - source
        return pert

    if cfg.optimizer is None:
        def step(pert, source, draws):
            grad, avg_loss = mean_grad(pert, source, draws)
            # normalized-gradient update (old/train_noise.py:173-177)
            dims = tuple(range(1, grad.dim()))
            gnorm = torch.sqrt(torch.sum(grad * grad, dim=dims, keepdim=True))
            return project(pert - grad / (gnorm + 1e-10) * cfg.step_size, source), avg_loss

        return step

    def opt_step(pert, opt_state, source, draws):
        grad, avg_loss = mean_grad(pert, source, draws)
        updates, opt_state = adam_update(grad, opt_state, cfg.lr)
        return project(pert + updates, source), opt_state, avg_loss

    opt_step.init = adam_init
    return opt_step


def make_universal_validation(model: DiffusionModel, cfg: UniversalConfig,
                              bank: PromptBank) -> Callable:
    """The validation edit of the periodic collage (old/train_noise.py:196-205):
    the training rep's encode, noise-add and LCM step on draw row 0,
    decoded through the full VAE.  ``validate(pert, source, draws) ->``
    image [1, 3, H, W] in [-1, 1]."""
    time_ids = _bank_time_ids(model, cfg, bank)

    @torch.no_grad()
    def validate(pert, source, draws: UniversalDraws):
        out = _edit_latents(model, cfg, bank, time_ids, lambda f: f, source + pert, draws, 0)
        return model.decode_latent(out, scaled=True)

    return validate


def _universal_collage(source, pert, validation, step: int) -> np.ndarray:
    """HWC uint8 [perturbed source | source | validation edit] with a caption
    strip above (the reference's wandb collage, old/train_noise.py:206-214).
    Inputs [1, 3, H, W] in [-1, 1], tensors or arrays."""
    from tml_image_editing_defense_torch.utils.vis import add_text_to_image

    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy()
        return np.asarray(x, np.float32)

    def u8(x):
        return (np.clip(x[0].transpose(1, 2, 0) / 2 + 0.5, 0, 1) * 255).astype(np.uint8)

    source, pert, validation = host(source), host(pert), host(validation)
    strip = np.hstack([u8(np.clip(source + pert, -1, 1)), u8(source), u8(validation)])
    return add_text_to_image(strip, f"universal step {step}", add_below=False)


def train_universal_perturbation(
    model: DiffusionModel,
    images: Sequence,                       # each [1, 3, H, W] in [-1, 1]
    cfg: UniversalConfig,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    pert_init: Optional[torch.Tensor] = None,
    log_fn: Optional[Callable[[int, float], None]] = None,
    preview: Optional[AutoencoderTiny] = None,
    vis_every: Optional[int] = None,
    vis_fn: Optional[Callable[[int, np.ndarray], None]] = None,
    draw_sampler=None,
    mesh=None,
) -> Tuple[torch.Tensor, List[float]]:
    """The dataset loop (old/train_noise.py:115-185): shuffled single-image
    steps until ``cfg.max_steps`` or ``cfg.epochs`` run out.

    Draws come from ``generator`` (default: one on the model's device seeded
    with ``seed``) through a :class:`UniversalDrawSampler`, or from
    ``draw_sampler``, an object with the same three methods.  ``log_fn(step,
    loss)`` after every step.  ``vis_every`` / ``vis_fn``: every k steps a
    validation edit of the step's image, handed to ``vis_fn(step, collage)``
    as an HWC uint8 [perturbed | source | validation] collage (the
    reference's ``validate_every_k_steps``, old/train_noise.py:196-214).
    ``mesh``: a mesh of ranks whose ``reps`` axis the EOT reps spread over
    (``parallel/eot.py::make_sharded_universal_step``; JAX :300-330); every
    rank runs this loop alike, with the same draws.
    Returns the perturbation [1, 3, H, W] and the loss of every step."""
    prompts = [(cfg.default_prompt + " " + e).strip() for e in cfg.edit_prompts]
    bank = model.embed_prompt_bank(prompts)
    if mesh is not None and mesh.size(REPS_AXIS) > 1:
        from tml_image_editing_defense_torch.parallel.eot import make_sharded_universal_step

        step = make_sharded_universal_step(model, cfg, bank, mesh, preview=preview)
    else:
        step = make_universal_step(model, cfg, bank, preview=preview)
    opt_init = getattr(step, "init", None)
    validate = None
    if vis_every is not None and vis_fn is not None:
        validate = make_universal_validation(model, cfg, bank)
    images = [torch.as_tensor(im).to(model.device, model.dtype) for im in images]
    if draw_sampler is None:
        if generator is None:
            generator = torch.Generator(device=model.device).manual_seed(seed)
        f = 2 ** (len(model.vae.config.block_out_channels) - 1)
        h, w = images[0].shape[-2:]
        draw_sampler = UniversalDrawSampler(
            generator, cfg, len(prompts), (model.vae.config.latent_channels, h // f, w // f),
            model.dtype)
    pert = torch.zeros_like(images[0]) if pert_init is None else pert_init
    opt_state = None if opt_init is None else opt_init(pert)
    losses: List[float] = []
    count = 0
    for _ in range(cfg.epochs):
        for idx in draw_sampler.permutation(len(images)):
            if count >= cfg.max_steps:
                return pert, losses
            img, draws = images[idx], draw_sampler.step()
            if opt_init is None:
                pert, loss = step(pert, img, draws)
            else:
                pert, opt_state, loss = step(pert, opt_state, img, draws)
            losses.append(float(loss))
            if log_fn is not None:
                log_fn(count, losses[-1])
            if validate is not None and count % vis_every == 0:
                val = validate(pert, img, draw_sampler.validation())
                vis_fn(count, _universal_collage(img, pert, val, count))
            count += 1
    return pert, losses

