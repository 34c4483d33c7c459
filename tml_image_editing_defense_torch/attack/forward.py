"""The differentiable editing chain (port of ``attack/forward.py``).

Noise-add, then K CFG UNet steps as a Python loop over the plan (reference
``Trainer.attack_forward``, main.py:194-245).  Every random draw -- the
pool noise and the per-step LCM noise -- is an argument.

:func:`apply_remat` wraps a stage in activation checkpointing by the JAX
package's policy names (``_REMAT_POLICIES``, forward.py:72-98 there); the
chain wraps each denoising step in it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from tml_image_editing_defense_torch.core.samplers import BaseSampler, DenoisePlan
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel


@dataclass
class CondInputs:
    """CFG-ready conditioning for one forward: stacked [uncond; cond]."""

    ctx: torch.Tensor                                 # [2, S, D]
    text_embeds: Optional[torch.Tensor] = None        # SDXL pooled, [2, P]
    time_ids: Optional[torch.Tensor] = None           # SDXL, [2, 6] or [2, 5]


def make_time_ids(image_size: int = 512, dtype=torch.float32, device=None,
                  aesthetic_score: Optional[float] = None,
                  negative_aesthetic_score: Optional[float] = None) -> torch.Tensor:
    """SDXL micro-conditioning ids, [neg; pos] for CFG (reference
    main.py:368-383): original size, crop (0, 0) and target size, the
    6-tuple.  With ``aesthetic_score``, the refiner's 5-tuple (original
    size, crop, score; the negative row takes ``negative_aesthetic_score``,
    2.5 unless given; sdxl_img2img_pipeline.py:344-378)."""
    base = [image_size, image_size, 0, 0]
    if aesthetic_score is not None:
        neg = 2.5 if negative_aesthetic_score is None else negative_aesthetic_score
        rows = [base + [neg], base + [aesthetic_score]]
    else:
        rows = [base + [image_size, image_size]] * 2
    return torch.tensor(rows, dtype=dtype, device=device)


def select_cond(bank_embeds: torch.Tensor, bank_uncond: torch.Tensor, prompt_idx,
                bank_pooled: Optional[torch.Tensor] = None,
                bank_uncond_pooled: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None) -> CondInputs:
    """Prompt row ``prompt_idx`` of the bank, stacked under the unconditional
    row; the pooled rows likewise where the bank has them.  A tensor index
    is gathered on its device (indexing with a 0-d tensor reads it on the
    host)."""
    def row(bank):
        if isinstance(prompt_idx, torch.Tensor):
            return bank.index_select(0, prompt_idx.reshape(1))[0]
        return bank[prompt_idx]

    te = None
    if bank_pooled is not None:
        te = torch.stack([bank_uncond_pooled, row(bank_pooled)])
    return CondInputs(ctx=torch.stack([bank_uncond, row(bank_embeds)]), text_embeds=te,
                      time_ids=time_ids)


def stack_cond(conds: Sequence[CondInputs]) -> CondInputs:
    """The CFG conditioning of reps run as one batch of c: the c
    unconditional rows, then the c conditional ones, as the chain splits
    the UNet's output (the batched counterpart of JAX's ``vmap`` over reps,
    attack/pgd.py:330-337 there)."""
    if len(conds) == 1:
        return conds[0]

    def cat(parts):
        if parts[0] is None:
            return None
        return torch.cat([p[:1] for p in parts] + [p[1:] for p in parts])

    return CondInputs(ctx=cat([c.ctx for c in conds]),
                      text_embeds=cat([c.text_embeds for c in conds]),
                      time_ids=cat([c.time_ids for c in conds]))


def denoise_chain(
    model: DiffusionModel,
    sampler: BaseSampler,
    plan: DenoisePlan,
    latents: torch.Tensor,             # [B, C, h, w], already noised to t0
    cond: CondInputs,
    guidance_scale: float,
    step_noise: Optional[Sequence[torch.Tensor]],   # row i: step i's draw
    extra_channels: Optional[torch.Tensor] = None,  # [2B, C', h, w], appended to the input
    remat_policy: str = "none",
) -> torch.Tensor:
    """K CFG denoising steps (reference loop main.py:229-243), the sampler's
    carry threaded through.  Row i of ``step_noise`` ([K, B, C, h, w], or
    [K, C, h, w] for one draw shared by the batch) is broadcast to the
    latent's shape; it may be None for a sampler that draws nothing.
    ``extra_channels`` are concatenated after the scaled latent on every
    step: the inpaint UNet's mask and masked-image latent.

    Each step's body (the CFG UNet call, the guidance and the sampler step)
    runs under :func:`apply_remat` by ``remat_policy``, its latent and
    carry passed as tensors (JAX forward.py:135-150).  Where no gradient is
    recorded (the evaluation pipelines) no checkpoint is paid."""
    x = latents
    b = x.shape[0]
    carry = sampler.init_carry(x.shape, x.dtype, x.device)
    policy = remat_policy if torch.is_grad_enabled() else "none"
    for i in range(plan.num_steps):
        noise = step_noise[i].expand_as(x) if sampler.uses_step_noise else None

        def body(x, *carry, i=i, noise=noise):
            latent_in = sampler.scale_model_input(plan, i, torch.cat([x, x], dim=0))
            if extra_channels is not None:
                latent_in = torch.cat([latent_in, extra_channels], dim=1)
            eps = model.apply_unet(latent_in, int(plan.t_eval[i]), cond.ctx, cond.text_embeds,
                                   cond.time_ids)
            eps_uncond, eps_text = eps[:b], eps[b:]
            guided = eps_uncond + guidance_scale * (eps_text - eps_uncond)
            x, carry = sampler.step(plan, i, carry, guided, x, noise)
            return (x, *carry)

        x, *carry = apply_remat(body, policy)(x, *carry)
    return x


def attack_forward_from_latent(
    model: DiffusionModel,
    sampler: BaseSampler,
    plan: DenoisePlan,
    z_scaled: torch.Tensor,            # [B, C, h, w], scaled VAE latent
    cond: CondInputs,
    init_noise: torch.Tensor,          # [B, C, h, w], the selected pool entries
    guidance_scale: float,
    step_noise: Optional[Sequence[torch.Tensor]],
    remat_policy: str = "none",
) -> torch.Tensor:
    """Post-encode tail of the chain: noise-add, K-step denoise (each step
    under ``remat_policy``), unscale (main.py:194-245)."""
    x = sampler.add_noise(plan, z_scaled, init_noise)
    x = denoise_chain(model, sampler, plan, x, cond, guidance_scale, step_noise,
                      remat_policy=remat_policy)
    return x / model.vae_scaling


def attack_forward(
    model: DiffusionModel,
    sampler: BaseSampler,
    plan: DenoisePlan,
    image: torch.Tensor,               # [B, 3, H, W] in [-1, 1]
    cond: CondInputs,
    init_noise: torch.Tensor,          # [B, C, h, w], the selected pool entries
    guidance_scale: float,
    vae_eps: Optional[torch.Tensor],   # [B, C, h, w], the posterior draw; None: its mean
    step_noise: Optional[Sequence[torch.Tensor]],
    remat_policy: str = "none",
) -> torch.Tensor:
    """Image to *unscaled* output latent (main.py:179-246, which returns
    ``latents / 0.18215`` at :245): the VAE encode with the caller's
    posterior draw, then :func:`attack_forward_from_latent`."""
    z = model.encode_image(image, vae_eps)
    return attack_forward_from_latent(model, sampler, plan, z, cond, init_noise, guidance_scale,
                                      step_noise, remat_policy=remat_policy)


def _checkpointed(body: Callable, saved_ops=None) -> Callable:
    """``body`` under ``torch.utils.checkpoint``: every activation is
    recomputed in the backward, except the outputs of ``saved_ops`` (aten
    overloads) where they are given (selective checkpointing)."""
    context_fn = None
    if saved_ops is not None:
        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved_ops
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        context_fn = functools.partial(create_selective_checkpoint_contexts, policy)

    def run(*args):
        if context_fn is None:
            return checkpoint(body, *args, use_reentrant=False)
        return checkpoint(body, *args, use_reentrant=False, context_fn=context_fn)

    return run


#: the unbatched matrix products: the counterpart of JAX's
#: ``checkpoint_dots_with_no_batch_dims`` (linear layers; not the batched
#: attention products)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})

_REMAT_POLICIES = {
    # recompute everything inside the body (lowest memory)
    "full": lambda body: _checkpointed(body),
    # save the unbatched matmul outputs (time embedding, projections)
    "dots": lambda body: _checkpointed(body, _DOTS),
    # save the convolution outputs too: the conv-dominated models recompute far less
    "conv_dots": lambda body: _checkpointed(body, _DOTS | {torch.ops.aten.convolution.default}),
    # no checkpoint: autograd keeps whatever it needs (highest memory)
    "none": lambda body: body,
}


def apply_remat(body: Callable, remat_policy: str) -> Callable:
    """Wrap ``body`` (tensors in, tensor out) by ``remat_policy``: "none",
    "full", "dots" or "conv_dots"."""
    try:
        return _REMAT_POLICIES[remat_policy](body)
    except KeyError:
        raise ValueError(
            f"unknown remat_policy {remat_policy!r}; have {sorted(_REMAT_POLICIES)}"
        ) from None
