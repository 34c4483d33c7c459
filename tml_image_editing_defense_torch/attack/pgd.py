"""PGD immunization engine (port of ``attack/pgd.py``).

- :func:`perturbation_step` and its L2 / L-inf branches: reference
  ``main.py:248-276``, including ``torch.renorm``'s slice-wise projection.
- :func:`make_eot_grad`: the ``grad_reps`` expectation over transformations
  (main.py:88-102) with the VAE encode run once and its backward applied once
  to the rep-averaged posterior gradient, as the JAX version does; the reps
  in batches of ``eot_chunk``, each denoising step under ``remat_policy``,
  the encode and decodes under a checkpoint with ``remat_vae``.
- :func:`_rep_loss_fn`: the per-rep loss that encodes the image itself, as
  the reference does every rep (main.py:191); the legacy loops use it.
- :func:`make_pgd_step` and :func:`run_pgd`: one outer iteration, and the
  host loop with visualization callbacks, which drives any step of that
  contract (the inpaint step of attack/inpaint.py too).

Randomness is explicit.  A step takes an :class:`EOTDraws` (prompt index,
pool indices, VAE posterior noise, LCM step noise); :func:`sample_draws`
makes one from a ``torch.Generator``, and :func:`run_pgd` seeds one
generator per iteration from (seed, iteration), so the stream does not depend
on where a run started.  JAX's threefry streams cannot be reproduced in
torch; the tests replay the JAX key tree into an ``EOTDraws`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tml_image_editing_defense_torch.attack.forward import (
    CondInputs,
    attack_forward_from_latent,
    make_time_ids,
    select_cond,
    stack_cond,
)
from tml_image_editing_defense_torch.attack.losses import lp_distance, perturbation_loss
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import BaseSampler, DenoisePlan
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel, PromptBank
from tml_image_editing_defense_torch.models.vae import sample_latent


def renorm_l2(x: torch.Tensor, maxnorm: float, dim: int = 0) -> torch.Tensor:
    """``torch.renorm(x, p=2, dim=dim, maxnorm)``: every slice along ``dim``
    whose L2 norm exceeds ``maxnorm`` is rescaled by
    ``maxnorm / (norm + 1e-7)`` (main.py:267)."""
    dims = tuple(i for i in range(x.dim()) if i != dim)
    norms = torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))
    factor = torch.where(norms > maxnorm, maxnorm / (norms + 1e-7), torch.ones_like(norms))
    return x * factor


def l2_perturbation_step(
    x_adv: torch.Tensor,
    grad: torch.Tensor,
    x_src: torch.Tensor,
    step_size: float,
    eps: float,
    min_value: float,
    max_value: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """L2 PGD: normalised-gradient step, renorm projection onto the eps-ball,
    clamp (main.py:254-268).  ``mask`` ([B,1,H,W]) restricts the step to
    salient regions (main.py:260-261)."""
    dims = tuple(range(1, grad.dim()))
    gnorm = torch.sqrt(torch.sum(grad * grad, dim=dims, keepdim=True))
    gn = grad / (gnorm + 1e-10)
    if mask is not None:
        gn = gn * mask
    x_adv = x_adv - gn * step_size
    d_x = renorm_l2(x_adv - x_src, eps, dim=0)
    return torch.clamp(x_src + d_x, min_value, max_value)


def linf_perturbation_step(
    x_adv: torch.Tensor,
    grad: torch.Tensor,
    x_src: torch.Tensor,
    step_size: float,
    eps: float,
    min_value: float,
    max_value: float,
) -> torch.Tensor:
    """L-inf PGD: sign step, box projection, clamp (main.py:270-274).  The
    segmentation mask does not apply here, as in the reference."""
    x_adv = x_adv - torch.sign(grad) * step_size
    x_adv = torch.minimum(torch.maximum(x_adv, x_src - eps), x_src + eps)
    return torch.clamp(x_adv, min_value, max_value)


def perturbation_step(norm_type: str, **kw) -> torch.Tensor:
    """Plain dispatcher with the reference's mask semantics: mask on L2 only."""
    if norm_type == "l2":
        return l2_perturbation_step(**kw)
    if norm_type == "linf":
        kw.pop("mask", None)
        return linf_perturbation_step(**kw)
    raise ValueError(f"unknown norm_type {norm_type!r}")


def select_perturbation_update(cfg: TrainConfig) -> Callable:
    """The CUDA update kernel's dispatcher unless ``cfg.use_pallas_update``
    is False (then the plain one)."""
    if cfg.use_pallas_update:
        from tml_image_editing_defense_torch.ops.pgd_kernels import fused_perturbation_step

        return fused_perturbation_step
    return perturbation_step


# ---------------------------------------------------------------------------
# attack data and random draws
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AttackData:
    """Device-resident inputs of one immunization run (NCHW)."""

    source: torch.Tensor                # [1, 3, H, W] in [-1, 1]
    target: torch.Tensor                # [1, 3, H, W]
    target_latent: torch.Tensor         # [1, C, h, w], unscaled (main.py:75)
    bank_embeds: torch.Tensor           # [P, S, D]
    bank_uncond: torch.Tensor           # [S, D]
    noise_pool: torch.Tensor            # [N, 1, C, h, w]
    bank_pooled: Optional[torch.Tensor] = None          # SDXL [P, Dp]
    bank_uncond_pooled: Optional[torch.Tensor] = None   # SDXL [Dp]
    time_ids: Optional[torch.Tensor] = None             # SDXL [2, 6]
    mask: Optional[torch.Tensor] = None  # [1, 1, H, W]

    def cond(self, prompt_idx) -> CondInputs:
        """The CFG conditioning of bank row ``prompt_idx``."""
        return select_cond(self.bank_embeds, self.bank_uncond, prompt_idx, self.bank_pooled,
                           self.bank_uncond_pooled, self.time_ids)


@torch.no_grad()
def make_attack_data(
    model: DiffusionModel,
    cfg: TrainConfig,
    source: torch.Tensor,
    target: torch.Tensor,
    bank: PromptBank,
    noise_pool: torch.Tensor,
    target_latent_eps: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> AttackData:
    """Assemble the attack's inputs (Trainer.run setup, main.py:61-75); the
    target latent is a posterior draw with ``target_latent_eps``, or the
    mean when it is None.  A pooled (SDXL) bank brings the 6-tuple of time
    ids at ``cfg.image_size``."""
    time_ids = None
    if bank.pooled is not None:
        time_ids = make_time_ids(cfg.image_size, source.dtype, source.device)
    return AttackData(
        source=source,
        target=target,
        target_latent=model.encode_image_raw(target, target_latent_eps),
        bank_embeds=bank.embeds,
        bank_uncond=bank.uncond,
        noise_pool=noise_pool,
        bank_pooled=bank.pooled,
        bank_uncond_pooled=bank.uncond_pooled,
        time_ids=time_ids,
        mask=mask if cfg.use_segmentation_mask else None,
    )


Index = Union[int, torch.Tensor]


@dataclasses.dataclass
class EOTDraws:
    """Every random number one PGD iteration uses."""

    #: row of the prompt bank (main.py:85), or one row per rep where the
    #: prompt is drawn per rep (the legacy loops and the inpaint attack)
    prompt_idx: Union[Index, Sequence[Index]]
    pool_idx: Sequence[Index]           # [R] noise-pool entry per rep (main.py:215)
    vae_eps: torch.Tensor               # [R, C, h, w] posterior noise per rep
    step_noise: torch.Tensor            # [R, K, C, h, w] LCM step noise per rep
    #: [R, C, h, w] fresh init noise per rep, when cfg.use_fixed_noise is False
    #: (the inpaint attack's fresh initial latents)
    init_noise: Optional[torch.Tensor] = None

    def rep_prompt(self, r: int) -> Index:
        """The prompt row rep ``r`` uses."""
        if isinstance(self.prompt_idx, (list, tuple)):
            return self.prompt_idx[r]
        return self.prompt_idx


def sample_draws(generator: torch.Generator, cfg: TrainConfig, n_prompts: int, n_pool: int,
                 latent_shape: Sequence[int], n_steps: int, dtype=torch.float32,
                 prompt_per_rep: bool = False) -> EOTDraws:
    """Draw one iteration's randomness on the generator's device, in a fixed
    order: prompt (one, or one per rep), pool indices, posterior noise, step
    noise, init noise."""
    dev = generator.device
    r = cfg.grad_reps
    c_hw = tuple(latent_shape[1:])
    prompt_idx = torch.randint(0, n_prompts, (r,) if prompt_per_rep else (), generator=generator,
                               device=dev)
    if prompt_per_rep:
        prompt_idx = list(prompt_idx.unbind(0))
    pool_idx = torch.randint(0, n_pool, (r,), generator=generator, device=dev)
    vae_eps = torch.randn((r, *c_hw), generator=generator, device=dev, dtype=dtype)
    step_noise = torch.randn((r, n_steps, *c_hw), generator=generator, device=dev, dtype=dtype)
    init_noise = None
    if not cfg.use_fixed_noise:
        init_noise = torch.randn((r, *c_hw), generator=generator, device=dev, dtype=dtype)
    return EOTDraws(prompt_idx, list(pool_idx.unbind(0)), vae_eps, step_noise, init_noise)


def iteration_generator(seed: int, iteration: int, device) -> torch.Generator:
    """The generator of one PGD iteration, seeded from (seed, iteration)
    alone, so a run resumed at iteration k draws what an uninterrupted run
    would (pgd.py:516-519 of the JAX package)."""
    mixed = np.random.SeedSequence((int(seed), int(iteration))).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


# ---------------------------------------------------------------------------
# EOT gradient
# ---------------------------------------------------------------------------


def _vae_checkpoint(fn: Callable, remat_vae: bool) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` with ``remat_vae`` (its
    activations recomputed in the backward, JAX ``jax.checkpoint``), else
    as it is."""
    if not remat_vae:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _rep_loss_from_dist(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                        cfg: TrainConfig):
    """The loss of EOT samples as a function of the VAE posterior (mean,
    logvar) (reference compute_grad, main.py:144-177; JAX pgd.py:211-258).

    ``loss_fn(mean, logvar, data, draws, rows) -> (losses, recs, perts,
    out_latents)`` runs the reps ``rows`` (a range of rows of ``draws``)
    through the chain as one batch, CFG doubling it; the outputs have one
    row per rep.  The denoising steps run under
    ``cfg.remat_policy``, the decode under a checkpoint with
    ``cfg.remat_vae``."""
    need_pixels = cfg.apply_loss_on_images or cfg.perturbation_loss_lambda > 0
    decode = _vae_checkpoint(lambda z: model.decode_latent(z, scaled=False), cfg.remat_vae)

    def loss_fn(mean, logvar, data: AttackData, draws: EOTDraws, rows: range):
        sl = slice(rows.start, rows.stop)
        if draws.init_noise is not None:
            noise = draws.init_noise[sl]
        else:
            noise = torch.cat([data.noise_pool[draws.pool_idx[r]] for r in rows])
        cond = stack_cond([data.cond(draws.rep_prompt(r)) for r in rows])
        z = sample_latent(mean, logvar, draws.vae_eps[sl]) * model.vae_scaling
        out_latent = attack_forward_from_latent(
            model, sampler, plan, z, cond, noise, cfg.guidance_scale,
            draws.step_noise[sl].transpose(0, 1), cfg.remat_policy)
        output_image = decode(out_latent) if need_pixels else None
        if cfg.apply_loss_on_images:
            rec = torch.stack([lp_distance(o, data.target, 2) for o in output_image.split(1)])
        elif cfg.apply_loss_on_latents:
            rec = torch.stack([lp_distance(o, data.target_latent, 2)
                               for o in out_latent.split(1)])
        else:
            raise ValueError("set apply_loss_on_images or apply_loss_on_latents")
        if cfg.perturbation_loss_lambda > 0:
            pert = torch.stack([perturbation_loss(o, data.source) for o in output_image.split(1)])
            loss = cfg.rec_loss_lambda * rec + cfg.perturbation_loss_lambda * pert
        else:
            pert = torch.zeros_like(rec)
            loss = cfg.rec_loss_lambda * rec
        return loss, rec, pert, out_latent

    return loss_fn


def _rep_loss_fn(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                 cfg: TrainConfig):
    """One EOT sample's loss as a function of the image: the encode runs
    inside, once per rep (reference compute_grad, main.py:144-177; JAX
    pgd.py:160-208, the chain under ``cfg.remat_policy`` and the decode
    under ``cfg.remat_vae``).  ``loss_fn(x_adv, data, draws, r) -> (loss,
    rec, pert, out_latent)``."""
    from_dist = _rep_loss_from_dist(model, sampler, plan, cfg)

    def loss_fn(x_adv, data: AttackData, draws: EOTDraws, r: int):
        mean, logvar = model.vae.encode(x_adv)
        loss, rec, pert, out_latent = from_dist(mean, logvar, data, draws, range(r, r + 1))
        return loss[0], rec[0], pert[0], out_latent

    return loss_fn


def rep_grad_mean(rep_loss: Callable, x_adv: torch.Tensor, reps: int):
    """The mean over ``reps`` of d loss_r / d x at ``x_adv``, one rep at a
    time, each rep's graph freed before the next is built (the legacy loops
    and the inpaint attack, whose reps each encode the image).
    ``rep_loss(x, r) -> (loss, *outputs)``; returns (grad, mean loss, the last
    rep's outputs detached)."""
    gsum = torch.zeros_like(x_adv)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x_adv.device)
    with torch.enable_grad():
        for r in range(reps):
            x = x_adv.detach().requires_grad_(True)
            loss, *outputs = rep_loss(x, r)
            (g,) = torch.autograd.grad(loss, [x])
            gsum += g
            loss_sum += loss.detach()
    return gsum / reps, loss_sum / reps, [t.detach() for t in outputs]


def eot_chunk_size(cfg: TrainConfig) -> int:
    """Reps per batch through the chain: ``eot_chunk`` under "scan", all
    of them under "vmap" (JAX pgd.py:316-328).  ``eot_chunk`` must divide
    ``grad_reps``; "shard" (reps over cards) waits for the multi-GPU slice."""
    if cfg.eot_mode == "vmap":
        return cfg.grad_reps
    if cfg.eot_mode == "shard":
        raise NotImplementedError('eot_mode="shard" comes with the multi-GPU slice of the port')
    if cfg.eot_mode != "scan":
        raise ValueError(f"unknown eot_mode {cfg.eot_mode!r}; have 'scan', 'vmap', 'shard'")
    chunk = max(int(cfg.eot_chunk), 1)
    if cfg.grad_reps % chunk:
        raise ValueError(f"eot_chunk={chunk} must divide grad_reps={cfg.grad_reps}")
    return chunk


def make_eot_grad(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                  cfg: TrainConfig):
    """EOT gradient ``eot(x_adv, data, draws) -> (grad, aux)``: the mean over
    ``grad_reps`` samples (main.py:88-102), prompt drawn once per call.

    The encode is shared: ``vae.encode(x_adv)`` runs once (under a
    checkpoint with ``cfg.remat_vae``, JAX pgd.py:310-314); the reps take
    their gradient with respect to detached copies of (mean, logvar), and
    the rep-averaged gradient goes through the encoder's backward once.  The
    reps run in batches of :func:`eot_chunk_size`, rows ``r0 .. r0+c-1`` of
    ``draws`` together; their losses are summed, so the mean gradient is the
    one-at-a-time one.  Each batch's graph is freed before the next one is
    built.  ``aux`` holds the mean loss over reps and the last rep's
    rec/pert losses and output latent (detached), as JAX's ``a[-1]``."""
    loss_fn = _rep_loss_from_dist(model, sampler, plan, cfg)
    reps = cfg.grad_reps
    chunk = eot_chunk_size(cfg)
    encode = _vae_checkpoint(model.vae.encode, cfg.remat_vae)

    def eot(x_adv: torch.Tensor, data: AttackData, draws: EOTDraws):
        with torch.enable_grad():
            x = x_adv.detach().requires_grad_(True)
            mean, logvar = encode(x)
            g_mean, g_logvar = torch.zeros_like(mean), torch.zeros_like(logvar)
            loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
            for r0 in range(0, reps, chunk):
                m = mean.detach().requires_grad_(True)
                lv = logvar.detach().requires_grad_(True)
                loss, rec, pert, out_lat = loss_fn(m, lv, data, draws, range(r0, r0 + chunk))
                gm, gl = torch.autograd.grad(loss.sum(), [m, lv])
                g_mean += gm
                g_logvar += gl
                loss_sum += loss.detach().sum()
            torch.autograd.backward([mean, logvar], [g_mean / reps, g_logvar / reps])
        aux = {
            "avg_loss": loss_sum / reps,
            "rec_loss": rec[-1].detach(),
            "pert_loss": pert[-1].detach(),
            "prompt_idx": draws.prompt_idx,
            "output_latent": out_lat[-1:].detach(),
        }
        return x.grad, aux

    return eot


# ---------------------------------------------------------------------------
# PGD step and loop
# ---------------------------------------------------------------------------


def make_pgd_step(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                  cfg: TrainConfig, decode_vis: bool = True) -> Callable:
    """One outer PGD iteration ``step(x_adv, data, draws) -> (x_adv', aux)``
    (main.py:79-115).  With ``decode_vis`` the aux also carries
    ``output_image``, the last rep's output decoded for the vis grid."""
    eot = make_eot_grad(model, sampler, plan, cfg)
    update = select_perturbation_update(cfg)

    def step(x_adv: torch.Tensor, data: AttackData, draws: EOTDraws):
        grad, aux = eot(x_adv, data, draws)
        # the encoder's backward may leave the gradient in a strided layout
        x_new = update(cfg.norm_type, x_adv=x_adv.detach(), grad=grad.contiguous(),
                       x_src=data.source,
                       step_size=cfg.step_size, eps=cfg.eps, min_value=cfg.min_value,
                       max_value=cfg.max_value, mask=data.mask)
        if decode_vis:
            with torch.no_grad():
                aux["output_image"] = model.decode_latent(aux["output_latent"], scaled=False)
        return x_new, aux

    return step


SCALAR_KEYS = ("avg_loss", "rec_loss", "pert_loss")


def run_pgd(
    model: DiffusionModel,
    sampler: BaseSampler,
    plan: DenoisePlan,
    cfg: TrainConfig,
    data: AttackData,
    seed: int,
    vis_callback: Optional[Callable] = None,
    vis_needs_image: bool = True,
    step_fn: Optional[Callable] = None,
    draw_sampler: Optional[Callable[[torch.Generator], EOTDraws]] = None,
    x_init: Optional[torch.Tensor] = None,
    start_iteration: int = 0,
    stop_flag=None,
    ckpt_callback: Optional[Callable] = None,
    ckpt_interval: int = 0,
) -> Tuple[torch.Tensor, list]:
    """Host-driven PGD loop (reference main.py:79-135), from ``x_init``
    (default: the source) at iteration ``start_iteration``.

    ``step_fn(x_adv, data, draws) -> (x_adv', aux)`` is the iteration
    (default: :func:`make_pgd_step` without the vis decode);
    ``draw_sampler(generator) -> EOTDraws`` draws its randomness from the
    iteration's generator (default: :func:`sample_draws`).  The generators
    are positional in (seed, iteration), so a run resumed at iteration k
    draws what an uninterrupted run would.
    ``vis_callback(it, x_adv, aux)`` fires at every
    ``cfg.image_visualization_interval``-th iteration and at the last one;
    the vis image is decoded from ``aux["output_latent"]`` only there, when
    ``vis_needs_image``.  ``ckpt_callback(it, x_adv)`` fires on its own
    schedule, after every iteration ``it`` with ``it % ckpt_interval == 0``
    but iteration 0, whether or not it is a vis iteration (JAX
    ``run_pgd``, pgd.py:472-478).  ``stop_flag`` (utils/preemption.py) is
    polled before each iteration; once it is set the loop returns the
    current iterate and the history ends with ``{"preempted_at": it}``, the
    iteration that did not run.

    Loss scalars stay on the device until the loop ends; the returned history
    has one ``{avg_loss, rec_loss, pert_loss}`` entry per iteration run.
    The JAX package's ``dispatch_block`` fuses iterations into one compiled
    TPU dispatch; a host-driven eager loop has no such dispatch, so the port
    has no counterpart of it."""
    step = step_fn or make_pgd_step(model, sampler, plan, cfg, decode_vis=False)
    if draw_sampler is None:
        def draw_sampler(gen):
            return sample_draws(gen, cfg, data.bank_embeds.shape[0], data.noise_pool.shape[0],
                                data.noise_pool.shape[1:], plan.num_steps, data.source.dtype)
    x_adv = data.source if x_init is None else x_init
    n, interval = cfg.n_optimization_steps, cfg.image_visualization_interval
    pending, preempted = [], None
    for it in range(start_iteration, n):
        if stop_flag:
            preempted = {"preempted_at": it}
            break
        draws = draw_sampler(iteration_generator(seed, it, data.source.device))
        x_adv, aux = step(x_adv, data, draws)
        pending.append(torch.stack([aux[k].float() for k in SCALAR_KEYS]))
        if vis_callback is not None and (it % interval == 0 or it == n - 1):
            if vis_needs_image:
                with torch.no_grad():
                    aux["output_image"] = model.decode_latent(aux["output_latent"], scaled=False)
            vis_callback(it, x_adv, aux)
        if ckpt_callback is not None and ckpt_interval and it and it % ckpt_interval == 0:
            ckpt_callback(it, x_adv)
    history = []
    if pending:
        rows = torch.stack(pending).cpu().tolist()
        history = [dict(zip(SCALAR_KEYS, row)) for row in rows]
    if preempted is not None:
        history.append(preempted)
    return x_adv, history
