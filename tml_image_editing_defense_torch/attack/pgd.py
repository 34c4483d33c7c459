"""PGD immunization engine (port of ``attack/pgd.py``).

- :func:`perturbation_step` and its L2 / L-inf branches: reference
  ``main.py:248-276``, including ``torch.renorm``'s slice-wise projection.
- :func:`make_batched_eot_grad`: the ``grad_reps`` expectation over
  transformations (main.py:88-102) of B images as one batch through the
  chain (JAX parallel/sweep.py's ``vmap``), with the VAE encode run once
  and its backward applied once to the rep-averaged posterior gradient, as
  the JAX version does; the reps in batches of ``eot_chunk``, each
  denoising step under ``remat_policy``, the encode and decodes under a
  checkpoint with ``remat_vae``.  :func:`make_batched_pgd_step` adds the
  update; :func:`make_eot_grad` and :func:`make_pgd_step` are both on a
  batch of one.
- :func:`_rep_loss_fn`: the per-rep loss that encodes the image itself, as
  the reference does every rep (main.py:191); the legacy loops use it.
- :func:`run_pgd`: the host loop with visualization callbacks, which drives
  any step of that contract (the inpaint step of attack/inpaint.py too),
  for one image or, with one seed per image, for a batch.

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

from tml_image_editing_defense_torch.attack.chunk_graph import ChunkRunner
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
from tml_image_editing_defense_torch.utils import profiling


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
    #: [R] noise-pool entry per rep (main.py:215): a 1-D tensor, or ints
    pool_idx: Union[torch.Tensor, Sequence[Index]]
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
    return EOTDraws(prompt_idx, pool_idx, vae_eps, step_noise, init_noise)


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


def _row_loss(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan, cfg: TrainConfig):
    """The loss of EOT rows run through the chain as one batch, CFG doubling
    it (reference compute_grad, main.py:144-177; JAX pgd.py:211-258).

    ``loss_fn(mean, logvar, eps, noise, cond, step_noise, target,
    target_latent, source) -> (losses, recs, perts, out_latents)``, one row
    per row of ``eps``: ``mean`` and ``logvar`` are the VAE posterior (one
    row shared by every row, or one per row), ``step_noise`` is
    [K, rows, C, h, w], and ``target``, ``target_latent`` and ``source``
    hold one row shared by every row or one per row.  The denoising steps
    run under ``cfg.remat_policy``, the decode under a checkpoint with
    ``cfg.remat_vae``."""
    need_pixels = cfg.apply_loss_on_images or cfg.perturbation_loss_lambda > 0
    decode = _vae_checkpoint(lambda z: model.decode_latent(z, scaled=False), cfg.remat_vae)

    def per_row(fn, outs, ref):
        refs = ref.expand(outs.shape[0], *ref.shape[1:]).split(1)
        return torch.stack([fn(o, r) for o, r in zip(outs.split(1), refs)])

    def loss_fn(mean, logvar, eps, noise, cond: CondInputs, step_noise, target, target_latent,
                source):
        z = sample_latent(mean, logvar, eps) * model.vae_scaling
        out_latent = attack_forward_from_latent(
            model, sampler, plan, z, cond, noise, cfg.guidance_scale, step_noise,
            cfg.remat_policy)
        output_image = decode(out_latent) if need_pixels else None
        if cfg.apply_loss_on_images:
            rec = per_row(lambda o, r: lp_distance(o, r, 2), output_image, target)
        elif cfg.apply_loss_on_latents:
            rec = per_row(lambda o, r: lp_distance(o, r, 2), out_latent, target_latent)
        else:
            raise ValueError("set apply_loss_on_images or apply_loss_on_latents")
        if cfg.perturbation_loss_lambda > 0:
            pert = per_row(perturbation_loss, output_image, source)
            loss = cfg.rec_loss_lambda * rec + cfg.perturbation_loss_lambda * pert
        else:
            pert = torch.zeros_like(rec)
            loss = cfg.rec_loss_lambda * rec
        return loss, rec, pert, out_latent

    return loss_fn


def rep_inputs(data: AttackData, draws: EOTDraws, rows: range, noise_pool=None):
    """The per-row inputs of reps ``rows`` of ``draws``: (posterior noise,
    init noise, CFG conditioning, step noise [K, rows, C, h, w]); the init
    noise is the drawn fresh noise, or the pool entries of ``noise_pool``
    [N, 1, C, h, w] (default ``data.noise_pool``)."""
    sl = slice(rows.start, rows.stop)
    pool = data.noise_pool if noise_pool is None else noise_pool
    if draws.init_noise is not None:
        noise = draws.init_noise[sl]
    else:
        # gathered on the pool's device: indexing with a 0-d device tensor
        # reads it on the host, once a row
        idx = draws.pool_idx[sl]
        if not torch.is_tensor(idx):
            idx = torch.stack([torch.as_tensor(i) for i in idx])
        noise = pool.index_select(0, idx.to(pool.device)).flatten(0, 1)
    cond = [data.cond(draws.rep_prompt(r)) for r in rows]
    return draws.vae_eps[sl], noise, cond, draws.step_noise[sl].transpose(0, 1)


def _rep_loss_from_dist(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                        cfg: TrainConfig):
    """The loss of EOT samples as a function of the VAE posterior (mean,
    logvar) (JAX pgd.py:211-258).

    ``loss_fn(mean, logvar, data, draws, rows) -> (losses, recs, perts,
    out_latents)`` runs the reps ``rows`` (a range of rows of ``draws``)
    through the chain as one batch (:func:`_row_loss`); the outputs have one
    row per rep."""
    row_loss = _row_loss(model, sampler, plan, cfg)

    def loss_fn(mean, logvar, data: AttackData, draws: EOTDraws, rows: range):
        eps, noise, cond, step_noise = rep_inputs(data, draws, rows)
        return row_loss(mean, logvar, eps, noise, stack_cond(cond), step_noise, data.target,
                        data.target_latent, data.source)

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


def rep_grad_mean(rep_loss: Callable, x_adv: torch.Tensor, reps: int,
                  rows: Optional[range] = None, reduce: Optional[Callable] = None):
    """The mean over ``reps`` of d loss_r / d x at ``x_adv``, one rep at a
    time, each rep's graph freed before the next is built (the legacy loops,
    the inpaint attack and the universal step, whose reps each encode the
    image).  ``rep_loss(x, r) -> (loss, *outputs)``; returns (grad, mean
    loss, the last rep's outputs detached).

    The hooks of a sharded call (``parallel/eot.py``): ``rows`` is the block
    of reps this call runs (default: all ``reps``), and ``reduce(tensors)``
    sums the gradient and loss sums in place over the ranks that run the
    other blocks; the sums are then divided by ``reps``."""
    gsum = torch.zeros_like(x_adv)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x_adv.device)
    outputs = []
    with torch.enable_grad():
        for r in range(reps) if rows is None else rows:
            x = x_adv.detach().requires_grad_(True)
            loss, *outputs = rep_loss(x, r)
            (g,) = torch.autograd.grad(loss, [x])
            gsum += g
            loss_sum += loss.detach()
    if reduce is not None:
        reduce([gsum, loss_sum])
    return gsum / reps, loss_sum / reps, [t.detach() for t in outputs]


def eot_chunk_size(cfg: TrainConfig) -> int:
    """Reps per batch through the chain: ``eot_chunk`` under "scan", all
    of them under "vmap" (JAX pgd.py:316-328).  ``eot_chunk`` must divide
    ``grad_reps``.  "shard" is "scan" here, as in the JAX serial step (every
    mode but "vmap" is the scan there): the reps spread over ranks with
    ``cfg.eot_shards`` (``api.immunize``, ``parallel/eot.py``)."""
    if cfg.eot_mode == "vmap":
        return cfg.grad_reps
    if cfg.eot_mode not in ("scan", "shard"):
        raise ValueError(f"unknown eot_mode {cfg.eot_mode!r}; have 'scan', 'vmap', 'shard'")
    chunk = max(int(cfg.eot_chunk), 1)
    if cfg.grad_reps % chunk:
        raise ValueError(f"eot_chunk={chunk} must divide grad_reps={cfg.grad_reps}")
    return chunk


def batch_attack_data(datas: Sequence[AttackData]) -> AttackData:
    """Stack the per-image fields (``source``, ``target``, ``target_latent``,
    ``noise_pool``, ``mask``) on a new leading image axis; the prompt bank,
    its pooled rows and the time ids are shared and stay unbatched (JAX
    parallel/sweep.py:27-49)."""
    d0 = datas[0]

    def stack(field):
        vals = [getattr(d, field) for d in datas]
        return None if vals[0] is None else torch.stack(vals)

    return AttackData(
        source=stack("source"),                 # [B, 1, 3, H, W]
        target=stack("target"),
        target_latent=stack("target_latent"),   # [B, 1, C, h, w]
        bank_embeds=d0.bank_embeds,
        bank_uncond=d0.bank_uncond,
        noise_pool=stack("noise_pool"),         # [B, N, 1, C, h, w]
        bank_pooled=d0.bank_pooled,
        bank_uncond_pooled=d0.bank_uncond_pooled,
        time_ids=d0.time_ids,
        mask=stack("mask"),                     # [B, 1, 1, H, W]
    )


SCALAR_KEYS = ("avg_loss", "rec_loss", "pert_loss")


def _one_image(aux: dict) -> dict:
    """A batch of one's aux as the one-image functions give it: scalar
    losses and one prompt row (the output latent stays [1, C, h, w])."""
    return {**aux, **{k: aux[k][0] for k in (*SCALAR_KEYS, "prompt_idx")}}


def make_batched_eot_grad(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                          cfg: TrainConfig, rows: Optional[range] = None,
                          reduce: Optional[Callable] = None):
    """EOT gradient of B images ``eot(x_advs [B, 3, H, W], batched, draws) ->
    (grad, aux)``, with ``batched`` from :func:`batch_attack_data` and
    ``draws`` one :class:`EOTDraws` per image: for each image the mean over
    ``grad_reps`` samples (main.py:88-102), its prompt drawn once per call.

    The encode is shared: ``vae.encode`` runs once on the B images (under a
    checkpoint with ``cfg.remat_vae``, JAX pgd.py:310-314); the reps take
    their gradient with respect to detached copies of (mean, logvar), and
    the rep-averaged gradient goes through the encoder's backward once.  The
    reps run in batches of :func:`eot_chunk_size`, rows ``r0 .. r0+c-1`` of
    every image's draws together as B x c rows, image-major, each row with
    its image's conditioning, noise, posterior sample, target and source.
    The rows' losses are summed: the rows are independent (the UNet and the
    VAE keep no batch statistics), so each image gets the sum over its own
    rows, the one-at-a-time gradient.  Each batch's graph is freed before
    the next one is built.  ``aux`` holds per image ([B], on the device) the
    mean loss over reps and the last rep's rec/pert losses (JAX's
    ``a[-1]``), the prompt rows, and the last rep's output latents
    [B, C, h, w], all detached.

    The hooks of the sharded steps (``parallel/eot.py``,
    ``parallel/dp_eot.py``): ``rows`` is the block of the global rep stream
    this call runs (rows of the same ``draws``), one rep at a time, as the
    JAX sharded scan runs its block (eot.py:86-88; ``eot_chunk`` does not
    apply there, nor here); ``reduce(tensors)`` sums the posterior
    gradients and the loss sums in place over the ranks that run the other
    blocks, before the one encoder backward (JAX's ``pmean`` of ``gdist``,
    eot.py:90-94).  The sums are divided by ``grad_reps`` after it; the
    aux's last rep is then the block's.

    On the card each chunk, its forward and its gradient, replays from CUDA
    graphs captured once (:mod:`~tml_image_editing_defense_torch.attack.chunk_graph`,
    whose rule decides); the encode, its backward, the accumulation and
    ``reduce`` stay eager."""
    row_loss = _row_loss(model, sampler, plan, cfg)
    reps = cfg.grad_reps
    chunk = eot_chunk_size(cfg) if rows is None else 1
    block = range(reps) if rows is None else rows
    encode = _vae_checkpoint(model.vae.encode, cfg.remat_vae)

    def chunk_loss(m, lv, eps, noise, ctx, text_embeds, time_ids, step_noise, target,
                   target_latent, source):
        return row_loss(m.repeat_interleave(chunk, 0), lv.repeat_interleave(chunk, 0), eps,
                        noise, CondInputs(ctx, text_embeds, time_ids), step_noise, target,
                        target_latent, source)

    run_chunk = ChunkRunner(chunk_loss, cfg)

    def rows_of(batched: AttackData, draws: Sequence[EOTDraws], rows: range):
        parts = [rep_inputs(batched, d, rows, noise_pool=batched.noise_pool[i])
                 for i, d in enumerate(draws)]
        eps, noise, conds, step_noise = zip(*parts)
        per_row = lambda t: t[:, 0].repeat_interleave(len(rows), 0)     # noqa: E731
        return (torch.cat(eps), torch.cat(noise), stack_cond([c for cs in conds for c in cs]),
                torch.cat(step_noise, dim=1), per_row(batched.target),
                per_row(batched.target_latent), per_row(batched.source))

    def eot(x_advs: torch.Tensor, batched: AttackData, draws: Sequence[EOTDraws]):
        b = x_advs.shape[0]
        if len(draws) != b:
            raise ValueError(f"{len(draws)} draws for {b} images")
        with torch.enable_grad():
            x = x_advs.detach().requires_grad_(True)
            mean, logvar = encode(x)
            g_mean, g_logvar = torch.zeros_like(mean), torch.zeros_like(logvar)
            loss_sum = torch.zeros((b,), dtype=torch.float32, device=x.device)
            for r0 in range(block.start, block.stop, chunk):
                with profiling.span("tid.eot.inputs"):
                    eps, noise, cond, step_noise, target, target_latent, source = rows_of(
                        batched, draws, range(r0, r0 + chunk))
                gm, gl, loss, rec, pert, out_lat = run_chunk(
                    (mean, logvar, eps, noise, cond.ctx, cond.text_embeds, cond.time_ids,
                     step_noise, target, target_latent, source), rep=r0, rows=b * chunk)
                g_mean += gm
                g_logvar += gl
                loss_sum += loss.view(b, chunk).sum(1)
            if reduce is not None:
                with profiling.span("tid.eot.reduce"):
                    reduce([g_mean, g_logvar, loss_sum])
            with profiling.span("tid.eot.encoder_backward", waits=True):
                torch.autograd.backward([mean, logvar], [g_mean / reps, g_logvar / reps])
        # copies: a replayed chunk's outputs are its graphs' static tensors
        last = lambda t: t.view(b, chunk, *t.shape[1:])[:, -1].clone()      # noqa: E731
        aux = {"avg_loss": loss_sum / reps, "rec_loss": last(rec), "pert_loss": last(pert),
               "prompt_idx": [d.prompt_idx for d in draws], "output_latent": last(out_lat)}
        return x.grad, aux

    return eot


def make_eot_grad(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                  cfg: TrainConfig):
    """EOT gradient of one image ``eot(x_adv [1, 3, H, W], data, draws) ->
    (grad, aux)``: :func:`make_batched_eot_grad` on a batch of one, the
    losses in ``aux`` scalars."""
    eot = make_batched_eot_grad(model, sampler, plan, cfg)

    def one(x_adv: torch.Tensor, data: AttackData, draws: EOTDraws):
        grad, aux = eot(x_adv, batch_attack_data([data]), [draws])
        return grad, _one_image(aux)

    return one


# ---------------------------------------------------------------------------
# PGD step and loop
# ---------------------------------------------------------------------------


def make_batched_pgd_step(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                          cfg: TrainConfig, eot: Optional[Callable] = None) -> Callable:
    """One outer PGD iteration of B images ``step(x_advs [B, 3, H, W],
    batched, draws) -> (x_advs', aux)`` (main.py:79-115; JAX
    parallel/sweep.py:85-109, the ``vmap`` of the one-image step, run here
    as one batch): the gradient of ``eot`` (default
    :func:`make_batched_eot_grad`; the sharded steps pass theirs), then one
    update of every image (K4 for L2 at [B, 3, H, W] with per-image norms,
    K5 for L-inf)."""
    if eot is None:
        eot = make_batched_eot_grad(model, sampler, plan, cfg)
    update = select_perturbation_update(cfg)

    def step(x_advs: torch.Tensor, batched: AttackData, draws: Sequence[EOTDraws]):
        grad, aux = eot(x_advs, batched, draws)
        mask = None if batched.mask is None else batched.mask[:, 0]
        with profiling.span("tid.pgd.update"):
            # the encoder's backward may leave the gradient in a strided layout
            x_new = update(cfg.norm_type, x_adv=x_advs.detach(), grad=grad.contiguous(),
                           x_src=batched.source[:, 0], step_size=cfg.step_size, eps=cfg.eps,
                           min_value=cfg.min_value, max_value=cfg.max_value, mask=mask)
        return x_new, aux

    return step


def one_image_step(step: Callable, model: DiffusionModel, decode_vis: bool = True) -> Callable:
    """A batched step (``step(x_advs, batched, draws)``) as a one-image step
    ``one(x_adv, data, draws) -> (x_adv', aux)`` on a batch of one, the
    losses in ``aux`` scalars; with ``decode_vis`` the aux also carries
    ``output_image``, the last rep's output decoded for the vis grid."""
    def one(x_adv: torch.Tensor, data: AttackData, draws: EOTDraws):
        x_new, aux = step(x_adv, batch_attack_data([data]), [draws])
        aux = _one_image(aux)
        if decode_vis:
            with torch.no_grad():
                aux["output_image"] = model.decode_latent(aux["output_latent"], scaled=False)
        return x_new, aux

    return one


def make_pgd_step(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                  cfg: TrainConfig, decode_vis: bool = True) -> Callable:
    """One outer PGD iteration of one image ``step(x_adv, data, draws) ->
    (x_adv', aux)``: :func:`make_batched_pgd_step` on a batch of one
    (:func:`one_image_step`)."""
    return one_image_step(make_batched_pgd_step(model, sampler, plan, cfg), model, decode_vis)


def run_pgd(
    model: DiffusionModel,
    sampler: BaseSampler,
    plan: DenoisePlan,
    cfg: TrainConfig,
    data: AttackData,
    seed: Union[int, Sequence[int]],
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

    ``seed`` is an int for one image, or a list of seeds, one per image of
    a batched ``data`` (:func:`batch_attack_data`), for a batch of images.
    ``step_fn(x_adv, data, draws) -> (x_adv', aux)`` is the iteration
    (default: :func:`make_pgd_step` without the vis decode, or
    :func:`make_batched_pgd_step` for a batch, whose ``draws`` hold one
    draw per image);
    ``draw_sampler(generator) -> EOTDraws`` draws its randomness from the
    iteration's generator (default: :func:`sample_draws`).  The generators
    are positional in (seed, iteration), so a run resumed at iteration k
    draws what an uninterrupted run would, and image i of a batch draws
    what a one-image run with seed i would.
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
    has one ``{avg_loss, rec_loss, pert_loss}`` entry per iteration run, a
    list of them per image for a batch.
    Where ``torch.profiler`` runs when the loop starts (or a recording is
    open), the call is recorded (``utils/profiling.py``): a
    ``tid.pgd.iteration`` span an iteration, with the spans of the draws, the
    EOT chunks, the models and the update under it (a chunk replayed from
    CUDA graphs holds no model span); without one each span costs one read
    of a flag.
    The JAX package's ``dispatch_block`` fuses iterations into one compiled
    TPU dispatch; a host-driven eager loop has no such dispatch, so the port
    has no counterpart of it."""
    seeds = list(seed) if isinstance(seed, (list, tuple)) else None
    if step_fn is None:
        step_fn = (make_pgd_step(model, sampler, plan, cfg, decode_vis=False) if seeds is None
                   else make_batched_pgd_step(model, sampler, plan, cfg))
    if draw_sampler is None:
        pool = data.noise_pool                  # [(B,) N, 1, C, h, w]

        def draw_sampler(gen):
            return sample_draws(gen, cfg, data.bank_embeds.shape[0], pool.shape[-5],
                                pool.shape[-4:], plan.num_steps, data.source.dtype)
    if x_init is None:
        x_init = data.source if seeds is None else data.source[:, 0]
    x_adv, dev = x_init, data.source.device
    n, interval = cfg.n_optimization_steps, cfg.image_visualization_interval
    pending, preempted = [], []
    images = 1 if seeds is None else len(seeds)

    def history(rows):
        return [dict(zip(SCALAR_KEYS, row)) for row in rows] + preempted

    with profiling.recording_if_profiled(dev):
        for it in range(start_iteration, n):
            if stop_flag:
                preempted = [{"preempted_at": it}]
                break
            with profiling.span(profiling.ITERATION, iteration=it, images=images):
                with profiling.span("tid.pgd.draws"):
                    if seeds is None:
                        draws = draw_sampler(iteration_generator(seed, it, dev))
                    else:
                        draws = [draw_sampler(iteration_generator(s, it, dev)) for s in seeds]
                x_adv, aux = step_fn(x_adv, data, draws)
                pending.append(torch.stack([aux[k].float() for k in SCALAR_KEYS], dim=-1))
                if vis_callback is not None and (it % interval == 0 or it == n - 1):
                    if vis_needs_image:
                        with torch.no_grad():
                            aux["output_image"] = model.decode_latent(aux["output_latent"],
                                                                      scaled=False)
                    vis_callback(it, x_adv, aux)
                if ckpt_callback is not None and ckpt_interval and it and it % ckpt_interval == 0:
                    ckpt_callback(it, x_adv)

        if seeds is None:
            return x_adv, history(torch.stack(pending).cpu().tolist() if pending else [])
        # [iterations, B, 3] -> per image
        per_image = (torch.stack(pending, dim=1).cpu().tolist() if pending
                     else [[] for _ in seeds])
        return x_adv, [history(rows) for rows in per_image]
