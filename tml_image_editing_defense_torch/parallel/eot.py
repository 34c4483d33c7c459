"""EOT reps over ranks (port of ``parallel/eot.py``).

The reference averages ``grad_reps`` gradient samples one after another on
one GPU (``main.py:88-102``).  Here each rank of the mesh's ``reps`` axis
runs a contiguous block of ``grad_reps / size`` of them, the block of the
same global rep stream that the serial step runs (JAX eot.py:115-116
block-shards ``split(k_reps, grad_reps)``; here every rank takes its rows
of the same :class:`~tml_image_editing_defense_torch.attack.pgd.EOTDraws`),
and one all-reduce sums the blocks: the EOT distribution is the serial
one, and only the order of the sums changes.

- :func:`make_sharded_eot_grad`: the batched EOT gradient with its reps
  over the ``reps`` axis; the posterior gradients and loss sums are summed
  over the axis before the one encoder backward (JAX :90-94).
- :func:`make_sharded_eot_pgd_step`: one image's PGD step on it (JAX :32).
- :func:`make_sharded_universal_step`: the universal step with its reps
  over the axis (JAX :145).
"""

from __future__ import annotations

from typing import Callable

from tml_image_editing_defense_torch.attack.pgd import (
    make_batched_eot_grad,
    one_image_step,
    rep_grad_mean,
)
from tml_image_editing_defense_torch.attack.universal import (
    _universal_rep_loss,
    make_universal_step,
)
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import BaseSampler, DenoisePlan
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel, PromptBank
from tml_image_editing_defense_torch.parallel.mesh import (
    REPS_AXIS,
    Mesh,
    all_reduce_,
    broadcast_,
)


def reps_block(mesh: Mesh, grad_reps: int) -> range:
    """This rank's block of the ``grad_reps`` reps; ``ValueError`` unless
    the ``reps`` axis divides them (JAX :50-54)."""
    n = mesh.size(REPS_AXIS)
    if grad_reps % n:
        raise ValueError(f"grad_reps={grad_reps} not divisible by reps-axis size {n}")
    return mesh.block(REPS_AXIS, grad_reps)


def make_sharded_eot_grad(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                          cfg: TrainConfig, mesh: Mesh) -> Callable:
    """:func:`~tml_image_editing_defense_torch.attack.pgd.make_batched_eot_grad`
    with this rank's block of reps, summed over the ``reps`` group before
    the encoder backward: ``eot(x_advs, batched, draws) -> (grad, aux)``,
    the same contract.  ``aux`` is the serial step's on every rank: the mean
    loss over all reps, and the last rep's losses and output latents, which
    the axis's last rank holds and broadcasts (JAX :100-106 selects them
    with a masked sum).  Under sharding the block runs one rep at a time
    and ``cfg.eot_chunk`` does not apply, as in JAX."""
    group = mesh.group(REPS_AXIS)
    eot = make_batched_eot_grad(model, sampler, plan, cfg, rows=reps_block(mesh, cfg.grad_reps),
                                reduce=lambda tensors: all_reduce_(tensors, group))

    def sharded(x_advs, batched, draws):
        grad, aux = eot(x_advs, batched, draws)
        broadcast_([aux["rec_loss"], aux["pert_loss"], aux["output_latent"]], -1, group)
        return grad, aux

    return sharded


def make_sharded_eot_pgd_step(model: DiffusionModel, sampler: BaseSampler, plan: DenoisePlan,
                              cfg: TrainConfig, mesh: Mesh, decode_vis: bool = True) -> Callable:
    """One image's PGD step with its EOT reps over ``mesh``'s ``reps``
    axis: ``step(x_adv, data, draws) -> (x_adv', aux)``, the contract of
    ``attack.pgd.make_pgd_step`` (the serial step's draws; ``decode_vis``
    as there), on every rank of the axis.  It is the 2-D step of
    ``parallel/dp_eot.py`` on a batch of one, so the iterate is one tensor
    on every rank (broadcast from the axis's first rank after the update)."""
    from tml_image_editing_defense_torch.parallel.dp_eot import make_dp_eot_pgd_step

    return one_image_step(make_dp_eot_pgd_step(model, sampler, plan, cfg, mesh), model,
                          decode_vis)


def make_sharded_universal_step(model: DiffusionModel, cfg, bank: PromptBank, mesh: Mesh,
                                preview=None) -> Callable:
    """The universal step (``attack/universal.py::make_universal_step``)
    with its ``cfg.grad_reps`` reps over ``mesh``'s ``reps`` axis, through
    its ``mean_grad`` hook (JAX :145-205): each rank runs its block of the
    step's draws, one rep at a time, and the gradient and loss sums are
    summed over the axis.  Every rank then holds the same mean gradient, bit
    for bit, so the same update keeps the perturbation one tensor."""
    rows = reps_block(mesh, cfg.grad_reps)
    group = mesh.group(REPS_AXIS)
    rep_loss = _universal_rep_loss(model, cfg, bank, preview)

    def mean_grad(pert, source, draws):
        grad, avg_loss, _ = rep_grad_mean(
            lambda x, r: (rep_loss(x, source, draws, r),), pert, cfg.grad_reps, rows=rows,
            reduce=lambda tensors: all_reduce_(tensors, group))
        return grad, avg_loss

    return make_universal_step(model, cfg, bank, preview=preview, mean_grad=mean_grad)
