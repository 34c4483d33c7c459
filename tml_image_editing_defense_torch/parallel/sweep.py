"""Batched PGD on one card: many independent immunizations as one batch
(port of ``parallel/sweep.py``, its ``mesh=None`` branch).

The JAX package ``vmap``s the one-image step over a leading image axis
(:85-109) and fuses the iterations into a ``lax.scan`` (:112-137).  Here
the batched step (``attack/pgd.py::make_batched_pgd_step``, of which the
one-image step is the batch of one) runs the B images through the chain as
one batch, and :func:`run_batched_pgd` loops over the iterations on the
host with ``attack/pgd.py::run_pgd``: a batch of B images launches the
kernels of one image, each launch doing B times the work.  Spreading the
images over several cards waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from tml_image_editing_defense_torch.attack.pgd import (
    AttackData,
    batch_attack_data,
    make_batched_pgd_step,
    run_pgd,
)
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import BaseSampler, DenoisePlan
from tml_image_editing_defense_torch.models.model_zoo import DiffusionModel

__all__ = ["batch_attack_data", "make_batched_pgd_step", "run_batched_pgd"]


def run_batched_pgd(
    model: DiffusionModel,
    sampler: BaseSampler,
    plan: DenoisePlan,
    cfg: TrainConfig,
    batched: AttackData,
    seeds: Sequence[int],
) -> Tuple[torch.Tensor, List[list]]:
    """``cfg.n_optimization_steps`` iterations of ``make_batched_pgd_step``
    from the sources, the counterpart of the JAX ``make_batched_pgd_loop``
    (:112-137) as ``run_pgd``'s host loop: image i draws iteration ``it``
    from ``iteration_generator(seeds[i], it)`` through ``sample_draws``, the
    draws ``run_pgd`` makes for a one-image run with that seed.  The losses
    stay on the device until the loop ends.  Returns the iterates
    [B, 3, H, W] and per image one ``{avg_loss, rec_loss, pert_loss}`` entry
    per iteration."""
    return run_pgd(model, sampler, plan, cfg, batched, list(seeds))
