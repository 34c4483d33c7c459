"""Batched PGD: many independent immunizations as one batch (port of
``parallel/sweep.py``, its ``mesh=None`` branch).

The JAX package ``vmap``s the one-image step over a leading image axis
(:85-109) and fuses the iterations into a ``lax.scan`` (:112-137).  Here
the batched step (``attack/pgd.py::make_batched_pgd_step``, of which the
one-image step is the batch of one) runs the B images through the chain as
one batch, and ``attack/pgd.py::run_pgd`` loops over the iterations on the
host with one seed per image: a batch of B images launches the kernels of
one image, each launch doing B times the work.  The images over ranks are
``parallel/dp_eot.py``'s.
"""

from __future__ import annotations

from tml_image_editing_defense_torch.attack.pgd import batch_attack_data, make_batched_pgd_step

__all__ = ["batch_attack_data", "make_batched_pgd_step"]
