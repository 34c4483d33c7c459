"""The PGD attack: editing chain, losses, EOT gradient and the loop."""

from tml_image_editing_defense_torch.attack.pgd import (
    AttackData,
    EOTDraws,
    make_attack_data,
    make_pgd_step,
    run_pgd,
    sample_draws,
)

__all__ = ["AttackData", "EOTDraws", "make_attack_data", "make_pgd_step", "run_pgd", "sample_draws"]
