"""The attacks: PGD (editing chain, losses, EOT gradient and the loop) and
the universal perturbation."""

from tml_image_editing_defense_torch.attack.pgd import (
    AttackData,
    EOTDraws,
    make_attack_data,
    make_pgd_step,
    run_pgd,
    sample_draws,
)
from tml_image_editing_defense_torch.attack.universal import (
    UniversalConfig,
    UniversalDraws,
    lcm_denoise_single_step,
    make_universal_step,
    make_universal_validation,
    sample_universal_draws,
    train_universal_perturbation,
)

__all__ = [
    "AttackData", "EOTDraws", "UniversalConfig", "UniversalDraws", "lcm_denoise_single_step",
    "make_attack_data", "make_pgd_step", "make_universal_step", "make_universal_validation",
    "run_pgd", "sample_draws", "sample_universal_draws", "train_universal_perturbation",
]
