"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions:
``flash_attention`` (K1-K3), ``pgd_kernels`` (K4, K5) and ``group_norm``
(group norm with its SiLU, forward and backward).  Import the submodules;
this package imports nothing itself, since ``pgd_kernels`` depends on
``attack.pgd``, whose models depend on ``flash_attention`` and
``group_norm``."""
