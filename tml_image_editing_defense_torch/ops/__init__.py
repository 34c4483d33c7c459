"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions:
``flash_attention`` (K1-K3) and ``pgd_kernels`` (K4).  Import the submodules;
this package imports nothing itself, since ``pgd_kernels`` depends on
``attack.pgd``, whose models depend on ``flash_attention``."""
