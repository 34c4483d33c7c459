"""The fused PGD updates, L2 (kernel K4) and L-inf (kernel K5), both in
``csrc/pgd_update.cu``, and the dispatcher the attack uses.

Counterpart of ``tml_image_editing_defense_tpu/ops/pgd_kernels.py``
(``pgd_l2_update`` with ``_l2_kernel`` / ``_l2_masked_kernel``, and
``pgd_linf_update`` with ``_linf_kernel``).  K4 takes per-sample norms, so
it serves any batch (the Pallas kernel took batch 1 only); K5 is
elementwise over any shape.  Each wrapper runs the plain version only for
CPU tensors; for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from tml_image_editing_defense_torch.attack.pgd import (
    l2_perturbation_step,
    linf_perturbation_step,
)
from tml_image_editing_defense_torch.ops._lib import (
    F,
    I,
    L,
    P,
    CudaKernel,
    require_cuda,
    stream_ptr,
)

PGD_L2_UPDATE = CudaKernel("tid_pgd_l2_update", [P, P, P, P, P, I, I, I, I, F, F, F, F, P])
#: K4 with a mask: the same kernels, its own C entry and so its own count.
PGD_L2_UPDATE_MASKED = CudaKernel("tid_pgd_l2_update_masked",
                                  [P, P, P, P, P, P, I, I, I, I, F, F, F, F, P])
PGD_LINF_UPDATE = CudaKernel("tid_pgd_linf_update", [P, P, P, P, L, I, F, F, F, F, P])

#: Bytes of one image plane that one block of K4 takes (``kL2Threads`` x 16
#: in ``csrc/pgd_update.cu``): 1024 f32 or 2048 bf16 pixels, every channel.
#: Each such chunk of a sample leaves one row of four partial sums.
L2_CHUNK_BYTES = 4096


def pgd_l2_update(
    x_adv: torch.Tensor,
    grad: torch.Tensor,
    x_src: torch.Tensor,
    step_size: float,
    eps: float,
    min_value: float,
    max_value: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused L2 PGD update of NCHW images in one call (reference
    main.py:254-268): the partial sums of every chunk, then the write; one
    kernel where its grid fits on the card at once, else two.

    ``mask`` ([B, 1, H, W]) scales the normalised gradient, broadcast over
    channels.  The plain ``l2_perturbation_step`` runs for CPU tensors."""
    if x_adv.device.type == "cpu":
        return l2_perturbation_step(x_adv, grad, x_src, step_size, eps, min_value, max_value,
                                    mask)
    require_cuda("pgd_l2_update", x_adv, grad, x_src)
    if x_adv.dim() != 4 or grad.shape != x_adv.shape or x_src.shape != x_adv.shape:
        raise ValueError(f"pgd_l2_update: x_adv, grad and x_src must share one [B,C,H,W] "
                         f"shape, got {tuple(x_adv.shape)}, {tuple(grad.shape)}, "
                         f"{tuple(x_src.shape)}")
    b, c, h, w = x_adv.shape
    if mask is not None:
        if tuple(mask.shape) != (b, 1, h, w) or mask.device != x_adv.device:
            raise ValueError(f"pgd_l2_update: mask must be [{b}, 1, {h}, {w}] on "
                             f"{x_adv.device}, got {tuple(mask.shape)} on {mask.device}")
        mask = mask.to(torch.float32).contiguous()      # no copy when already so
    out = torch.empty_like(x_adv)
    if out.numel():
        partials = torch.empty((b, l2_chunks(h * w, x_adv.element_size()), 4),
                               dtype=torch.float32, device=x_adv.device)
        rest = (partials.data_ptr(), out.data_ptr(), b, c, h * w,
                int(x_adv.dtype == torch.bfloat16), float(step_size), float(eps),
                float(min_value), float(max_value), stream_ptr(x_adv))
        if mask is None:
            PGD_L2_UPDATE(x_adv.data_ptr(), grad.data_ptr(), x_src.data_ptr(), *rest)
        else:
            PGD_L2_UPDATE_MASKED(x_adv.data_ptr(), grad.data_ptr(), x_src.data_ptr(),
                                 mask.data_ptr(), *rest)
    return out


def l2_chunks(hw: int, item_size: int) -> int:
    """K4's chunks per sample: pixels of one plane over those of a chunk."""
    return -(-hw // (L2_CHUNK_BYTES // item_size))


def pgd_linf_update(
    x_adv: torch.Tensor,
    grad: torch.Tensor,
    x_src: torch.Tensor,
    step_size: float,
    eps: float,
    min_value: float,
    max_value: float,
) -> torch.Tensor:
    """Fused L-inf PGD update, one launch (reference main.py:270-274):
    sign step, box projection onto [src - eps, src + eps], clamp.  Any shape;
    f32 or bf16.  The plain ``linf_perturbation_step`` runs for CPU tensors."""
    if x_adv.device.type == "cpu":
        return linf_perturbation_step(x_adv, grad, x_src, step_size, eps, min_value, max_value)
    require_cuda("pgd_linf_update", x_adv, grad, x_src)
    if grad.shape != x_adv.shape or x_src.shape != x_adv.shape:
        raise ValueError(f"pgd_linf_update: x_adv, grad and x_src must share one shape, got "
                         f"{tuple(x_adv.shape)}, {tuple(grad.shape)}, {tuple(x_src.shape)}")
    out = torch.empty_like(x_adv)
    if out.numel():
        PGD_LINF_UPDATE(x_adv.data_ptr(), grad.data_ptr(), x_src.data_ptr(), out.data_ptr(),
                        x_adv.numel(), int(x_adv.dtype == torch.bfloat16), float(step_size),
                        float(eps), float(min_value), float(max_value), stream_ptr(x_adv))
    return out


def fused_perturbation_step(norm_type: str, **kw) -> torch.Tensor:
    """Kernel-backed counterpart of :func:`attack.pgd.perturbation_step`;
    the mask applies on the L2 branch only (main.py:260-261 vs 270-274)."""
    if norm_type == "l2":
        return pgd_l2_update(**kw)
    if norm_type == "linf":
        kw.pop("mask", None)
        return pgd_linf_update(**kw)
    raise ValueError(f"unknown norm_type {norm_type!r}")


KERNELS = (PGD_L2_UPDATE, PGD_L2_UPDATE_MASKED, PGD_LINF_UPDATE)
