"""Flash self-attention: the CUDA kernels K1 (forward), K2 (dK, dV) and K3
(dQ) from ``csrc/flash_attention.cu``, their plain PyTorch versions, and the
``autograd.Function`` that ties them together.

Counterpart of ``tml_image_editing_defense_tpu/ops/flash_attention.py`` (the
Pallas kernels ``_fwd_kernel``, ``_bwd_kv_kernel``, ``_bwd_q_kernel``).  It
takes the slot of the long self-attentions on the attack's path: the UNet's
64x64 level ([2, 4096, 8, 40] at 512x512) and the VAE mid-block
([1, 4096, 1, 512]), forward and backward.

Layout: q/k/v are [B, T, H, D] (no transpose, no lane padding); the
log-sum-exp residual is [B, T, H] f32.  Self-attention only (T == S), no
mask, softmax scale 1/sqrt(D).

Each wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from tml_image_editing_defense_torch.ops._lib import F, I, P, CudaKernel, require_cuda, stream_ptr

#: Head dims the CUDA kernels are compiled for (csrc: TID_FOR_EACH_HEAD_DIM).
KERNEL_HEAD_DIMS = (40, 64, 80, 512)

FLASH_FWD = CudaKernel("tid_flash_fwd", [P, P, P, P, P, I, I, I, I, I, F, P])
FLASH_BWD_KV = CudaKernel("tid_flash_bwd_kv", [P, P, P, P, P, P, P, P, I, I, I, I, I, F, P])
FLASH_BWD_Q = CudaKernel("tid_flash_bwd_q", [P, P, P, P, P, P, P, I, I, I, I, I, F, P])


# ---------------------------------------------------------------------------
# plain versions (dense f32 math; the kernels' reference)
# ---------------------------------------------------------------------------


def flash_fwd_reference(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """o = softmax(QK^T/sqrt(D)) V and lse = logsumexp rows ([B,T,H] f32),
    computed densely in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)                                  # [B,H,T]
    o = torch.einsum("bhts,bshd->bthd", torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse.permute(0, 2, 1).contiguous()


def _p_ds(q, k, v, do, lse, delta):
    """p = exp(s - lse) and dS = p (dO V^T - delta) / sqrt(D), dense f32 [B,H,T,S]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    p = torch.exp(s - lse.float().permute(0, 2, 1)[..., None])
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    return p, p * (dp - delta.float().permute(0, 2, 1)[..., None]) * scale


def flash_bwd_kv_reference(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: (dk, dv) = (dS^T Q, P^T dO)."""
    p, ds = _p_ds(q, k, v, do, lse, delta)
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_q_reference(q, k, v, do, lse, delta) -> torch.Tensor:
    """Plain version of K3: dq = dS K."""
    _, ds = _p_ds(q, k, v, do, lse, delta)
    return torch.einsum("bhts,bshd->bthd", ds, k.float()).to(q.dtype)


def flash_bwd_reference(q, k, v, o, lse, do) -> Tuple[torch.Tensor, ...]:
    """The flash-2 backward densely in f32: p = exp(s - lse),
    dS = p (dO V^T - rowsum(dO o)) / sqrt(D); returns (dq, dk, dv)."""
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = flash_bwd_kv_reference(q, k, v, do, lse, delta)
    return flash_bwd_q_reference(q, k, v, do, lse, delta), dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, q, *others):
    require_cuda(name, q, *others)
    if q.dim() != 4:
        raise ValueError(f"{name}: expected [B, T, H, D], got {tuple(q.shape)}")
    for t in others:
        if t.shape != q.shape:
            raise ValueError(f"{name}: shapes {tuple(q.shape)} and {tuple(t.shape)} differ "
                             "(self-attention only)")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} has no compiled tile plan "
                         f"(have {KERNEL_HEAD_DIMS})")


def _check_stats(name, q, *stats):
    b, t, h, _ = q.shape
    for s in stats:
        if s.dtype != torch.float32 or s.shape != (b, t, h) or not s.is_contiguous() \
                or s.device != q.device:
            raise ValueError(f"{name}: row statistics must be contiguous f32 [{b}, {t}, {h}] "
                             f"on {q.device}")


def _check_aligned(name, *tensors):
    """K1, K2 and K3 copy rows by 16-byte cp.async: every tensor must start
    on a 16-byte boundary."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must start on a 16-byte boundary")


def flash_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (o, lse).  Plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v)
    _check("flash_fwd", q, k, v)
    _check_aligned("flash_fwd", q, k, v)
    b, t, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, t, h), dtype=torch.float32, device=q.device)
    FLASH_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
              b, t, h, d, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream_ptr(q))
    return o, lse


def flash_bwd_kv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (dk, dv) from the saved lse and delta = rowsum(dO o)."""
    _check("flash_bwd_kv", q, k, v, do)
    _check_stats("flash_bwd_kv", q, lse, delta)
    _check_aligned("flash_bwd_kv", q, k, v, do)
    b, t, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    FLASH_BWD_KV(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d,
                 int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream_ptr(q))
    return dk, dv


def flash_bwd_q(q, k, v, do, lse, delta) -> torch.Tensor:
    """K3: dq from the saved lse and delta = rowsum(dO o)."""
    _check("flash_bwd_q", q, k, v, do)
    _check_stats("flash_bwd_q", q, lse, delta)
    _check_aligned("flash_bwd_q", q, k, v, do)
    b, t, h, d = q.shape
    dq = torch.empty_like(q)
    FLASH_BWD_Q(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), b, t, h, d,
                int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream_ptr(q))
    return dq


def flash_bwd(q, k, v, o, lse, do) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv): K2 then K3 on CUDA tensors, plain version on CPU."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do)
    # delta = rowsum(dO o): tiny [B,T,H] f32, a plain torch op as in the JAX _bwd
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = flash_bwd_kv(q, k, v, do, lse, delta)
    dq = flash_bwd_q(q, k, v, do, lse, delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash self-attention with the flash-2 backward; saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_bwd(q, k, v, o, lse, do.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flash self-attention over [B, T, H, D]; softmax scale 1/sqrt(D)."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous())


KERNELS = (FLASH_FWD, FLASH_BWD_KV, FLASH_BWD_Q)
