"""Group normalisation with the SiLU that follows it: the CUDA kernels of
``csrc/group_norm.cu`` (one C entry forward, one backward, two kernels
each), the ``autograd.Function`` that ties them together, and
:func:`group_norm`, which the models call at every group norm.

Counterpart of no TPU kernel: the JAX package leaves ``GroupNorm`` and the
SiLU after it to XLA.  Layout NCHW, f32 or bf16, statistics computed in
f32.

:func:`group_norm` launches the kernels (route "kernel") for every CUDA
tensor, and refuses one that they cannot take: a dtype other than f32 or
bf16, or a norm whose weight or bias would need a gradient (the kernels
give none; the port's networks are frozen).  Tensors off the card run
PyTorch's own ``F.group_norm`` (and ``F.silu``), route "plain".
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tml_image_editing_defense_torch.ops._lib import F as CF
from tml_image_editing_defense_torch.ops._lib import I, L, P, CudaKernel, require_cuda, stream_ptr
from tml_image_editing_defense_torch.utils import profiling

GROUP_NORM_FWD = CudaKernel("tid_group_norm_fwd",
                            [P, P, P, P, P, P, L, I, I, I, I, I, I, I, I, CF, P])
GROUP_NORM_BWD = CudaKernel("tid_group_norm_bwd",
                            [P, P, P, P, P, P, P, L, I, I, I, I, I, I, I, I, P])

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: A chunk of a row is a whole number of these elements: 256 threads
#: (``kThreads`` in ``csrc/group_norm.cu``) times the widest vector, 8 bf16;
#: and at least MIN_CHUNK, the four vectors a thread loads at once (on an
#: H100 shorter chunks took 15-40 % longer at SD-1.5's and SDXL's UNet
#: shapes, and 4 waves 2-4 % less time than 2 at the VAE decoders')
CHUNK_ALIGN, MIN_CHUNK = 2048, 8192
#: Blocks of 256 threads an SM holds at once, and the waves of them a grid
#: should reach: the chunks of a row are as many as fill the card this often.
BLOCKS_PER_SM, WAVES = 8, 4
#: The kernels index a row with 32-bit integers.
MAX_ROW_LEN = 1 << 30


def chunk_plan(rows: int, row_len: int, sms: int) -> Tuple[int, int]:
    """(chunk, chunks): each of ``rows`` rows of ``row_len`` elements cut
    into ``chunks`` chunks of ``chunk`` elements (a multiple of
    ``CHUNK_ALIGN``, the last one ragged): the longest chunks that still
    give the grid of ``rows * chunks`` blocks ``WAVES`` waves over ``sms``
    SMs, but no shorter than ``MIN_CHUNK``."""
    want = -(-WAVES * BLOCKS_PER_SM * sms // rows)
    chunk = max(MIN_CHUNK, row_len // want // CHUNK_ALIGN * CHUNK_ALIGN)
    return chunk, -(-row_len // chunk)


# ---------------------------------------------------------------------------
# the plain route
# ---------------------------------------------------------------------------


def group_norm_plain(x: torch.Tensor, norm: nn.GroupNorm, silu: bool) -> torch.Tensor:
    """PyTorch's own group norm, then its SiLU where ``silu``: the route
    "plain", off the card."""
    y = F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)
    return F.silu(y) if silu else y


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _geometry(name, x, groups: int):
    """(rows, row_len, hw, cpg, chunk, chunks) of ``x`` [N, C, H, W]."""
    if x.dim() != 4 or x.shape[1] % groups:
        raise ValueError(f"{name}: expected [N, C, H, W] with C divisible by {groups} groups, "
                         f"got {tuple(x.shape)}")
    n, c, h, w = x.shape
    rows, cpg, hw = n * groups, c // groups, h * w
    if cpg * hw > MAX_ROW_LEN:
        raise ValueError(f"{name}: a group of {cpg * hw} elements is over {MAX_ROW_LEN}")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunk, chunks = chunk_plan(rows, cpg * hw, sms)
    if rows * chunks >= 1 << 31:
        raise ValueError(f"{name}: {rows * chunks} blocks do not fit one grid")
    return rows, cpg * hw, hw, cpg, chunk, chunks


def _check_params(name, x, weight, bias):
    require_cuda(name, x, weight, bias, dtypes=KERNEL_DTYPES)
    if weight.shape != (x.shape[1],) or bias.shape != (x.shape[1],):
        raise ValueError(f"{name}: weight and bias must be [{x.shape[1]}], got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")


def group_norm_fwd(x, weight, bias, groups: int, eps: float,
                   silu: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels: (z, the rows' (mean, rstd) [N * G, 2] f32)."""
    _check_params("group_norm_fwd", x, weight, bias)
    rows, row_len, hw, cpg, chunk, chunks = _geometry("group_norm_fwd", x, groups)
    out = torch.empty_like(x)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    if x.numel():
        partials = torch.empty((rows * chunks, 2), dtype=torch.float32, device=x.device)
        GROUP_NORM_FWD(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), partials.data_ptr(),
                       stats.data_ptr(), out.data_ptr(), rows, row_len, hw, groups, cpg, chunk,
                       chunks, int(x.dtype == torch.bfloat16), int(silu), float(eps),
                       stream_ptr(x))
    return out, stats


def group_norm_bwd(dz, x, weight, bias, stats, groups: int, silu: bool) -> torch.Tensor:
    """The backward kernels: dx from dz and the forward's (mean, rstd)."""
    _check_params("group_norm_bwd", x, weight, bias)
    require_cuda("group_norm_bwd", x, dz, dtypes=KERNEL_DTYPES)
    if dz.shape != x.shape:
        raise ValueError(f"group_norm_bwd: dz {tuple(dz.shape)} and x {tuple(x.shape)} differ")
    rows, row_len, hw, cpg, chunk, chunks = _geometry("group_norm_bwd", x, groups)
    if stats.dtype != torch.float32 or stats.shape != (rows, 2) or not stats.is_contiguous() \
            or stats.device != x.device:
        raise ValueError(f"group_norm_bwd: stats must be contiguous f32 [{rows}, 2] on {x.device}")
    dx = torch.empty_like(x)
    if x.numel():
        partials = torch.empty((rows * chunks, 2), dtype=torch.float32, device=x.device)
        GROUP_NORM_BWD(x.data_ptr(), dz.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                       stats.data_ptr(), partials.data_ptr(), dx.data_ptr(), rows, row_len, hw,
                       groups, cpg, chunk, chunks, int(x.dtype == torch.bfloat16), int(silu),
                       stream_ptr(x))
    return dx


class GroupNormSiLU(torch.autograd.Function):
    """Group norm with an optional SiLU; saves x and the rows' (mean, rstd)
    only, neither the norm's output nor the activation's input.  No gradient
    for the weight and bias."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int, eps: float, silu: bool):
        z, stats = group_norm_fwd(x, weight, bias, groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.groups, ctx.silu = groups, silu
        return z

    @staticmethod
    def backward(ctx, dz):
        x, weight, bias, stats = ctx.saved_tensors
        dx = group_norm_bwd(dz.contiguous(), x, weight, bias, stats, ctx.groups, ctx.silu)
        return dx, None, None, None, None, None


def group_norm_route(x: torch.Tensor, norm: nn.GroupNorm) -> str:
    """Which version :func:`group_norm` runs, from what the call shows:
    "kernel" for a CUDA tensor, "plain" for a tensor off the card.  Raises
    for a CUDA call the kernels cannot take: a dtype other than f32 or
    bf16, a norm without weight or bias, or one whose weight or bias needs a
    gradient while autograd records."""
    if x.device.type != "cuda":
        return "plain"
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"group_norm: the kernels take f32 or bf16 on the card, got {x.dtype}")
    if norm.weight is None or norm.bias is None:
        raise ValueError("group_norm: the kernels need the norm's weight and bias")
    if torch.is_grad_enabled() and (norm.weight.requires_grad or norm.bias.requires_grad):
        raise ValueError("group_norm: the kernels give no gradient for the norm's weight and "
                         "bias; freeze them (requires_grad_(False)) or run under no_grad")
    return "kernel"


def group_norm(x: torch.Tensor, norm: nn.GroupNorm, silu: bool) -> torch.Tensor:
    """``norm(x)``, then SiLU where ``silu``, by :func:`group_norm_route`;
    counted as ``group_norm.<route>``."""
    route = group_norm_route(x, norm)
    profiling.count(f"group_norm.{route}")
    if route == "kernel":
        return GroupNormSiLU.apply(x.contiguous(), norm.weight.to(x.dtype), norm.bias.to(x.dtype),
                                   norm.num_groups, norm.eps, silu)
    return group_norm_plain(x, norm, silu)


KERNELS = (GROUP_NORM_FWD, GROUP_NORM_BWD)
