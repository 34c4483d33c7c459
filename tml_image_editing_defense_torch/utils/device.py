"""Device choice and numerics, in one place.

Entry points run on the card unless the caller passes ``device="cpu"`` (the
tests do).  Without CUDA they raise: they never carry on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda") -> torch.device:
    """The device to run on; ``None`` means the card.  Raises when CUDA is
    asked for and absent.  Among several ranks, ``"cuda"`` is the rank's
    own card, ``cuda:{LOCAL_RANK}``: ``parallel.mesh.init_distributed``
    makes it the current device."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    return device


def set_numerics(dtype: Union[str, torch.dtype] = "float32") -> torch.dtype:
    """Resolve the compute dtype and pin the matmul/convolution precision.

    f32 must mean f32: cuDNN runs f32 convolutions in TF32 unless told not
    to, so both TF32 switches are turned off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return DTYPES[dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}; have {sorted(DTYPES)}") from None


def numerics_summary() -> dict:
    """The precision switches as they stand (chip_smoke prints them)."""
    return {
        "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
