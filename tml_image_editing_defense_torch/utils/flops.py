"""Model-FLOP counting and MFU (port of ``utils/flops.py``).

"Useful model FLOPs" are the convolutions' and matrix products' multiply-
adds of a forward, 2 per multiply-accumulate, counted by
``torch.utils.flop_counter.FlopCounterMode`` from the operators a forward
dispatches, as the JAX package counts ``conv_general_dilated`` and
``dot_general`` in the traced jaxpr.  Count on the ``meta`` device (no
memory, no arithmetic) or the CPU, with the plain attention: the flash
kernels are foreign calls the counter does not see.  Backward passes count
as 2x the forward (the PGD attack differentiates the image only: one
forward-sized contraction chain), and a remat policy's recompute is not
counted: MFU measures useful work, so remat shows as a lower MFU.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch.utils.flop_counter import FlopCounterMode

#: Peak dense FLOP/s by device-name substring and compute dtype (NVIDIA's
#: H100 SXM data sheet: bf16 and fp16 on the tensor cores, f32 on the CUDA
#: cores, the rate the port's f32 path runs at with TF32 off).
PEAK_FLOPS = {
    "h100": {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12},
}


def device_peak_flops(device=None, dtype: Union[str, torch.dtype] = torch.bfloat16
                      ) -> Optional[float]:
    """Peak dense FLOP/s of ``device`` (default: the current CUDA device)
    for ``dtype``, or None on the CPU and on unknown hardware."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peaks in PEAK_FLOPS.items():
        if key in name:
            return peaks.get(dtype)
    return None


def count_fn_flops(fn: Callable, *args, **kwargs) -> int:
    """Forward model FLOPs of ``fn(*args, **kwargs)``: every convolution and
    matrix product it dispatches, run under no_grad (on ``meta`` tensors
    nothing is computed)."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def diffusion_model_flops(family: str, image_size: int, unet_batch: int = 2) -> Dict[str, int]:
    """Forward FLOPs of one UNet call at batch ``unet_batch`` (2: a CFG
    pair), one VAE encode and one VAE decode of a single image, for
    ``family`` at ``image_size``, counted on a ``meta`` build with the
    plain attention (no weights, no memory)."""
    from tml_image_editing_defense_torch.attack.forward import make_time_ids
    from tml_image_editing_defense_torch.models.model_zoo import build_model

    model = build_model(family, image_size=image_size, device="meta", attn_kv_chunk=None)
    _, c, h, w = model.latent_shape
    ucfg = model.unet.config
    sample = torch.zeros((unet_batch, ucfg.in_channels, h, w), device="meta")
    seq = model.tokenizers[0].model_max_length
    ctx = torch.zeros((unet_batch, seq, ucfg.cross_attention_dim), device="meta")
    extra = {}
    if ucfg.addition_embed_type == "text_time":
        pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
        extra = dict(text_embeds=torch.zeros((unet_batch, pooled), device="meta"),
                     time_ids=make_time_ids(image_size, device="meta").repeat(unet_batch // 2, 1))
    image = torch.zeros((1, 3, image_size, image_size), device="meta")
    latent = torch.zeros((1, c, h, w), device="meta")
    return {
        "unet": count_fn_flops(model.unet, sample, 500, ctx, **extra),
        "vae_encode": count_fn_flops(model.vae.encode, image),
        "vae_decode": count_fn_flops(model.vae.decode, latent),
    }


def training_flops(forward_flops: int) -> int:
    """Forward and backward FLOPs when differentiating with respect to the
    weights and the inputs: the backward is about 2x the forward."""
    return 3 * forward_flops


def input_grad_flops(forward_flops: int) -> int:
    """Forward and backward FLOPs when differentiating with respect to the
    input only, the PGD regime (reference ``torch.autograd.grad(loss,
    [cur_image])``, main.py:176): the weights need no gradient, so the
    backward is one forward-sized contraction chain, 2x the forward in all."""
    return 2 * forward_flops


def mfu(model_flops: float, seconds: float, device=None,
        dtype: Union[str, torch.dtype] = torch.bfloat16) -> Optional[float]:
    """Model-FLOPs utilization in [0, 1] against the peak for ``dtype``, or
    None where the peak is unknown (the CPU)."""
    peak = device_peak_flops(device, dtype)
    if peak is None or seconds <= 0:
        return None
    return model_flops / seconds / peak


def pgd_step_model_flops(
    unet_fwd: int,
    vae_encode_fwd: int,
    vae_decode_fwd: int,
    grad_reps: int,
    image_loss: bool,
    vis_decode: bool = False,
) -> int:
    """Useful FLOPs of one PGD iteration (the structure of attack/pgd.py):

    - per rep: the K-step CFG UNet chain (``unet_fwd`` includes the K steps
      and the CFG batch) forward and backward, and a VAE decode forward and
      backward when the loss needs pixels;
    - once per iteration: the shared VAE encode and its backward, and one
      visualization decode (forward only) with ``vis_decode``.

    Every backward is input-gradient only (2x forward), whatever
    ``eot_chunk`` batches together and whatever the remat policies
    recompute."""
    per_rep = input_grad_flops(unet_fwd)
    if image_loss:
        per_rep += input_grad_flops(vae_decode_fwd)
    return (grad_reps * per_rep + input_grad_flops(vae_encode_fwd)
            + (vae_decode_fwd if vis_decode else 0))
