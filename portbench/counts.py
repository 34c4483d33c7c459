"""The work of one PGD image-iteration, counted on the benchmark's frozen
reference (``portbench/reference``) built on ``meta`` at the cell's shapes,
never on the program's modules, so that a change to the program leaves the
yardstick where it was.

- Useful FLOPs: the forward convolutions and matrix products (attention's
  too), 2 per multiply-accumulate, as ``FlopCounterMode`` counts them, and
  the backward with respect to the activations counted as one more forward
  (no weight gradients; attention's backward, two forwards' worth, is
  counted as one, so the count errs low); nothing recomputed is counted.
  Per image-iteration: the encode, and per rep the K CFG UNet calls and
  (for a loss on pixels) the decode, each with its backward.
- Long self-attention: every self-attention over at least
  :data:`LONG_TOKENS` tokens, with its least time on the device: forward 2
  products of [T x S x D] per row and head, backward 4 (dV, dP, dQ, dK, no
  recompute); bytes as each input read once and each output written once
  (forward q, k, v in and o out; backward q, k, v, dO in and dQ, dK, dV
  out); the larger of operations over peak FLOP/s and bytes over peak
  bandwidth.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import models as ref
from portbench.reference.attack import lcm_plan

#: self-attention over at least this many tokens counts as long
LONG_TOKENS = 2048

#: NVIDIA H100 SXM data sheet: dense FLOP/s by dtype (f32 on the CUDA cores,
#: as the program runs it with TF32 off), and HBM3 bandwidth
PEAKS = {"H100": {"flops": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12},
                  "bytes_per_s": 3.35e12}}


def peak(device_kind: str, dtype: str) -> Optional[dict]:
    """``{"flops", "bytes_per_s"}`` of the card named ``device_kind`` at
    ``dtype``, or None for a card the table does not know."""
    for key, p in PEAKS.items():
        if key in device_kind and dtype in p["flops"]:
            return {"flops": p["flops"][dtype], "bytes_per_s": p["bytes_per_s"]}
    return None


def meta_models(config: dict):
    """The reference UNet and VAE of ``config`` on ``meta``."""
    with torch.device("meta"):
        return ref.UNet(config["unet"]), ref.VAE(config["vae"])


def _forward(fn, *args):
    """(FLOPs, attention calls) of ``fn(*args)`` on meta tensors."""
    log = []
    ref.NUMERICS.attention_log = log
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
    finally:
        ref.NUMERICS.attention_log = None
    return int(counter.get_total_flops()), log


def unit_work(config: dict, traffic: dict) -> dict:
    """Per image-iteration: ``flops`` (useful), ``long_attention`` (a list of
    (batch, T, S, H, D) forward calls, each also run backward)."""
    unet, vae = meta_models(config)
    size, train = traffic["image_size"], traffic["train"]
    lat = config["vae"]["latent_channels"]
    h = size // 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    text = config["text"]
    meta = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    kw = {}
    if config["unet"].get("addition_embed_type") == "text_time":
        kw = dict(text_embeds=meta(2, text["pooled_width"]), time_ids=meta(2, 6))
    unet_f, unet_a = _forward(lambda: unet(meta(2, lat, h, h), 500,
                                           meta(2, text["tokens"], text["width"]), **kw))
    enc_f, enc_a = _forward(lambda: vae.encode(meta(1, 3, size, size)))
    dec_f, dec_a = _forward(lambda: vae.decode(meta(1, lat, h, h)))
    steps = len(lcm_plan(train["n_denoising_steps_per_iteration"],
                         700 if train.get("limit_timesteps", True) else None).timesteps)
    pixels = train["apply_loss_on_images"] or train["perturbation_loss_lambda"] > 0
    reps = train["grad_reps"]
    per_rep = steps * unet_f + (dec_f if pixels else 0)
    calls = enc_a + reps * (steps * unet_a + (dec_a if pixels else []))
    return {"flops": 2 * (enc_f + reps * per_rep),
            "long_attention": [c for c in calls if c[1] == c[2] and c[1] >= LONG_TOKENS]}


def attention_bound_s(calls, dtype_bytes: int, pk: dict) -> float:
    """Least device seconds of ``calls`` forward and backward."""
    total = 0.0
    for b, t, s, h, d in calls:
        prod = 2 * b * h * t * s * d                 # one [T x S x D] product per row, head
        q_bytes, kv_bytes = b * t * h * d * dtype_bytes, b * s * h * d * dtype_bytes
        fwd = max(2 * prod / pk["flops"], (2 * q_bytes + 2 * kv_bytes) / pk["bytes_per_s"])
        bwd = max(4 * prod / pk["flops"], (3 * q_bytes + 4 * kv_bytes) / pk["bytes_per_s"])
        total += fwd + bwd
    return total
