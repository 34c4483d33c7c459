"""LoRA fusion into the UNet's weights (port of ``models/lora.py``).

The reference fuses LCM-LoRA into the UNet at load time
(``pipeline.load_lora_weights(...); pipeline.fuse_lora()``,
``main.py:292-295, 305-308``), so the attack's graph never sees adapters.
Here the fusion is ``W' = W + scale·(alpha/r)·(B·A)`` on the port's modules,
in torch layout (Linear ``[out, in]``, conv OIHW), in place.

Key layouts, as the JAX package reads them:
- PEFT / diffusers: ``unet.<module>.lora_A.weight`` / ``lora_B.weight``;
- legacy diffusers: ``<module>.lora.down.weight`` / ``lora.up.weight``;
- ``<module>.lora_down.weight`` / ``lora_up.weight``;
each with an optional ``<module>.alpha`` (scaled as alpha/rank).  The
``unet.`` and ``lora_unet_`` prefixes are stripped; a kohya-style name
(``lora_unet_down_blocks_0_...``) keeps its underscores, as in the JAX
package, and so matches no module.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn as nn

_DOWN_PATTERNS = (".lora_A.weight", ".lora.down.weight", ".lora_down.weight")
_UP_FOR_DOWN = {
    ".lora_A.weight": ".lora_B.weight",
    ".lora.down.weight": ".lora.up.weight",
    ".lora_down.weight": ".lora_up.weight",
}


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def collect_lora_pairs(
    state: Mapping[str, object],
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, float]]:
    """{diffusers module key -> (A [r, in...], B [out, r...], alpha/r or 1)}
    (JAX ``collect_lora_pairs``, lora.py:33-53)."""
    pairs = {}
    for key in state:
        for down_pat in _DOWN_PATTERNS:
            if key.endswith(down_pat):
                module = key[: -len(down_pat)]
                up_key = module + _UP_FOR_DOWN[down_pat]
                if up_key not in state:
                    continue
                a, b = _as_tensor(state[key]), _as_tensor(state[up_key])
                scale = 1.0
                alpha_key = module + ".alpha"
                if alpha_key in state:
                    scale = float(_as_tensor(state[alpha_key])) / a.shape[0]
                module = module.removeprefix("unet.").removeprefix("lora_unet_")
                pairs[module] = (a, b, scale)
    return pairs


def _lora_delta(a: torch.Tensor, b: torch.Tensor, weight_ndim: int) -> torch.Tensor:
    """The adapter's delta in torch layout (JAX ``_lora_delta``,
    lora.py:56-81, before its transpose to flax layout).

    Linear ``[out, in]``: ``B @ A``; factors stored conv-style for a 1x1
    projection are flattened.  Conv OIHW: ``einsum("or,rikl->oikl")`` of B
    ``[out, r(,1,1)]`` and A ``[r, in, kh, kw]``; an A stored as a matrix is
    a 1x1 kernel.  Computed in the factors' dtype."""
    if weight_ndim == 2:
        if a.ndim == 4:
            a = a.reshape(a.shape[0], -1)
        if b.ndim == 4:
            b = b.reshape(b.shape[0], -1)
        return b @ a
    if weight_ndim == 4:
        if a.ndim == 2:
            a = a[:, :, None, None]
        return torch.einsum("or,rikl->oikl", b.reshape(b.shape[0], b.shape[1]), a)
    raise ValueError(f"unsupported weight ndim {weight_ndim}")


@torch.no_grad()
def fuse_lora(unet: nn.Module, lora_state: Mapping[str, object], scale: float = 1.0,
              strict: bool = True) -> nn.Module:
    """Fuse LoRA deltas into every matching Linear and Conv weight of
    ``unet``, in place (JAX ``fuse_lora``, lora.py:84-122):
    ``W' = W + scale·(alpha/r)·Δ``, with Δ computed on W's device, rounded
    to the factors' dtype and cast to W's dtype first, as the JAX package
    casts it.

    LCM-LoRA files carry adapters on the attention projections and on
    conv1 / conv2 / conv_shortcut, the samplers' convs and proj_in /
    proj_out.  ``strict`` (default) raises ``KeyError`` on any adapter that
    matches no module, before any weight changes: a partly fused UNet is
    numerically wrong.  Returns ``unet``."""
    pairs = collect_lora_pairs(lora_state)
    targets = {name: module for name, module in unet.named_modules()
               if name in pairs and isinstance(module, (nn.Linear, nn.Conv2d))}
    unused = set(pairs) - set(targets)
    if unused and strict:          # before any weight moves
        raise KeyError(f"{len(unused)} LoRA modules not matched, e.g. {sorted(unused)[:5]}")
    if unused:
        print(f"[lora] warning: {len(unused)} LoRA modules unmatched "
              f"(e.g. {sorted(unused)[:3]})", flush=True)
    for name, module in targets.items():
        a, b, s = pairs[name]
        w = module.weight
        # the JAX package computes the delta in the factors' dtype; here it is
        # computed in f32 and rounded to that dtype once, on every device
        delta = _lora_delta(a.to(w.device, torch.float32), b.to(w.device, torch.float32),
                            w.ndim).to(a.dtype).to(w.dtype)
        if tuple(delta.shape) != tuple(w.shape):
            raise ValueError(f"LoRA delta for {name} has shape {tuple(delta.shape)}, the weight "
                             f"{tuple(w.shape)}")
        w.copy_(w + scale * s * delta)
    return unet
