"""ISNet (briaai/RMBG-1.4), the salient-object segmenter of the masked
attack (port of ``models/isnet.py``).

The reference gates its masked PGD on RMBG-1.4's foreground mask
(``main.py:311-322``, applied on the L2 branch at ``main.py:260-261``).
RMBG-1.4 is ``BriaRMBG``, the ISNet/DIS architecture: a U^2-Net of RSU
blocks (nested U-shapes of conv + batchnorm + relu units with max-pool
encoders and bilinear-upsample decoders) and six sigmoid side heads.  The
modules are NCHW and named so that ``state_dict()`` has the real
checkpoint's keys (``tests/manifests/rmbg_isnet.json``):

- ``conv_in`` is the stride-2 stem (``myrebnconv``: children ``conv`` and
  ``bn``);
- the encoder stages ``stage1..stage6`` and decoder stages
  ``stage5d..stage1d`` are RSU blocks whose children are ``rebnconvin``,
  ``rebnconv<i>`` and ``rebnconv<i>d``, each a ``conv_s1`` + ``bn_s1`` pair;
- ``side1..side6`` are the 3x3 prediction heads.

BatchNorm runs in inference mode on its running statistics, as the JAX
``InferenceBatchNorm`` (isnet.py:78-92) computes it; the module stays in
eval mode and in f32, the only dtype the attack loads it in.  The pools
have no parameters.

:func:`salient_mask` is the RMBG pipeline around the forward: resize to the
native 1024x1024, subtract 0.5, take the first side output d1, min-max
normalize, resize back and binarize (``main.py:320-321``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tml_image_editing_defense_torch.utils.device import resolve_device, set_numerics


@dataclasses.dataclass(frozen=True)
class ISNetConfig:
    """Stage plan.  ``enc_stages`` / ``dec_stages`` entries are
    ``(kind, mid_ch, out_ch)`` with ``kind`` an int RSU height (7 means
    RSU7) or ``"F"`` for the dilated, pool-free RSU4F.  ``dec_stages`` runs
    deepest first (stage<N-1>d ... stage1d)."""

    in_channels: int = 3
    out_channels: int = 1
    stem_channels: int = 64
    enc_stages: Tuple = (
        (7, 32, 64), (6, 32, 128), (5, 64, 256),
        (4, 128, 512), ("F", 256, 512), ("F", 256, 512),
    )
    dec_stages: Tuple = (
        ("F", 256, 512), (4, 128, 256), (5, 64, 128), (6, 32, 64), (7, 16, 64),
    )
    #: native inference resolution (the RMBG pipeline resizes inputs here)
    image_size: int = 1024


#: briaai/RMBG-1.4 (ISNetDIS with the DIS defaults)
RMBG_14 = ISNetConfig()

#: test preset: the same code paths (3 stages, one an RSU4F), tiny
#: channels, 64x64 native size
TINY_ISNET = ISNetConfig(
    stem_channels=8,
    enc_stages=((3, 4, 8), (3, 4, 8), ("F", 4, 8)),
    dec_stages=(("F", 4, 8), (3, 4, 8)),
    image_size=64,
)

_PRESETS = {"rmbg": RMBG_14, "tiny": TINY_ISNET}


class REBNCONV(nn.Module):
    """conv 3x3 (with dilation) -> batchnorm -> relu, U^2-Net's unit."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _max_pool_ceil(x):
    """``nn.MaxPool2d(2, stride=2, ceil_mode=True)``: an odd trailing row or
    column is kept (isnet.py:114-118)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(src, tar):
    """Bilinear resize to ``tar``'s spatial size, half-pixel centres
    (isnet.py:121-128).  The network only ever upsamples here, where
    ``jax.image.resize`` and a plain bilinear ``F.interpolate`` agree."""
    return F.interpolate(src, size=tar.shape[-2:], mode="bilinear", align_corners=False)


class RSU(nn.Module):
    """RSU-``height``: an encoder of ``height - 1`` REBNCONVs with pools
    between, a dilated top and a skip-concat decoder, residual over the
    stage-entry ``rebnconvin``."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        setattr(self, f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, dirate=2))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", REBNCONV(2 * mid_ch, mid_ch))
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch)

    def forward(self, x):
        h = self.height
        hxin = self.rebnconvin(x)
        enc, hx = [], hxin
        for i in range(1, h):
            hx = getattr(self, f"rebnconv{i}")(hx)
            enc.append(hx)
            if i < h - 1:
                hx = _max_pool_ceil(hx)
        hx = getattr(self, f"rebnconv{h}")(hx)
        for i in range(h - 1, 0, -1):
            hx = getattr(self, f"rebnconv{i}d")(torch.cat([hx, enc[i - 1]], 1))
            if i > 1:
                hx = _upsample_like(hx, enc[i - 2])
        return hx + hxin


class RSU4F(nn.Module):
    """Pool-free RSU: dilations 1/2/4/8 up, 4/2/1 down."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        hx1 = self.rebnconv1(hxin)
        hx2 = self.rebnconv2(hx1)
        hx3 = self.rebnconv3(hx2)
        hx4 = self.rebnconv4(hx3)
        hx3d = self.rebnconv3d(torch.cat([hx4, hx3], 1))
        hx2d = self.rebnconv2d(torch.cat([hx3d, hx2], 1))
        hx1d = self.rebnconv1d(torch.cat([hx2d, hx1], 1))
        return hx1d + hxin


class MyRebnConv(nn.Module):
    """The checkpoint's ``myrebnconv`` stem (children ``conv`` / ``bn``)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 2):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1)
        self.bn = nn.BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _make_stage(spec, in_ch: int) -> nn.Module:
    kind, mid, out = spec
    if kind == "F":
        return RSU4F(in_ch, mid, out)
    return RSU(int(kind), in_ch, mid, out)


class ISNet(nn.Module):
    """BriaRMBG's forward: stride-2 stem, pooled RSU encoder, upsample-concat
    RSU decoder, six side heads upsampled to the input's size.  Returns the
    tuple ``(sigmoid(d1), ..., sigmoid(dN))``; the pipeline takes
    d1 (:meth:`saliency`)."""

    def __init__(self, config: ISNetConfig = RMBG_14):
        super().__init__()
        self.config = cfg = config
        self.conv_in = MyRebnConv(cfg.in_channels, cfg.stem_channels)
        ch, outs = cfg.stem_channels, []
        for i, spec in enumerate(cfg.enc_stages):
            setattr(self, f"stage{i + 1}", _make_stage(spec, ch))
            ch = spec[2]
            outs.append(ch)
        n = len(cfg.enc_stages)
        side_ch = [outs[-1]]                       # side N reads the deepest stage
        for j, spec in enumerate(cfg.dec_stages):
            idx = n - 1 - j                        # N-1 .. 1
            setattr(self, f"stage{idx}d", _make_stage(spec, ch + outs[idx - 1]))
            ch = spec[2]
            side_ch.append(ch)
        for i, c in enumerate(reversed(side_ch)):  # side1 reads stage1d
            setattr(self, f"side{i + 1}", nn.Conv2d(c, cfg.out_channels, 3, padding=1))

    def train(self, mode: bool = True):
        """Inference only: the module stays in eval mode, so that BatchNorm
        uses (and never updates) its running statistics."""
        return super().train(False)

    def forward(self, x):
        n = len(self.config.enc_stages)
        feats, hx = [], self.conv_in(x)
        for i in range(n):
            hx = getattr(self, f"stage{i + 1}")(hx)
            feats.append(hx)
            if i < n - 1:
                hx = _max_pool_ceil(hx)
        dec = [feats[-1]]
        for j in range(len(self.config.dec_stages)):
            idx = n - 1 - j
            skip = feats[idx - 1]
            hx = getattr(self, f"stage{idx}d")(torch.cat([_upsample_like(hx, skip), skip], 1))
            dec.append(hx)
        return tuple(torch.sigmoid(_upsample_like(getattr(self, f"side{i + 1}")(f), x))
                     for i, f in enumerate(reversed(dec)))

    def saliency(self, image):
        """``image`` NCHW in the model's normalized space -> the d1
        probability map [N, 1, H, W] in [0, 1] (isnet.py:252-262)."""
        return self(image)[0]


def _f32(dtype: Union[str, torch.dtype]) -> None:
    """Refuse any dtype but f32 (and pin f32 numerics): the attack loads
    ISNet in f32 only."""
    if set_numerics(dtype) != torch.float32:
        raise ValueError(f"ISNet runs in float32 only, got {dtype!r}")


@torch.no_grad()
def _random_init_(model: ISNet, generator: torch.Generator) -> None:
    """The JAX ``_fast_random_params`` rule (model_zoo.py:205-230): conv
    weights normal over sqrt(fan-in), biases and running means zero,
    BatchNorm scales and running variances one.  A normal draw for the
    variance would NaN the mask."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = math.prod(m.weight.shape[1:])
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()                   # weight 1, bias 0, running stats 0 / 1


def build_isnet(
    preset: str = "rmbg",
    device: Union[str, torch.device, None] = "cuda",
    dtype: Union[str, torch.dtype] = "float32",
    generator: Optional[torch.Generator] = None,
) -> ISNet:
    """ISNet at ``preset`` ("rmbg" | "tiny") with random weights made on
    ``device`` from ``generator`` (default: seed 0).  ``device="meta"``
    builds the module without memory (shape checks).  f32 only."""
    if preset not in _PRESETS:
        raise ValueError(f"unknown isnet preset {preset!r}; have {sorted(_PRESETS)}")
    device = resolve_device(device)
    _f32(dtype)
    with torch.device("meta"):
        model = ISNet(_PRESETS[preset])
    if device.type == "meta":
        return model.requires_grad_(False).eval()
    model.to_empty(device=device)
    _random_init_(model, generator or torch.Generator(device=device).manual_seed(0))
    return model.requires_grad_(False).eval()


def load_rmbg_checkpoint(
    model_dir,
    device: Union[str, torch.device, None] = "cuda",
    dtype: Union[str, torch.dtype] = "float32",
) -> ISNet:
    """Load a ``briaai/RMBG-1.4`` directory: every ``*.safetensors`` inside,
    read with :func:`~tml_image_editing_defense_torch.models.convert.load_safetensors`
    (isnet.py:293-312).  Every model key must be there (``KeyError``
    otherwise); the checkpoint's BatchNorm ``num_batches_tracked`` counters
    are taken when present, and other extra keys are ignored, as the JAX
    converter ignores them.  A directory without one raises
    ``FileNotFoundError``.  f32 only."""
    from tml_image_editing_defense_torch.models.convert import load_safetensors_dir

    state = load_safetensors_dir(model_dir)
    device = resolve_device(device)
    _f32(dtype)
    with torch.device("meta"):
        model = ISNet(RMBG_14)
    wanted = model.state_dict()
    missing = sorted(k for k in wanted if k not in state and not k.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"{len(missing)} model keys missing from {model_dir}, e.g. {missing[:5]}")
    loaded = {k: state[k] if k in state else torch.zeros((), dtype=torch.int64) for k in wanted}
    model.load_state_dict(loaded, strict=True, assign=True)
    return model.to(device=device, dtype=torch.float32).requires_grad_(False).eval()


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")``: half-pixel centres, and an
    antialiasing triangle filter where it shrinks."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


@torch.no_grad()
def salient_mask(
    model: ISNet,
    image01: np.ndarray,
    out_size: int,
    threshold: float = 0.5,
) -> np.ndarray:
    """The RMBG pipeline's pre- and post-processing around the forward
    (isnet.py:324-346), on the model's device.

    ``image01``: HWC float array in [0, 1] at any size.  Resizes it to the
    model's native size, subtracts 0.5 (mean 0.5, std 1), takes d1, min-max
    normalizes it (the range floored at 1e-8), resizes to ``out_size`` and
    binarizes at ``threshold`` (main.py:320-321).  Both resizes antialias
    as ``jax.image.resize`` does.  Returns a float32 {0, 1} numpy array
    [out_size, out_size]."""
    p = next(model.parameters())
    x = torch.as_tensor(np.asarray(image01, np.float32)).permute(2, 0, 1)[None].to(p.device)
    x = _resize(x, model.config.image_size) - 0.5
    d1 = model.saliency(x)
    lo, hi = d1.min(), d1.max()
    d1 = (d1 - lo) / torch.clamp(hi - lo, min=1e-8)
    m = _resize(d1, out_size)
    return (m[0, 0] > threshold).float().cpu().numpy()
