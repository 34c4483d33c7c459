"""AutoencoderTiny (TAESD / taesdxl), the universal attack's preview decoder
(port of ``models/tiny_vae.py``), NCHW.

The reference's universal-perturbation trainer decodes its 1-step-edited
latents through ``AutoencoderTiny.from_pretrained("madebyollin/taesdxl")``
inside the gradient path (``old/train_noise.py:82`` builds it, ``:151``
decodes with it); the tiny decoder costs far less than the full
``AutoencoderKL`` decoder in every EOT rep.

Module names give diffusers' ``AutoencoderTiny`` state-dict keys
(``encoder.layers.<i>...``, ``decoder.layers.<i>.conv.<0|2|4>...``,
``skip``): the ``nn.Sequential`` indices are kept, and the parameter-free
ReLU and Upsample entries take an index as in diffusers.  Conventions:

- a block is ``relu(conv3(x) + skip(x))``, ``conv3`` = conv-relu-conv-relu-
  conv (indices 0/2/4), ``skip`` a bias-free 1x1 conv only when the channel
  counts differ (identity in every real TAESD block);
- the encoder rescales its input from [-1, 1] to [0, 1]; its stage-entry
  convs are stride-2 and bias-free, all but the first;
- the decoder clamps incoming latents with ``tanh(z/3)*3``, upsamples by
  nearest neighbour, has bias-free stage-exit convs except the final RGB
  conv, and rescales its [0, 1] output to [-1, 1];
- ``scaling_factor`` is 1.0: TAESD reads and writes latents in the UNet's
  scaled space.

:func:`build_tiny_autoencoder` makes random weights from a
``torch.Generator``; :func:`load_taesd_checkpoint` reads a real
``madebyollin/taesd[xl]`` directory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tml_image_editing_defense_torch.utils.device import resolve_device, set_numerics


@dataclasses.dataclass(frozen=True)
class TinyVAEConfig:
    """The ``madebyollin/taesd[xl]`` AutoencoderTiny config (taesd and
    taesdxl share the architecture; only the weights differ)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    encoder_block_out_channels: Tuple[int, ...] = (64, 64, 64, 64)
    decoder_block_out_channels: Tuple[int, ...] = (64, 64, 64, 64)
    num_encoder_blocks: Tuple[int, ...] = (1, 3, 3, 3)
    num_decoder_blocks: Tuple[int, ...] = (3, 3, 3, 1)
    upsampling_factor: int = 2
    #: decoder input clamp half-range: ``tanh(z / m) * m``
    latent_magnitude: float = 3.0
    #: latents are already in the UNet's scaled space
    scaling_factor: float = 1.0


TAESD = TinyVAEConfig()
#: small preset for CPU tests: the same code paths, equal channels per stage
TINY_TAESD = TinyVAEConfig(
    encoder_block_out_channels=(8, 8),
    decoder_block_out_channels=(8, 8),
    num_encoder_blocks=(1, 1),
    num_decoder_blocks=(1, 1),
)

_PRESETS = {"taesd": TAESD, "taesdxl": TAESD, "tiny": TINY_TAESD}


def _conv3(cin: int, cout: int, stride: int = 1, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


class TinyBlock(nn.Module):
    """``AutoencoderTinyBlock``: relu(conv-relu-conv-relu-conv + skip)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Sequential(_conv3(in_channels, out_channels), nn.ReLU(),
                                  _conv3(out_channels, out_channels), nn.ReLU(),
                                  _conv3(out_channels, out_channels))
        self.skip = (nn.Conv2d(in_channels, out_channels, 1, bias=False)
                     if in_channels != out_channels else nn.Identity())

    def forward(self, x):
        return F.relu(self.conv(x) + self.skip(x))


class TinyEncoder(nn.Module):
    """``EncoderTiny``: [-1,1] -> [0,1], conv/block stages with stride-2
    entries, a final conv to the latent channels."""

    def __init__(self, cfg: TinyVAEConfig):
        super().__init__()
        layers, prev = [], cfg.in_channels
        for i, n_blocks in enumerate(cfg.num_encoder_blocks):
            ch = cfg.encoder_block_out_channels[i]
            layers.append(_conv3(prev, ch) if i == 0 else _conv3(prev, ch, stride=2, bias=False))
            layers += [TinyBlock(ch, ch) for _ in range(n_blocks)]
            prev = ch
        layers.append(_conv3(prev, cfg.latent_channels))
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers((x + 1.0) / 2.0)


class TinyDecoder(nn.Module):
    """``DecoderTiny``: tanh clamp, conv + relu stem, block / upsample /
    conv stages, [0,1] -> [-1,1]."""

    def __init__(self, cfg: TinyVAEConfig):
        super().__init__()
        self.latent_magnitude = cfg.latent_magnitude
        boc = cfg.decoder_block_out_channels
        layers = [_conv3(cfg.latent_channels, boc[0]), nn.ReLU()]
        n_stages = len(cfg.num_decoder_blocks)
        for i, n_blocks in enumerate(cfg.num_decoder_blocks):
            is_final = i == n_stages - 1
            ch = boc[i]
            layers += [TinyBlock(ch, ch) for _ in range(n_blocks)]
            if not is_final:
                layers.append(nn.Upsample(scale_factor=cfg.upsampling_factor, mode="nearest"))
            layers.append(_conv3(ch, cfg.out_channels if is_final else ch, bias=is_final))
        self.layers = nn.Sequential(*layers)

    def forward(self, z):
        m = self.latent_magnitude
        return self.layers(torch.tanh(z / m) * m) * 2.0 - 1.0


class AutoencoderTiny(nn.Module):
    """Deterministic tiny autoencoder: ``encode`` returns the latents
    themselves (no posterior), as diffusers' ``AutoencoderTiny.encode``."""

    def __init__(self, config: TinyVAEConfig):
        super().__init__()
        self.config = config
        self.encoder = TinyEncoder(config)
        self.decoder = TinyDecoder(config)

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """Image NCHW in [-1, 1] -> latents in the UNet's scaled space."""
        return self.encoder(image)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled-space latents -> image NCHW in [-1, 1] (the reference's
        preview decode, old/train_noise.py:151)."""
        return self.decoder(z)

    def forward(self, image):
        return self.decode(self.encode(image))


#: the JAX package's bundle of module and parameters is the module itself here
TinyAutoencoder = AutoencoderTiny


def build_tiny_autoencoder(
    preset: str = "taesd",
    device: Union[str, torch.device, None] = "cuda",
    dtype: Union[str, torch.dtype] = "float32",
    generator: Optional[torch.Generator] = None,
) -> AutoencoderTiny:
    """The preview autoencoder with random weights made on ``device`` from
    ``generator`` (the rule of ``model_zoo.random_init_``), built on
    ``meta`` first; ``device="meta"`` leaves it without memory."""
    from tml_image_editing_defense_torch.models.model_zoo import random_init_

    if preset not in _PRESETS:
        raise ValueError(f"unknown tiny-vae preset {preset!r}; have {sorted(_PRESETS)}")
    device = resolve_device(device)
    dtype = set_numerics(dtype)
    with torch.device("meta"):
        module = AutoencoderTiny(_PRESETS[preset])
    if device.type != "meta":
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        module.to_empty(device=device)
        module.to(dtype)
        random_init_(module, generator)
    module.requires_grad_(False)
    return module.eval()


def load_taesd_checkpoint(
    model_dir,
    dtype: Union[str, torch.dtype] = "float32",
    device: Union[str, torch.device, None] = "cuda",
) -> AutoencoderTiny:
    """Load a ``madebyollin/taesd[xl]`` diffusers directory (the reference's
    ``AutoencoderTiny.from_pretrained``, old/train_noise.py:82; JAX
    tiny_vae.py:230-250): every ``*.safetensors`` under ``model_dir`` into
    the ``"taesd"`` preset, every key required (``load_state(strict=True)``,
    the 134 keys of tests/manifests/taesd_vae.json).  A directory without
    one raises ``FileNotFoundError``."""
    from tml_image_editing_defense_torch.models.convert import load_safetensors_dir, load_state

    state = load_safetensors_dir(model_dir)
    module = build_tiny_autoencoder("taesd", device="meta")
    module.to_empty(device=resolve_device(device)).to(set_numerics(dtype))
    return load_state(module, state, strict=True)
