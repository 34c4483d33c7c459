"""What the benchmark makes from ``--seed`` and hands to the program and to
the reference alike: the weights, the images, the prompt bank, the noise
pool and every iteration's draws.

Each kind of draw has its own stream, a ``torch.Generator`` on the device
seeded from (seed, stream, index...) through numpy's ``SeedSequence``, so
the same seed gives the same numbers in any order of use, and the reference
can draw them again after the window.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn

WEIGHTS, IMAGES, BANK, POOL, DRAWS, CHECK = range(1, 7)


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed from ``seed`` and the stream ``tags``."""
    state = np.random.SeedSequence([int(seed) % 2**64, *tags]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def seeded_weights(modules: Dict[str, nn.Module], seed: int, device, dtype
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A state dict for each module (diffusers names, from the modules'
    own ``state_dict`` on any device, ``meta`` included), drawn in one call
    on ``device`` in ``dtype``: matrices and kernels N(0, 1 / fan_in),
    biases N(0, 0.02^2), norm scales 1 + N(0, 0.1^2).  The tensors are views
    of one buffer."""
    shapes = {name: [(k, tuple(v.shape)) for k, v in m.state_dict().items()]
              for name, m in modules.items()}
    total = sum(math.prod(s) for entries in shapes.values() for _, s in entries)
    buf = torch.randn(total, generator=generator(device, seed, WEIGHTS), device=device,
                      dtype=dtype)
    out, o = {}, 0
    for name, entries in shapes.items():
        sd = {}
        for key, shape in entries:
            n = math.prod(shape)
            t = buf[o:o + n].view(shape)
            o += n
            if len(shape) >= 2:
                t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
            elif key.endswith("bias"):
                t.mul_(0.02)
            else:
                t.mul_(0.1).add_(1.0)
            sd[key] = t
        out[name] = sd
    return out


def images(device, seed: int, n: int, size: int, dtype, stream: int) -> torch.Tensor:
    """``n`` images [n, 3, size, size], clip(N(0, 1) * 0.4, -1, 1), image i
    from its own stream."""
    out = [torch.randn((1, 3, size, size), generator=generator(device, seed, IMAGES, stream, i),
                       device=device) for i in range(n)]
    return (torch.cat(out) * 0.4).clamp(-1, 1).to(dtype)


def prompt_bank(device, seed: int, rows: int, tokens: int, width: int, pooled: int, dtype):
    """(embeds [rows, tokens, width], uncond [tokens, width], pooled [rows,
    pooled] or None, uncond pooled [pooled] or None): standard normals, the
    scale of CLIP's normalised hidden states."""
    g = generator(device, seed, BANK)
    emb = torch.randn((rows + 1, tokens, width), generator=g, device=device, dtype=dtype)
    pool = (torch.randn((rows + 1, pooled), generator=g, device=device, dtype=dtype)
            if pooled else None)
    return (emb[:-1], emb[-1], None if pool is None else pool[:-1],
            None if pool is None else pool[-1])


def noise_pools(device, seed: int, n_images: int, n_noise: int, latent: Sequence[int], dtype):
    """Per image a pool [n_noise, 1, C, h, w] and the target's posterior
    noise [1, C, h, w]."""
    pools, eps = [], []
    for i in range(n_images):
        g = generator(device, seed, POOL, i)
        pools.append(torch.randn((n_noise, 1, *latent), generator=g, device=device, dtype=dtype))
        eps.append(torch.randn((1, *latent), generator=g, device=device, dtype=dtype))
    return pools, eps


def draws(device, seed: int, iteration: int, image: int, rows: int, reps: int, steps: int,
          latent: Sequence[int], n_noise: int, dtype) -> dict:
    """One image's draws of one iteration: a prompt row, a pool entry, the
    posterior noise and the scheduler noise of every rep."""
    g = generator(device, seed, DRAWS, iteration, image)
    return {
        "prompt_idx": torch.randint(0, rows, (), generator=g, device=device),
        "pool_idx": torch.randint(0, n_noise, (reps,), generator=g, device=device),
        "vae_eps": torch.randn((reps, *latent), generator=g, device=device, dtype=dtype),
        "step_noise": torch.randn((reps, steps, *latent), generator=g, device=device,
                                  dtype=dtype),
    }
