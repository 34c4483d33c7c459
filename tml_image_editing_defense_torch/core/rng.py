"""Noise pool and named random streams (port of ``core/rng.py``).

Draws come from explicit ``torch.Generator``s.  The pool lives NCHW
([N, 1, 4, h, w]) in the port; the ``noise.npz`` artifact keeps the JAX
package's layout ([N, 1, h, w, 4] f32, rng.py:42-54) so the JAX
``evaluate`` can read what the port writes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch


#: named streams of a run (:func:`stream_generator`)
SETUP_STREAM, EVAL_STREAM = 1, 2


def stream_generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one named stream of a run seeded with ``seed``:
    ``SETUP_STREAM`` for ``immunize``'s set-up draws (noise pool, target
    posterior noise), ``EVAL_STREAM`` for ``evaluate``'s.  numpy's
    SeedSequence spawn key ``(stream,)`` keeps each apart from the others,
    from the per-iteration generators (``attack/pgd.py``) and from the
    weights' (``manual_seed(seed)``), so a run draws the same numbers
    whether it builds its model or is handed one."""
    state = np.random.SeedSequence(int(seed), spawn_key=(stream,)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def make_noise_pool(generator: torch.Generator, n_noise: int, latent_shape: Sequence[int],
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Fixed pool of latent noises, ``[n_noise, *latent_shape]`` (main.py:41-45)."""
    device = generator.device if device is None else device
    return torch.randn((n_noise, *latent_shape), generator=generator, device=device, dtype=dtype)


def save_noise_pool(path: Path, pool: torch.Tensor) -> None:
    """Write the pool as ``noises`` [N, 1, h, w, C] f32 (.npz cannot hold
    bf16; bf16 -> f32 is exact)."""
    host = pool.detach().to("cpu", torch.float32).permute(0, 1, 3, 4, 2).numpy()
    np.savez(str(path), noises=np.ascontiguousarray(host))


def load_noise_pool(path: Path, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Read a ``noise.npz`` back into the port's [N, 1, C, h, w] layout."""
    with np.load(str(path)) as f:
        arr = np.ascontiguousarray(f["noises"].transpose(0, 1, 4, 2, 3))
    return torch.from_numpy(arr).to(device=device, dtype=dtype)
