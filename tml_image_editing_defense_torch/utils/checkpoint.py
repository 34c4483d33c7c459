"""Attack-state checkpoint and resume (port of ``utils/checkpoint.py``).

``attack_state.npz`` keeps the JAX package's field names and layouts:
``x_adv`` [1, H, W, 3] and ``noise_pool`` [N, 1, h, w, C], NHWC as
``noise.npz`` is, widened to f32 with the true dtype beside each
(``x_adv_dtype``, ``noise_pool_dtype``: .npz cannot hold bf16, and bf16 ->
f32 is exact), and ``iteration``, the next iteration to run.

Where JAX stores ``key_data`` (the threefry key of its loop), the port
stores ``seed`` (int64): its per-iteration generators are positional in
(seed, iteration) (``attack/pgd.py::iteration_generator``), so the seed and
the iteration fix every later draw.  A file without ``seed``, such as one
the JAX package wrote, is refused: its key cannot drive the port's streams.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch


def _widen(t: torch.Tensor, perm) -> Tuple[np.ndarray, np.str_]:
    """(NHWC f32 host array, the tensor's dtype name)."""
    host = t.detach().to("cpu", torch.float32).permute(*perm).contiguous().numpy()
    return host, np.str_(str(t.dtype).removeprefix("torch."))


def save_attack_state(path: Path, x_adv: torch.Tensor, iteration: int, seed: int,
                      noise_pool: Optional[torch.Tensor] = None) -> None:
    """Write ``x_adv`` (NCHW), the next ``iteration``, the run's ``seed`` and
    the pool ([N, 1, C, h, w]) to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    x_host, x_dt = _widen(x_adv, (0, 2, 3, 1))
    payload = {
        "x_adv": x_host,
        "x_adv_dtype": x_dt,
        "iteration": np.asarray(iteration, np.int64),
        "seed": np.asarray(seed, np.int64),
    }
    if noise_pool is not None:
        payload["noise_pool"], payload["noise_pool_dtype"] = _widen(noise_pool, (0, 1, 3, 4, 2))
    np.savez(str(path), **payload)


def _restore(f, name: str, perm, device) -> torch.Tensor:
    dtype = getattr(torch, str(f[f"{name}_dtype"]))
    arr = np.ascontiguousarray(f[name].transpose(perm))
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def load_attack_state(path: Path, device="cpu"):
    """Returns (x_adv NCHW, iteration, seed, noise_pool [N, 1, C, h, w] or
    None), each tensor in the dtype it was saved from."""
    with np.load(str(path)) as f:
        if "seed" not in f:
            raise ValueError(
                f"{path} holds no 'seed': it was not written by this package (the JAX "
                "package stores a threefry key, which cannot drive the port's per-iteration "
                "torch generators); resume from a state the port saved")
        x_adv = _restore(f, "x_adv", (0, 3, 1, 2), device)
        pool = _restore(f, "noise_pool", (0, 1, 4, 2, 3), device) if "noise_pool" in f else None
        return x_adv, int(f["iteration"]), int(f["seed"]), pool
