"""Checkpoint, resume and preemption of the port's ``immunize``, on the CPU
with the tiny family.

The port's per-iteration generators are positional in (seed, iteration),
so a run resumed at iteration k from ``attack_state.npz`` ends bit-equal on
the uninterrupted run's iterate (the same ops on the same inputs on one
CPU).  A state the JAX package wrote holds a threefry key and no seed, and
is refused.
"""

from __future__ import annotations

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_api import _cfg
from test_torch_models import one_torch_thread  # noqa: F401
from tml_image_editing_defense_tpu.utils.checkpoint import save_attack_state as j_save_attack_state

from tml_image_editing_defense_torch import api
from tml_image_editing_defense_torch.attack.pgd import run_pgd
from tml_image_editing_defense_torch.utils.checkpoint import load_attack_state, save_attack_state
from tml_image_editing_defense_torch.utils.logging import MetricsLogger

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 4


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("full")
    cfg = _cfg(tmp, n_optimization_steps=N, enable_visualization=False)
    return cfg, api.immunize(cfg, device="cpu")


@pytest.mark.parametrize("k", [2, 3])
def test_resume_at_k_ends_on_the_uninterrupted_iterate(tmp_path, uninterrupted, k):
    """A run of k iterations that checkpoints after each (the last save, after
    iteration k - 1, says k); then the full run resumed from that state:
    the uninterrupted run's iterate bit for bit, and its history from k on."""
    full_cfg, full = uninterrupted
    (tmp_path / "part").mkdir()
    part_cfg = _cfg(tmp_path / "part", n_optimization_steps=k, checkpoint_interval=1,
                    enable_visualization=False)
    api.immunize(part_cfg, device="cpu")
    state = part_cfg.output_path / "attack_state.npz"
    assert load_attack_state(state)[1:3] == (k, full_cfg.seed)
    (tmp_path / "res").mkdir()
    res_cfg = _cfg(tmp_path / "res", n_optimization_steps=N, enable_visualization=False)
    res = api.immunize(res_cfg, device="cpu", resume_from=state)
    assert torch.equal(res.x_adv, full.x_adv)
    assert res.history == full.history[k:]
    rows = [json.loads(line) for line in
            (res_cfg.output_path / "metrics.jsonl").read_text().splitlines()]
    assert sorted(r["step"] for r in rows) == list(range(k, N))


def test_sigusr1_mid_run_saves_the_state_and_the_run_resumes(tmp_path, uninterrupted):
    """A SIGUSR1 sent during iteration 1 stops the loop before iteration 2;
    the state says 2, and resuming from it ends on the uninterrupted iterate."""
    full_cfg, full = uninterrupted

    class SignallingLogger(MetricsLogger):
        def log(self, metrics, step=None, images=None):
            super().log(metrics, step=step, images=images)
            if step == 1:
                os.kill(os.getpid(), signal.SIGUSR1)

    before = signal.getsignal(signal.SIGUSR1)
    (tmp_path / "a").mkdir()
    cfg = _cfg(tmp_path / "a", n_optimization_steps=N, image_visualization_interval=1,
               enable_visualization=False)
    logger = SignallingLogger(output_dir=cfg.output_path, verbose=False, use_wandb=False)
    stopped = api.immunize(cfg, device="cpu", logger=logger)
    logger.finish()
    assert stopped.history[-1] == {"preempted_at": 2} and len(stopped.history) == 3
    assert signal.getsignal(signal.SIGUSR1) == before        # the handler was restored
    state = cfg.output_path / "attack_state.npz"
    x_saved, it, _, _ = load_attack_state(state)
    assert it == 2 and torch.equal(x_saved, stopped.x_adv)
    res = api.immunize(cfg, device="cpu", resume_from=state)
    assert torch.equal(res.x_adv, full.x_adv)


def test_checkpoint_interval_saves_on_its_own_schedule(tmp_path):
    """ckpt_interval 2 with vis interval 3 over 7 iterations: states after
    iterations 2, 4 and 6, never after 0, whatever the vis schedule (JAX
    api.py:313-319)."""
    cfg = _cfg(tmp_path, n_optimization_steps=7, image_visualization_interval=3)
    data = type("Data", (), {"source": torch.zeros(1, 3, 2, 2)})()
    vis, ckpt = [], []

    def step(x, data_, draws):
        z = torch.zeros(())
        return x + 1, {"avg_loss": z, "rec_loss": z, "pert_loss": z}

    x, history = run_pgd(None, None, None, cfg, data, 0, step_fn=step,
                         draw_sampler=lambda gen: None, vis_needs_image=False,
                         vis_callback=lambda it, x_, aux: vis.append(it),
                         ckpt_callback=lambda it, x_: ckpt.append((it, float(x_.mean()))),
                         ckpt_interval=2)
    assert vis == [0, 3, 6] and ckpt == [(2, 3.0), (4, 5.0), (6, 7.0)]
    assert len(history) == 7 and float(x.mean()) == 7.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_state_round_trips_exactly(tmp_path, dtype):
    """x_adv and the pool come back with their dtype and bits; the file
    keeps the JAX field names and NHWC layouts, widened to f32."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 3, 8, 6), generator=gen).to(dtype)
    pool = torch.randn((2, 1, 4, 3, 5), generator=gen).to(dtype)
    save_attack_state(tmp_path / "s.npz", x, 7, 123, pool)
    x2, it, seed, pool2 = load_attack_state(tmp_path / "s.npz")
    assert (it, seed, x2.dtype, pool2.dtype) == (7, 123, dtype, dtype)
    assert torch.equal(x2, x) and torch.equal(pool2, pool)
    with np.load(tmp_path / "s.npz") as f:
        assert f["x_adv"].shape == (1, 8, 6, 3) and f["x_adv"].dtype == np.float32
        assert f["noise_pool"].shape == (2, 1, 3, 5, 4)
        assert str(f["x_adv_dtype"]) == str(dtype).removeprefix("torch.")


def test_jax_written_state_is_refused(tmp_path):
    path = tmp_path / "attack_state.npz"
    j_save_attack_state(path, jnp.zeros((1, 32, 32, 3)), 3, jax.random.key(0),
                        jnp.zeros((1, 1, 16, 16, 4)))
    with pytest.raises(ValueError, match="threefry"):
        load_attack_state(path)
