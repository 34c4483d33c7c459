"""The EOT batching knobs of the port's PGD iteration: ``eot_chunk`` (reps
r0 .. r0+c-1 through the chain as one batch, CFG doubling it) and
``eot_mode`` ("scan" in chunks, "vmap" all reps at once, "shard" the scan,
as in the JAX serial step), and ``eot_shards`` above 1, which needs that
many ranks (``ValueError`` without a process group, as JAX's "exceeds local
device count"; the ranks themselves: tests/test_torch_parallel.py).

Batched reps sum their losses, so the gradient is the one-rep-at-a-time
gradient up to the order of the convolutions' sums over a larger batch:
held at rtol = atol = 1e-5.  The largest differences measured on the CPU:
2.4e-7 on the iterate, a relative 1.8e-7 on the losses, and 6.5e-5 on an
output latent whose largest element is 53.8, so the latent is held at the
chain's rtol = atol = 2e-4.  ``eot_chunk=2`` is also held
against the JAX step with ``eot_chunk=2`` (vmapped reps) on replayed draws
at the tolerance of tests/test_torch_pgd.py.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import nchw, nhwc, one_torch_thread, port_model_from_jax  # noqa: F401
from test_torch_pgd import GS, SIZE, TOL, _rand, _step_both, golden_jax_model, replay_draws
from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
from tml_image_editing_defense_tpu.models.model_zoo import PromptBank as JBank

from tml_image_editing_defense_torch import api
from tml_image_editing_defense_torch.attack.pgd import make_attack_data, make_pgd_step
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import LCMSampler
from tml_image_editing_defense_torch.models.model_zoo import PromptBank

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPS = 4


@pytest.fixture(scope="module")
def tiny():
    """The goldens' JAX tiny model, its port twin, and one iteration's
    inputs on the port side (4 reps, 3 prompts, a pool of 4)."""
    jmodel = golden_jax_model("tiny")
    pm = port_model_from_jax(jmodel)
    cfg = TrainConfig(norm_type="l2", derive_norm_hyperparams=False, eps=12.0, step_size=1.5,
                      grad_reps=REPS, guidance_scale=GS, image_size=SIZE,
                      perturbation_loss_lambda=0.3, prompts=["a", "b", "c"])
    source = np.clip(_rand(23, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    target = np.clip(_rand(24, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    x0 = np.clip(source + _rand(25, source.shape, 0.01), -1, 1)
    embeds, uncond = _rand(20, (3, 7, 32)), _rand(21, (7, 32))
    pool = _rand(22, (4, 1, 16, 16, 4))
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(4, limit_t=700)
    data = make_attack_data(pm, cfg, nchw(source), nchw(target),
                            PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond)),
                            torch.from_numpy(np.ascontiguousarray(pool.transpose(0, 1, 4, 2, 3))))
    draws = replay_draws(jax.random.key(21), REPS, 3, 4, plan.num_steps, (1, 16, 16, 4))
    return dict(jmodel=jmodel, pm=pm, cfg=cfg, sampler=sampler, plan=plan, data=data,
                draws=draws, x0=x0, source=source, target=target, embeds=embeds,
                uncond=uncond, pool=pool)


def _step(t, **changes):
    cfg = dataclasses.replace(t["cfg"], **changes)
    return make_pgd_step(t["pm"], t["sampler"], t["plan"], cfg)(nchw(t["x0"]), t["data"],
                                                               t["draws"])


@pytest.mark.parametrize("changes", [dict(eot_chunk=2), dict(eot_mode="vmap")],
                         ids=["eot_chunk=2", "vmap"])
def test_batched_reps_equal_one_at_a_time(tiny, changes):
    """Chunks of 2 and all 4 reps in one batch give the iterate and the mean
    loss of 4 reps one at a time; the aux carries the last rep's losses and
    output latent, as JAX's ``a[-1]``."""
    x_ref, a_ref = _step(tiny)
    x, aux = _step(tiny, **changes)
    torch.testing.assert_close(x, x_ref, rtol=1e-5, atol=1e-5)
    for name in ("avg_loss", "rec_loss", "pert_loss"):
        torch.testing.assert_close(aux[name], a_ref[name], rtol=1e-5, atol=1e-5, msg=name)
    torch.testing.assert_close(aux["output_latent"], a_ref["output_latent"], rtol=2e-4,
                               atol=2e-4)
    assert aux["output_latent"].shape == a_ref["output_latent"].shape == (1, 4, 16, 16)


def test_eot_chunk_matches_jax(tiny):
    """``eot_chunk=2`` against the jitted JAX step with ``eot_chunk=2`` (the
    JAX scan over chunks of vmapped reps, pgd.py:330-341)."""
    t = tiny
    jcfg = JTrainConfig(
        norm_type="l2", derive_norm_hyperparams=False, eps=12.0, step_size=1.5,
        grad_reps=REPS, eot_chunk=2, guidance_scale=GS, image_size=SIZE,
        n_denoising_steps_per_iteration=4, limit_timesteps=True, apply_loss_on_images=True,
        perturbation_loss_lambda=0.3, rec_loss_lambda=1.0, prompts=["a", "b", "c"])
    jbank = JBank(embeds=jnp.asarray(t["embeds"]), uncond=jnp.asarray(t["uncond"]))
    pbank = PromptBank(embeds=torch.tensor(t["embeds"]), uncond=torch.tensor(t["uncond"]))
    (jx1, jaux), (x1, aux) = _step_both(t["jmodel"], t["pm"], jcfg, jbank, pbank, t["pool"],
                                        t["source"], t["target"], t["x0"], jax.random.key(77),
                                        4)
    for name in ("avg_loss", "rec_loss", "pert_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]), rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(nhwc(aux["output_image"]), np.asarray(jaux["output_image"]), **TOL)
    np.testing.assert_allclose(nhwc(x1), np.asarray(jx1), **TOL)


def test_eot_chunk_must_divide_grad_reps(tiny):
    with pytest.raises(ValueError, match="eot_chunk=3 must divide grad_reps=4"):
        _step(tiny, eot_chunk=3)


@pytest.mark.parametrize("changes", [dict(eot_mode="shard"), dict(eot_shards=2)],
                         ids=["eot_mode=shard", "eot_shards=2"])
def test_sharded_reps_wait_for_the_multi_gpu_slice(tmp_path, tiny, changes):
    """``eot_mode="shard"`` is the scan in the serial step (JAX
    attack/pgd.py:316-323: every mode but "vmap"): the same iterate and
    losses, bit for bit.  ``eot_shards=2`` without a process group is a
    world of one rank: ``immunize`` raises ``ValueError`` (JAX api.py:168-171,
    "exceeds local device count") before it builds anything."""
    if "eot_mode" in changes:
        x_ref, a_ref = _step(tiny)
        x, aux = _step(tiny, **changes)
        assert torch.equal(x, x_ref)
        for name in ("avg_loss", "rec_loss", "pert_loss", "output_latent"):
            assert torch.equal(aux[name], a_ref[name]), name
        return
    cfg = TrainConfig(model_family="tiny", image_size=SIZE, output_path=tmp_path,
                      source_image_path=Path("missing.png"), **changes)
    with pytest.raises(ValueError, match="eot_shards=2 exceeds local device count 1"):
        api.immunize(cfg, device="cpu")
