"""The encoder attack and the legacy ``super_l2`` / ``super_linf`` loops of
the port against the JAX package, on the tiny family.

Both sides take identical random draws: the encoder step's posterior noise
is ``normal(key, [B, h, w, C])`` of the JAX step's key (one key per step
in the loop, ``split(key, N)``); the legacy loops' per-rep prompt, pool
index, posterior noise and step noises are replayed from the JAX key tree
(encoder_attack.py:110-115, pgd.py:170-173, forward.py:206).  Tolerances
are those of tests/test_torch_pgd.py: rtol = atol = 2e-4 through a
differentiated chain, and the L-inf rule of ``assert_sign_steps_close``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import (  # noqa: F401  (one_torch_thread: a fixture)
    jittered,
    nchw,
    nhwc,
    one_torch_thread,
    port_model_from_jax,
)
from test_torch_pgd import GS, SIZE, TOL, _port_cfg, _rand, assert_sign_steps_close
from test_whole_program_oracle import replay_chain_keys
from tml_image_editing_defense_tpu.attack import encoder_attack as jea
from tml_image_editing_defense_tpu.attack.losses import lp_distance as j_lp_distance
from tml_image_editing_defense_tpu.attack.pgd import make_attack_data as j_make_attack_data
from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
from tml_image_editing_defense_tpu.core.samplers import LCMSampler as JLCM
from tml_image_editing_defense_tpu.models import build_model as jax_build_model
from tml_image_editing_defense_tpu.models.model_zoo import PromptBank as JBank

from tml_image_editing_defense_torch.attack import encoder_attack as ea
from tml_image_editing_defense_torch.attack.pgd import EOTDraws, make_attack_data
from tml_image_editing_defense_torch.core.samplers import LCMSampler
from tml_image_editing_defense_torch.models.model_zoo import PromptBank

B = 2
LAT_B = (B, SIZE // 2, SIZE // 2, 4)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def models():
    """A JAX tiny bundle with jittered weights and its port twin."""
    m = jax_build_model("tiny", key=jax.random.key(0), image_size=SIZE, fast_init=True)
    jmodel = dataclasses.replace(m, params=jittered(m.params, 12))
    return jmodel, port_model_from_jax(jmodel)


def _encoder_inputs(jmodel):
    src = np.clip(_rand(30, (B, SIZE, SIZE, 3), 0.4), -1, 1)
    target = np.clip(_rand(31, (B, SIZE, SIZE, 3), 0.4), -1, 1)
    target_latent = np.asarray(jmodel.encode_image(jmodel.params["vae"], jnp.asarray(target)))
    return src, target_latent


def _eps(key):
    return nchw(np.asarray(jax.random.normal(key, LAT_B, jnp.float32)))


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_encoder_step_matches_jax(models, norm):
    jmodel, pm = models
    src, tl = _encoder_inputs(jmodel)
    x0 = np.clip(src + _rand(32, src.shape, 0.01), -1, 1)
    kw = dict(norm_type=norm, step_size=0.006 if norm == "linf" else 0.5,
              eps=0.1 if norm == "linf" else 1.0)
    key = jax.random.key(33)
    jx1, jloss = jax.jit(jea.make_encoder_attack_step(jmodel, **kw))(
        jmodel.params, jnp.asarray(x0), jnp.asarray(src), jnp.asarray(tl), key)
    x1, loss = ea.make_encoder_attack_step(pm, **kw)(nchw(x0), nchw(src), nchw(tl), _eps(key))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    if norm == "l2":
        np.testing.assert_allclose(nhwc(x1), np.asarray(jx1), **TOL)
        norms = torch.linalg.vector_norm((x1 - nchw(src)).flatten(1), dim=1)
        assert float(norms.max()) <= 1.0 + 1e-4
        return
    jgrad = jax.grad(lambda x: j_lp_distance(
        jmodel.encode_image(jmodel.params["vae"], x, key=key), jnp.asarray(tl), 2))(
        jnp.asarray(x0))
    assert_sign_steps_close(nhwc(x1), np.asarray(jx1), np.asarray(jgrad))
    assert float((x1 - nchw(src)).abs().max()) <= 0.1 + 1e-6


def test_encoder_loop_matches_jax(models):
    """Three L-inf steps from the source; one posterior draw per step."""
    jmodel, pm = models
    src, tl = _encoder_inputs(jmodel)
    key = jax.random.key(34)
    jx, jlosses = jax.jit(jea.make_encoder_attack_loop(jmodel, 3, norm_type="linf"))(
        jmodel.params, jnp.asarray(src), jnp.asarray(tl), key)
    eps = torch.stack([_eps(k) for k in jax.random.split(key, 3)])
    x, losses = ea.make_encoder_attack_loop(pm, 3, norm_type="linf")(nchw(src), nchw(tl), eps)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=2e-4)
    # three sign steps: an element whose gradient sign flipped stays off by
    # a multiple of 2 * step; at most 0.1 % of them may
    off = np.abs(nhwc(x) - np.asarray(jx)) > 2e-4
    assert off.mean() <= 1e-3, int(off.sum())
    assert float((x - nchw(src)).abs().max()) <= 0.1 + 1e-6


def test_encoder_step_needs_noise_when_stochastic(models):
    _, pm = models
    x = torch.zeros((1, 3, SIZE, SIZE))
    tl = torch.ones((1, 4, SIZE // 2, SIZE // 2))
    with pytest.raises(ValueError, match="posterior noise"):
        ea.make_encoder_attack_step(pm)(x, x, tl)
    x1, loss = ea.make_encoder_attack_step(pm, stochastic_encode=False)(x, x, tl)
    assert loss.item() == pytest.approx(float(torch.linalg.vector_norm(pm.encode_image(x) - tl)))
    assert float(x1.abs().max()) == pytest.approx(0.006)


def replay_legacy_draws(key, grad_reps, n_prompts, n_pool, n_steps) -> EOTDraws:
    """The draws the JAX legacy EOT makes from ``key`` (a prompt per rep,
    then the pool index and the chain's draws of ``_rep_loss_fn``)."""
    prompts, pool, eps, steps = [], [], [], []
    for k in jax.random.split(key, grad_reps):
        k_p, k_r = jax.random.split(k)
        prompts.append(int(jax.random.randint(k_p, (), 0, n_prompts)))
        k_noise, k_fwd = jax.random.split(k_r)
        pool.append(int(jax.random.randint(k_noise, (), 0, n_pool)))
        e, sn = replay_chain_keys(k_fwd, n_steps, (1, SIZE // 2, SIZE // 2, 4))
        eps.append(nchw(e)[0])
        steps.append(torch.stack([nchw(x)[0] for x in sn]))
    return EOTDraws(prompts, pool, torch.stack(eps), torch.stack(steps))


@pytest.mark.parametrize("norm", ["l2", "linf"])
def test_super_loop_one_iteration_matches_jax(models, norm):
    jmodel, pm = models
    radius = dict(eps=2.0, step_size=0.5) if norm == "l2" else dict(eps=0.1, step_size=0.006)
    jcfg = JTrainConfig(
        norm_type=norm, derive_norm_hyperparams=False, **radius, grad_reps=2,
        guidance_scale=GS, image_size=SIZE, n_denoising_steps_per_iteration=2,
        limit_timesteps=True, apply_loss_on_images=True, perturbation_loss_lambda=0.3,
        prompts=["a", "b", "c"])
    embeds, uncond = _rand(40, (3, 7, 32)), _rand(41, (7, 32))
    pool = _rand(42, (2, 1, SIZE // 2, SIZE // 2, 4))
    source = np.clip(_rand(43, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    target = np.clip(_rand(44, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    jsampler = JLCM(jmodel.schedule)
    jplan = jsampler.plan(2, limit_t=700)
    jdata = j_make_attack_data(jmodel, jcfg, jnp.asarray(source), jnp.asarray(target),
                               JBank(embeds=jnp.asarray(embeds), uncond=jnp.asarray(uncond)),
                               jnp.asarray(pool))
    runner = {"l2": jea.super_l2, "linf": jea.super_linf}[norm]
    key = jax.random.key(45)
    jx, jlosses = runner(jmodel, jsampler, jplan, jcfg, jdata, key, iters=1)

    cfg = _port_cfg(jcfg)
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(2, limit_t=700)
    data = make_attack_data(pm, cfg, nchw(source), nchw(target),
                            PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond)),
                            torch.from_numpy(np.ascontiguousarray(pool.transpose(0, 1, 4, 2, 3))))
    draws = replay_legacy_draws(jax.random.split(key, 1)[0], 2, 3, 2, plan.num_steps)
    port_runner = {"l2": ea.super_l2, "linf": ea.super_linf}[norm]
    x, losses = port_runner(pm, sampler, plan, cfg, data, seed=0, iters=1,
                            draw_sampler=lambda gen: draws)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=2e-4)
    if norm == "l2":
        np.testing.assert_allclose(nhwc(x), np.asarray(jx), **TOL)
        return
    grad, _ = ea.make_legacy_eot_grad(pm, sampler, plan, cfg)(data.source, data, draws)
    assert_sign_steps_close(nhwc(x), np.asarray(jx), nhwc(grad))
    assert float((x - data.source).abs().max()) <= 0.1 + 1e-6
