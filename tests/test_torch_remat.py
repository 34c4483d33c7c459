"""The attack step's remat knobs in the port: ``remat_policy`` (each
denoising step under ``apply_remat``) and ``remat_vae`` (the shared encode
and each rep's decode under a checkpoint).

A remat policy changes what the backward recomputes, never the math, so on
the CPU, where the recompute runs the same kernels in the same order, every
policy gives the "none" iterate to rtol 1e-6.  One case of each path
("full" with ``remat_vae``) is also held against the jitted JAX step with
the same config on replayed draws at rtol = atol = 2e-4, the tolerance of
tests/test_torch_pgd.py: on ``tiny`` (L2), on ``tiny-sdxl`` (the 1024x1024
path's family at small size) and on the ``tiny-inpaint`` step.  The JAX
package's own tests/test_pgd.py:208-235 shows its policies equal, so no
more JAX steps are compiled here.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_inpaint import _both_sides, replay_inpaint_draws
from test_torch_models import nchw, nhwc, one_torch_thread, port_model_from_jax  # noqa: F401
from test_torch_pgd import GS, SIZE, TOL, _rand, _step_both, golden_jax_model, replay_draws
from test_torch_sdxl import CTX_DIM, POOLED
from tml_image_editing_defense_tpu.attack.inpaint import (
    make_inpaint_pgd_step as j_make_inpaint_pgd_step,
)
from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
from tml_image_editing_defense_tpu.models.model_zoo import PromptBank as JBank

from tml_image_editing_defense_torch.attack import forward
from tml_image_editing_defense_torch.attack.forward import CondInputs, apply_remat
from tml_image_editing_defense_torch.attack.inpaint import make_inpaint_pgd_step
from tml_image_editing_defense_torch.attack.pgd import make_attack_data, make_pgd_step
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import LCMSampler
from tml_image_editing_defense_torch.models.model_zoo import PromptBank
from tml_image_editing_defense_torch.ops import flash_attention as fa

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REMAT = dict(remat_policy="full", remat_vae=True)


@pytest.fixture(scope="module")
def twins():
    """The goldens' JAX model of a tiny family and its port twin, built once
    per family on first use."""
    built = {}

    def get(family):
        if family not in built:
            jmodel = golden_jax_model(family)
            built[family] = jmodel, port_model_from_jax(jmodel, family=family)
        return built[family]

    return get


def _l2_jcfg(**kw) -> JTrainConfig:
    return JTrainConfig(
        norm_type="l2", derive_norm_hyperparams=False, eps=12.0, step_size=1.5, grad_reps=2,
        guidance_scale=GS, image_size=SIZE, n_denoising_steps_per_iteration=4,
        limit_timesteps=True, apply_loss_on_images=True, perturbation_loss_lambda=0.3,
        rec_loss_lambda=1.0, prompts=["a", "b", "c"], **kw)


def _images():
    source = np.clip(_rand(23, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    target = np.clip(_rand(24, (1, SIZE, SIZE, 3), 0.4), -1, 1)
    x0 = np.clip(source + _rand(25, source.shape, 0.01), -1, 1)
    return source, target, x0


@pytest.mark.parametrize("changes", [
    dict(remat_policy="full"), dict(remat_policy="dots"), dict(remat_policy="conv_dots"),
    dict(remat_vae=True), REMAT,
], ids=["full", "dots", "conv_dots", "remat_vae", "full+remat_vae"])
def test_remat_equals_no_remat(twins, changes):
    """The port's step on ``tiny`` under a policy (and with ``remat_vae``)
    against its "none" step on the same draws: the iterate, the losses and
    the last rep's output latent to rtol 1e-6."""
    _, pm = twins("tiny")
    cfg = TrainConfig(norm_type="l2", derive_norm_hyperparams=False, eps=12.0, step_size=1.5,
                      grad_reps=2, guidance_scale=GS, image_size=SIZE,
                      perturbation_loss_lambda=0.3, prompts=["a", "b", "c"])
    source, target, x0 = _images()
    bank = PromptBank(embeds=torch.tensor(_rand(20, (3, 7, 32))),
                      uncond=torch.tensor(_rand(21, (7, 32))))
    pool = torch.tensor(_rand(22, (4, 1, 4, SIZE // 2, SIZE // 2)))
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(4, limit_t=700)
    data = make_attack_data(pm, cfg, nchw(source), nchw(target), bank, pool)
    draws = replay_draws(jax.random.key(31), cfg.grad_reps, 3, 4, plan.num_steps,
                         (1, SIZE // 2, SIZE // 2, 4))
    x_ref, a_ref = make_pgd_step(pm, sampler, plan, cfg)(nchw(x0), data, draws)
    x, aux = make_pgd_step(pm, sampler, plan, dataclasses.replace(cfg, **changes))(
        nchw(x0), data, draws)
    torch.testing.assert_close(x, x_ref, rtol=1e-6, atol=0)
    for name in ("avg_loss", "rec_loss", "pert_loss", "output_latent", "output_image"):
        torch.testing.assert_close(aux[name], a_ref[name], rtol=1e-6, atol=0, msg=name)


def test_remat_step_matches_jax(twins):
    """"full" with ``remat_vae`` on tiny against the JAX step with the same
    config."""
    jmodel, pm = twins("tiny")
    jcfg = _l2_jcfg(**REMAT)
    embeds, uncond = _rand(20, (3, 7, 32)), _rand(21, (7, 32))
    jbank = JBank(embeds=jnp.asarray(embeds), uncond=jnp.asarray(uncond))
    pbank = PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond))
    source, target, x0 = _images()
    (jx1, jaux), (x1, aux) = _step_both(jmodel, pm, jcfg, jbank, pbank,
                                        _rand(22, (4, 1, 16, 16, 4)), source, target, x0,
                                        jax.random.key(77), 4)
    for name in ("avg_loss", "rec_loss", "pert_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]), rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(nhwc(x1), np.asarray(jx1), **TOL)


def test_remat_sdxl_step_matches_jax(twins):
    """The slice's path at small size: tiny-sdxl (pooled bank, 6-tuple time
    ids) with "full" and ``remat_vae`` against the JAX step."""
    jmodel, pm = twins("tiny-sdxl")
    jcfg = _l2_jcfg(use_sdxl=True, **REMAT)
    embeds, uncond = _rand(20, (3, 7, CTX_DIM)), _rand(21, (7, CTX_DIM))
    pooled, uncond_pooled = _rand(26, (3, POOLED)), _rand(27, (POOLED,))
    jbank = JBank(embeds=jnp.asarray(embeds), uncond=jnp.asarray(uncond),
                  pooled=jnp.asarray(pooled), uncond_pooled=jnp.asarray(uncond_pooled))
    pbank = PromptBank(embeds=torch.tensor(embeds), uncond=torch.tensor(uncond),
                       pooled=torch.tensor(pooled), uncond_pooled=torch.tensor(uncond_pooled))
    source, target, x0 = _images()
    (jx1, jaux), (x1, aux) = _step_both(jmodel, pm, jcfg, jbank, pbank,
                                        _rand(22, (4, 1, 16, 16, 4)), source, target, x0,
                                        jax.random.key(78), 4)
    for name in ("avg_loss", "rec_loss", "pert_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]), rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(nhwc(x1), np.asarray(jx1), **TOL)


def test_remat_inpaint_step_matches_jax(twins):
    """The inpaint step threads ``remat_policy`` into its chain, as the JAX
    step does (inpaint.py:107): "full" on tiny-inpaint against JAX, L2
    (a smooth step, so the iterates compare at the chain tolerance)."""
    jmodel, pm = twins("tiny-inpaint")
    jcfg = JTrainConfig(
        attack_mode="inpaint", norm_type="l2", derive_norm_hyperparams=False, eps=2.0,
        step_size=0.5, grad_reps=2, guidance_scale=GS, image_size=SIZE,
        n_denoising_steps_per_iteration=2, apply_loss_on_images=True,
        perturbation_loss_lambda=0.3, prompts=["a", "b", "c"], **REMAT)
    (jsampler, jplan, jdata), (cfg, sampler, plan, data), x0 = _both_sides(jmodel, pm, jcfg, 2)
    assert cfg.remat_policy == "full"
    key = jax.random.key(79)
    jx1, jaux = jax.jit(j_make_inpaint_pgd_step(jmodel, jsampler, jplan, jcfg))(
        jmodel.params, jnp.asarray(x0), jdata, key)
    draws = replay_inpaint_draws(key, cfg.grad_reps, 3, plan.num_steps)
    x1, aux = make_inpaint_pgd_step(pm, sampler, plan, cfg)(nchw(x0), data, draws)
    for name in ("avg_loss", "rec_loss", "pert_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]), rtol=2e-4, err_msg=name)
    np.testing.assert_allclose(nhwc(x1), np.asarray(jx1), **TOL)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_flash_attention_reruns_alike_under_checkpoint(monkeypatch, policy):
    """The flash ``autograd.Function`` under a remat policy: its forward
    runs again in the backward (K1's second launch on the card) and gives
    the O and lse it gave the first time, so the gradients are those
    without the checkpoint (on the CPU the wrappers run the plain
    versions)."""
    calls = []
    fwd = fa.flash_fwd

    def spy(q, k, v):
        calls.append(fwd(q, k, v))
        return calls[-1]

    monkeypatch.setattr(fa, "flash_fwd", spy)
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((2, 64, 2, 40), generator=gen) for _ in range(4))

    def body(q, k, v):
        return torch.tanh(fa.flash_attention(q, k, v))

    grads = []
    for wrap in ("none", policy):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            out = apply_remat(body, wrap)(*leaves)
            grads.append(torch.autograd.grad(out, leaves, do))
    assert len(calls) == 3
    for o_lse in calls[2:]:
        assert all(torch.equal(a, b) for a, b in zip(o_lse, calls[1]))
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_no_checkpoint_without_a_gradient(twins, monkeypatch):
    """Under ``torch.no_grad()`` (the evaluation pipelines) the chain pays no
    checkpoint whatever the policy: ``torch.utils.checkpoint`` is never
    called, and the output is the one without a policy."""
    _, pm = twins("tiny")
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(4, limit_t=700)
    z = torch.tensor(_rand(3, (1, 4, SIZE // 2, SIZE // 2)))
    cond = CondInputs(ctx=torch.tensor(_rand(2, (2, 7, 32))))
    noise = torch.tensor(_rand(4, (1, 4, SIZE // 2, SIZE // 2)))
    steps = torch.tensor(_rand(5, (plan.num_steps, 4, SIZE // 2, SIZE // 2)))
    with torch.no_grad():
        want = forward.attack_forward_from_latent(pm, sampler, plan, z, cond, noise, GS, steps)

    def refuse(*args, **kwargs):
        raise AssertionError("a checkpoint without a gradient")

    monkeypatch.setattr(forward, "checkpoint", refuse)
    with torch.no_grad():
        got = forward.attack_forward_from_latent(pm, sampler, plan, z, cond, noise, GS, steps,
                                                 remat_policy="full")
    assert torch.equal(got, want)
