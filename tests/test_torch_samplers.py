"""The port's noise schedule and samplers (DDIM, LCM, PLMS, Euler) against
the JAX package's.

Plan tables are host integers and f32 scalars: equal exactly, field by
field.  ``add_noise``, ``scale_model_input`` and ``step`` get the same
tensors and the same noise on both sides and agree at 1e-6 (both compute
their scalars in f32; the elementwise math is a few roundings), over whole
chains with the carry (PLMS's eps history) threaded through.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tml_image_editing_defense_tpu.core.samplers import LCMSampler as JLCM
from tml_image_editing_defense_tpu.core.samplers import make_sampler as j_make_sampler
from tml_image_editing_defense_tpu.core.schedule import make_noise_schedule as j_schedule

from tml_image_editing_defense_torch.core.samplers import LCMSampler, make_sampler
from tml_image_editing_defense_torch.core.schedule import make_noise_schedule

TOL = dict(rtol=1e-6, atol=1e-6)


def test_schedule_table_matches_jax():
    j, p = j_schedule(), make_noise_schedule()
    np.testing.assert_array_equal(p.alphas_cumprod, np.asarray(j.alphas_cumprod))
    assert p.final_alpha_cumprod == np.float32(j.final_alpha_cumprod)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("limit_t", [None, 700])
def test_lcm_plan_tables_match_jax(k, limit_t):
    jp = JLCM(j_schedule()).plan(k, limit_t=limit_t)
    pp = LCMSampler(make_noise_schedule()).plan(k, limit_t=limit_t)
    assert pp.num_steps == jp.num_steps
    np.testing.assert_array_equal(pp.t_eval, np.asarray(jp.t_eval))
    np.testing.assert_array_equal(pp.alpha_prod, np.asarray(jp.alpha_prod))
    np.testing.assert_array_equal(pp.alpha_prod_prev, np.asarray(jp.alpha_prod_prev))
    np.testing.assert_array_equal(pp.is_last, np.asarray(jp.is_last))
    assert pp.init_timestep == int(jp.init_timestep)


def test_default_training_plan_is_two_steps():
    """K = 4 with the t < 700 filter leaves t = 519 and 279 (configs.py:157)."""
    plan = LCMSampler(make_noise_schedule()).plan(4, limit_t=700)
    assert plan.t_eval.tolist() == [519, 279]


def test_add_noise_matches_jax():
    rng = np.random.default_rng(0)
    x0, noise = (rng.standard_normal((1, 4, 8, 8)).astype(np.float32) for _ in range(2))
    for t in (519, 279, 999):
        want = j_schedule().add_noise(jnp.asarray(x0), jnp.asarray(noise), t)
        got = make_noise_schedule().add_noise(torch.from_numpy(x0), torch.from_numpy(noise), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k,limit_t", [(4, 700), (2, None)])
def test_lcm_step_matches_jax_on_given_noise(k, limit_t):
    """Every step of the plan, the last one (no noise) included; the JAX
    step draws its noise from a key, which is replayed here."""
    import jax

    jsampler, psampler = JLCM(j_schedule()), LCMSampler(make_noise_schedule())
    jplan, pplan = jsampler.plan(k, limit_t=limit_t), psampler.plan(k, limit_t=limit_t)
    rng = np.random.default_rng(k)
    sample = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    out = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    for i in range(pplan.num_steps):
        key = jax.random.key(10 + i)
        noise = np.array(jax.random.normal(key, sample.shape, jnp.float32))
        want, _ = jsampler.step(jplan, i, (), jnp.asarray(out), jnp.asarray(sample), key)
        got, _ = psampler.step(pplan, i, (), torch.from_numpy(out), torch.from_numpy(sample),
                               None if pplan.is_last[i] else torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unported_sampler_kinds_raise():
    with pytest.raises(ValueError, match="unknown sampler kind"):
        make_sampler("heun", make_noise_schedule())


PLAN_FIELDS = ("t_eval", "alpha_prod", "alpha_prod_prev", "sigma", "sigma_next", "ab_a", "ab_w",
               "push", "use_orig", "is_last")


@pytest.mark.parametrize("kind", ["ddim", "plms", "euler", "lcm"])
@pytest.mark.parametrize("k", [4, 10, 50])
@pytest.mark.parametrize("strength", [None, 0.6, 1.0])
@pytest.mark.parametrize("window", [(None, None), (700, None), (800, 101)])
def test_plan_fields_match_jax(kind, k, strength, window):
    """Every field of the plan, over ``k``, ``strength`` and the
    ``limit_t`` / ``min_t`` windows."""
    limit_t, min_t = window
    jp = j_make_sampler(kind, j_schedule()).plan(k, strength=strength, limit_t=limit_t,
                                                 min_t=min_t)
    pp = make_sampler(kind, make_noise_schedule()).plan(k, strength=strength, limit_t=limit_t,
                                                        min_t=min_t)
    assert (pp.num_steps, pp.kind) == (jp.num_steps, jp.kind)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(pp, name), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert pp.init_timestep == int(jp.init_timestep)
    assert np.float32(pp.init_sigma) == np.asarray(jp.init_sigma)


#: (kind, sampler kwargs, K, strength): the evaluation's PLMS at 10 steps
#: (the warm-up row and every Adams-Bashforth order), DDIM with and without
#: eta, Euler, and LCM's 4-step chain
CHAINS = [("plms", {}, 10, 0.6), ("plms", {}, 10, None), ("ddim", {"eta": 0.0}, 8, 0.6),
          ("ddim", {"eta": 0.9}, 8, 0.6), ("euler", {}, 8, 0.6), ("lcm", {}, 4, None)]


@pytest.mark.parametrize("kind,kwargs,k,strength", CHAINS)
def test_sampler_chain_matches_jax(kind, kwargs, k, strength):
    """A whole chain fed a fixed sequence of model outputs: add_noise, then
    per step scale_model_input and step with the carry threaded through;
    the JAX step's noise (DDIM with eta, LCM) is replayed from its key.
    Every step's sample agrees within 1e-6."""
    import jax

    jsampler = j_make_sampler(kind, j_schedule(), **kwargs)
    psampler = make_sampler(kind, make_noise_schedule(), **kwargs)
    jplan, pplan = jsampler.plan(k, strength=strength), psampler.plan(k, strength=strength)
    rng = np.random.default_rng(7)
    shape = (2, 4, 8, 8)
    x0, noise0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    outs = rng.standard_normal((pplan.num_steps, *shape)).astype(np.float32)
    jx = jsampler.add_noise(jplan, jnp.asarray(x0), jnp.asarray(noise0))
    px = psampler.add_noise(pplan, torch.from_numpy(x0), torch.from_numpy(noise0))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), **TOL)
    jcarry = jsampler.init_carry(shape, jnp.float32)
    pcarry = psampler.init_carry(shape, torch.float32, "cpu")
    for i in range(pplan.num_steps):
        np.testing.assert_allclose(psampler.scale_model_input(pplan, i, px).numpy(),
                                   np.asarray(jsampler.scale_model_input(jplan, i, jx)), **TOL)
        key = jax.random.key(100 + i)
        noise = torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))
        jx, jcarry = jsampler.step(jplan, i, jcarry, jnp.asarray(outs[i]), jx, key)
        px, pcarry = psampler.step(pplan, i, pcarry, torch.from_numpy(outs[i]), px,
                                   noise if psampler.uses_step_noise else None)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), err_msg=f"step {i}", **TOL)
