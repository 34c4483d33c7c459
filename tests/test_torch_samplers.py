"""The port's noise schedule and LCM sampler against the JAX package's.

Plan tables are host integers and f32 scalars: equal exactly.  ``add_noise``
and ``step`` get the same tensors and the same noise on both sides and agree
at 1e-6 (both compute their scalars in f32; the elementwise math is one or
two roundings).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tml_image_editing_defense_tpu.core.samplers import LCMSampler as JLCM
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
        got = psampler.step(pplan, i, torch.from_numpy(out), torch.from_numpy(sample),
                            None if pplan.is_last[i] else torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unported_sampler_kinds_raise():
    with pytest.raises(ValueError, match="not ported yet"):
        make_sampler("plms", make_noise_schedule())
