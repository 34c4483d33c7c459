"""The PGD updates of the port on the CPU (the plain versions the CUDA
kernels K4 and K5 are held against on the card) against the JAX package.

- L2: the Pallas kernel (interpret mode) for batch 1 and
  ``l2_perturbation_step`` for batch 2, with and without the salient mask,
  at the tolerances of tests/test_pallas_ops.py.
- L-inf: the Pallas ``pgd_linf_update`` (interpret mode), bit-equal in f32
  (every operation is exactly rounded) and within one bf16 ulp in bf16 (the
  Pallas kernel casts the scalars to bf16 first); the mask semantics.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tml_image_editing_defense_tpu.attack.pgd import l2_perturbation_step as j_l2_step
from tml_image_editing_defense_tpu.attack.pgd import linf_perturbation_step as j_linf_step
from tml_image_editing_defense_tpu.ops.pgd_kernels import pgd_l2_update as j_pgd_l2_update
from tml_image_editing_defense_tpu.ops.pgd_kernels import pgd_linf_update as j_pgd_linf_update

from tml_image_editing_defense_torch.attack.pgd import perturbation_step
from tml_image_editing_defense_torch.ops import pgd_kernels as pk
from test_torch_models import nchw, nhwc

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(b, seed, mask):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, 32, 32, 3)) * 0.3).astype(np.float32)
    g = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    s = np.clip(rng.standard_normal((b, 32, 32, 3)) * 0.4, -1, 1).astype(np.float32)
    m = (rng.uniform(size=(b, 32, 32, 1)) > 0.5).astype(np.float32) if mask else None
    return x, g, s, m


@pytest.mark.parametrize("mask", [False, True])
def test_l2_update_matches_pallas_kernel_batch1(mask):
    x, g, s, m = _inputs(1, 3 + mask, mask)
    want = j_pgd_l2_update(jnp.asarray(x), jnp.asarray(g), jnp.asarray(s), 7.5, 0.4, -1.0, 1.0,
                           mask=None if m is None else jnp.asarray(m), interpret=True)
    got = pk.pgd_l2_update(nchw(x), nchw(g), nchw(s), 7.5, 0.4, -1.0, 1.0,
                           mask=None if m is None else nchw(m))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("mask", [False, True])
def test_l2_update_takes_per_sample_norms(mask):
    x, g, s, m = _inputs(2, 7 + mask, mask)
    want = j_l2_step(jnp.asarray(x), jnp.asarray(g), jnp.asarray(s), 2.0, 0.5, -1.0, 1.0,
                     None if m is None else jnp.asarray(m))
    got = pk.pgd_l2_update(nchw(x), nchw(g), nchw(s), 2.0, 0.5, -1.0, 1.0,
                           mask=None if m is None else nchw(m))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_linf_branch_ignores_the_mask():
    x, g, s, m = _inputs(1, 30, True)
    kw = dict(x_adv=nchw(x), grad=nchw(g), x_src=nchw(s), step_size=0.006, eps=0.1,
              min_value=-1.0, max_value=1.0)
    masked = pk.fused_perturbation_step("linf", mask=nchw(m), **kw)
    plain = perturbation_step("linf", mask=nchw(m), **kw)
    want = j_linf_step(jnp.asarray(x), jnp.asarray(g), jnp.asarray(s), 0.006, 0.1, -1.0, 1.0)
    torch.testing.assert_close(masked, pk.fused_perturbation_step("linf", **kw), rtol=0, atol=0)
    torch.testing.assert_close(masked, plain, rtol=0, atol=0)
    np.testing.assert_allclose(nhwc(masked), np.asarray(want), rtol=1e-6, atol=1e-7)


def _linf_inputs(shape, dtype, seed):
    """NHWC inputs with exact zeros in the gradient (sign(0) = 0 leaves x)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    g[rng.uniform(size=shape) < 0.05] = 0.0
    s = np.clip(x + rng.uniform(-0.1, 0.1, shape), -1, 1).astype(np.float32)
    return tuple(jnp.asarray(a, dtype) for a in (x, g, s))


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value (8 significant bits)."""
    _, e = np.frexp(np.abs(a).astype(np.float64))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64, 64, 3), (2, 33, 35, 3)])
def test_linf_update_matches_pallas_kernel(shape, dtype):
    x, g, s = _linf_inputs(shape, dtype, 50 + shape[0])
    want = np.asarray(j_pgd_linf_update(x, g, s, 0.006, 0.1, -1.0, 1.0, interpret=True),
                      np.float32)
    tdt = getattr(torch, dtype)
    x_t, g_t, s_t = (nchw(np.asarray(a, np.float32)).to(tdt) for a in (x, g, s))
    got = nhwc(pk.pgd_linf_update(x_t, g_t, s_t, 0.006, 0.1, -1.0, 1.0).float())
    unmoved = np.asarray(g, np.float32) == 0
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[unmoved], np.asarray(x, np.float32)[unmoved])
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    assert np.abs(got - np.asarray(s, np.float32)).max() <= 0.1 + 1e-2


def test_linf_update_launches_nothing_on_cpu():
    x, g, s, _ = _inputs(1, 41, False)
    out = pk.fused_perturbation_step("linf", x_adv=nchw(x), grad=nchw(g), x_src=nchw(s),
                                     step_size=0.006, eps=0.1, min_value=-1.0, max_value=1.0,
                                     mask=None)
    assert pk.PGD_LINF_UPDATE.launches == 0
    torch.testing.assert_close(out, perturbation_step(
        "linf", x_adv=nchw(x), grad=nchw(g), x_src=nchw(s), step_size=0.006, eps=0.1,
        min_value=-1.0, max_value=1.0), rtol=0, atol=0)


def test_update_launches_nothing_on_cpu_and_rejects_unknown_norms():
    x, g, s, _ = _inputs(1, 40, False)
    pk.fused_perturbation_step("l2", x_adv=nchw(x), grad=nchw(g), x_src=nchw(s), step_size=1.0,
                               eps=0.5, min_value=-1.0, max_value=1.0, mask=None)
    assert pk.PGD_L2_UPDATE.launches == 0
    with pytest.raises(ValueError, match="unknown norm_type"):
        pk.fused_perturbation_step("l1", x_adv=nchw(x))
