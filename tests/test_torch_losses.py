"""The port's losses against the JAX package's ``attack/losses.py``: the Lp
norm and distance at p = 1, 2, 3 and inf (the float and the string), value
and gradient (``jax.grad``), and the perturbation MSE.

The inputs are seeded normals, so ``max |x - y|`` has no tie: the gradient
of the L-inf distance is one signed element either way."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tml_image_editing_defense_tpu.attack import losses as jl

from tml_image_editing_defense_torch.attack import losses

TOL = dict(rtol=1e-5, atol=1e-6)
PS = [1, 2, 3, math.inf, "inf"]


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 3, 8, 8)).astype(np.float32),
            rng.standard_normal((1, 3, 8, 8)).astype(np.float32))


@pytest.mark.parametrize("p", PS)
def test_lp_distance_value_and_grad_match_jax(p):
    x, y = _inputs(0)
    jp = jnp.inf if p == math.inf else p
    want, want_g = jax.value_and_grad(lambda a: jl.lp_distance(a, jnp.asarray(y), jp))(
        jnp.asarray(x))
    with torch.enable_grad():       # another test module may turn grad mode off
        xt = torch.from_numpy(x).requires_grad_(True)
        got = losses.lp_distance(xt, torch.from_numpy(y), p)
        (g,) = torch.autograd.grad(got, [xt])
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("p", PS)
def test_lp_norm_matches_jax(p):
    x, _ = _inputs(1)
    jp = jnp.inf if p == math.inf else p
    np.testing.assert_allclose(losses.lp_norm(torch.from_numpy(x), p).item(),
                               float(jl.lp_norm(jnp.asarray(x), jp)), **TOL)


def test_linf_distance_is_the_largest_difference():
    """The fault this file guards: ``sum(|d|**inf) ** (1/inf)`` is 1.0 for
    any input.  Against zeros the L-inf distance is max |x|, 2.3982 for this
    seeded tensor, and its gradient is one signed element."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, 8, 8)).astype(np.float32))
    with torch.enable_grad():
        x.requires_grad_(True)
        d = losses.lp_distance(x, torch.zeros_like(x), math.inf)
        (g,) = torch.autograd.grad(d, [x])
    i = int(x.detach().abs().argmax())
    assert d.item() == pytest.approx(x.detach().abs().max().item())
    assert d.item() == pytest.approx(2.3982, abs=1e-4)
    assert g.abs().sum().item() == pytest.approx(1.0)
    assert g.reshape(-1)[i].item() == pytest.approx(float(torch.sign(x.detach().reshape(-1)[i])))


def test_perturbation_loss_matches_jax():
    x, y = _inputs(2)
    np.testing.assert_allclose(
        losses.perturbation_loss(torch.from_numpy(x), torch.from_numpy(y)).item(),
        float(jl.perturbation_loss(jnp.asarray(x), jnp.asarray(y))), **TOL)


@pytest.mark.parametrize("p", PS)
def test_lp_regularization_matches_jax(p):
    """``LpRegularization``: one tensor, and a list of tensors of two
    shapes (the sum of their norms), value and gradient."""
    x, y = _inputs(3)
    z = np.random.default_rng(4).standard_normal((2, 5)).astype(np.float32)
    jp = jnp.inf if p == math.inf else p
    for arrays in ([x], [x, y, z]):
        want, want_g = jax.value_and_grad(
            lambda a: jl.lp_regularization(list(a) if len(a) > 1 else a[0], jp))(
            [jnp.asarray(a) for a in arrays])
        with torch.enable_grad():
            ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
            got = losses.lp_regularization(ts if len(ts) > 1 else ts[0], p)
            grads = torch.autograd.grad(got, ts)
        np.testing.assert_allclose(got.item(), float(want), **TOL)
        for g, wg in zip(grads, want_g):
            np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)


@pytest.mark.parametrize("axis", [1, -1, 2])
def test_cosine_similarity_loss_matches_jax(axis):
    """``CosineSimilarity``: mean(cos + 1) along ``axis``, value and
    gradient; a zero row takes the ``eps`` floor on both sides."""
    x, y = _inputs(5)
    x[0, 1] = 0.0
    want, want_g = jax.value_and_grad(
        lambda a, b: jl.cosine_similarity_loss(a, b, axis=axis), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    with torch.enable_grad():
        xt, yt = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
        got = losses.cosine_similarity_loss(xt, yt, axis=axis)
        grads = torch.autograd.grad(got, [xt, yt])
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for g, wg in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)
