"""The PGD updates of the port on the CPU (the plain versions the CUDA
kernels K4 and K5 are held against on the card) against the JAX package.

- L2: the Pallas kernel (interpret mode) for batch 1 and
  ``l2_perturbation_step`` for batch 2, with and without the salient mask,
  at the tolerances of tests/test_pallas_ops.py; and K4's algorithm
  (``_k4_emulated``: chunk moments, their fixed-order sum, the write pass)
  against both.
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


def _inputs(b, seed, mask, hw=(32, 32)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, *hw, 3)) * 0.3).astype(np.float32)
    g = rng.standard_normal((b, *hw, 3)).astype(np.float32)
    s = np.clip(rng.standard_normal((b, *hw, 3)) * 0.4, -1, 1).astype(np.float32)
    m = (rng.uniform(size=(b, *hw, 1)) > 0.5).astype(np.float32) if mask else None
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


def _k4_emulated(x, g, s, step, eps, min_value, max_value, mask=None, chunk=None):
    """K4's algorithm on NCHW f32 tensors, as ``csrc/pgd_update.cu`` runs it.

    First kernel: per (sample, chunk of ``chunk`` pixels of every channel;
    the wrapper's chunk by default, the last one ragged) the f32 moments
    sum g^2, sum a^2, sum a h, sum h^2, with a = x - src and h = g * mask.
    Second kernel: their sum over the chunks in order, in f64; gden =
    sqrt(sum g^2) + 1e-10 in f32; ||d||^2 = sum a^2 - 2 c sum a h + c^2 sum h^2
    with c = step / gden, clamped at 0; the factor; then each element in f32
    in the plain version's order."""
    b, c, h, w = x.shape
    chunk = chunk or pk.L2_CHUNK_BYTES // x.element_size()
    xs, gs, ss = (t.reshape(b, c, h * w) for t in (x, g, s))
    ms = torch.ones(b, 1, h * w) if mask is None else mask.reshape(b, 1, h * w)
    a, hs = xs - ss, gs * ms
    out = torch.empty_like(xs)
    for i in range(b):
        tot = torch.zeros(4, dtype=torch.float64)
        for p0 in range(0, h * w, chunk):
            cut = (i, slice(None), slice(p0, p0 + chunk))
            part = torch.stack([(gs[cut] ** 2).sum(), (a[cut] ** 2).sum(),
                                (a[cut] * hs[cut]).sum(), (hs[cut] ** 2).sum()])
            tot += part.double()
        gden = torch.sqrt(tot[0]).float() + 1e-10
        cc = step / gden.double()
        dnorm = torch.sqrt(torch.clamp(tot[1] - 2 * cc * tot[2] + cc * cc * tot[3], min=0)).float()
        factor = eps / (dnorm + 1e-7) if dnorm > eps else torch.ones(())
        gn = gs[i] / gden
        if mask is not None:
            gn = gn * ms[i]
        d = (xs[i] - gn * step) - ss[i]
        out[i] = torch.clamp(ss[i] + d * factor, min_value, max_value)
    return out.reshape(b, c, h, w)


def _on_ball(x, g, s, m, eps):
    """Move x onto the eps-ball around s, ||x - s|| = eps per sample, and
    point sample 0's gradient outward (x - step * g / ||g|| leaves the ball)
    and sample 1's inward; the gradient is the displacement itself."""
    rng = np.random.default_rng(0)
    d = rng.standard_normal(x.shape)
    d *= eps / np.sqrt((d * d).sum(axis=(1, 2, 3), keepdims=True))
    x = (s + d).astype(np.float32)
    g = np.stack([-(x[0] - s[0]), x[1] - s[1]]).astype(np.float32)
    return x, g, s, m


#: (id, batch, [H, W], mask, step, eps, reference, chunk, edit of the inputs)
K4_CASES = [
    ("pallas-b1", 1, (64, 64), False, 7.5, 0.4, "pallas", None, None),
    ("pallas-b1-mask", 1, (64, 64), True, 7.5, 0.4, "pallas", None, None),
    ("per-sample-b2", 2, (64, 64), False, 2.0, 0.5, "jax", None, None),
    ("per-sample-b2-mask", 2, (64, 64), True, 2.0, 0.5, "jax", None, None),
    ("on-ball-out-and-in", 2, (64, 64), True, 7.5, 32.0, "jax", None,
     lambda x, g, s, m: _on_ball(x, g, s, np.ones_like(m), 32.0)),
    ("zero-gradient", 2, (64, 64), False, 7.5, 0.4, "jax", None,
     lambda x, g, s, m: (x, np.zeros_like(g), s, m)),
    ("zero-mask", 2, (64, 64), True, 7.5, 0.4, "jax", None,
     lambda x, g, s, m: (x, g, s, np.zeros_like(m))),
    ("ragged-chunk", 2, (33, 35), True, 2.0, 0.5, "jax", 300, None),
]


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in K4_CASES])
def test_k4_algorithm_matches_the_jax_update(case):
    """K4's one-pass moments and fixed-order chunk sum give the L2 update of
    the Pallas kernel (interpret mode, batch 1) and of ``l2_perturbation_step``
    (per-sample norms) at ``TOL``: with and without the mask, on the ball
    with the step outward and inward, with a zero gradient, an all-zero
    mask, and a chunk that divides no plane (ragged H x W)."""
    _, b, hw, mask, step, eps, ref, chunk, edit = case
    x, g, s, m = _inputs(b, 60 + b + mask, mask, hw)
    if edit is not None:
        x, g, s, m = edit(x, g, s, m)
    got = _k4_emulated(nchw(x), nchw(g), nchw(s), step, eps, -1.0, 1.0,
                       None if m is None else nchw(m), chunk)
    jm = None if m is None else jnp.asarray(m)
    if ref == "pallas":
        want = j_pgd_l2_update(jnp.asarray(x), jnp.asarray(g), jnp.asarray(s), step, eps, -1.0,
                               1.0, mask=jm, interpret=True)
    else:
        want = j_l2_step(jnp.asarray(x), jnp.asarray(g), jnp.asarray(s), step, eps, -1.0, 1.0, jm)
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
    pk.fused_perturbation_step("l2", x_adv=nchw(x), grad=nchw(g), x_src=nchw(s), step_size=1.0,
                               eps=0.5, min_value=-1.0, max_value=1.0,
                               mask=torch.ones(1, 1, 32, 32))
    assert pk.PGD_L2_UPDATE.launches == 0 and pk.PGD_L2_UPDATE_MASKED.launches == 0
    with pytest.raises(ValueError, match="unknown norm_type"):
        pk.fused_perturbation_step("l1", x_adv=nchw(x))
