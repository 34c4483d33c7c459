"""The flash-attention op of the port on the CPU: its plain versions (the
reference the CUDA kernels K1-K3 are held against on the card) against the
JAX package's Pallas kernel (interpret mode on the CPU) and its chunked
flash-2 scan, and the attention dispatch.

Tolerances are those of tests/test_pallas_ops.py: forward 1e-5, gradients
1e-4 (f32 on both sides, sums in different orders).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tml_image_editing_defense_tpu.models import layers as jl
from tml_image_editing_defense_tpu.ops.flash_attention import flash_attention as pallas_flash

from tml_image_editing_defense_torch.models import layers as pl
from tml_image_editing_defense_torch.ops import flash_attention as fa

SHAPES = [(2, 512, 8, 40), (1, 256, 4, 80), (1, 256, 1, 512)]
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _port_grads(q, k, v, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with torch.enable_grad():
        o = fa.flash_attention(*ts)
        o.backward(torch.from_numpy(g))
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, q, k, v, g):
    q, k, v, g = (jnp.asarray(a) for a in (q, k, v, g))
    o = fn(q, k, v)
    grads = jax.grad(lambda *a: jnp.vdot(fn(*a), g), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel(shape):
    q, k, v, g = _inputs(shape, sum(shape))
    o, grads = _port_grads(q, k, v, g)
    jo, jgrads = _jax_grads(pallas_flash, q, k, v, g)
    np.testing.assert_allclose(o, jo, **FWD)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a, b, **GRAD)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_chunked_flash2_scan(shape):
    """Against ``layers._chunked_attention_cv`` (the JAX main path's long
    attention) -- forward, lse residual and the flash-2 gradients."""
    q, k, v, g = _inputs(shape, sum(shape) + 1)
    chunk = 128
    o, grads = _port_grads(q, k, v, g)
    jo, jgrads = _jax_grads(lambda *a: jl._chunked_attention_cv(*a, chunk), q, k, v, g)
    np.testing.assert_allclose(o, jo, **FWD)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a, b, **GRAD)
    _, lse = fa.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    _, jlse = jl._chunked_attention_fwd_lse(q, k, v, chunk)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD)


def test_bwd_reference_is_the_autograd_gradient():
    """flash_bwd_reference (what K2/K3 are held against) is the exact
    gradient of the dense softmax attention."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs((1, 64, 2, 40), 3))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        pl.dot_product_attention(*ts).backward(g)
    o, lse = fa.flash_fwd_reference(q, k, v)
    for a, t in zip(fa.flash_bwd_reference(q, k, v, o, lse, g), ts):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), **FWD)


def test_dispatch_routes_long_self_attention_to_the_op(monkeypatch):
    """The JAX rule (layers.py:322): self-attention with S >= max(2 chunk,
    MIN_CHUNKED_SEQ) goes to the flash op; cross-attention (S = 77) and
    shorter sequences take the plain path.  Results equal JAX's dispatch."""
    monkeypatch.setattr(pl, "MIN_CHUNKED_SEQ", 256)
    monkeypatch.setattr(jl, "MIN_CHUNKED_SEQ", 256)
    calls = []
    monkeypatch.setattr(pl, "flash_attention", lambda *a: calls.append(1) or fa.flash_attention(*a))
    rng = np.random.default_rng(11)
    q = rng.standard_normal((1, 512, 4, 40)).astype(np.float32)
    kv = rng.standard_normal((1, 512, 4, 40)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 4, 40)).astype(np.float32)
    short = rng.standard_normal((1, 128, 4, 40)).astype(np.float32)
    cases = [((q, kv, kv), 1), ((q, ctx, ctx), 0), ((short, short, short), 0)]
    for args, routed in cases:
        before = len(calls)
        got = pl.scaled_attention(*(torch.from_numpy(a) for a in args), kv_chunk=128)
        assert len(calls) - before == routed
        want = jl.scaled_attention(*(jnp.asarray(a) for a in args), kv_chunk=128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert pl.scaled_attention(*(torch.from_numpy(a) for a in (q, kv, kv))).shape == q.shape
    assert len(calls) == 1        # no kv_chunk: plain path


def test_launch_counters_stay_zero_on_cpu():
    before = [kern.launches for kern in fa.KERNELS]
    q, k, v, g = _inputs((1, 70, 2, 40), 5)
    _port_grads(q, k, v, g)
    assert [kern.launches for kern in fa.KERNELS] == before == [0, 0, 0]


def test_kernel_wrappers_raise_off_cuda():
    """A kernel-only wrapper never falls back: tensors that are not on the
    card are refused."""
    q = torch.zeros((1, 64, 1, 40))
    lse = torch.zeros((1, 64, 1))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_kv(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_q(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q.to("meta"), q.to("meta"), q.to("meta"))
