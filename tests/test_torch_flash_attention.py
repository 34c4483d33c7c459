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
from tml_image_editing_defense_tpu.ops.flash_attention import _flash_fwd_res as pallas_fwd_res
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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped 13 bits'
    range to the magnitude bits, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads from an f32 register given as TF32: the 13
    low mantissa bits dropped."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as K2/K3 run it on the tensor cores: each operand x split into
    hi = tf32(x) and lo = x - hi (read by the tensor core with its low bits
    dropped), then ahi bhi (one pass) or alo bhi + ahi blo + ahi bhi (three
    passes); products of TF32 values are exact in f32 and the sums are f32."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if passes == 3:
        out = _tf32_trunc(a - ah) @ bh + ah @ _tf32_trunc(b - bh) + out
    return out


def _k1_emulated(q, k, v, passes: int, bk: int):
    """K1's arithmetic for one (b, h), q/k/v [T, D] f32: KV tiles of ``bk``
    rows (the last one ragged), S and P V as the tensor cores run them
    (``_tf32_mm``: Q, K, P and V split into TF32 operands), and the online
    softmax in base 2 with an f32 running max m and sum l.  Returns
    (o, lse)."""
    sl2 = torch.tensor(1.0 / np.sqrt(q.shape[-1]) * np.log2(np.e), dtype=torch.float32)
    m = torch.full((q.shape[0],), -torch.inf)
    l = torch.zeros(q.shape[0])
    acc = torch.zeros_like(q)
    for k0 in range(0, k.shape[0], bk):
        s = _tf32_mm(q, k[k0:k0 + bk].T, passes) * sl2
        m_new = torch.maximum(m, s.max(1).values)
        corr = torch.exp2(m - m_new)                  # 0 at the first tile
        p = torch.exp2(s - m_new[:, None])
        l = l * corr + p.sum(1)
        acc = acc * corr[:, None] + _tf32_mm(p, v[k0:k0 + bk], passes)
        m = m_new
    return acc / l[:, None], m * np.float32(np.log(2.0)) + torch.log(l)


def pallas_lse(q, k, v):
    """The Pallas forward (interpret mode on the CPU) on [B, T, H, D] numpy
    inputs: o [B, T, H, D] and lse [B, T, H]."""
    b, t, h, _ = q.shape
    o, res = pallas_fwd_res(*(jnp.asarray(a) for a in (q, k, v)))
    return np.array(o), np.array(res[-1]).reshape(b, h, t).transpose(0, 2, 1)


def _fwd_err(got, want) -> float:
    """chip_smoke.py's measure for K1: the larger of the errors of o and lse,
    over max(1, |o|)."""
    (o, lse), (o_ref, lse_ref) = got, want
    err = max((o - o_ref).abs().max().item(), (lse - lse_ref).abs().max().item())
    return err / max(1.0, o_ref.abs().max().item())


#: Backward cases keep their ids; forward cases emulate K1 at each plan's
#: KV tile (64 rows at D = 40, 16 at D = 512) and a ragged T.
TF32_CASES = [
    pytest.param("backward", shape, passes, id=f"shape{i}-{passes}")
    for i, shape in enumerate([(1, 128, 1, 40), (1, 64, 1, 512)]) for passes in (3, 1)
] + [
    pytest.param("forward", shape, passes, id=f"forward-T{shape[1]}-D{shape[3]}-{passes}")
    for shape in [(1, 200, 1, 40), (1, 150, 1, 512)] for passes in (3, 1)
]


@pytest.mark.parametrize("kernel,shape,passes", TF32_CASES)
def test_tf32_passes_against_the_f32_tolerance(kernel, shape, passes):
    """Why the f32 kernels take three TF32 passes.

    Backward: all five products split as K2/K3 split them (S, dP, dV, dK,
    dQ; P and dS rounded to TF32 as operands) are within the 1e-4 x
    max(1, |ref|) that the card's check holds K2/K3 to with three passes,
    and outside it with one.

    Forward: K1's tile walk (``_k1_emulated``) at T = 200 (D = 40, 64-row
    KV tiles) and T = 150 (D = 512, 16-row tiles), and on the first 128
    rows, a T that the Pallas kernel takes: o and lse within 1e-4 x
    max(1, |o|) of ``flash_fwd_reference`` (and, at T = 128, of the Pallas
    forward in interpret mode) with three passes; with one pass, outside
    it against the reference at both shapes."""
    if kernel == "forward":
        q, k, v = (torch.from_numpy(a) for a in _inputs(shape, 7)[:3])
        bk = 16 if shape[-1] > 128 else 64
        got = _k1_emulated(q[0, :, 0], k[0, :, 0], v[0, :, 0], passes, bk)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
        err = _fwd_err(got, (o_ref[0, :, 0], lse_ref[0, :, 0]))
        if passes == 1:
            assert err > 1e-4, err
            return
        assert err <= 1e-4, err
        q, k, v = (x[:, :128] for x in (q, k, v))
        got = _k1_emulated(q[0, :, 0], k[0, :, 0], v[0, :, 0], passes, bk)
        jo, jlse = pallas_lse(q.numpy(), k.numpy(), v.numpy())
        assert _fwd_err(got, (torch.from_numpy(jo)[0, :, 0], torch.from_numpy(jlse)[0, :, 0])) \
            <= 1e-4
        return
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(shape, 7))
    o, lse = fa.flash_fwd_reference(q, k, v)
    want = fa.flash_bwd_reference(q, k, v, o, lse, g)
    delta = (g * o).sum(-1)
    q1, k1, v1, g1 = (x[0, :, 0] for x in (q, k, v, g))
    l1, d1 = lse[0, :, 0], delta[0, :, 0]
    scale = 1.0 / np.sqrt(shape[-1])
    p = torch.exp(_tf32_mm(q1, k1.T, passes) * scale - l1[:, None])
    ds = p * (_tf32_mm(g1, v1.T, passes) - d1[:, None]) * scale
    got = (_tf32_mm(ds, k1, passes), _tf32_mm(ds.T, q1, passes), _tf32_mm(p.T, g1, passes))
    errs = [((a - w[0, :, 0]).abs().max() / max(1.0, w.abs().max().item())).item()
            for a, w in zip(got, want)]
    if passes == 3:
        assert max(errs) <= 1e-4, errs
    else:
        assert max(errs) > 1e-4, errs


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
