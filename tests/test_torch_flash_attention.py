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
from tml_image_editing_defense_tpu.ops.flash_attention import _bwd as pallas_bwd
from tml_image_editing_defense_tpu.ops.flash_attention import _flash_fwd_res as pallas_fwd_res
from tml_image_editing_defense_tpu.ops.flash_attention import _from_bhtd, _to_bhtd
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
    MIN_CHUNKED_SEQ) goes to the flash op at a compiled head dim and to the
    chunked scan at any other (D = 32); cross-attention (S = 77) and
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
    q32, kv32 = (rng.standard_normal((1, 512, 4, 32)).astype(np.float32) for _ in range(2))
    cases = [((q, kv, kv), 1), ((q, ctx, ctx), 0), ((short, short, short), 0),
             ((q32, kv32, kv32), 0)]
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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), as f32."""
    return x.to(torch.bfloat16).float()


def _bwd_bf16_emulated(q, k, v, do, lse, delta, bs: int, kv_round=None):
    """The bf16 K2 and K3 plans' arithmetic for one (b, h): q, k, v, dO
    [T, D] holding bf16 values, lse and delta [T] f32.  Streamed tiles of
    ``bs`` rows in order (64 at D <= 80, 16 at D = 512; the last one
    ragged): S and dP in f32 from the bf16 operands, P = 2^(S scale log2(e)
    - lse log2(e)) and dS = P (dP - delta) scale in f32, P and dS rounded
    to bf16 as the operands of the next product, accumulators in f32.  K2
    walks the Q tiles (dV += P^T dO, dK += dS^T Q), K3 the KV tiles
    (dQ += dS K).  ``kv_round`` replaces K2's rounding of P and dS (D = 512:
    K2 keeps its mma.sync plan, which rounds them to TF32).  Returns (dq,
    dk, dv) rounded once to bf16."""
    t, d = q.shape
    scale = np.float32(1.0 / np.sqrt(d))
    sl2 = torch.tensor(scale * np.float32(np.log2(np.e)), dtype=torch.float32)
    l2 = lse * torch.tensor(np.log2(np.e), dtype=torch.float32)
    kv_round = kv_round or _bf16

    def p_ds(qs, ks, dos, vs, l2s, ds_):
        p = torch.exp2(qs @ ks.T * sl2 - l2s[:, None])
        return p, p * (dos @ vs.T - ds_[:, None]) * scale

    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)
    for q0 in range(0, t, bs):          # K2: each Q tile against every KV row
        sl = slice(q0, q0 + bs)
        p, ds = p_ds(q[sl], k, do[sl], v, l2[sl], delta[sl])
        dv += kv_round(p).T @ do[sl]
        dk += kv_round(ds).T @ q[sl]
    for k0 in range(0, t, bs):          # K3: every Q row against each KV tile
        sl = slice(k0, k0 + bs)
        _, ds = p_ds(q, k[sl], do, v[sl], l2, delta)
        dq += _bf16(ds) @ k[sl]
    return _bf16(dq), _bf16(dk), _bf16(dv)


#: (shape, streamed tile rows): T a multiple of the Pallas block's 128
BF16_CASES = [((2, 256, 2, 40), 64), ((1, 256, 2, 64), 64), ((1, 128, 1, 512), 16)]


@pytest.mark.parametrize("shape,bs", BF16_CASES, ids=[f"D{c[0][-1]}" for c in BF16_CASES])
def test_bf16_wgmma_arithmetic_against_pallas_and_reference(shape, bs):
    """The bf16 K2 and K3 (csrc/flash_attention.cu, the wgmma plans; K2 at
    D = 512 keeps its mma.sync plan) are meant to round P and dS to bf16
    where the Pallas ``_bwd_kv_kernel`` and ``_bwd_q_kernel`` do, with f32
    scores and accumulators.  This test pins those rounding points only: it
    runs ``_bwd_bf16_emulated``, a plain-torch emulation of the plans'
    arithmetic written here, and no code of the port or of its kernels, so
    a change to the kernels cannot fail it.  The kernels themselves are
    held against the plain versions on the card (``chip_smoke.check_flash``,
    at the data's scale: ``BF16_BWD_NORM_TOL``, ``BF16_BWD_PEAK_TOL``).
    The emulation, on bf16 inputs made from a seed, against:

    - the Pallas ``_bwd`` in interpret mode on the same inputs, lse and o:
      each output of a wgmma plan's emulation bit-equal on at least 99 % of
      its elements, and every output within 2^-8 max(1, |ref|) (sums in
      another order can move a P or dS element by one rounding step, which
      moves an output by up to about 2^-9 of its largest element; measured:
      at most 0.26 % of the elements differ, by at most 2^-9 max(1, |ref|));
      K2 at D = 512, which rounds P and dS to TF32, within one bf16 ulp of
      the largest element, 2^-7 max(1, |ref|) (measured: 41-43 % of dK and
      dV differ, by at most 2^-8 max(1, |ref|));
    - ``flash_bwd_reference`` (dense f32, rounded once): within the card's
      bf16 tolerance, 2e-2 max(1, |ref|) (``chip_smoke.check_flash``;
      measured: at most 3.9e-3, as the Pallas backward's own)."""
    b, t, h, d = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd_reference(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    ref = fa.flash_bwd_reference(q, k, v, o, lse, do)
    kv_wgmma = d <= 128
    got = [torch.zeros(shape) for _ in range(3)]
    for bi in range(b):
        for hi in range(h):
            parts = _bwd_bf16_emulated(*(x[bi, :, hi].float() for x in (q, k, v, do)),
                                       lse[bi, :, hi], delta[bi, :, hi], bs,
                                       None if kv_wgmma else _tf32)
            for g, part in zip(got, parts):
                g[bi, :, hi] = part

    def jx(x):
        return _to_bhtd(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))

    jlse = jnp.asarray(lse.permute(0, 2, 1).reshape(b * h, 1, t).numpy())
    want = [np.array(_from_bhtd(x, b, h, d).astype(jnp.float32))
            for x in pallas_bwd(jx(q), jx(k), jx(v), jx(o), jlse, jx(do), 1.0 / np.sqrt(d))]
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        w = torch.from_numpy(w)
        wgmma_plan = i == 0 or kv_wgmma
        if wgmma_plan:
            assert (g != w).float().mean().item() <= 0.01
        assert (g - w).abs().max().item() <= 2.0 ** (-8 if wgmma_plan else -7) * max(
            1.0, w.abs().max().item())
        r = r.float()
        assert (g - r).abs().max().item() <= 2e-2 * max(1.0, r.abs().max().item())


def _fwd_bf16_emulated(q, k, v, bk: int):
    """The bf16 K1 plans' arithmetic for one (b, h): q, k, v [T, D] holding
    bf16 values.  KV tiles of ``bk`` rows in order (64 at D <= 80, 32 at
    D = 512; the last one ragged): S in f32 from the bf16 operands, the
    online softmax in base 2 (m = max S scale log2(e), P = 2^(S scale
    log2(e) - m), corr = 2^(m_prev - m)), P rounded to bf16 as the operand
    of P V, l summed from the unrounded P, the accumulator in f32; o = acc /
    l rounded once to bf16 and lse = m ln 2 + log l."""
    t, d = q.shape
    sl2 = torch.tensor(np.float32(1.0 / np.sqrt(d)) * np.float32(np.log2(np.e)),
                       dtype=torch.float32)
    m = torch.full((t,), -torch.inf)
    l = torch.zeros(t)
    acc = torch.zeros(t, d)
    for k0 in range(0, k.shape[0], bk):
        s = q @ k[k0:k0 + bk].T
        m_new = torch.maximum(m, s.max(1).values * sl2)
        corr = torch.exp2(m - m_new)                  # 0 at the first tile
        p = torch.exp2(s * sl2 - m_new[:, None])
        l = l * corr + p.sum(1)
        acc = acc * corr[:, None] + _bf16(p) @ v[k0:k0 + bk]
        m = m_new
    return _bf16(acc / l[:, None]), m * np.float32(np.log(2.0)) + torch.log(l)


#: (shape, KV tile rows): the small plan's 64-row tiles at D = 40 and 64
#: (T = 1024: two of the Pallas kernel's 512-row blocks), the wide plan's 32
BF16_FWD_CASES = [((2, 256, 2, 40), 64), ((1, 256, 2, 64), 64), ((1, 1024, 1, 64), 64),
                  ((1, 128, 1, 512), 32)]


@pytest.mark.parametrize("shape,bk", BF16_FWD_CASES,
                         ids=[f"T{c[0][1]}-D{c[0][-1]}" for c in BF16_FWD_CASES])
def test_bf16_k1_arithmetic_against_pallas_and_reference(shape, bk):
    """The bf16 K1 (csrc/flash_attention.cu, ``flash_fwd_kernel_tma`` and
    ``flash_fwd_kernel_wide``) is meant to round P to bf16 where the Pallas
    ``_fwd_kernel`` does (``p.astype(v_ref.dtype)``), with f32 scores,
    statistics and accumulator and o rounded once.  (At D = 512 under one
    wave of 64-row blocks the launcher keeps the one-pass TF32 ``mma.sync``
    plan, which rounds P to TF32, finer than this.)  This test pins those
    rounding points only: it runs ``_fwd_bf16_emulated``, a plain-torch
    emulation of the plans' arithmetic written here, and no code of the port
    or of its kernels; the kernels are held against the plain version on
    the card (``chip_smoke.check_flash``: ``BF16_FWD_NORM_TOL``,
    ``BF16_FWD_PEAK_TOL``, ``BF16_LSE_TOL``).  The emulation, on bf16
    inputs made from a seed, against:

    - the Pallas ``_fwd`` in interpret mode on the same inputs: o bit-equal
      on at least 60 % of its elements (measured: 69-74 %; the Pallas block
      is 512 rows, so it rescales and rounds P at other points than 64- or
      32-row tiles, and a P element one rounding step apart moves o by up
      to one bf16 ulp), o within 2^-7 max(1, |ref|) (measured: at most
      2^-8), lse within 1e-5 (measured: at most 9.6e-7);
    - ``flash_fwd_reference`` (dense f32, rounded once): o within 4e-3
      normwise (measured: 2.2-2.3e-3; the Pallas forward's own 2.3-2.4e-3)
      and 2^-6 of the peak (measured: at most 6.2e-3), lse within 1e-5."""
    b, t, h, d = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
    got_o, got_lse = torch.zeros(shape), torch.zeros((b, t, h))
    for bi in range(b):
        for hi in range(h):
            got_o[bi, :, hi], got_lse[bi, :, hi] = _fwd_bf16_emulated(
                *(x[bi, :, hi].float() for x in (q, k, v)), bk)
    jo, res = pallas_fwd_res(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                               for x in (q, k, v)))
    jo = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    jlse = torch.from_numpy(np.array(res[-1])).reshape(b, h, t).permute(0, 2, 1)
    assert (got_o == jo).float().mean().item() >= 0.6
    assert (got_o - jo).abs().max().item() <= 2.0 ** -7 * max(1.0, jo.abs().max().item())
    assert (got_lse - jlse).abs().max().item() <= 1e-5
    o_ref = o_ref.float()
    assert ((got_o - o_ref).norm() / o_ref.norm()).item() <= 4e-3
    assert ((got_o - o_ref).abs().max() / o_ref.abs().max()).item() <= 2.0 ** -6
    assert (got_lse - lse_ref).abs().max().item() <= 1e-5


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
