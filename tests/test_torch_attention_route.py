"""The port's long-attention routes on the CPU: the rule that picks the
flash kernels (K1-K3), the chunked online-softmax scan or plain attention
from shapes alone, and the chunked scan with its flash-2 backward
(``models/layers.py::_chunked_attention_cv``) against the JAX package's
``_chunked_attention_cv`` and ``_chunked_attention_fwd_lse``.

Tolerances are those of tests/test_torch_flash_attention.py: forward 1e-5,
gradients 1e-4 (f32 on both sides, sums in different orders).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tml_image_editing_defense_tpu.models import layers as jl

from tml_image_editing_defense_torch.api import EVAL_ATTN_CHUNK, _train_attn_chunk
from tml_image_editing_defense_torch.models import layers as pl
from tml_image_editing_defense_torch.models.unet import SD15_UNET
from tml_image_editing_defense_torch.models.vae import TINY_VAE
from tml_image_editing_defense_torch.ops import flash_attention as fa

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _tiny_vae_mid_shape(image_size: int):
    """The tiny family's VAE mid-block attention: one head of the last
    level's width over the latent's tokens (one downsample a level)."""
    side = image_size >> (len(TINY_VAE.block_out_channels) - 1)
    return (1, side * side, 1, TINY_VAE.block_out_channels[-1])


def _sd15_unet_level_shape(image_size: int, level: int):
    """SD-1.5's UNet self-attention at ``level`` under CFG (batch 2)."""
    side = (image_size // 8) >> level
    heads = SD15_UNET.num_attention_heads[level]
    return (2, side * side, heads, SD15_UNET.block_out_channels[level] // heads)


#: (q shape, kv length, kv chunk, route) on the shapes the real
#: configurations send; the chunked ones raised on the card before the rule
ROUTES = [
    (_tiny_vae_mid_shape(512), _train_attn_chunk(512), "chunked"),
    (_tiny_vae_mid_shape(128), EVAL_ATTN_CHUNK, "chunked"),
    (_sd15_unet_level_shape(1536, 2), _train_attn_chunk(1536), "chunked"),
    (_sd15_unet_level_shape(1536, 1), _train_attn_chunk(1536), "flash"),
    (_sd15_unet_level_shape(1536, 0), _train_attn_chunk(1536), "flash"),
    ((2, 4096, 8, 40), 512, "flash"),
    ((1, 4096, 1, 512), 512, "flash"),
    ((2, 4096, 10, 64), 512, "flash"),
    ((1, 16384, 1, 512), 512, "flash"),
    ((2, 4096, 10, 80), 512, "flash"),
    ((2, 1024, 10, 64), 512, "plain"),          # SDXL at 512x512: under the floor
    ((2, 4096, 8, 40), None, "plain"),           # no chunk: the evaluate-less builds
]


@pytest.mark.parametrize("q_shape,kv_chunk,route", ROUTES,
                         ids=[f"{'x'.join(map(str, s))}-{r}" for s, _, r in ROUTES])
def test_route_rule_on_the_real_shapes(q_shape, kv_chunk, route):
    """The rule reads shapes only: long self-attention at a compiled head dim
    -> flash, at any other head dim -> chunked, below the floor -> plain."""
    assert pl.attention_route(q_shape, q_shape[1], kv_chunk) == route


def test_the_shapes_of_the_fault():
    """The configurations that raised on the card: the tiny family's VAE
    mid-block at 512x512 and SD-1.5's UNet level 2 at 1536x1536."""
    assert _tiny_vae_mid_shape(512) == (1, 65536, 1, 32)
    assert _sd15_unet_level_shape(1536, 2) == (2, 2304, 8, 160)
    assert _sd15_unet_level_shape(1536, 1) == (2, 9216, 8, 80)


def test_route_rule_edges():
    """Every compiled head dim takes the flash route; cross-attention at
    S = 77 and a long S with T != S take plain and chunked; the floor is
    max(2 kv_chunk, MIN_CHUNKED_SEQ)."""
    for d in fa.KERNEL_HEAD_DIMS:
        assert pl.attention_route((1, 4096, 1, d), 4096, 512) == "flash"
    for d in (16, 32, 48, 96, 128, 160, 256):
        assert pl.attention_route((1, 4096, 1, d), 4096, 512) == "chunked"
    assert pl.attention_route((2, 4096, 8, 40), 77, 512) == "plain"
    assert pl.attention_route((2, 1024, 8, 40), 4096, 512) == "chunked"
    assert pl.attention_route((1, 2047, 1, 40), 2047, 512) == "plain"
    assert pl.attention_route((1, 2048, 1, 40), 2048, 512) == "flash"
    assert pl.attention_route((1, 3000, 1, 40), 3000, 2048) == "plain"


def _inputs(shape, seed, s=None):
    rng = np.random.default_rng(seed)
    kv = (shape[0], s or shape[1], shape[2], shape[3])
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(kv).astype(np.float32),
            rng.standard_normal(kv).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _port_grads(fn, q, k, v, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with torch.enable_grad():
        o = fn(*ts)
        o.backward(torch.from_numpy(g))
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_grads(fn, q, k, v, g):
    q, k, v, g = (jnp.asarray(a) for a in (q, k, v, g))
    o = fn(q, k, v)
    grads = jax.grad(lambda *a: jnp.vdot(fn(*a), g), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in grads]


#: (q shape, kv length, chunk): ragged T at D = 16, 32 and 160, a T under
#: one chunk, and a cross-attention with S != T
CHUNKED_CASES = [
    ((1, 100, 2, 16), None, 32),
    ((2, 75, 1, 32), None, 16),
    ((1, 50, 2, 160), None, 16),
    ((1, 7, 1, 32), None, 16),
    ((1, 40, 2, 16), 77, 16),
]


@pytest.mark.parametrize("shape,s,chunk", CHUNKED_CASES,
                         ids=[f"T{c[0][1]}-S{c[1] or c[0][1]}-D{c[0][3]}-C{c[2]}"
                              for c in CHUNKED_CASES])
def test_chunked_matches_jax(shape, s, chunk):
    """o, lse and the three gradients of the port's chunk scan against the
    JAX ``_chunked_attention_cv`` (its custom VJP) and
    ``_chunked_attention_fwd_lse``, on seeded inputs."""
    q, k, v, g = _inputs(shape, sum(shape) + chunk, s)
    o, grads = _port_grads(lambda *a: pl._chunked_attention_cv(*a, chunk), q, k, v, g)
    jo, jgrads = _jax_grads(lambda *a: jl._chunked_attention_cv(*a, chunk), q, k, v, g)
    np.testing.assert_allclose(o, jo, **FWD)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a, b, **GRAD)
    o2, lse = pl._chunked_attention_fwd_lse(*(torch.from_numpy(a) for a in (q, k, v)), chunk)
    jo2, jlse = jl._chunked_attention_fwd_lse(q, k, v, chunk)
    np.testing.assert_allclose(o2.numpy(), np.asarray(jo2), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD)


def test_chunked_agrees_with_the_dense_reference():
    """At a compiled head dim the chunk scan and the flash op's plain
    version (dense f32) agree: forward, lse and the flash-2 gradients."""
    q, k, v, g = _inputs((1, 130, 2, 40), 4)
    o, grads = _port_grads(lambda *a: pl._chunked_attention_cv(*a, 32), q, k, v, g)
    fo, fgrads = _port_grads(fa.flash_attention, q, k, v, g)
    np.testing.assert_allclose(o, fo, **FWD)
    for a, b in zip(grads, fgrads):
        np.testing.assert_allclose(a, b, **GRAD)
    _, lse = pl._chunked_attention_fwd_lse(*(torch.from_numpy(a) for a in (q, k, v)), 32)
    _, flse = fa.flash_fwd_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(lse.numpy(), flse.numpy(), **FWD)


@pytest.mark.parametrize("d", [16, 32, 160])
def test_scaled_attention_takes_the_chunked_route(monkeypatch, d):
    """``scaled_attention`` at a head dim outside K1-K3's tile plans, the
    floor lowered as the JAX tests lower it: the chunked route, never the
    flash op, and JAX's ``scaled_attention`` result and gradients."""
    monkeypatch.setattr(pl, "MIN_CHUNKED_SEQ", 64)
    monkeypatch.setattr(jl, "MIN_CHUNKED_SEQ", 64)
    flash_calls = []
    monkeypatch.setattr(pl, "flash_attention", lambda *a: flash_calls.append(1))
    q, k, v, g = _inputs((1, 150, 2, d), d)
    o, grads = _port_grads(lambda *a: pl.scaled_attention(*a, kv_chunk=32), q, k, v, g)
    jo, jgrads = _jax_grads(lambda *a: jl.scaled_attention(*a, kv_chunk=32), q, k, v, g)
    assert not flash_calls
    np.testing.assert_allclose(o, jo, **FWD)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a, b, **GRAD)
