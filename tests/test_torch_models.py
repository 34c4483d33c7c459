"""The port's networks against the JAX package's, on the tiny family in f32.

Weights cross through ``tml_image_editing_defense_torch.models.convert.
from_jax_params`` and ``load_state_dict(strict=True)``; inputs are made with
numpy from a seed and handed to both sides.  Tolerance rtol = atol = 1e-5,
that of tests/test_unet_vae_torch_parity.py (both sides f32 on the CPU; the
sums run in different orders).

The helpers here (layout transposes, a tiny port model carrying a JAX
model's weights) are shared by the other ``test_torch_*`` files.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tml_image_editing_defense_tpu.models import build_model as jax_build_model
from tml_image_editing_defense_tpu.models.unet import TINY_UNET as J_TINY_UNET
from tml_image_editing_defense_tpu.models.unet import UNet2DCondition as JUNet

from tml_image_editing_defense_torch.models import layers as port_layers
from tml_image_editing_defense_torch.models.clip_text import TINY_TEXT, CLIPTextModel
from tml_image_editing_defense_torch.models.convert import from_jax_params
from tml_image_editing_defense_torch.models.model_zoo import build_model
from tml_image_editing_defense_torch.models.unet import TINY_UNET, UNet2DCondition
from tml_image_editing_defense_torch.models.vae import TINY_VAE, AutoencoderKL

TOL = dict(rtol=1e-5, atol=1e-5)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's tests on one torch thread.  The tiny models' ops are
    too small to gain from more, and under the suite's parallel workers
    eight OpenMP threads per process contend for the cores, which made
    each small op wait on the scheduler."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(x_nhwc) -> torch.Tensor:
    """NHWC (JAX layout) array -> NCHW torch tensor."""
    a = np.asarray(x_nhwc)
    perm = (0, a.ndim - 1) + tuple(range(1, a.ndim - 1))
    return torch.from_numpy(np.ascontiguousarray(a.transpose(perm)))


def nhwc(x_nchw: torch.Tensor) -> np.ndarray:
    """NCHW torch tensor -> NHWC numpy array."""
    a = x_nchw.detach().numpy()
    return a.transpose((0,) + tuple(range(2, a.ndim)) + (1,))


def port_model_from_jax(jmodel, attn_kv_chunk=None, family=None):
    """A CPU port bundle of ``jmodel``'s family carrying its weights
    (``family`` names it where the JAX bundle keeps only its base family,
    as for ``tiny-inpaint`` and ``tiny-sdxl``)."""
    pm = build_model(family or jmodel.family, image_size=jmodel.image_size, device="cpu",
                     attn_kv_chunk=attn_kv_chunk)
    params = jax.device_get(jmodel.params)
    pm.unet.load_state_dict(from_jax_params(params["unet"], "unet"))
    pm.vae.load_state_dict(from_jax_params(params["vae"], "vae"))
    assert len(pm.text_models) == len(params["text"])
    for text_model, text_params in zip(pm.text_models, params["text"]):
        text_model.load_state_dict(from_jax_params(text_params, "clip"))
    return pm


def jittered(params, seed: int, scale: float = 0.05):
    """``params`` as numpy with every leaf moved by noise, so that biases
    and norm scales (zeros and ones at init) are not trivial."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + rng.normal(0.0, scale, np.shape(p))).astype(np.float32),
        jax.device_get(params))


@pytest.fixture(scope="module")
def jtiny():
    """The JAX tiny bundle with jittered weights (fast on-device init)."""
    m = jax_build_model("tiny", key=jax.random.key(0), image_size=32, fast_init=True)
    return dataclasses.replace(m, params=jittered(m.params, 11))


@pytest.mark.parametrize("t", [[519, 41], [279, 279]])
def test_unet_forward_matches_jax(jtiny, t):
    params = jtiny.params["unet"]
    rng = np.random.default_rng(sum(t))
    sample = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, J_TINY_UNET.cross_attention_dim)).astype(np.float32)
    want = np.asarray(jtiny.unet.apply({"params": params}, sample, jnp.asarray(t), ctx))
    unet = UNet2DCondition(TINY_UNET)
    unet.load_state_dict(from_jax_params(params, "unet"))
    with torch.no_grad():
        got = unet(nchw(sample), torch.tensor(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(nhwc(got), want, **TOL)


def test_unet_long_attention_path_matches_jax(jtiny, monkeypatch):
    """With a kv chunk and the length floor lowered, the port's UNet sends its
    64-token self-attention (head dim 16, outside the kernels' tile plans)
    through the chunked flash-2 scan, and, with 16 taken into
    ``KERNEL_HEAD_DIMS``, through the flash op (plain version on CPU); JAX
    through its chunked flash-2 scan: same outputs either way."""
    import tml_image_editing_defense_tpu.models.layers as jl

    monkeypatch.setattr(jl, "MIN_CHUNKED_SEQ", 16)
    monkeypatch.setattr(port_layers, "MIN_CHUNKED_SEQ", 16)
    calls = {"flash": [], "chunked": []}
    real_flash, real_chunked = port_layers.flash_attention, port_layers._chunked_attention_cv
    monkeypatch.setattr(port_layers, "flash_attention",
                        lambda *a: calls["flash"].append(a[0].shape) or real_flash(*a))
    monkeypatch.setattr(port_layers, "_chunked_attention_cv",
                        lambda *a: calls["chunked"].append(a[0].shape) or real_chunked(*a))
    params = jtiny.params["unet"]
    rng = np.random.default_rng(3)
    sample = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 7, J_TINY_UNET.cross_attention_dim)).astype(np.float32)
    module = JUNet(dataclasses.replace(J_TINY_UNET, attn_kv_chunk=8))
    want = np.asarray(module.apply({"params": params}, sample, jnp.asarray(123), ctx))
    unet = UNet2DCondition(dataclasses.replace(TINY_UNET, attn_kv_chunk=8))
    unet.load_state_dict(from_jax_params(params, "unet"))
    for route, head_dims in (("chunked", port_layers.KERNEL_HEAD_DIMS),
                             ("flash", port_layers.KERNEL_HEAD_DIMS + (16,))):
        monkeypatch.setattr(port_layers, "KERNEL_HEAD_DIMS", head_dims)
        with torch.no_grad():
            got = unet(nchw(sample), 123, torch.from_numpy(ctx))
        assert calls[route] and all(s[1] == 64 for s in calls[route]), calls
        np.testing.assert_allclose(nhwc(got), want, **TOL)
    assert len(calls["flash"]) == len(calls["chunked"]), calls


def test_vae_encode_decode_matches_jax(jtiny):
    module, params = jtiny.vae, jtiny.params["vae"]
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mean, logvar = module.apply({"params": params}, x, method="encode")
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    dec = module.apply({"params": params}, z, method="decode")

    vae = AutoencoderKL(TINY_VAE)
    vae.load_state_dict(from_jax_params(params, "vae"))
    with torch.no_grad():
        t_mean, t_logvar = vae.encode(nchw(x))
        t_dec = vae.decode(nchw(z))
    np.testing.assert_allclose(nhwc(t_mean), np.asarray(mean), **TOL)
    np.testing.assert_allclose(nhwc(t_logvar), np.asarray(logvar), **TOL)
    np.testing.assert_allclose(nhwc(t_dec), np.asarray(dec), **TOL)


def test_clip_text_matches_jax(jtiny):
    module, params = jtiny.text_models[0], jtiny.params["text"][0]
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 998, (3, 16)).astype(np.int32)
    ids[:, 0], ids[0, 5:], ids[1, 9:], ids[2, 15] = 998, 999, 999, 999
    want = module.apply({"params": params}, jnp.asarray(ids))
    clip = CLIPTextModel(TINY_TEXT)
    clip.load_state_dict(from_jax_params(params, "clip"))
    with torch.no_grad():
        got = clip(torch.from_numpy(ids).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_prompt_bank_matches_jax(jtiny):
    pm = port_model_from_jax(jtiny)
    prompts = ["a painting, detailed", ", detailed", "in a city under the rain, detailed"]
    want = jtiny.embed_prompt_bank(prompts, "blurry")
    got = pm.embed_prompt_bank(prompts, "blurry")
    np.testing.assert_allclose(got.embeds.numpy(), np.asarray(want.embeds), **TOL)
    np.testing.assert_allclose(got.uncond.numpy(), np.asarray(want.uncond), **TOL)
    assert got.prompts == prompts


def test_hash_tokenizer_is_byte_exact():
    from tml_image_editing_defense_tpu.models.tokenizer import HashTokenizer as JTok

    from tml_image_editing_defense_torch.models.tokenizer import HashTokenizer

    texts = ["a painting, detailed", "", "Über ünïcode wörds " * 30]
    for kw in ({}, {"vocab_size": 1000, "max_length": 16}):
        np.testing.assert_array_equal(HashTokenizer(**kw)(texts), JTok(**kw)(texts))


def test_build_model_random_init_rule():
    m = build_model("tiny", device="cpu", generator=torch.Generator().manual_seed(1))
    for net in (m.unet, m.vae, m.text_models[0]):
        assert all(not p.requires_grad for p in net.parameters())
    conv = m.unet.conv_in.weight
    assert abs(conv.std().item() * np.sqrt(4 * 9) - 1.0) < 0.2
    assert torch.count_nonzero(m.unet.conv_in.bias) == 0
    assert torch.all(m.unet.conv_norm_out.weight == 1)
    emb = m.text_models[0].text_model.embeddings.token_embedding.weight
    assert abs(emb.std().item() - 0.02) < 0.002
    again = build_model("tiny", device="cpu", generator=torch.Generator().manual_seed(1))
    assert torch.equal(again.unet.conv_in.weight, conv)


def test_build_model_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only machine's error")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model("tiny")
