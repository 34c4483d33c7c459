"""The port's AutoencoderTiny (TAESD / taesdxl, the universal attack's preview
decoder) against the JAX package's, with the JAX weights carried by
``from_jax_params``: encode and decode values and the decode's VJP at
rtol = atol = 1e-5 (as tests/test_torch_models.py holds the big modules), on
``TINY_TAESD``, on a config whose encoder stages widen, and on a block whose
channels change (the 1x1 skip conv).  The full "taesd" preset's state-dict
keys and shapes equal ``tests/manifests/taesd_vae.json`` and the keys of
``from_jax_params`` on the JAX parameter tree, checked on ``meta``."""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import TOL, nchw, nhwc, one_torch_thread  # noqa: F401
from tml_image_editing_defense_tpu.models import tiny_vae as jtv

from tml_image_editing_defense_torch.models import tiny_vae as tv
from tml_image_editing_defense_torch.models.convert import from_jax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MANIFEST = Path(__file__).parent / "manifests" / "taesd_vae.json"
#: the encoder's stages widen (8 -> 16 channels at the stride-2 entry conv),
#: the decoder takes two blocks in its first stage
WIDENING = dict(encoder_block_out_channels=(8, 16), decoder_block_out_channels=(12, 12),
                num_encoder_blocks=(1, 2), num_decoder_blocks=(2, 1))


def _random_params(module, x_shape, seed: int):
    """Seeded numpy weights of ``module``'s parameter shapes (traced with
    ``eval_shape``, not compiled): fan-in-scaled normal conv kernels (HWIO),
    biases of 0.05-scaled noise."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros(x_shape)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * (0.05 if len(s.shape) == 1 else
                                                    np.prod(s.shape[:3]) ** -0.5))
        .astype(np.float32), shapes["params"])


def _twins(name: str, seed: int):
    """A JAX AutoencoderTiny with seeded weights and the port's twin."""
    jcfg = jtv.TINY_TAESD if name == "tiny" else jtv.TinyVAEConfig(**WIDENING)
    cfg = tv.TINY_TAESD if name == "tiny" else tv.TinyVAEConfig(**WIDENING)
    module = jtv.AutoencoderTiny(jcfg)
    params = _random_params(module, (1, 16, 16, 3), seed)
    port = tv.AutoencoderTiny(cfg)
    port.load_state_dict(from_jax_params(params, "vae"))
    return module, params, port.eval()


@pytest.mark.parametrize("name", ["tiny", "widening"])
def test_tiny_vae_encode_decode_match_jax(name):
    module, params, port = _twins(name, 3)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    apply = jax.jit(lambda a, method: module.apply({"params": params}, a, method=method),
                    static_argnums=1)
    z = np.asarray(apply(x, jtv.AutoencoderTiny.encode))
    f = 2 ** (len(port.config.encoder_block_out_channels) - 1)
    assert z.shape == (2, 16 // f, 16 // f, 4)
    zin = (2.5 * rng.standard_normal(z.shape)).astype(np.float32)    # tanh clamp in play
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(port.encode(nchw(x))), z, **TOL)
        np.testing.assert_allclose(nhwc(port.decode(nchw(zin))),
                                   np.asarray(apply(zin, jtv.AutoencoderTiny.decode)), **TOL)
        np.testing.assert_allclose(nhwc(port(nchw(x))),
                                   np.asarray(apply(x, jtv.AutoencoderTiny.__call__)), **TOL)


@pytest.mark.parametrize("name", ["tiny", "widening"])
def test_tiny_vae_decode_vjp_matches_jax(name):
    module, params, port = _twins(name, 5)
    rng = np.random.default_rng(6)
    f = 2 ** (len(port.config.encoder_block_out_channels) - 1)
    zin = (2.0 * rng.standard_normal((1, 16 // f, 16 // f, 4))).astype(np.float32)

    def decode_vjp(z, cot):
        _, vjp = jax.vjp(lambda a: module.apply({"params": params}, a,
                                                method=jtv.AutoencoderTiny.decode), z)
        return vjp(cot)[0]

    cot = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    want = jax.jit(decode_vjp)(zin, cot)
    with torch.enable_grad():       # another test module may turn grad mode off
        z = nchw(zin).requires_grad_(True)
        (got,) = torch.autograd.grad(port.decode(z), [z], nchw(cot))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


def test_tiny_block_skip_conv_matches_jax():
    """A block whose channels change adds the bias-free 1x1 skip conv (no
    real TAESD block does, but the block takes it)."""
    module = jtv.TinyBlock(in_channels=3, out_channels=6)
    x = np.random.default_rng(7).standard_normal((1, 8, 8, 3)).astype(np.float32)
    params = _random_params(module, x.shape, 8)
    port = tv.TinyBlock(3, 6)
    port.load_state_dict(from_jax_params(params, "vae"))
    assert port.skip.bias is None
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(port(nchw(x))),
                                   np.asarray(module.apply({"params": params}, x)), **TOL)


def test_taesd_keys_match_manifest_and_converter():
    """The full preset's 134 keys: diffusers' AutoencoderTiny names (what the
    real-weight loader will read) and the converter's names for the JAX
    "taesd" tree, all with the manifest's torch shapes."""
    manifest = json.loads(MANIFEST.read_text())
    for preset in ("taesd", "taesdxl"):
        module = tv.build_tiny_autoencoder(preset, device="meta")
        assert {k: list(v.shape) for k, v in module.state_dict().items()} == manifest
    shapes = jtv.tiny_vae_param_shapes("taesd")
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    converted = {k: list(v.shape) for k, v in from_jax_params(tree, "vae").items()}
    assert converted == manifest and len(manifest) == 134


def test_build_tiny_autoencoder_seeded_and_frozen():
    a = tv.build_tiny_autoencoder("tiny", device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    b = tv.build_tiny_autoencoder("tiny", device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert not any(p.requires_grad for p in a.parameters()) and not a.training
    assert a.config == tv.TINY_TAESD and tv.TinyAutoencoder is tv.AutoencoderTiny
    with pytest.raises(ValueError, match="unknown tiny-vae preset"):
        tv.build_tiny_autoencoder("huge", device="cpu")
