"""Weight conversion into the port, and the port's full-width key sets.

``from_jax_params`` must give exactly what the JAX package's
``export_state_dict`` gives (key for key, value for value); the port's
SD-1.5 and SDXL modules, built on the meta device (no memory, no weights),
must hold exactly the keys and shapes of the real checkpoints
(tests/manifests/, enumerated independently of either converter).
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tml_image_editing_defense_tpu.models import build_model as jax_build_model
from tml_image_editing_defense_tpu.models.convert import export_state_dict

from tml_image_editing_defense_torch.models.convert import from_jax_params
from tml_image_editing_defense_torch.models.model_zoo import build_model

MANIFESTS = Path(__file__).parent / "manifests"


@pytest.fixture(scope="module")
def jtiny_params():
    m = jax_build_model("tiny", key=jax.random.key(0), image_size=32, fast_init=True)
    return jax.device_get(m.params)


@pytest.mark.parametrize("part,kind", [("unet", "unet"), ("vae", "vae"), ("text", "clip")])
def test_from_jax_params_equals_export_state_dict(jtiny_params, part, kind):
    params = jtiny_params[part][0] if part == "text" else jtiny_params[part]
    want = export_state_dict(params, kind)
    got = from_jax_params(params, kind)
    assert set(got) == set(want)
    for key, arr in want.items():
        assert isinstance(got[key], torch.Tensor)
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)


@pytest.fixture(scope="module")
def jtiny_sdxl_params():
    m = jax_build_model("tiny-sdxl", key=jax.random.key(2), image_size=32, fast_init=True)
    return jax.device_get(m.params)


@pytest.mark.parametrize("part,kind,index", [("unet", "unet", None), ("text", "clip", 0),
                                              ("text", "clip", 1)])
def test_from_jax_params_carries_the_sdxl_parts(jtiny_sdxl_params, part, kind, index):
    """The tiny-sdxl UNet with its ``add_embedding``, and both text encoders
    (encoder 2's ``text_projection`` among them), convert as the JAX
    package exports them."""
    params = jtiny_sdxl_params[part] if index is None else jtiny_sdxl_params[part][index]
    want = export_state_dict(params, kind)
    got = from_jax_params(params, kind)
    assert set(got) == set(want)
    assert {"unet": "add_embedding.linear_2.weight", "clip": "text_projection.weight"}[kind] in got
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)


def _assert_matches_manifest(family, part, name):
    model = build_model(family, device="meta")
    if part.startswith("text"):
        module = model.text_models[int(part[len("text"):] or 0)]
    else:
        module = getattr(model, part)
    got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    want = {k: tuple(v) for k, v in json.loads((MANIFESTS / f"{name}.json").read_text()).items()}
    assert sorted(set(want) - set(got)) == []
    assert sorted(set(got) - set(want)) == []
    assert {k: (got[k], want[k]) for k in want if got[k] != want[k]} == {}


@pytest.mark.parametrize("part,name", [("unet", "sd15_unet"), ("vae", "sd15_vae"),
                                        ("text", "sd15_text")])
def test_sd15_modules_match_checkpoint_manifest(part, name):
    _assert_matches_manifest("sd15", part, name)


@pytest.mark.parametrize("part,name", [("unet", "sdxl_unet"), ("vae", "sdxl_vae"),
                                        ("text0", "sdxl_text"), ("text1", "sdxl_text_2")])
def test_sdxl_modules_match_checkpoint_manifest(part, name):
    """SDXL's UNet (text_time embedding, depth-0 level, linear projections,
    10-layer mid block), VAE and both encoders (CLIP-L; bigG with its
    projection)."""
    _assert_matches_manifest("sdxl", part, name)


def test_sd15_inpaint_unet_matches_checkpoint_manifest():
    _assert_matches_manifest("sd15-inpaint", "unet", "sd15_inpaint_unet")


def test_from_jax_params_carries_the_9_channel_conv_in():
    """The tiny-inpaint UNet's weights load into the port's 9-channel UNet."""
    m = jax_build_model("tiny-inpaint", key=jax.random.key(1), image_size=32, fast_init=True)
    params = jax.device_get(m.params["unet"])
    sd = from_jax_params(params, "unet")
    assert tuple(sd["conv_in.weight"].shape) == (32, 9, 3, 3)
    np.testing.assert_array_equal(sd["conv_in.weight"].numpy(),
                                  np.asarray(params["conv_in"]["kernel"]).transpose(3, 2, 0, 1))
    unet = build_model("tiny-inpaint", device="cpu").unet
    unet.load_state_dict(sd)
    assert torch.equal(unet.conv_in.weight, sd["conv_in.weight"])


def test_from_jax_params_rejects_unknown_kind(jtiny_params):
    with pytest.raises(ValueError, match="unknown kind"):
        from_jax_params(jtiny_params["vae"], "vae2")
