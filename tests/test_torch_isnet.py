"""The port's ISNet (``models/isnet.py``, RMBG-1.4) against the JAX package's.

- The tiny preset's forward, with the JAX weights (moved off their trivial
  init, running variances kept positive) carried across by
  ``from_jax_params`` and loaded strictly: every side output within 1e-4,
  the tolerance ``tests/test_isnet.py`` holds the JAX model to its torch
  mirror (measured here: about 1e-7).
- The full "rmbg" module on ``meta``: RMBG-1.4's keys and shapes
  (``tests/manifests/rmbg_isnet.json``), BatchNorm counters included.
- ``salient_mask``: its two resizes antialias as ``jax.image.resize`` does,
  so the masks agree except where the JAX map lies within 1e-5 of the
  threshold.
- ``load_rmbg_checkpoint`` through the port's safetensors reader.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_models import one_torch_thread  # noqa: F401
from tml_image_editing_defense_tpu.models.isnet import build_isnet as j_build_isnet
from tml_image_editing_defense_tpu.models.isnet import salient_mask as j_salient_mask

from tml_image_editing_defense_torch.models import isnet
from tml_image_editing_defense_torch.models.convert import from_jax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MANIFEST = Path(__file__).parent / "manifests" / "rmbg_isnet.json"
TOL = 1e-4


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny ISNet with every leaf moved off its init (running
    variances in [0.5, 1.5]) and the port's twin carrying its weights."""
    jb = j_build_isnet("tiny", key=jax.random.key(0), fast_init=True)
    rng = np.random.default_rng(3)

    def jitter(path, p):
        p = np.asarray(p)
        name = path[-1].key
        if name == "running_var":
            return rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
        return (p + rng.normal(0.0, 0.1, p.shape)).astype(np.float32)

    jb.params = jax.tree_util.tree_map_with_path(jitter, jax.device_get(jb.params))
    model = isnet.build_isnet("tiny", device="cpu")
    counters = {k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")}
    model.load_state_dict({**from_jax_params(jb.params, "vae"), **counters}, strict=True)
    return jb, model


@pytest.mark.parametrize("size", [64, 52])
def test_tiny_isnet_matches_jax(tiny_pair, size):
    """Every side output at 64x64, and at 52x52, where the ceil-mode pools
    keep an odd trailing row (52 -> 26 -> 13 -> 7)."""
    jb, model = tiny_pair
    x = np.random.default_rng(size).normal(size=(1, size, size, 3)).astype(np.float32) * 0.4
    want = jb.module.apply({"params": jb.params}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert len(got) == len(want) == len(isnet.TINY_ISNET.enc_stages)
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (1, 1, size, size) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(w),
                                   rtol=TOL, atol=TOL, err_msg=f"side{i + 1}")
        errs.append(float(np.abs(g.numpy().transpose(0, 2, 3, 1) - np.asarray(w)).max()))
    print(f"max abs err per side output at {size}: {errs}")


def test_rmbg_on_meta_has_the_checkpoint_keys():
    model = isnet.build_isnet("rmbg", device="meta")
    manifest = json.loads(MANIFEST.read_text())
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: list(v) for k, v in manifest.items()}
    assert sum(k.endswith("num_batches_tracked") for k in got) == 113
    n_params = sum(p.numel() for p in model.parameters())
    assert 40e6 < n_params < 50e6, n_params


def _jax_normalized_map(jb, img, out_size):
    """The JAX salient_mask's map just before it binarizes (isnet.py:337-345)."""
    s = jb.module.config.image_size
    x = jax.image.resize(jnp.asarray(img)[None], (1, s, s, 3), method="bilinear") - 0.5
    d1 = jb.saliency(jb.params, x)
    d1 = (d1 - d1.min()) / jnp.maximum(d1.max() - d1.min(), 1e-8)
    m = jax.image.resize(d1, (1, out_size, out_size, 1), method="bilinear")
    return np.asarray(m)[0, ..., 0]


@pytest.mark.parametrize("shape,out_size", [((48, 80), 32), ((32, 32), 96)])
def test_salient_mask_matches_jax(tiny_pair, shape, out_size):
    """48x80 -> 64x64 (down one axis, up the other) -> 32x32, and 32x32 ->
    64x64 -> 96x96: the masks agree except where the JAX map lies within
    1e-5 of the threshold."""
    jb, model = tiny_pair
    img = np.random.default_rng(5).uniform(0, 1, (*shape, 3)).astype(np.float32)
    want = j_salient_mask(jb, img, out_size)
    got = isnet.salient_mask(model, img, out_size)
    assert got.shape == (out_size, out_size) and got.dtype == np.float32
    assert set(np.unique(got)) <= {0.0, 1.0}
    m = _jax_normalized_map(jb, img, out_size)
    np.testing.assert_array_equal(want, (m > 0.5).astype(np.float32))
    assert 0 < want.mean() < 1
    off = got != want
    assert np.all(np.abs(m[off] - 0.5) <= 1e-5), int(off.sum())


def test_resize_antialiases_as_jax_does():
    """1024x1024 -> 512x512 within 1e-6 of ``jax.image.resize``; a plain
    bilinear ``F.interpolate`` is off by far more, so this check would fail
    without ``antialias=True``."""
    x = np.random.default_rng(7).normal(size=(1, 1024, 1024, 1)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 512, 512, 1), method="bilinear"))
    t = torch.from_numpy(x.transpose(0, 3, 1, 2))
    got = isnet._resize(t, 512).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = F.interpolate(t, size=(512, 512), mode="bilinear", align_corners=False)
    assert np.abs(plain.numpy().transpose(0, 2, 3, 1) - want).max() > 1e-2


def test_random_weights_give_positive_variances_and_a_finite_mask():
    model = isnet.build_isnet("tiny", device="cpu", generator=torch.Generator().manual_seed(4))
    sd = model.state_dict()
    variances = [v for k, v in sd.items() if k.endswith("running_var")]
    means = [v for k, v in sd.items() if k.endswith("running_mean")]
    assert variances and min(float(v.min()) for v in variances) > 0
    assert max(float(v.abs().max()) for v in means) == 0
    img = np.random.default_rng(0).uniform(0, 1, (32, 32, 3)).astype(np.float32)
    mask = isnet.salient_mask(model, img, 32)
    assert np.isfinite(mask).all() and 0 < mask.mean() < 1
    again = isnet.build_isnet("tiny", device="cpu", generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())


@pytest.fixture(scope="module")
def rmbg_dir(tmp_path_factory):
    """A random full-size RMBG-1.4 written by ``safetensors.torch.save_file``."""
    st_torch = pytest.importorskip("safetensors.torch")
    d = tmp_path_factory.mktemp("rmbg")
    model = isnet.build_isnet("rmbg", device="cpu", generator=torch.Generator().manual_seed(1))
    sd = {k: v.contiguous() for k, v in model.state_dict().items()}
    st_torch.save_file(sd, str(d / "model.safetensors"))
    return d, sd


def test_load_rmbg_checkpoint_loads_every_key(rmbg_dir):
    d, sd = rmbg_dir
    model = isnet.load_rmbg_checkpoint(d, device="cpu")
    assert not model.training
    got = model.state_dict()
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert all(not p.requires_grad for p in model.parameters())


def test_load_rmbg_checkpoint_refuses_a_missing_key_and_an_empty_directory(rmbg_dir, tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    _, sd = rmbg_dir
    part = dict(sd)
    del part["stage3.rebnconv2.conv_s1.weight"]
    del part["side1.bias"]
    (tmp_path / "part").mkdir()
    st_torch.save_file(part, str(tmp_path / "part" / "model.safetensors"))
    with pytest.raises(KeyError, match="stage3.rebnconv2.conv_s1.weight"):
        isnet.load_rmbg_checkpoint(tmp_path / "part", device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        isnet.load_rmbg_checkpoint(tmp_path / "empty", device="cpu")


def test_isnet_runs_in_f32_only():
    """The attack loads ISNet in f32; another dtype is refused rather than
    run with BatchNorm in a precision nothing checks."""
    with pytest.raises(ValueError, match="float32 only"):
        isnet.build_isnet("tiny", device="cpu", dtype="bfloat16")
    assert next(isnet.build_isnet("tiny", device="cpu").parameters()).dtype == torch.float32
