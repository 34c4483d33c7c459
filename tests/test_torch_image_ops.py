"""The port's device-side image helpers (``core/image_ops.py``: normalize,
denormalize, resize_bilinear, center_crop, quantize_uint8_roundtrip)
against the JAX package's (``core/image_ops.py:89-119``) on the same
seeded NCHW inputs: equal for the elementwise helpers and the crop, within
1e-5 for the antialiased resize (``jax.image.resize`` and
``F.interpolate(antialias=True)`` sum their taps in another order)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tml_image_editing_defense_tpu.core import image_ops as jops

from tml_image_editing_defense_torch.core import image_ops as pops


def _image(shape, seed, lo=-1.2, hi=1.2):
    """Seeded values a little beyond [-1, 1], so the clamps act, with the
    exact halves of the uint8 grid (k + 0.5) / 255 mapped back to [-1, 1]
    among them, so rounding half to even acts too."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, shape).astype(np.float32)
    halves = ((np.arange(x.size // 4) % 255 + 0.5) / 255.0 * 2.0 - 1.0).astype(np.float32)
    x.reshape(-1)[: halves.size] = halves
    return x


@pytest.mark.parametrize("name", ["normalize", "denormalize", "quantize_uint8_roundtrip"])
def test_elementwise_helpers_equal_jax(name):
    x = _image((2, 3, 17, 23), 0)
    want = np.asarray(getattr(jops, name)(jnp.asarray(x)))
    got = getattr(pops, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,size", [
    ((2, 3, 60, 90), 48),       # landscape, shrink
    ((1, 3, 90, 60), 48),       # portrait, shrink
    ((1, 3, 40, 56), 64),       # landscape, enlarge
    ((2, 3, 33, 33), 20),       # square, shrink by a ratio that is no integer
])
def test_resize_bilinear_matches_jax(shape, size):
    x = _image(shape, 1)
    want = np.asarray(jops.resize_bilinear(jnp.asarray(x), size))
    got = pops.resize_bilinear(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,size", [((2, 3, 48, 72), 48), ((1, 3, 75, 50), 49),
                                        ((1, 3, 32, 32), 32)])
def test_center_crop_equals_jax(shape, size):
    x = _image(shape, 2)
    want = np.asarray(jops.center_crop(jnp.asarray(x), size))
    got = pops.center_crop(torch.from_numpy(x), size).numpy()
    assert got.shape == (*shape[:2], size, size)
    np.testing.assert_array_equal(got, want)
