"""The params bundle shared by both packages: flax's msgpack state dict,
read and written by the port without flax or msgpack.

A bundle the JAX package writes loads into the port bit for bit, and one
the port writes loads into the JAX package bit for bit: on ``tiny`` and
``tiny-sdxl`` (two text encoders), in bf16, and in flax's chunked form for
large arrays.  ``to_jax_params`` must give exactly the JAX trees' paths and
shapes at full width (``jax.eval_shape``, no weights).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from tml_image_editing_defense_tpu.models import build_model as jax_build_model
from tml_image_editing_defense_tpu.models import checkpoint_io as j_io
from tml_image_editing_defense_tpu.models.model_zoo import param_shapes

from tml_image_editing_defense_torch.models import checkpoint_io
from tml_image_editing_defense_torch.models.convert import from_jax_params, to_jax_params
from tml_image_editing_defense_torch.models.model_zoo import build_model
from test_torch_models import jittered, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@functools.lru_cache(maxsize=None)
def _jax_template(family):
    return jax_build_model(family, key=jax.random.key(0), image_size=32, fast_init=True)


def _jax_model(family, seed):
    """The JAX bundle (built once per family) and weights jittered by ``seed``."""
    m = _jax_template(family)
    return m, jittered(m.params, seed + 100)


def _port_parts(pm):
    return [("unet", "unet", pm.unet), ("vae", "vae", pm.vae)] + [
        (("text", i), "clip", m) for i, m in enumerate(pm.text_models)]


def _sub(params, part):
    return params[part] if isinstance(part, str) else params[part[0]][part[1]]


def _assert_port_holds(pm, params):
    """Every tensor of the port model equals the JAX tree's, bit for bit."""
    for part, kind, module in _port_parts(pm):
        want = from_jax_params(_sub(params, part), kind)
        got = module.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("family", ["tiny", "tiny-sdxl"])
def test_jax_bundle_loads_into_the_port_bit_equal(tmp_path, family):
    _, params = _jax_model(family, 3)
    path = tmp_path / "w.msgpack"
    j_io.save_params(path, params)
    pm = build_model(family, image_size=32, device="cpu")
    assert checkpoint_io.load_params(path, pm) is pm
    _assert_port_holds(pm, params)


@pytest.mark.parametrize("family", ["tiny", "tiny-sdxl"])
def test_port_bundle_loads_into_jax_bit_equal(tmp_path, family):
    pm = build_model(family, image_size=32, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    path = tmp_path / "w.msgpack"
    checkpoint_io.save_params(path, pm)
    jm, _ = _jax_model(family, 7)
    loaded = j_io.load_params(path, jax.device_get(jm.params))
    assert len(loaded["text"]) == len(pm.text_models)
    _assert_port_holds(pm, loaded)
    # and the file is flax's own: msgpack_restore reads it
    assert set(serialization.msgpack_restore(path.read_bytes())) == {"unet", "vae", "text"}


def test_bf16_bundle_both_ways(tmp_path):
    """bfloat16, which numpy lacks: JAX -> port and port -> JAX, bit-equal."""
    _, params = _jax_model("tiny", 4)
    params16 = jax.device_get(jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params))
    j_path = tmp_path / "j.msgpack"
    j_io.save_params(j_path, params16)
    pm = build_model("tiny", image_size=32, device="cpu", dtype="bfloat16")
    checkpoint_io.load_params(j_path, pm)
    for part, kind, module in _port_parts(pm):
        for k, v in module.state_dict().items():
            assert v.dtype == torch.bfloat16
        flat = traverse_util.flatten_dict(_sub(params16, part))
        mine = traverse_util.flatten_dict(to_jax_params(module.state_dict(), kind))
        assert set(flat) == set(mine)
        for p, arr in flat.items():
            np.testing.assert_array_equal(mine[p].float().numpy(),
                                          np.asarray(arr, np.float32), err_msg=str(p))
    p_path = tmp_path / "p.msgpack"
    checkpoint_io.save_params(p_path, pm)
    back = j_io.load_params(p_path, jax.device_get(params16))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32),
                                                            np.asarray(b, np.float32)),
                 back, params16)
    assert jax.tree.leaves(back)[0].dtype == jnp.bfloat16


def test_load_params_dtype_rounds_through_it(tmp_path):
    """``dtype`` casts the tree first, as the JAX ``load_params(dtype=)``
    does; the values land in each parameter's own dtype."""
    _, params = _jax_model("tiny", 6)
    path = tmp_path / "w.msgpack"
    j_io.save_params(path, params)
    pm = build_model("tiny", image_size=32, device="cpu")
    checkpoint_io.load_params(path, pm, dtype="bfloat16")
    want = j_io.load_params(path, jax.device_get(params), dtype=jnp.bfloat16)
    w = np.asarray(want["unet"]["conv_in"]["kernel"], np.float32).transpose(3, 2, 0, 1)
    assert pm.unet.conv_in.weight.dtype == torch.float32
    np.testing.assert_array_equal(pm.unet.conv_in.weight.numpy(), w)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_chunked_arrays_both_ways(tmp_path, monkeypatch, direction):
    """Arrays over MAX_CHUNK_SIZE bytes take flax's chunked form; forced
    here with a small limit, on the writing side."""
    _, params = _jax_model("tiny", 8)
    path = tmp_path / "w.msgpack"
    if direction == "jax_to_port":
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
        j_io.save_params(path, params)
        assert b"__msgpack_chunked_array__" in path.read_bytes()
        pm = build_model("tiny", image_size=32, device="cpu")
        checkpoint_io.load_params(path, pm)
        _assert_port_holds(pm, params)
    else:
        monkeypatch.setattr(checkpoint_io, "MAX_CHUNK_SIZE", 256)
        pm = build_model("tiny", image_size=32, device="cpu",
                         generator=torch.Generator().manual_seed(9))
        checkpoint_io.save_params(path, pm)
        assert b"__msgpack_chunked_array__" in path.read_bytes()
        jm, _ = _jax_model("tiny", 10)
        _assert_port_holds(pm, j_io.load_params(path, jax.device_get(jm.params)))


def test_bundle_missing_an_encoder_raises(tmp_path):
    _, params = _jax_model("tiny", 11)
    path = tmp_path / "w.msgpack"
    j_io.save_params(path, params)
    with pytest.raises(KeyError, match="text encoder"):
        checkpoint_io.load_params(path, build_model("tiny-sdxl", image_size=32, device="cpu"))


@pytest.mark.parametrize("obj", [
    {"a": 1, "b": -1, "c": -33, "d": 200, "e": 70000, "f": 2 ** 40, "g": -(2 ** 40)},
    {"s": "x" * 40, "t": "é" * 200, "n": None, "y": True, "z": False, "fl": 1.5},
    {"bin": b"\x00\x01" * 200, "list": [1, "two", [3.0, None]], "big": list(range(20))},
    {str(i): {"k": i} for i in range(40)},
])
def test_msgpack_codec_matches_the_msgpack_package(tmp_path, obj):
    """The port's codec against ``msgpack`` on every type a bundle holds."""
    path = tmp_path / "x.msgpack"
    checkpoint_io.write_msgpack(path, obj)
    assert msgpack.unpackb(path.read_bytes(), raw=False) == obj
    assert path.read_bytes() == msgpack.packb(obj, use_bin_type=True)
    path.write_bytes(msgpack.packb(obj, use_bin_type=True))
    assert checkpoint_io.read_msgpack(path) == obj


def test_msgpack_reader_refuses_trailing_and_truncated_data(tmp_path):
    path = tmp_path / "x.msgpack"
    path.write_bytes(msgpack.packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="after the msgpack object"):
        checkpoint_io.read_msgpack(path)
    path.write_bytes(msgpack.packb({"a": "abc"})[:-1])
    with pytest.raises(ValueError, match="truncated"):
        checkpoint_io.read_msgpack(path)


@pytest.mark.parametrize("family", ["sd15", "sd15-inpaint", "sdxl"])
def test_to_jax_params_nests_exactly_as_the_jax_trees(family):
    """At full width, on the meta device: every path and shape of
    ``to_jax_params`` of the port's state dicts is the JAX tree's, no more,
    no less (e.g. ``down_blocks_0_attentions_0 / transformer_blocks_0 /
    attn1 / to_q / kernel``, ``decoder / mid_block_attentions_0 / to_out_0
    / bias``, ``layers_0 / fc1 / kernel``)."""
    shapes = param_shapes(family)
    pm = build_model(family, device="meta")
    for part, kind, module in _port_parts(pm):
        want = {p: tuple(s.shape) for p, s in
                traverse_util.flatten_dict(_sub(shapes, part)).items()}
        got = {p: tuple(t.shape) for p, t in
               traverse_util.flatten_dict(to_jax_params(module.state_dict(), kind)).items()}
        assert sorted(set(want) - set(got)) == []
        assert sorted(set(got) - set(want)) == []
        assert {p: (got[p], want[p]) for p in want if got[p] != want[p]} == {}
    assert math.prod(shapes["unet"]["conv_in"]["kernel"].shape) > 0


def test_to_jax_params_inverts_from_jax_params():
    _, params = _jax_model("tiny-sdxl", 12)
    for part, kind in (("unet", "unet"), ("vae", "vae"), (("text", 1), "clip")):
        tree = _sub(params, part)
        back = to_jax_params(from_jax_params(tree, kind), kind)
        flat, mine = traverse_util.flatten_dict(tree), traverse_util.flatten_dict(back)
        assert set(flat) == set(mine)
        for p, arr in flat.items():
            np.testing.assert_array_equal(mine[p].numpy(), np.asarray(arr), err_msg=str(p))
