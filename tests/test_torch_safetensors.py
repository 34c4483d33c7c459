"""The port's safetensors reader (``models/convert.py::load_safetensors``)
against the ``safetensors`` package's own: every dtype the format and the
port support, 0-d and empty tensors, several tensors with a
``__metadata__`` entry; and the headers it must refuse.  Equality is exact
(the same bytes read as the same dtype)."""

from __future__ import annotations

import json
import struct

import pytest
import torch

from tml_image_editing_defense_torch.models.convert import load_safetensors

st_torch = pytest.importorskip("safetensors.torch")

DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64,
          torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool]


def _sample(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 100
    if dtype == torch.bool:
        return x > 0
    if dtype == torch.uint8:
        return x.abs().to(dtype)
    return x.to(dtype)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_each_dtype_reads_as_safetensors_reads_it(tmp_path, dtype):
    path = tmp_path / "one.safetensors"
    st_torch.save_file({"w": _sample(dtype, (3, 5, 2), 1)}, str(path))
    _assert_same(load_safetensors(path), st_torch.load_file(str(path)))


def test_zero_dim_empty_and_several_tensors_with_metadata(tmp_path):
    path = tmp_path / "many.safetensors"
    tensors = {"scalar": torch.tensor(2.5), "empty": torch.zeros((0, 4), dtype=torch.int32),
               "a.weight": _sample(torch.float32, (7, 3), 2),
               "a.bias": _sample(torch.bfloat16, (7,), 3),
               "counter": torch.tensor(12, dtype=torch.int64)}
    st_torch.save_file(tensors, str(path), metadata={"format": "pt", "note": "test"})
    got = load_safetensors(path)
    _assert_same(got, st_torch.load_file(str(path)))
    _assert_same(got, tensors)


def _write_raw(path, header: dict, data: bytes) -> None:
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["overrun", "overlap", "unknown-dtype", "size-mismatch",
                                  "header-overrun"])
def test_bad_headers_raise_value_error(tmp_path, case):
    path = tmp_path / "bad.safetensors"
    f32 = {"dtype": "F32", "shape": [2]}
    header = {
        "overrun": {"a": {**f32, "data_offsets": [0, 8]}, "b": {**f32, "data_offsets": [8, 16]}},
        "overlap": {"a": {**f32, "data_offsets": [0, 8]}, "b": {**f32, "data_offsets": [4, 12]}},
        "unknown-dtype": {"a": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}},
        "size-mismatch": {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}},
        "header-overrun": {},
    }[case]
    if case == "header-overrun":
        path.write_bytes(struct.pack("<Q", 1000) + b"{}")
    else:
        _write_raw(path, header, bytes(12))
    with pytest.raises(ValueError):
        load_safetensors(path)
