"""The JAX package's params bundle, read and written without flax (port of
``models/checkpoint_io.py``).

One prepared file serves both packages: ``params_path`` means the same in
either.  The file is flax's msgpack state dict of ``DiffusionModel.params``
(``flax.serialization.to_bytes``):

- a map ``{"unet", "vae", "text": {"0", "1"?}}`` of flax-named trees in
  flax layout (Dense ``[in, out]``, conv HWIO; ``models/convert.py``);
- every array is msgpack ext type 1, whose payload is itself msgpack
  ``[shape, dtype name, C-order bytes]``; ``"bfloat16"`` is read with
  ``torch.frombuffer``;
- an array over :data:`MAX_CHUNK_SIZE` bytes is a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": flat array, ...}}``.

The msgpack codec below covers the types such a file holds: map, array,
str, bin, int, float, nil, bool and ext.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import BinaryIO, Optional, Tuple, Union

import torch

from tml_image_editing_defense_torch.models.convert import (
    from_jax_params,
    load_state,
    read_file,
    to_jax_params,
)

#: flax's limit for one array leaf before it is chunked (serialization.py)
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
           "float64": torch.float64, "int64": torch.int64, "int32": torch.int32,
           "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    """msgpack decoding over one writable buffer; arrays become tensors that
    view the buffer where their bytes are aligned."""

    def __init__(self, buf: bytearray):
        self.buf = buf
        self.view = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> int:
        start = self.pos
        if start + n > len(self.buf):
            raise ValueError(f"truncated msgpack data at byte {start} (needs {n} more)")
        self.pos = start + n
        return start

    def _unpack_fmt(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, self.buf, self._take(size))[0]

    def _str(self, n: int) -> str:
        start = self._take(n)
        return bytes(self.view[start:start + n]).decode("utf-8")

    def _bin(self, n: int) -> Tuple[int, int]:
        return self._take(n), n

    def read(self):
        b = self.buf[self._take(1)]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self._unpack_fmt(ints[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack_fmt({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xC4, 0xC5, 0xC6):
            start, n = self._bin(self._unpack_fmt({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
            return bytes(self.view[start:start + n])
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self._unpack_fmt(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack_fmt(">H" if b == 0xDE else ">I"))
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self._unpack_fmt({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x} at {self.pos - 1}")

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if out.get(_CHUNKED) is True:
            shape = [out["shape"][str(i)] for i in range(len(out["shape"]))]
            chunks = [out["chunks"][str(i)] for i in range(len(out["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return out

    def _ext(self, n: int):
        code = struct.unpack_from(">b", self.buf, self._take(1))[0]
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not an array")
        head = self.buf[self._take(1)]
        if head != 0x93:
            raise ValueError("an array's payload is not a 3-element msgpack array")
        shape = self.read()
        name = self.read()
        name = name.decode() if isinstance(name, bytes) else name
        b = self.buf[self._take(1)]
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError("an array's bytes are not msgpack bin")
        start, nbytes = self._bin(self._unpack_fmt({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
        if self.pos != end:
            raise ValueError("an array's payload does not fill its ext")
        dtype = _DTYPES.get(name)
        if dtype is None:
            raise ValueError(f"unsupported array dtype {name!r}")
        numel = math.prod(shape)
        if nbytes != numel * dtype.itemsize:
            raise ValueError(f"array of shape {shape} in {name} holds {nbytes} bytes")
        if numel == 0:
            t = torch.empty(shape, dtype=dtype)
        elif start % dtype.itemsize:
            t = torch.frombuffer(bytearray(self.view[start:start + nbytes]), dtype=dtype)
        else:
            t = torch.frombuffer(self.buf, dtype=dtype, count=numel, offset=start)
        t = t.reshape(shape)
        return t.reshape(()) if code == _EXT_NPSCALAR else t


def read_msgpack(path) -> dict:
    """A flax msgpack state dict as nested dicts of tensors (on the host,
    viewing one buffer that holds the file)."""
    buf = read_file(path)
    r = _Reader(buf)
    out = r.read()
    if r.pos != len(buf):
        raise ValueError(f"{path}: {len(buf) - r.pos} bytes after the msgpack object")
    return out


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _len_header(n: int, fix: Optional[Tuple[int, int]], codes: Tuple[int, ...]) -> bytes:
    """The header of a str / bin / array / map of length ``n``: the fix form
    when ``fix=(base, limit)`` allows it, else 8-, 16- or 32-bit lengths
    (``codes`` per width; None where msgpack has none)."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} is too long for msgpack")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31),
                            (0xD3, ">q", 63)):
        if v >= -(1 << bits):
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} is out of msgpack's range")


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _len_header(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + raw


def _write_tensor(f: BinaryIO, t: torch.Tensor) -> None:
    t = t.detach().contiguous().to("cpu")
    name = _DTYPE_NAMES.get(t.dtype)
    if name is None:
        raise ValueError(f"unsupported tensor dtype {t.dtype}")
    nbytes = t.numel() * t.element_size()
    head = (b"\x93" + _len_header(t.ndim, (0x90, 16), (None, 0xDC, 0xDD))
            + b"".join(_pack_int(d) for d in t.shape) + _pack_str(name)
            + _len_header(nbytes, None, (0xC4, 0xC5, 0xC6)))
    n = len(head) + nbytes
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    f.write(bytes([fixext[n]]) if n in fixext else _len_header(n, None, (0xC7, 0xC8, 0xC9)))
    f.write(bytes([_EXT_NDARRAY]) + head)
    if nbytes:
        f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def _write(f: BinaryIO, obj) -> None:
    if isinstance(obj, torch.Tensor):
        if obj.numel() * obj.element_size() > MAX_CHUNK_SIZE:
            per = max(1, MAX_CHUNK_SIZE // obj.element_size())
            flat = obj.reshape(-1)
            obj = {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(obj.shape)},
                   "chunks": {str(i): flat[j:j + per]
                              for i, j in enumerate(range(0, flat.numel(), per))}}
        else:
            _write_tensor(f, obj)
            return
    if isinstance(obj, dict):
        f.write(_len_header(len(obj), (0x80, 16), (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _write(f, k)
            _write(f, v)
    elif isinstance(obj, str):
        f.write(_pack_str(obj))
    elif obj is None:
        f.write(b"\xc0")
    elif isinstance(obj, bool):
        f.write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        f.write(_pack_int(obj))
    elif isinstance(obj, float):
        f.write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, (bytes, bytearray)):
        f.write(_len_header(len(obj), None, (0xC4, 0xC5, 0xC6)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        f.write(_len_header(len(obj), (0x90, 16), (None, 0xDC, 0xDD)))
        for v in obj:
            _write(f, v)
    else:
        raise TypeError(f"cannot write a {type(obj).__name__} to msgpack")


def write_msgpack(path, tree: dict) -> None:
    """Write nested dicts of tensors as a flax msgpack state dict, one
    tensor at a time (each copied to the host as it is written)."""
    with open(path, "wb") as f:
        _write(f, tree)


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------

def _parts(model):
    yield "unet", "unet", model.unet
    yield "vae", "vae", model.vae


def save_params(path, model) -> None:
    """Write ``model``'s UNet, VAE and text encoders as the JAX package's
    params bundle (JAX ``save_params``, checkpoint_io.py:18-30), in the
    modules' own dtypes."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = {name: to_jax_params(module.state_dict(), kind) for name, kind, module in _parts(model)}
    tree["text"] = {str(i): to_jax_params(m.state_dict(), "clip")
                    for i, m in enumerate(model.text_models)}
    write_msgpack(path, tree)


def load_params(path, model, dtype: Union[str, torch.dtype, None] = None):
    """Load a params bundle (either package's ``save_params``) into
    ``model`` in place (JAX ``load_params``, checkpoint_io.py:32-44): each
    tree mapped to the port's names by ``from_jax_params``, then
    ``load_state(strict=True)``, which casts to each parameter's dtype.
    ``dtype`` first rounds every array to that dtype, as the JAX
    ``load_params(dtype=)`` casts the tree.  Returns ``model``."""
    tree = read_msgpack(path)
    if dtype is not None and not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, dtype)
    texts = tree.get("text", {})
    parts = [(tree.get(name), kind, module) for name, kind, module in _parts(model)]
    parts += [(texts.get(str(i)), "clip", m) for i, m in enumerate(model.text_models)]
    if any(sub is None for sub, _, _ in parts) or len(texts) != len(model.text_models):
        raise KeyError(f"{path}: the bundle holds {sorted(tree)} with {len(texts)} text "
                       f"encoder(s); the model has a UNet, a VAE and "
                       f"{len(model.text_models)}")
    for sub, kind, module in parts:
        state = from_jax_params(sub, kind)
        if dtype is not None:
            state = {k: v.to(dtype) for k, v in state.items()}
        load_state(module, state, strict=True)
    return model
