"""Carry JAX weights across: flax parameter trees -> torch state dicts.

The port's own copy of the rename and transpose in the JAX package's
``models/convert.py`` (``export_state_dict``).  Because every module on both
sides is named after its diffusers / transformers counterpart, the mapping is
mechanical:

- path elements are joined with '.', with ``_<digit>`` boundaries rewritten
  to ``.<digit>.`` (``down_blocks_0_attentions_0`` -> ``down_blocks.0.attentions.0``);
- leaves ``kernel`` / ``scale`` / ``embedding`` become ``weight``; Dense
  kernels [in, out] -> [out, in], conv kernels HWIO -> OIHW;
- CLIP paths take the transformers prefixes (``text_model.encoder...``).

The port's modules then ``load_state_dict(strict=True)`` the result.

:func:`load_safetensors` reads a checkpoint file without the ``safetensors``
package.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_NUM_RE = re.compile(r"_(\d+)(_|$)")

#: names where diffusers itself keeps an underscore before the digit
_LITERAL_NAMES = frozenset({"linear_1", "linear_2"})


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _name_to_diffusers(name: str) -> str:
    if name in _LITERAL_NAMES:
        return name
    if name.startswith("mid_block_"):     # mid_block has no index of its own
        name = "mid_block." + name[len("mid_block_"):]
    return _NUM_RE.sub(lambda m: f".{m.group(1)}" + ("." if m.group(2) else ""), name)


def _leaf_to_torch(leaf: str) -> str:
    return {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(leaf, leaf)


def _generic_key(path) -> str:
    joined = ".".join(_name_to_diffusers(p) for p in path[:-1]).replace("..", ".")
    return f"{joined}.{_leaf_to_torch(path[-1])}"


def _clip_key(path) -> str:
    parts = list(path)
    leaf = _leaf_to_torch(parts[-1])
    if parts[0] == "token_embedding":
        return "text_model.embeddings.token_embedding.weight"
    if parts[0] == "position_embedding":
        return "text_model.embeddings.position_embedding.weight"
    if parts[0] == "final_layer_norm":
        return f"text_model.final_layer_norm.{leaf}"
    if parts[0] == "text_projection":
        return "text_projection.weight"
    m = re.match(r"layers_(\d+)", parts[0])
    if m:
        sub = parts[1]
        prefix = f"text_model.encoder.layers.{m.group(1)}"
        if sub in ("q_proj", "k_proj", "v_proj", "out_proj"):
            return f"{prefix}.self_attn.{sub}.{leaf}"
        if sub in ("fc1", "fc2"):
            return f"{prefix}.mlp.{sub}.{leaf}"
        return f"{prefix}.{sub}.{leaf}"        # layer_norm1/2
    raise KeyError(f"unmapped CLIP path {path}")


def _to_torch_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel":
        if arr.ndim == 2:
            return arr.T                       # Dense [in, out] -> [out, in]
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)   # conv HWIO -> OIHW
    return arr


#: safetensors dtype names -> torch dtypes (the format's little-endian bytes)
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def load_safetensors(path) -> Dict[str, torch.Tensor]:
    """Read a ``.safetensors`` file into CPU tensors, with no ``safetensors``
    package (the counterpart of the JAX package's ``load_safetensors``,
    convert.py:170-174).

    The format: an 8-byte little-endian header length, a JSON header of
    ``{name: {dtype, shape, data_offsets}}`` (and an optional
    ``__metadata__``), then the raw little-endian bytes, each tensor's at
    ``data_offsets`` from the end of the header.  A header whose offsets
    overrun the file, overlap each other or disagree with the shape, or
    that names an unknown dtype, raises ``ValueError``."""
    buf = bytearray(Path(path).read_bytes())
    if len(buf) < 8:
        raise ValueError(f"{path}: {len(buf)} bytes, too short for a safetensors header")
    n = int.from_bytes(buf[:8], "little")
    if n > len(buf) - 8:
        raise ValueError(f"{path}: header of {n} bytes overruns the file ({len(buf)} bytes)")
    try:
        header = json.loads(buf[8:8 + n].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable header ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    start, size = 8 + n, len(buf) - 8 - n
    spans, out = [], {}
    for name, info in header.items():
        dtype = _ST_DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise ValueError(f"{path}: {name} has an unknown dtype {info.get('dtype')!r}")
        shape, (begin, end) = tuple(info["shape"]), info["data_offsets"]
        numel = math.prod(shape)
        if not 0 <= begin <= end <= size:
            raise ValueError(f"{path}: {name}'s offsets [{begin}, {end}] overrun the "
                             f"{size} bytes of data")
        if end - begin != numel * dtype.itemsize:
            raise ValueError(f"{path}: {name} holds {end - begin} bytes, its shape {list(shape)} "
                             f"in {info['dtype']} needs {numel * dtype.itemsize}")
        spans.append((begin, end, name))
        out[name] = (torch.frombuffer(buf, dtype=dtype, count=numel, offset=start + begin)
                     .reshape(shape).clone() if numel else torch.empty(shape, dtype=dtype))
    spans.sort()
    for (_, end, a), (begin, _, b) in zip(spans, spans[1:]):
        if begin < end:
            raise ValueError(f"{path}: the bytes of {a} and {b} overlap")
    return out


def from_jax_params(params: Mapping, kind: str = "unet") -> Dict[str, torch.Tensor]:
    """A flax parameter tree (numpy leaves) as a torch state dict.

    ``kind``: "unet" | "vae" | "clip"."""
    if kind not in ("unet", "vae", "clip"):
        raise ValueError(f"unknown kind {kind!r}")
    out = {}
    for path, arr in _flatten(params).items():
        key = _clip_key(path) if kind == "clip" else _generic_key(path)
        out[key] = torch.tensor(np.ascontiguousarray(_to_torch_layout(arr, path[-1])))
    return out
