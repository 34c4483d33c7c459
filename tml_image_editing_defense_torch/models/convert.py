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

The port's modules then take the result through :func:`load_state`, the
counterpart of the JAX ``convert_state_dict``; :func:`to_jax_params` is the
inverse of :func:`from_jax_params`, for the params bundle
(``models/checkpoint_io.py``).

:func:`load_safetensors` reads a checkpoint file without the ``safetensors``
package, and :func:`load_sd_checkpoint` a diffusers model directory with it.
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


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    """{path: leaf}; torch leaves stay tensors (numpy has no bfloat16)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v if isinstance(v, torch.Tensor) else np.asarray(v)
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


def _to_torch_layout(t: torch.Tensor, leaf: str) -> torch.Tensor:
    if leaf == "kernel":
        if t.ndim == 2:
            return t.T                         # Dense [in, out] -> [out, in]
        if t.ndim == 4:
            return t.permute(3, 2, 0, 1)       # conv HWIO -> OIHW
    return t


def _to_flax_layout(t: torch.Tensor, leaf: str) -> torch.Tensor:
    if leaf == "kernel":
        if t.ndim == 2:
            return t.T                         # Dense [out, in] -> [in, out]
        if t.ndim == 4:
            return t.permute(2, 3, 1, 0)       # conv OIHW -> HWIO
    return t


#: torch names that open a flax module spanning the next name as well:
#: ``down_blocks.0.attentions.0`` is the one flax module
#: ``down_blocks_0_attentions_0``, ``mid_block.resnets.0`` is
#: ``mid_block_resnets_0``, ``ff.net.0.proj`` is ``ff / net_0_proj``
_SPANNING = re.compile(r"(down_blocks_\d+|up_blocks_\d+|mid_block|net_\d+)")


def _generic_path(key: str, ndim: int) -> Tuple[str, ...]:
    """Inverse of :func:`_generic_key`: a diffusers key -> the flax path."""
    *names, leaf = key.split(".")
    joined = []
    for name in names:                 # an index joins the name before it
        if name.isdigit() and joined:
            joined[-1] += "_" + name
        else:
            joined.append(name)
    path = []
    for name in joined:
        if path and _SPANNING.fullmatch(path[-1]):
            path[-1] += "_" + name
        else:
            path.append(name)
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return (*path, leaf)


def _clip_path(key: str, ndim: int) -> Tuple[str, ...]:
    """Inverse of :func:`_clip_key`: a transformers CLIP key -> the flax path."""
    if key == "text_model.embeddings.token_embedding.weight":
        return ("token_embedding", "embedding")
    if key == "text_model.embeddings.position_embedding.weight":
        return ("position_embedding",)
    if key == "text_projection.weight":
        return ("text_projection", "kernel")
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "weight":
        leaf = "kernel" if ndim == 2 else "scale"
    m = re.fullmatch(r"text_model\.final_layer_norm\.\w+", key)
    if m:
        return ("final_layer_norm", leaf)
    m = re.fullmatch(r"text_model\.encoder\.layers\.(\d+)\.(?:self_attn\.|mlp\.)?(\w+)\.\w+", key)
    if m:
        return (f"layers_{m.group(1)}", m.group(2), leaf)
    raise KeyError(f"unmapped CLIP key {key!r}")


#: safetensors dtype names -> torch dtypes (the format's little-endian bytes)
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_file(path) -> bytearray:
    """A file's bytes in one writable buffer (``torch.frombuffer`` views it
    without a warning), read in place: the host holds the file once."""
    path = Path(path)
    buf = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        n = f.readinto(buf)
    if n != len(buf):
        raise ValueError(f"{path}: read {n} of {len(buf)} bytes")
    return buf


def load_safetensors(path) -> Dict[str, torch.Tensor]:
    """Read a ``.safetensors`` file into CPU tensors, with no ``safetensors``
    package (the counterpart of the JAX package's ``load_safetensors``,
    convert.py:170-174).

    The format: an 8-byte little-endian header length, a JSON header of
    ``{name: {dtype, shape, data_offsets}}`` (and an optional
    ``__metadata__``), then the raw little-endian bytes, each tensor's at
    ``data_offsets`` from the end of the header.  A header whose offsets
    overrun the file, overlap each other or disagree with the shape, or
    that names an unknown dtype, raises ``ValueError``.

    Each tensor views the file's bytes (one buffer, held once on the host,
    which the tensors keep alive); one whose bytes are not aligned to its
    dtype is copied out."""
    buf = read_file(path)
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
        if not numel:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=dtype, count=numel, offset=start + begin).reshape(shape)
        out[name] = t.clone() if (start + begin) % dtype.itemsize else t
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
        t = arr if isinstance(arr, torch.Tensor) else torch.tensor(arr)
        out[key] = _to_torch_layout(t, path[-1]).contiguous()
    return out


def to_jax_params(state_dict: Mapping[str, torch.Tensor], kind: str = "unet") -> dict:
    """A torch state dict as the JAX package's flax parameter tree, the
    inverse of :func:`from_jax_params`: the nesting of the JAX modules
    (``down_blocks_0_attentions_0 / transformer_blocks_0 / attn1 / to_q /
    kernel``), leaves ``kernel`` / ``scale`` / ``embedding``, Dense kernels
    [in, out] and conv kernels HWIO.  Leaves are views of the state dict's
    tensors where the layout allows it."""
    if kind not in ("unet", "vae", "clip"):
        raise ValueError(f"unknown kind {kind!r}")
    tree: dict = {}
    for key, t in state_dict.items():
        path = _clip_path(key, t.ndim) if kind == "clip" else _generic_path(key, t.ndim)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        if path[-1] in node:
            raise ValueError(f"{key} and another key map to the same flax path {path}")
        node[path[-1]] = _to_flax_layout(t, path[-1])
    return tree


@torch.no_grad()
def load_state(module: torch.nn.Module, state: Mapping[str, object], strict: bool = True):
    """Copy a torch-layout state dict into ``module``'s own parameters and
    buffers, the counterpart of the JAX ``convert_state_dict``
    (convert.py:103-134) with ``module.state_dict()`` as the template.

    A key the module has and ``state`` lacks raises ``KeyError`` under
    ``strict``; otherwise a warning is printed and the module keeps its
    value.  A shape mismatch raises ``ValueError`` (before anything is
    copied).  Extra keys in ``state`` are ignored (older CLIP files carry
    ``text_model.embeddings.position_ids``).  Each tensor is cast to the
    dtype of the parameter it lands in and copied there, on the module's
    device, one tensor at a time.  Returns ``module``."""
    template = module.state_dict()
    missing = [k for k in template if k not in state]
    if missing:
        msg = f"{len(missing)} unmapped params, e.g. {missing[:5]}"
        if strict:
            raise KeyError(msg)
        print(f"[convert] warning: {msg}; keeping template init for those", flush=True)
    for key, dst in template.items():
        if key in state and tuple(state[key].shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {tuple(state[key].shape)} vs "
                             f"model {tuple(dst.shape)}")
    for key, dst in template.items():
        if key in state:
            src = state[key]
            dst.copy_(src if isinstance(src, torch.Tensor) else torch.as_tensor(np.asarray(src)))
    return module


def load_safetensors_dir(directory) -> Dict[str, torch.Tensor]:
    """Every ``*.safetensors`` under ``directory``, read in sorted order and
    merged (``FileNotFoundError`` when there is none)."""
    directory = Path(directory)
    state: Dict[str, torch.Tensor] = {}
    for f in sorted(directory.glob("*.safetensors")):
        state.update(load_safetensors(f))
    if not state:
        raise FileNotFoundError(f"no .safetensors under {directory}")
    return state


def load_sd_checkpoint(model_dir, model, strict: bool = True):
    """Load a diffusers-layout model directory into ``model`` (a
    ``DiffusionModel``) in place, after the JAX ``load_sd_checkpoint``
    (convert.py:177-208): ``unet/``, ``vae/`` and ``text_encoder/``, and
    ``text_encoder_2/`` when the family has two encoders.  The port's
    modules carry diffusers' and transformers' names, so each directory's
    state dict loads as it is, through :func:`load_state`.  One directory is
    held on the host at a time.  Returns ``model``."""
    model_dir = Path(model_dir)
    parts = [("unet", model.unet), ("vae", model.vae)]
    parts += [("text_encoder" if i == 0 else f"text_encoder_{i + 1}", m)
              for i, m in enumerate(model.text_models)]
    for sub, module in parts:
        load_state(module, load_safetensors_dir(model_dir / sub), strict)
    return model
