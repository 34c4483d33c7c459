"""LoRA fusion in the port against the JAX ``fuse_lora`` on ``tiny``: Linear
and conv weights, the three key layouts, ``alpha``, factors stored in the
other shape (1x1), fp16 factors, and ``strict``.  Fused weights within
1e-6."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn
from flax import traverse_util

from tml_image_editing_defense_tpu.models import build_model as jax_build_model
from tml_image_editing_defense_tpu.models.convert import _generic_key
from tml_image_editing_defense_tpu.models.lora import fuse_lora as j_fuse_lora

from tml_image_editing_defense_torch.models.convert import from_jax_params, load_state
from tml_image_editing_defense_torch.models.lora import (
    _lora_delta,
    collect_lora_pairs,
    fuse_lora,
)
from tml_image_editing_defense_torch.models.model_zoo import build_model
from test_torch_models import jittered, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def junet():
    m = jax_build_model("tiny", key=jax.random.key(0), image_size=32, fast_init=True)
    return jittered(m.params, 21)["unet"]


def _port_unet(params):
    unet = build_model("tiny", image_size=32, device="cpu").unet
    return load_state(unet, from_jax_params(params, "unet"))


def _targets(unet):
    """{module name: weight shape} of every Linear and Conv2d."""
    return {n: tuple(m.weight.shape) for n, m in unet.named_modules()
            if isinstance(m, (nn.Linear, nn.Conv2d))}


def _factors(rng, shape, r, dtype=np.float32, swap=False):
    """torch-layout LoRA factors (A, B) for a weight of ``shape``; ``swap``
    stores a Linear's factors conv-style and a 1x1 conv's A as a matrix."""
    if len(shape) == 2:
        a = rng.normal(0, 0.02, (r, shape[1]))
        b = rng.normal(0, 0.02, (shape[0], r))
        if swap:
            a, b = a[:, :, None, None], b[:, :, None, None]
    else:
        o, i, kh, kw = shape
        a = rng.normal(0, 0.02, (r, i, kh, kw))
        b = rng.normal(0, 0.02, (o, r, 1, 1))
        if swap and kh == kw == 1:
            a = a[:, :, 0, 0]
    return a.astype(dtype), b.astype(dtype)


def _assert_fused_equal(unet, jfused, tol=TOL):
    want = from_jax_params(jfused, "unet")
    got = unet.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **tol)


LAYOUTS = {
    "peft": ("unet.{}.lora_A.weight", "unet.{}.lora_B.weight", "unet.{}.alpha"),
    "legacy": ("{}.lora.down.weight", "{}.lora.up.weight", "{}.alpha"),
    "lora_down": ("lora_unet_{}.lora_down.weight", "lora_unet_{}.lora_up.weight",
                  "lora_unet_{}.alpha"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("swap,dtype", [(False, np.float32), (True, np.float32),
                                        (False, np.float16)])
def test_fuse_lora_matches_jax(junet, layout, swap, dtype):
    """Adapters on every other Linear and conv, alpha on every third, fused
    at scale 0.5: the port's weights equal the JAX package's within 1e-6.
    fp16 factors multiply in fp16 on both sides, as the JAX package
    computes the delta in the factors' dtype; numpy's fp16 einsum rounds
    its partial sums, torch's rounds once, so the two deltas may differ by
    one fp16 ulp of the delta (|delta| < 8e-3 here), which bounds that case
    at scale 0.5."""
    unet = _port_unet(junet)
    rng = np.random.default_rng(hash((layout, swap)) % 2 ** 32)
    down, up, alpha = LAYOUTS[layout]
    state = {}
    names = sorted(_targets(unet))
    for j, name in enumerate(names[::2]):
        a, b = _factors(rng, _targets(unet)[name], r=4, dtype=dtype, swap=swap)
        state[down.format(name)], state[up.format(name)] = a, b
        if j % 3 == 0:
            state[alpha.format(name)] = np.asarray(2.0 + 3 * (j % 3), dtype)
    kinds = {len(_targets(unet)[n]) for n in names[::2]}
    assert kinds == {2, 4}
    fuse_lora(unet, state, scale=0.5)
    tol = TOL
    if dtype == np.float16:
        deltas = [_lora_delta(torch.from_numpy(state[down.format(n)].astype(np.float32)),
                              torch.from_numpy(state[up.format(n)].astype(np.float32)),
                              len(_targets(unet)[n])).abs().max().item()
                  for n in names[::2]]
        assert max(deltas) < 8e-3
        tol = dict(rtol=0, atol=0.5 * float(np.spacing(np.float16(8e-3))))
    _assert_fused_equal(unet, j_fuse_lora(junet, state, scale=0.5), tol)
    assert len(collect_lora_pairs(state)) == len(names[::2])


def test_every_linear_and_conv_fuses(junet):
    """The counterpart of tests/test_convert.py::test_lora_every_kernel_fusable:
    the port's Linear and Conv2d modules are exactly the JAX tree's kernels,
    and an adapter on each fuses under ``strict`` and moves every weight."""
    unet = _port_unet(junet)
    targets = _targets(unet)
    kernels = {_generic_key(p)[: -len(".weight")] for p in traverse_util.flatten_dict(junet)
               if p[-1] == "kernel"}
    assert set(targets) == kernels
    before = {n: m.weight.clone() for n, m in unet.named_modules() if n in targets}
    rng = np.random.default_rng(2)
    state = {}
    for name, shape in targets.items():
        a, b = _factors(rng, shape, r=2)
        state[f"unet.{name}.lora_A.weight"], state[f"unet.{name}.lora_B.weight"] = a, b
    fuse_lora(unet, state, scale=0.1, strict=True)
    for n, m in unet.named_modules():
        if n in targets:
            assert not torch.equal(m.weight, before[n]), n
    _assert_fused_equal(unet, j_fuse_lora(junet, state, scale=0.1))


@pytest.mark.parametrize("bad", ["unknown_module", "kohya"])
def test_unmatched_adapters_raise_under_strict(junet, bad, capsys):
    """An adapter that matches no module raises in both packages; with
    ``strict=False`` both fuse the rest and warn.  kohya-style names keep
    their underscores in both, so they match nothing."""
    unet = _port_unet(junet)
    name = "conv_in"
    rng = np.random.default_rng(3)
    a, b = _factors(rng, _targets(unet)[name], r=2)
    state = {f"unet.{name}.lora_A.weight": a, f"unet.{name}.lora_B.weight": b}
    odd = {"unknown_module": "unet.no_such.proj",
           "kohya": "lora_unet_down_blocks_0_resnets_0_conv1"}[bad]
    state[f"{odd}.lora_A.weight"], state[f"{odd}.lora_B.weight"] = a, b
    with pytest.raises(KeyError, match="not matched"):
        fuse_lora(unet, state)
    with pytest.raises(KeyError, match="not matched"):
        j_fuse_lora(junet, state)
    fuse_lora(unet, state, strict=False)
    assert "unmatched" in capsys.readouterr().out
    _assert_fused_equal(unet, j_fuse_lora(junet, state, strict=False))
