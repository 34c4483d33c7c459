"""The benchmark's counts of work, against hand counts at the tiny size."""

import json

import pytest
import torch

from portbench import counts
from portbench.reference import models as ref

from .conftest import HERE

TINY = json.loads((HERE / "data" / "configs" / "tiny.json").read_text())
TRAFFIC = json.loads((HERE / "data" / "traffic" / "tiny-l2-b4.json").read_text())


def test_flops_of_one_convolution_by_hand():
    conv = torch.nn.Conv2d(16, 32, 3, padding=1, device="meta")
    x = torch.zeros((2, 16, 8, 8), device="meta")
    f, _ = counts._forward(lambda: ref.conv(x, conv))
    assert f == 2 * (2 * 8 * 8) * 32 * (16 * 9)


def test_attention_flops_by_hand():
    q = torch.zeros((2, 64, 3, 8), device="meta")
    k = torch.zeros((2, 20, 3, 8), device="meta")
    f, log = counts._forward(lambda: ref.attention(q, k, k))
    assert f == 2 * (2 * 2 * 3 * 64 * 20 * 8)
    assert log == [(2, 64, 20, 3, 8)]


def test_unit_work_composes_the_iteration():
    w = counts.unit_work(TINY, TRAFFIC)
    unet, vae = counts.meta_models(TINY)
    s, h = TRAFFIC["image_size"], TRAFFIC["image_size"] // 2
    z = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    u, _ = counts._forward(lambda: unet(z(2, 4, h, h), 500, z(2, 16, 32)))
    e, _ = counts._forward(lambda: vae.encode(z(1, 3, s, s)))
    d, _ = counts._forward(lambda: vae.decode(z(1, 4, h, h)))
    reps, steps = TRAFFIC["train"]["grad_reps"], 2     # LCM K=4 with t >= 700 dropped
    assert w["flops"] == 2 * (e + reps * (steps * u + d))
    assert w["long_attention"] == []                  # 256 tokens at the tiny size


def test_long_attentions_counted_by_hand():
    # at 128x128 the tiny UNet's first level holds 64x64 = 4096 tokens (2
    # heads of 16) and the VAE's mid block 64x64 (one head of 32)
    tr = dict(TRAFFIC, image_size=128)
    w = counts.unit_work(TINY, tr)
    unet_level0 = 1 + 2                               # 1 down transformer, 2 up
    reps, steps = tr["train"]["grad_reps"], 2
    assert w["long_attention"].count((2, 4096, 4096, 2, 16)) == reps * steps * unet_level0
    assert w["long_attention"].count((1, 4096, 4096, 1, 32)) == 1 + reps
    assert len(w["long_attention"]) == reps * steps * unet_level0 + 1 + reps


def test_attention_bound_by_hand():
    pk = counts.peak("NVIDIA H100 80GB HBM3", "bfloat16")
    b, t, h, d = 8, 4096, 8, 40
    ops = 2 * b * h * t * t * d
    want = 2 * ops / 989e12 + 4 * ops / 989e12       # compute-bound at T = 4096
    assert counts.attention_bound_s([(b, t, t, h, d)], 2, pk) == pytest.approx(want)
    # a short one is bound by its bytes
    small = counts.attention_bound_s([(1, 16, 16, 1, 64)], 2, pk)
    assert small == pytest.approx((4 + 7) * 16 * 64 * 2 / 3.35e12)
    assert counts.peak("cpu", "bfloat16") is None
