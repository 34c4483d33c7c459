"""Group norm with the SiLU after it (``ops/group_norm.py``,
``csrc/group_norm.cu``).

On the CPU: the route rule; the plain route bit for bit what the models ran
before (``F.silu(nn.GroupNorm(...)(x))``), forward and input gradient, on
the tiny SD-1.5 and SDXL families; the ``group_norm.<route>`` counts of a
UNet and a VAE call against a hand count of their sites, and the same
graphed (``tests/test_torch_chunk_graph.py``'s stand-in capture) as eager;
``group_norm`` off the card, SiLU on and off, in each dtype; the
``autograd.Function`` keeping x and the row statistics only; the ctypes
signatures; the chunk plan and the merge of chunk moments in the kernels'
order; and ``gn_kernel_share``'s reader.

On the card (marker ``chip``; ``python -m pytest --noconftest -m chip -s
tests/test_torch_group_norm.py``, since the suite's conftest imports JAX,
which that machine lacks): the kernels against the plain version and against
float64 at the cells' shapes, f32 and bf16, with and without the SiLU,
forward and backward, two runs bit-equal; and the route's launches and
refusal.
"""

from __future__ import annotations

import copy
import ctypes
import re
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from tml_image_editing_defense_torch.attack import chunk_graph
from tml_image_editing_defense_torch.models import layers, unet, vae
from tml_image_editing_defense_torch.models.model_zoo import build_model
from tml_image_editing_defense_torch.ops import group_norm as gn
from tml_image_editing_defense_torch.utils import profiling
from test_torch_chunk_graph import EAGER, GRAPH, ITERS, REPS, Attack, stand_in  # noqa: F401


def _norm(groups, channels, eps=1e-5, dtype=torch.float32, device="cpu", seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    norm = nn.GroupNorm(groups, channels, eps=eps)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(channels, generator=g))
        norm.bias.copy_(0.1 * torch.randn(channels, generator=g))
    return norm.to(device, dtype).requires_grad_(grad)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

#: (device, dtype, weights need a gradient, autograd records, the route or
#: the error): on the card the kernels or an error, never the plain route
ROUTE_CASES = {
    "cuda bf16 frozen": ("cuda", torch.bfloat16, False, True, "kernel"),
    "cuda f32 frozen": ("cuda", torch.float32, False, True, "kernel"),
    "cuda f16": ("cuda", torch.float16, False, True, TypeError),
    "cuda f64": ("cuda", torch.float64, False, True, TypeError),
    "cuda, weights need a gradient": ("cuda", torch.bfloat16, True, True, ValueError),
    "cuda, weights need a gradient, under no_grad": ("cuda", torch.bfloat16, True, False,
                                                     "kernel"),
    "cpu f32 frozen": ("cpu", torch.float32, False, True, "plain"),
    "cpu bf16 frozen": ("cpu", torch.bfloat16, False, True, "plain"),
    "cpu f64, weights need a gradient": ("cpu", torch.float64, True, True, "plain"),
}


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_the_route_follows_device_dtype_and_frozen_weights(case):
    device, dtype, grad, recording, want = ROUTE_CASES[case]
    x = SimpleNamespace(device=torch.device(device), dtype=dtype)   # the rule reads no data
    norm = _norm(4, 8, grad=grad)
    with torch.set_grad_enabled(recording):
        if isinstance(want, str):
            assert gn.group_norm_route(x, norm) == want
        else:
            with pytest.raises(want):
                gn.group_norm_route(x, norm)


def test_the_route_refuses_a_norm_without_weights_on_the_card():
    x = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)
    with pytest.raises(ValueError, match="weight and bias"):
        gn.group_norm_route(x, nn.GroupNorm(4, 8, affine=False))


# ---------------------------------------------------------------------------
# the plain route in the models, and its counts
# ---------------------------------------------------------------------------


def _before(x, norm, silu):
    """What the models ran at every group norm before the kernels."""
    return F.silu(norm(x)) if silu else norm(x)


#: Group norms of one call, by hand.  tiny UNet: 8 resnets (down 1 + 1, mid
#: 2, up 2 + 2) of two each, 3 transformers (down 1, up 2; no mid attention),
#: conv_norm_out: 20.  tiny-sdxl UNet: the same resnets, 4 transformers (down
#: 1, mid 1, up 2): 21.  VAE encoder: 4 resnets (2 levels of 1, mid 2), the
#: mid attention, conv_norm_out: 10; decoder: 6 resnets (mid 2, 2 levels of
#: 2): 14.
HAND_COUNT = {("tiny", "unet"): 20, ("tiny-sdxl", "unet"): 21, ("tiny", "encode"): 10,
              ("tiny-sdxl", "encode"): 10, ("tiny", "decode"): 14, ("tiny-sdxl", "decode"): 14}


@pytest.fixture(scope="module")
def tiny_models():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield {f: build_model(f, image_size=32, device="cpu", dtype="float32",
                          generator=torch.Generator().manual_seed(3))
           for f in ("tiny", "tiny-sdxl")}
    torch.set_num_threads(n)


def _call(model, net: str):
    """(the input, a function of it running ``net`` of ``model``)."""
    g = torch.Generator().manual_seed(5)
    if net == "encode":
        return torch.randn((2, 3, 32, 32), generator=g), lambda x: model.vae.encode(x)[0]
    if net == "decode":
        return torch.randn((2, 4, 4, 4), generator=g), model.vae.decode
    cfg = model.unet.config
    ctx = torch.randn((2, 7, cfg.cross_attention_dim), generator=g)
    extra = {}
    if cfg.addition_embed_type == "text_time":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        extra = dict(text_embeds=torch.randn((2, pooled), generator=g),
                     time_ids=torch.randn((2, 6), generator=g))
    return torch.randn((2, 4, 8, 8), generator=g), lambda x: model.unet(x, 500, ctx, **extra)


def _run(fn, x):
    """fn(x), the gradient of a fixed projection of it, and the counts made."""
    x = x.clone().requires_grad_(True)
    with torch.enable_grad(), profiling.tallied() as counts:
        out = fn(x)
        w = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
        (grad,) = torch.autograd.grad((out * w).sum(), x)
    return out, grad, {k: n for k, n in counts.items() if k.startswith("group_norm.")}


@pytest.mark.parametrize("family", ["tiny", "tiny-sdxl"])
@pytest.mark.parametrize("net", ["unet", "encode", "decode"])
def test_the_plain_route_is_the_models_old_group_norm_bit_for_bit(tiny_models, monkeypatch,
                                                                  family, net):
    x, fn = _call(tiny_models[family], net)
    out, grad, counts = _run(fn, x)
    assert counts == {"group_norm.plain": HAND_COUNT[(family, net)]}
    for mod in (layers, unet, vae):
        monkeypatch.setattr(mod, "group_norm", _before)
    old_out, old_grad, old_counts = _run(fn, x)
    assert old_counts == {}
    assert torch.equal(out, old_out) and torch.equal(grad, old_grad)


def _norm_counts(attack, graphed: bool):
    """Per iteration, the ``group_norm.<route>`` counts in a recording over
    ``ITERS`` iterations of one step, the calls of each net the eager spans
    show, and ``gn_kernel_share`` read from the recording."""
    from portbench import cells

    step = attack.step()
    with profiling.recording("cpu") as rec:
        for it in range(ITERS):
            with profiling.span(profiling.ITERATION, iteration=it):
                (_, _, counts), = attack.run(step, iters=1)
            want = ({EAGER: 0, GRAPH: REPS} if it else {EAGER: 1, GRAPH: REPS - 1}
                    ) if graphed else {EAGER: REPS, GRAPH: 0}
            assert {k: counts[k] for k in want} == want
    norms = [Counter() for _ in range(ITERS)]
    calls = [Counter() for _ in range(ITERS)]
    for s in rec.spans:
        if s.iteration is not None:
            norms[s.iteration].update({k: n for k, n in s.counts.items()
                                       if k.startswith("group_norm.")})
            if s.name in ("tid.unet", "tid.vae.encode", "tid.vae.decode"):
                calls[s.iteration][s.name] += 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "last_recording", lambda: rec)
        share = cells.reader("metrics", "gn_kernel_share").read(SimpleNamespace(steps=ITERS))
    return norms, calls, share


def test_group_norm_counts_are_the_hand_count_and_read_the_same_graphed_as_eager(stand_in):
    attack = Attack("cpu")
    with torch.enable_grad():
        graphed, _, graphed_share = _norm_counts(attack, True)
        assert len(stand_in.graphs) == 2
        stand_in.mp.setattr(chunk_graph, "GRAPH_DEVICE", "cuda")
        eager, calls, eager_share = _norm_counts(attack, False)
    assert graphed == eager and graphed[0] == graphed[1]
    # every call of an eager iteration shows its span: the counts are its sites'
    per_call = {"tid.unet": HAND_COUNT[("tiny", "unet")],
                "tid.vae.encode": HAND_COUNT[("tiny", "encode")],
                "tid.vae.decode": HAND_COUNT[("tiny", "decode")]}
    assert calls[0]["tid.unet"] > 0 and calls[0]["tid.vae.decode"] == REPS
    assert eager[0] == {"group_norm.plain": sum(per_call[k] * n for k, n in calls[0].items())}
    assert graphed_share == eager_share == 0.0       # on the CPU every call is plain


# ---------------------------------------------------------------------------
# group_norm off the card, and the Function
# ---------------------------------------------------------------------------

SHAPES = {"tiny": ((2, 16, 4, 4), 8), "ragged": ((2, 96, 33, 35), 32)}


def _inputs(shape, seed=11):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 2 + 0.5
    return x, torch.randn(shape, generator=g)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64],
                         ids=["f32", "bf16", "f64"])
def test_group_norm_off_the_card_is_pytorchs_and_counts_plain(dtype, silu):
    x, dz = _inputs(SHAPES["ragged"][0])
    x, dz = x.to(dtype), dz.to(dtype)
    norm = _norm(32, 96, eps=1e-6, dtype=dtype)

    def run(fn):
        xx = x.clone().requires_grad_(True)
        with torch.enable_grad(), profiling.tallied() as counts:
            out = fn(xx)
            (grad,) = torch.autograd.grad(out, xx, dz)
        return out, grad, {k: n for k, n in counts.items() if k.startswith("group_norm.")}

    out, grad, counts = run(lambda xx: gn.group_norm(xx, norm, silu))
    want, want_grad, _ = run(lambda xx: _before(xx, norm, silu))
    assert counts == {"group_norm.plain": 1}
    assert out.dtype == dtype and torch.equal(out, want) and torch.equal(grad, want_grad)


@pytest.mark.parametrize("silu", [True, False])
def test_the_function_keeps_x_and_the_row_statistics_only(monkeypatch, silu):
    x, _ = _inputs(SHAPES["tiny"][0])
    norm = _norm(8, 16)
    stats = torch.zeros((16, 2))
    # the kernels' forward, as the Function sees it: (z, the rows' statistics)
    monkeypatch.setattr(gn, "group_norm_fwd", lambda x, *args: (x * 2, stats))
    x.requires_grad_(True)
    with torch.enable_grad():
        z = gn.GroupNormSiLU.apply(x, norm.weight, norm.bias, 8, norm.eps, silu)
    saved = z.grad_fn.saved_tensors
    assert len(saved) == 4 and saved[0] is x and saved[3] is stats
    assert saved[1] is norm.weight and saved[2] is norm.bias


def _c_params(symbol: str) -> list:
    """The parameter types of ``symbol``'s C entry in ``csrc/group_norm.cu``."""
    src = (Path(gn.__file__).resolve().parents[1] / "csrc" / "group_norm.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    return [re.sub(r"\s*\w+$", "", p.strip()) for p in m.group(1).split(",")]


@pytest.mark.parametrize("kernel", gn.KERNELS, ids=lambda k: k.symbol)
def test_the_ctypes_signatures_are_the_c_entries(kernel):
    """ctypes passes what argtypes says: a pointer for void*, 64 bits for
    long long, 32 for int, a float for float (a short list would cut the
    stream pointer to an int)."""
    kinds = {ctypes.c_void_p: ("const void*", "void*"), ctypes.c_longlong: ("long long",),
             ctypes.c_int: ("int",), ctypes.c_float: ("float",)}
    params = _c_params(kernel.symbol)
    assert len(params) == len(kernel.argtypes)
    for c_type, arg in zip(params, kernel.argtypes):
        assert c_type in kinds[arg], (c_type, arg)


# ---------------------------------------------------------------------------
# the chunks of a row and the merge of their moments
# ---------------------------------------------------------------------------

#: (rows, row length) of the cells' group norms, and a ragged one
PLAN_CASES = {"1024 decoder [1,128,1024,1024]": (32, 4 * 1024 * 1024),
              "SD-1.5 64x64 [8,320,64,64]": (256, 10 * 4096),
              "SD-1.5 8x8 [8,1280,8,8]": (256, 40 * 64),
              "512 decoder [4,128,512,512]": (128, 4 * 512 * 512),
              "ragged [2,96,33,35]": (64, 3 * 33 * 35),
              "one row": (1, 100)}


@pytest.mark.parametrize("case", PLAN_CASES)
def test_the_chunk_plan_covers_each_row_and_fills_the_card(case):
    rows, row_len = PLAN_CASES[case]
    chunk, chunks = gn.chunk_plan(rows, row_len, sms=132)
    assert chunk % gn.CHUNK_ALIGN == 0 and (chunks - 1) * chunk < row_len <= chunks * chunk
    assert rows * chunks >= gn.WAVES * gn.BLOCKS_PER_SM * 132 or chunk == gn.MIN_CHUNK
    if case.startswith("1024"):
        assert (chunk, chunks) == (30720, 137)


def _chan(a, b):
    """``chan`` of ``csrc/group_norm.cu`` in float32."""
    if b[0] == 0:
        return a
    if a[0] == 0:
        return b
    f = np.float32
    n = f(a[0] + b[0])
    wb = f(b[0] / n)
    d = f(b[1] - a[1])
    return n, f(d * wb + a[1]), f(a[2] + b[2] + d * d * a[0] * wb)


def _row_moments(row: np.ndarray, chunk: int):
    """The apply kernel's row statistics from its chunks' (mean, M2): lane l
    merges chunks l, l + 32, ... in order, then a tree of shuffles down."""
    parts = []
    for p in range(0, row.size, chunk):
        c = row[p:p + chunk].astype(np.float64)
        parts.append((np.float32(c.size), np.float32(c.mean()),
                      np.float32(((c - c.mean()) ** 2).sum())))
    lanes = [(np.float32(0),) * 3 for _ in range(32)]
    for i, part in enumerate(parts):
        lanes[i % 32] = _chan(lanes[i % 32], part)
    off = 16
    while off:
        lanes = [_chan(lanes[l], lanes[l + off]) if l + off < 32 else lanes[l]
                 for l in range(32)]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("case", ["1024 decoder [1,128,1024,1024]", "ragged [2,96,33,35]",
                                  "512 decoder [4,128,512,512]"])
def test_merged_chunk_moments_are_the_rows(case):
    rows, row_len = PLAN_CASES[case]
    chunk, chunks = gn.chunk_plan(rows, row_len, sms=132)
    row = (np.random.default_rng(2).standard_normal(row_len) * 3 + 5).astype(np.float32)
    n, mean, m2 = _row_moments(row, chunk)
    assert n == row_len
    exact = row.astype(np.float64)
    np.testing.assert_allclose(mean, exact.mean(), rtol=1e-6)
    np.testing.assert_allclose(m2 / n, exact.var(), rtol=1e-5)


# ---------------------------------------------------------------------------
# gn_kernel_share's reader
# ---------------------------------------------------------------------------

KERNEL, PLAIN = "group_norm.kernel", "group_norm.plain"
GN_SHARE_CASES = {
    "all kernel": ([(0, {KERNEL: 60}), (1, {KERNEL: 60})], 100.0),
    "a quarter plain": ([(0, {KERNEL: 3, PLAIN: 1}), (1, {KERNEL: 6, PLAIN: 2})], 75.0),
    "all plain": ([(0, {PLAIN: 4})], 0.0),
    "no group norm": ([(0, {"attention.flash": 3})], None),
}


@pytest.mark.parametrize("case", GN_SHARE_CASES)
def test_gn_kernel_share_reads_the_traced_iterations(monkeypatch, case):
    from portbench import cells

    counts, want = GN_SHARE_CASES[case]
    spans_ = [SimpleNamespace(name=profiling.ITERATION, iteration=it, counts={}) for it in (0, 1)]
    spans_ += [SimpleNamespace(name="tid.eot.forward", iteration=it, counts=c) for it, c in counts]
    spans_.append(SimpleNamespace(name="tid.vae.encode", iteration=None, counts={PLAIN: 9}))
    monkeypatch.setattr(profiling, "last_recording", lambda: SimpleNamespace(spans=spans_))
    reader = cells.reader("metrics", "gn_kernel_share")
    assert reader.read(SimpleNamespace(steps=2)) == want
    monkeypatch.setattr(profiling, "last_recording", lambda: None)
    assert reader.read(SimpleNamespace(steps=2)) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


#: Each compared per element as |got - want| <= rtol |want| + atol max |want|.
#: In bf16 the kernels round where PyTorch's unfused ops round: the rows'
#: mean and rstd, the norm's output a before the SiLU, the SiLU's output, the
#: SiLU's gradient dy before the norm's backward, and dx, each by half an ulp,
#: at most 2^-8 of its value.  The errors of a, rstd and mean move z by up to
#: about 1.6 x 2^-8 |a| (not relative to z), and dy's reaches dx scaled by
#: rstd gamma: about 3 x 2^-8 of the peak in all against float64, as the
#: plain version's.  In f32: the arithmetic and the sums' order.
KERNEL_TOL = {torch.bfloat16: (2 ** -7, 2 ** -6), torch.float32: (1e-5, 1e-5)}
#: Against the plain version, by (dtype, output).  bf16 z: bit for bit, as
#: the kernels round mean, rstd, a and z where PyTorch rounds them, from f32
#: values that on an H100 rounded alike at every shape here.  bf16 dx: dy is
#: rounded from f32 values that differ in their last bits (exp, the order of
#: the sums), so an element of dy or dx may land one ulp apart (2^-7 of its
#: value at most), and dx takes dy's through rstd gamma: at most 2.5e-3 of
#: dx's peak on an H100, under 2^-8.  f32: a few ulps of the peak from the
#: sums' order; measured at most 4.6e-7 of the peak, under 1e-6.
PLAIN_TOL = {(torch.bfloat16, "z"): (0.0, 0.0), (torch.bfloat16, "dx"): (2 ** -7, 2 ** -8),
             (torch.float32, "z"): (1e-6, 1e-6), (torch.float32, "dx"): (1e-6, 1e-6)}
#: (shape, groups, eps): the 1024x1024 VAE decoder's widest norm, SD-1.5's
#: UNet at 64x64 and at 8x8 (CFG batch 2 x 4 images), its VAE decoder at
#: 512x512 (4 images), and a ragged size (no 16-byte vectors, cpg 3)
CARD_SHAPES = {"[1,128,1024,1024]": ((1, 128, 1024, 1024), 32, 1e-6),
               "[8,320,64,64]": ((8, 320, 64, 64), 32, 1e-5),
               "[8,1280,8,8]": ((8, 1280, 8, 8), 32, 1e-5),
               "[4,128,512,512]": ((4, 128, 512, 512), 32, 1e-6),
               "[2,96,33,35]": ((2, 96, 33, 35), 32, 1e-6)}


def _within(got, want, tol, what):
    rtol, atol = tol
    d = (got.double() - want).abs()
    bound = rtol * want.abs() + atol * want.abs().max()
    worst = float((d - bound).max())
    assert worst <= 0, f"{what}: {worst:.3e} over the bound, max err {float(d.max()):.3e}"
    return float(d.max() / want.abs().max())


@pytest.mark.chip
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_SHAPES)
def test_kernels_match_plain_and_float64_on_the_card(card, case, dtype, silu):
    shape, groups, eps = CARD_SHAPES[case]
    g = torch.Generator(device=card).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=card) * 2 + 0.5).to(dtype)
    dz = torch.randn(shape, generator=g, device=card).to(dtype)
    norm = _norm(groups, shape[1], eps, dtype, card)
    w, b = norm.weight, norm.bias

    z, stats = gn.group_norm_fwd(x, w, b, groups, eps, silu)
    dx = gn.group_norm_bwd(dz, x, w, b, stats, groups, silu)
    z2, stats2 = gn.group_norm_fwd(x, w, b, groups, eps, silu)
    dx2 = gn.group_norm_bwd(dz, x, w, b, stats2, groups, silu)
    torch.cuda.synchronize()
    assert torch.equal(z, z2) and torch.equal(stats, stats2) and torch.equal(dx, dx2), \
        "two runs differ"

    def plain(xx, nn_norm):
        xx = xx.clone().requires_grad_(True)
        with torch.enable_grad():
            out = gn.group_norm_plain(xx, nn_norm, silu)
            (grad,) = torch.autograd.grad(out, xx, dz.to(xx.dtype))
        return out.detach(), grad

    z_p, dx_p = plain(x, norm)
    z_e, dx_e = plain(x.double(), copy.deepcopy(norm).to(torch.float64))
    rows = x.double().reshape(shape[0] * groups, -1)
    var, mean = torch.var_mean(rows, dim=1, unbiased=False)
    # computed in f32; in bf16 kept at bf16's precision, as PyTorch keeps them
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -8
    torch.testing.assert_close(stats[:, 0].double(), mean, rtol=rtol, atol=1e-6)
    torch.testing.assert_close(stats[:, 1].double(), torch.rsqrt(var + eps), rtol=rtol, atol=0)
    errs = {}
    for name, k, p, e in (("z", z, z_p, z_e), ("dx", dx, dx_p, dx_e)):
        errs[name] = (_within(k, e, KERNEL_TOL[dtype], f"kernel {name} vs float64"),
                      _within(k, p.double(), PLAIN_TOL[dtype, name], f"kernel {name} vs plain"),
                      float((p.double() - e).abs().max() / e.abs().max()))
    print(f"[group norm] {case} {dtype} silu={silu}: peak-relative max errors "
          f"(kernel vs float64, kernel vs plain, plain vs float64) {errs}")


@pytest.mark.chip
def test_the_route_launches_the_kernels_on_the_card(card):
    x = torch.randn((2, 64, 16, 16), device=card, dtype=torch.bfloat16, requires_grad=True)
    frozen, trained = _norm(32, 64, dtype=torch.bfloat16, device=card), \
        _norm(32, 64, dtype=torch.bfloat16, device=card, grad=True)
    before = [k.launches for k in gn.KERNELS]
    with torch.enable_grad(), profiling.tallied() as counts:
        gn.group_norm(x, frozen, silu=True).sum().backward()
        with pytest.raises(ValueError, match="no gradient"):
            gn.group_norm(x, trained, silu=True)
        with pytest.raises(TypeError, match="f32 or bf16"):
            gn.group_norm(x.detach().half(), frozen.half(), silu=True)
    assert [k.launches - n for k, n in zip(gn.KERNELS, before)] == [1, 1]
    assert {k: n for k, n in counts.items() if k.startswith("group_norm.")} == \
        {"group_norm.kernel": 1}
