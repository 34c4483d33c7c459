"""EOT chunks replayed from CUDA graphs (``attack/chunk_graph.py``).

On the CPU, with a stand-in for the capture (``StandInGraph``: a replay runs
the captured function again, with no recording and no kernel count, and
copies its outputs into the tensors the capture returned) and
``GRAPH_DEVICE`` set to "cpu", so that the rule's bookkeeping runs without a
card: the key, each stand-down of the rule, one capture per key with the
later chunks replayed, a capture under a recording with its spans paused,
the counters in the open span and in ``COUNTS`` (a replay counts again what
its capture counted, launches aside), the kernels' launches and runs,
``aux`` apart from the static buffers, the step unchanged (bit for bit
against the eager step, and against the JAX goldens that hold the eager
one), the attention counters the same graphed as eager, and the readers of
``chunk_graph_share`` and ``attn_flash_share``.

On the card (marker ``chip``; ``python -m pytest --noconftest -m chip -s
tests/test_torch_chunk_graph.py``, since the suite's conftest imports JAX,
which that machine lacks): on the tiny family in bf16 with its VAE's
attention on the flash kernels, the graphed step against the eager step over
2 iterations, the counters of the first call, the launches counted and the
kernels the profiler saw run, and ``max_memory_reserved``.  JAX is imported
only inside the golden test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from tml_image_editing_defense_torch.api import training_sampler_kind
from tml_image_editing_defense_torch.attack import chunk_graph, pgd
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import make_sampler
from tml_image_editing_defense_torch.models import layers, model_zoo
from tml_image_editing_defense_torch.models.model_zoo import PromptBank, build_model
from tml_image_editing_defense_torch.models.vae import TINY_VAE
from tml_image_editing_defense_torch.ops._lib import CudaKernel
from tml_image_editing_defense_torch.utils import profiling

SIZE, IMAGES, ITERS, REPS = 32, 2, 2, 3
GRAPH, EAGER, CAPTURES = "eot.chunks.graph", "eot.chunks.eager", "eot.graph.captures"


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def grad_on():
    """Autograd on, whatever a test run earlier in the process left."""
    with torch.enable_grad():
        yield


class StandInGraph:
    """A captured function: a replay runs it again, unseen as a card's
    replay is (no span, no count, no kernel call), and copies its outputs
    into the tensors the capture returned."""

    def __init__(self, fn, outs, pool):
        self.fn, self.static, self.replays = fn, [o.detach() for o in outs], 0
        self._pool = ("pool of", id(self)) if pool is None else pool

    def pool(self):
        return self._pool

    def replay(self):
        self.replays += 1
        launches = TOY.launches
        active, profiling._ACTIVE = profiling._ACTIVE, None
        try:
            new = self.fn()
        finally:
            profiling._ACTIVE = active
        TOY.launches = launches
        for s, n in zip(self.static, new):
            s.data.copy_(n)             # a replay bumps no autograd version


@pytest.fixture
def stand_in(monkeypatch):
    """CPU chunks replay from stand-in graphs; ``.graphs`` lists them in the
    order they were captured."""
    made = SimpleNamespace(graphs=[], pools=[], mp=monkeypatch)

    def capture(fn, pool=None):
        made.pools.append(pool)
        outs = fn()
        graph = StandInGraph(fn, outs, pool)
        made.graphs.append(graph)
        return graph, outs

    monkeypatch.setattr(chunk_graph, "GRAPH_DEVICE", "cpu")
    monkeypatch.setattr(chunk_graph, "capture", capture)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return made


@contextlib.contextmanager
def chunk_counts():
    """``with chunk_counts() as counts:``: what the block added to
    ``chunk_graph.COUNTS``."""
    before, counts = Counter(chunk_graph.COUNTS), Counter()
    try:
        yield counts
    finally:
        counts.update(chunk_graph.COUNTS - before)


# ---------------------------------------------------------------------------
# a toy chunk: counts and launches in its forward and its backward
# ---------------------------------------------------------------------------

TOY = CudaKernel("tid_chunk_graph_toy", [])


def _launch():
    """What ``CudaKernel.__call__`` counts once its launch is accepted."""
    TOY.launches += 1
    profiling.count(f"launches.{TOY.symbol}")


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        _launch()
        return x * 3

    @staticmethod
    def backward(ctx, g):
        _launch()
        profiling.count("toy.backward")
        return g * 3


def toy_forward(m, lv, x, extra):
    """(loss [B], output): one launch forward, one backward, in a span."""
    profiling.count("toy.forward")
    with profiling.span("tid.toy"):
        h = _Scale.apply(m * x + lv.exp())
    if extra is not None:
        h = h + extra.sum()
    return h.flatten(1).sum(1), (m * x).sum(1)


def toy_inputs(seed=0, rows=2, extra=False, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    t = [torch.randn((rows, 4), generator=g, dtype=dtype) for _ in range(3)]
    return (*t, torch.randn((rows, 6), generator=g, dtype=dtype) if extra else None)


def _counts(counts):
    return {k: counts.get(k, 0) for k in (EAGER, GRAPH, CAPTURES)}


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

KEY_CASES = {
    "equal": (toy_inputs(1), True),
    "shape": (toy_inputs(0, rows=3), False),
    "dtype": (toy_inputs(0, dtype=torch.float64), False),
    "cond present": (toy_inputs(0, extra=True), False),
}


@pytest.mark.parametrize("case", KEY_CASES)
def test_the_key_separates_shapes_dtypes_and_cond_structure(case):
    other, same = KEY_CASES[case]
    assert (chunk_graph.chunk_key(toy_inputs(0)) == chunk_graph.chunk_key(other)) is same


def test_the_key_separates_cond_shapes():
    a, b = toy_inputs(0, extra=True), toy_inputs(0, extra=True)
    b = (*b[:3], b[3][:, :5])
    assert chunk_graph.chunk_key(a) != chunk_graph.chunk_key(b)


STAND_DOWN = ("remat_policy", "remat_vae", "cpu", "no_grad")
TOY_LAUNCHES = f"launches.{TOY.symbol}"


@pytest.mark.parametrize("case", STAND_DOWN)
def test_the_rule_keeps_the_chunk_eager(stand_in, case):
    cfg = TrainConfig(remat_policy="full" if case == "remat_policy" else "none",
                      remat_vae=case == "remat_vae")
    inputs = toy_inputs()
    if case == "cpu":
        stand_in.mp.setattr(chunk_graph, "GRAPH_DEVICE", "cuda")
    if case == "no_grad":
        with torch.no_grad():
            assert not chunk_graph.engages(cfg, inputs)
        assert chunk_graph.engages(cfg, inputs)
        return
    runner = chunk_graph.ChunkRunner(toy_forward, cfg)
    with chunk_counts() as counts:
        for _ in range(3):
            runner(inputs)
    assert _counts(counts) == {EAGER: 3, GRAPH: 0, CAPTURES: 0}
    assert not stand_in.graphs and runner.graphs is None


def test_capture_once_per_key_then_replay_and_a_new_key_releases_the_pair(stand_in):
    runner = chunk_graph.ChunkRunner(toy_forward, TrainConfig())
    eager = chunk_graph.ChunkRunner(toy_forward, TrainConfig(remat_vae=True))
    launches, runs = TOY.launches, chunk_graph.kernel_runs([TOY])[TOY.symbol]
    with chunk_counts() as counts:
        got = [[t.clone() for t in runner(toy_inputs(seed))] for seed in range(4)]
    assert _counts(counts) == {EAGER: 1, GRAPH: 3, CAPTURES: 1}
    assert [g.replays for g in stand_in.graphs] == [3, 3]
    # each chunk runs one launch forward and one backward: the eager chunk
    # calls both, the capture calls both into its graphs, the replays none
    assert TOY.launches - launches == 4
    assert counts[f"captured.{TOY.symbol}"] == 2 and counts[f"replayed.{TOY.symbol}"] == 6
    assert chunk_graph.kernel_runs([TOY])[TOY.symbol] - runs == 8
    for seed, outs in enumerate(got):
        for a, b in zip(outs, eager(toy_inputs(seed))):
            assert torch.equal(a, b)
    pair = weakref.ref(runner.graphs)
    stand_in.graphs.clear()             # a stand-in holds the functions it replays
    with chunk_counts() as counts:
        runner(toy_inputs(0, rows=3))
        gc.collect()
        assert runner.graphs is None and pair() is None
        runner(toy_inputs(1, rows=3))
    assert _counts(counts) == {EAGER: 1, GRAPH: 1, CAPTURES: 1}
    assert len(stand_in.graphs) == 2


def test_a_capture_shares_the_pool_of_the_graphs_alive(stand_in):
    """Two steps alive share one pool; once every graph is gone, the next
    capture takes a pool of its own (its predecessor's was freed)."""
    gc.collect()
    assert not chunk_graph._Graph._alive
    first, second = (chunk_graph.ChunkRunner(toy_forward, TrainConfig()) for _ in range(2))
    for runner in (first, first, second, second):
        runner(toy_inputs(0))
    pool = stand_in.graphs[0].pool()
    assert stand_in.pools == [None, pool, pool, pool]
    first.graphs = second.graphs = None
    stand_in.graphs.clear()             # a stand-in holds the functions it replays
    gc.collect()
    assert not chunk_graph._Graph._alive
    third = chunk_graph.ChunkRunner(toy_forward, TrainConfig())
    third(toy_inputs(0))
    third(toy_inputs(0))
    assert stand_in.pools[4:] == [None, stand_in.graphs[0].pool()]


def _chunk_spans(rec):
    return [[s for s in rec.spans if s.name == n] for n in ("tid.eot.forward", "tid.eot.backward")]


def test_counters_land_in_the_open_span_and_a_replay_counts_no_launch(stand_in):
    runner = chunk_graph.ChunkRunner(toy_forward, TrainConfig())
    runner(toy_inputs(0))
    runner(toy_inputs(1))                                  # the capture
    launches = TOY.launches
    with chunk_counts() as counts, profiling.recording("cpu") as rec:
        with profiling.span(profiling.ITERATION, iteration=0):
            runner(toy_inputs(2), rep=2, rows=2)
    (fwd,), (bwd,) = _chunk_spans(rec)
    assert fwd.attrs == {"rep": 2, "rows": 2}
    # the counts the captures took with no recording open, launches aside
    assert fwd.counts == {GRAPH: 1, "toy.forward": 1} and bwd.counts == {"toy.backward": 1}
    assert rec.totals == {GRAPH: 1, "toy.forward": 1, "toy.backward": 1}
    assert not [s for s in rec.spans if s.name == "tid.toy"]
    assert TOY.launches == launches
    assert counts == {GRAPH: 1, f"replayed.{TOY.symbol}": 2}
    # an eager chunk under a recording counts as eager in its span, with
    # its own spans and launches
    runner = chunk_graph.ChunkRunner(toy_forward, TrainConfig())
    with profiling.recording("cpu") as rec:
        runner(toy_inputs(0))
    (fwd,), (bwd,) = _chunk_spans(rec)
    assert fwd.counts == {EAGER: 1, "toy.forward": 1}
    assert bwd.counts == {"toy.backward": 1, TOY_LAUNCHES: 1}
    (toy,) = [s for s in rec.spans if s.name == "tid.toy"]
    assert toy.parent == fwd.id and toy.counts == {TOY_LAUNCHES: 1}


def test_a_capture_under_a_recording_pauses_its_spans(stand_in):
    """The capture runs with the recording open, no span opening inside it;
    its counts land in the chunk's spans, the backward's in the backward's,
    and the launches in the spans are the kernel's own.  The replay that
    follows counts the capture's counts again, launches aside; the capture's
    own chunk counts them once."""
    runner = chunk_graph.ChunkRunner(toy_forward, TrainConfig())
    launches = TOY.launches
    with chunk_counts() as counts, profiling.recording("cpu") as rec:
        for seed in range(3):
            runner(toy_inputs(seed))
    assert _counts(counts) == {EAGER: 1, GRAPH: 2, CAPTURES: 1}
    fwd, bwd = _chunk_spans(rec)
    assert [s.counts for s in fwd] == [
        {EAGER: 1, "toy.forward": 1},
        {CAPTURES: 1, GRAPH: 1, "toy.forward": 1, TOY_LAUNCHES: 1},
        {GRAPH: 1, "toy.forward": 1}]
    assert [s.counts for s in bwd] == [{"toy.backward": 1, TOY_LAUNCHES: 1},
                                       {"toy.backward": 1, TOY_LAUNCHES: 1},
                                       {"toy.backward": 1}]
    # the eager chunk's span alone: none opened inside the capture
    assert [s.parent for s in rec.spans if s.name == "tid.toy"] == [fwd[0].id]
    assert rec.totals[TOY_LAUNCHES] == TOY.launches - launches == 4
    assert not rec.paused


def test_spans_paused_opens_no_span_and_marks_no_backward():
    x = torch.ones(3, requires_grad=True)
    with profiling.recording("cpu") as rec, profiling.span("tid.outer") as outer:
        with profiling.spans_paused():
            assert profiling.span("tid.inner") is profiling._NOOP
            profiling.count("inside")
            y = profiling.backward_span("tid.x.backward", lambda t: t * 2, x)
            with profiling.spans_paused():                 # nested: still paused
                profiling.count("inside")
            assert rec.paused
        assert not rec.paused
    assert type(y.grad_fn).__name__ == "MulBackward0"
    assert [s.name for s in rec.spans] == ["tid.outer"] and outer.counts == {"inside": 2}
    with profiling.spans_paused():                         # nothing open: a no-op
        profiling.count("d")


# ---------------------------------------------------------------------------
# the tiny family's step
# ---------------------------------------------------------------------------


class Attack:
    """The tiny family's batched step on ``device`` (``REPS`` reps one at a
    time, so that one call warms up, captures and replays)."""

    def __init__(self, device, dtype=torch.float32, reps=REPS):
        self.device, self.dtype = torch.device(device), dtype
        self.model = build_model("tiny", image_size=SIZE, device=device, dtype=dtype,
                                 generator=torch.Generator(device=device).manual_seed(0),
                                 attn_kv_chunk=32)
        self.cfg = TrainConfig(image_size=SIZE, grad_reps=reps, n_noise=1,
                               derive_norm_hyperparams=False, enable_visualization=False)
        self.sampler = make_sampler(training_sampler_kind(self.model.base_family,
                                                          self.cfg.use_lcm), self.model.schedule)
        self.plan = self.sampler.plan(self.cfg.n_denoising_steps_per_iteration,
                                      limit_t=700 if self.cfg.limit_timesteps else None)
        g = torch.Generator().manual_seed(1)
        src = (torch.rand((IMAGES, 3, SIZE, SIZE), generator=g) * 2 - 1).to(device, dtype)
        tgt = (torch.rand((IMAGES, 3, SIZE, SIZE), generator=g) * 2 - 1).to(device, dtype)
        ctx = self.model.unet.config.cross_attention_dim
        bank = PromptBank(torch.randn((4, 77, ctx), generator=g).to(device, dtype),
                          torch.randn((77, ctx), generator=g).to(device, dtype))
        pools = torch.randn((IMAGES, 1, *self.model.latent_shape), generator=g).to(device, dtype)
        with torch.no_grad():
            self.batched = pgd.batch_attack_data([
                pgd.make_attack_data(self.model, self.cfg, src[i:i + 1], tgt[i:i + 1], bank,
                                     pools[i]) for i in range(IMAGES)])

    def step(self):
        return pgd.make_batched_pgd_step(self.model, self.sampler, self.plan, self.cfg)

    def run(self, step, iters=ITERS):
        """``iters`` iterations of ``step`` from the sources: the iterates,
        the aux and what each added to ``chunk_graph.COUNTS``."""
        x, out = self.batched.source[:, 0], []
        lat = self.model.latent_shape
        for it in range(iters):
            draws = [pgd.sample_draws(pgd.iteration_generator(i, it, self.device), self.cfg,
                                      self.batched.bank_embeds.shape[0], 1, lat,
                                      self.plan.num_steps, self.dtype) for i in range(IMAGES)]
            with chunk_counts() as counts:
                x, aux = step(x, self.batched, draws)
            out.append((x, aux, counts))
        return out


AUX = ("avg_loss", "rec_loss", "pert_loss", "output_latent")


@pytest.fixture(scope="module")
def tiny(one_thread):
    return Attack("cpu")


def test_stand_in_graphs_leave_the_step_unchanged(tiny, stand_in):
    graphed = tiny.run(tiny.step())
    stand_in.mp.setattr(chunk_graph, "GRAPH_DEVICE", "cuda")
    eager = tiny.run(tiny.step())
    for (xg, ag, cg), (xe, ae, ce) in zip(graphed, eager):
        assert torch.equal(xg, xe)
        for k in AUX:
            assert torch.equal(ag[k], ae[k]), k
        assert _counts(ce) == {EAGER: REPS, GRAPH: 0, CAPTURES: 0}
    assert _counts(graphed[0][2]) == {EAGER: 1, GRAPH: REPS - 1, CAPTURES: 1}
    assert _counts(graphed[1][2]) == {EAGER: 0, GRAPH: REPS, CAPTURES: 0}


def _attention_counts(attack, graphed: bool):
    """Per iteration, the ``attention.<route>`` counts in a recording over
    ``ITERS`` iterations of one step, and ``attn_flash_share`` read from it."""
    from portbench import cells

    step = attack.step()
    with profiling.recording("cpu") as rec:
        for it in range(ITERS):
            with profiling.span(profiling.ITERATION, iteration=it):
                (_, _, counts), = attack.run(step, iters=1)
            want = ({EAGER: 0, GRAPH: REPS} if it else {EAGER: 1, GRAPH: REPS - 1}
                    ) if graphed else {EAGER: REPS, GRAPH: 0}
            assert {k: counts[k] for k in want} == want
    per_iteration = [Counter() for _ in range(ITERS)]
    for s in rec.spans:
        if s.iteration is not None:
            per_iteration[s.iteration].update(
                {k: n for k, n in s.counts.items() if k.startswith("attention.")})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "last_recording", lambda: rec)
        share = cells.reader("metrics", "attn_flash_share").read(SimpleNamespace(steps=ITERS))
    return per_iteration, share


def test_attention_counters_read_the_same_graphed_as_eager(stand_in):
    """Over two iterations, the first warming up and capturing, the second
    replaying every chunk: each iteration's route counts and the flash share
    equal the eager step's.  The VAE attends at head dim 64 over 256 tokens,
    which the flash route takes once the long-attention floor is lowered (on
    the CPU the kernel's plain version runs), the UNet on the chunked and
    plain routes."""
    unet, _, texts, native = model_zoo._FAMILIES["tiny"]
    stand_in.mp.setitem(model_zoo._FAMILIES, "tiny",
                        (unet, dataclasses.replace(TINY_VAE, block_out_channels=(32, 64)), texts,
                         native))
    stand_in.mp.setattr(layers, "MIN_CHUNKED_SEQ", 64)
    attack = Attack("cpu")
    graphed, graphed_share = _attention_counts(attack, True)
    assert len(stand_in.graphs) == 2
    stand_in.mp.setattr(chunk_graph, "GRAPH_DEVICE", "cuda")
    eager, eager_share = _attention_counts(attack, False)
    assert graphed == eager and graphed[0] == graphed[1]
    assert {"attention.flash", "attention.chunked"} <= set(eager[0])
    assert graphed_share == eager_share and 0 < eager_share < 100


def test_aux_shares_no_storage_with_the_static_buffers(tiny, stand_in):
    pairs = []
    init = chunk_graph.ChunkGraphs.__init__

    def kept(self, *args):
        init(self, *args)
        pairs.append(self)

    stand_in.mp.setattr(chunk_graph.ChunkGraphs, "__init__", kept)
    runs = tiny.run(tiny.step())
    (pair,) = pairs
    static = {t.untyped_storage().data_ptr() for t in (*pair.inputs, *pair.outputs)
              if t is not None}
    for x, aux, _ in runs:
        for t in (x, *(aux[k] for k in AUX)):
            assert t.untyped_storage().data_ptr() not in static


@pytest.mark.parametrize("graphs", ["eager", "stand-in graphs"])
def test_golden_step_holds_with_and_without_chunk_graphs(one_thread, stand_in, graphs):
    """The golden iterate of tests/test_torch_pgd.py (its 2 reps: the first
    the warm-up, the second captured and replayed where graphs engage);
    on the CPU the step is eager."""
    import jax
    import numpy as np
    from test_torch_models import nchw, nhwc, port_model_from_jax
    from test_torch_pgd import GOLDEN_PATH, GS, TOL, _rand, golden_jax_model, replay_draws

    from tml_image_editing_defense_torch.core.samplers import LCMSampler
    from tml_image_editing_defense_tpu.core.rng import make_noise_pool as j_noise_pool

    if graphs == "eager":
        stand_in.mp.setattr(chunk_graph, "GRAPH_DEVICE", "cuda")
    jmodel = golden_jax_model("tiny")
    pm = port_model_from_jax(jmodel)
    ref = np.load(GOLDEN_PATH)
    cfg = TrainConfig(
        norm_type="l2", derive_norm_hyperparams=False, eps=8.0, step_size=1.0,
        n_denoising_steps_per_iteration=2, limit_timesteps=False, grad_reps=2,
        guidance_scale=GS, image_size=32, apply_loss_on_images=True,
        apply_loss_on_latents=False, perturbation_loss_lambda=1.0, prompts=["a", "b"],
        use_pallas_update=False,
    )
    image = np.clip(_rand(1, (1, 32, 32, 3), 0.4), -1, 1)
    bank = pm.embed_prompt_bank(cfg.prompts)
    pool = np.asarray(j_noise_pool(jax.random.key(5), 2, jmodel.latent_shape))
    pool = torch.from_numpy(np.ascontiguousarray(pool.transpose(0, 1, 4, 2, 3)))
    sampler = LCMSampler(pm.schedule)
    plan = sampler.plan(2)
    data = pgd.make_attack_data(pm, cfg, nchw(image), torch.zeros_like(nchw(image)), bank, pool)
    draws = replay_draws(jax.random.key(7), 2, 2, 2, plan.num_steps, (1, 16, 16, 4))
    with chunk_counts() as counts:
        x1, aux = pgd.make_pgd_step(pm, sampler, plan, cfg, decode_vis=False)(
            nchw(image), data, draws)
    np.testing.assert_allclose(nhwc(x1), ref["pgd_x_adv"], **TOL)
    np.testing.assert_allclose(aux["avg_loss"].item(), ref["pgd_avg_loss"], rtol=2e-4)
    want = ({EAGER: 2, GRAPH: 0, CAPTURES: 0} if graphs == "eager"
            else {EAGER: 1, GRAPH: 1, CAPTURES: 1})
    assert _counts(counts) == want


# ---------------------------------------------------------------------------
# what a capture requires of the chain
# ---------------------------------------------------------------------------


def test_an_int_timestep_embeds_as_its_tensor(tiny):
    unet = tiny.model.unet
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 8, 8), generator=g)
    ctx = torch.randn((2, 77, unet.config.cross_attention_dim), generator=g)
    with torch.no_grad():
        assert torch.equal(unet(x, 501, ctx), unet(x, torch.tensor(501), ctx))
        assert torch.equal(unet(x, 501, ctx), unet(x, torch.tensor([501, 501]), ctx))


def test_plms_copies_its_weights_once_a_plan(monkeypatch):
    sampler = make_sampler("plms", build_model("tiny", device="meta").schedule)
    plan = sampler.plan(4)
    copies = []
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor", lambda *a, **k: copies.append(1) or as_tensor(*a, **k))
    x = torch.randn((1, 4, 8, 8))
    carry = sampler.init_carry(x.shape, x.dtype, x.device)
    for i in range(plan.num_steps):
        x, carry = sampler.step(plan, i, carry, torch.randn_like(x), x, None)
    assert len(copies) == 1
    w = sampler._weights_on(plan, x.device, x.dtype)
    assert torch.equal(w, as_tensor(plan.ab_w, dtype=x.dtype))


# ---------------------------------------------------------------------------
# chunk_graph_share's reader
# ---------------------------------------------------------------------------


def _recording(counts):
    spans_ = [SimpleNamespace(name=profiling.ITERATION, iteration=it, counts={})
              for it in range(2)]
    spans_ += [SimpleNamespace(name="tid.eot.forward", iteration=it, counts=c)
               for it, c in counts]
    spans_.append(SimpleNamespace(name="tid.eot.forward", iteration=None, counts={EAGER: 5}))
    return SimpleNamespace(spans=spans_)


SHARE_CASES = {
    "all replayed": ([(0, {GRAPH: 1})] * 3 + [(1, {GRAPH: 1})] * 3, 100.0),
    "one eager": ([(0, {EAGER: 1})] + [(0, {GRAPH: 1})] * 3, 75.0),
    "no counters": ([(0, {"launches.x": 3})], None),
}


@pytest.mark.parametrize("case", SHARE_CASES)
def test_chunk_graph_share_reads_the_traced_iterations(monkeypatch, case):
    from portbench import cells

    counts, want = SHARE_CASES[case]
    rec = _recording(counts)
    monkeypatch.setattr(profiling, "last_recording", lambda: rec)
    assert cells.reader("metrics", "chunk_graph_share").read(SimpleNamespace(steps=2)) == want
    monkeypatch.setattr(profiling, "last_recording", lambda: None)
    assert cells.reader("metrics", "chunk_graph_share").read(SimpleNamespace(steps=2)) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _kernels():
    from tml_image_editing_defense_torch.ops import flash_attention, group_norm, pgd_kernels

    return flash_attention.KERNELS + pgd_kernels.KERNELS + group_norm.KERNELS


@pytest.fixture(scope="module")
def card():
    """The tiny family in bf16 whose VAE attends at head dim 64 over 256
    tokens, which the flash kernels take once the long-attention floor is
    lowered."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    with pytest.MonkeyPatch.context() as mp:
        unet, _, texts, native = model_zoo._FAMILIES["tiny"]
        mp.setitem(model_zoo._FAMILIES, "tiny",
                   (unet, dataclasses.replace(TINY_VAE, block_out_channels=(32, 64)), texts,
                    native))
        mp.setattr(layers, "MIN_CHUNKED_SEQ", 64)
        yield Attack("cuda", torch.bfloat16)


def _launch_counts():
    return {k.symbol: k.launches for k in _kernels()}


def _profiled(fn, trace_dir=None):
    """``fn()`` under ``torch.profiler`` (under ``profiling.trace``, with a
    recording open, where ``trace_dir`` is given): its result and the device
    records by name, those of memory copies apart (a replay copies its
    inputs into the graphs' static buffers)."""
    from torch.profiler import ProfilerActivity, profile

    block = (profile(activities=[ProfilerActivity.CUDA]) if trace_dir is None
             else profiling.trace(trace_dir))
    with block as prof:
        out = fn()
        torch.cuda.synchronize()
    ran = Counter(e.name() for e in prof.profiler.kineto_results.events()
                  if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()
                  and "memcpy" not in e.name().lower() and "copy" not in e.name().lower())
    return out, ran


def _ulps(a, b):
    """The largest gap of two bf16 tensors, in units of the last place at
    the larger magnitude."""
    a, b = a.float(), b.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    return float(((a - b).abs() / ulp).max())


@pytest.mark.chip
def test_graphed_step_is_the_eager_step_on_the_card(card, tmp_path):
    with pytest.MonkeyPatch.context() as off:
        off.setattr(chunk_graph, "GRAPH_DEVICE", "none")
        before = _launch_counts()
        torch.cuda.reset_peak_memory_stats()
        eager, eager_ran = _profiled(lambda: card.run(card.step()))
        eager_reserved = torch.cuda.max_memory_reserved()
        eager_launches = {k: n - before[k] for k, n in _launch_counts().items()}
    gc.collect()
    torch.cuda.empty_cache()
    before, runs = _launch_counts(), chunk_graph.kernel_runs(_kernels())
    torch.cuda.reset_peak_memory_stats()
    # traced, as profiling.trace traces: the capture runs under the recording
    graphed, graphed_ran = _profiled(lambda: card.run(card.step()), tmp_path)
    rec = profiling.last_recording()
    graphed_reserved = torch.cuda.max_memory_reserved()
    graphed_launches = {k: n - before[k] for k, n in _launch_counts().items()}
    graphed_runs = {k: n - runs[k] for k, n in chunk_graph.kernel_runs(_kernels()).items()}
    assert eager_launches["tid_flash_fwd"] > 0, "the flash kernels were not reached"
    assert _counts(graphed[0][2]) == {EAGER: 1, GRAPH: REPS - 1, CAPTURES: 1}
    assert _counts(graphed[1][2]) == {EAGER: 0, GRAPH: REPS, CAPTURES: 0}
    assert _counts(rec.totals) == {EAGER: 1, GRAPH: ITERS * REPS - 1, CAPTURES: 1}
    # the model's spans of the eager chunk alone: none opened in the capture
    assert sum(s.name == "tid.vae.decode" for s in rec.spans) == 1
    # the kernels called: the eager chunk's and the capture's, no replay's
    # (2 of the ITERS x REPS chunks called theirs); the kernels run: every chunk's
    captured = {k[len("captured."):]: n for k, n in graphed[0][2].items()
                if k.startswith("captured.")}
    flash = {k: n for k, n in eager_launches.items() if k.startswith("tid_flash")}
    norms = {k for k, n in eager_launches.items() if k.startswith("tid_group_norm") and n}
    assert captured and set(captured) <= set(flash) | norms and norms <= set(captured)
    for k, n in eager_launches.items():
        assert graphed_launches[k] == n - (ITERS * REPS - 2) * captured.get(k, 0), k
    assert graphed_runs == eager_launches
    # the profiler saw every kernel run: the same kernels as eager, and as
    # many flash kernels as the counts say ran.  Fills and memsets apart:
    # on an H100 the graphed run showed 16 FillFunctor<long> and 56 memsets
    # where the eager run showed 12 and 58
    fills = {n for n in {*graphed_ran, *eager_ran} if "Memset" in n or "FillFunctor" in n}
    assert ({n: c for n, c in graphed_ran.items() if n not in fills}
            == {n: c for n, c in eager_ran.items() if n not in fills})
    assert sum(n for name, n in graphed_ran.items() if "flash_" in name) == sum(flash.values())
    gaps = {"iterate": max(_ulps(g[0], e[0]) for g, e in zip(graphed, eager))}
    for k in AUX:
        gaps[k] = max(_ulps(g[1][k], e[1][k]) for g, e in zip(graphed, eager))
    print(f"[chunk graphs] gaps in bf16 ulps {gaps}; max_memory_reserved eager "
          f"{eager_reserved} graphed {graphed_reserved} bytes; launches eager "
          f"{eager_launches} graphed {graphed_launches}; device records "
          f"{sum(graphed_ran.values())} graphed, {sum(eager_ran.values())} eager; fills and "
          f"memsets graphed {[graphed_ran[n] for n in fills]}, eager "
          f"{[eager_ran[n] for n in fills]}")
    # the same kernels on the same inputs in the same order: bit for bit
    for (xg, ag, _), (xe, ae, _) in zip(graphed, eager):
        assert torch.equal(xg, xe), gaps
        for k in AUX:
            assert torch.equal(ag[k], ae[k]), (k, gaps)
