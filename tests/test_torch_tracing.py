"""The port's recorder (``utils/profiling.py``): spans and counters over
``run_pgd``'s iterations, the EOT chunks, the UNet, the VAE and attention.

On the CPU, on the tiny family with 2 images and 2 iterations
(``MIN_CHUNKED_SEQ`` lowered and D = 32 taken as a flash head dim, so that
the VAE's attention takes the flash route, through its plain version, and
the UNet's the chunked one): the recorder changes no iterate and no loss;
off, it records nothing; on, the span tree is the iteration's structure;
``trace`` writes the spans into the Chrome trace and ``spans.jsonl``; an
SDXL-shaped UNet spans its added embedding.

On the card (marker ``chip``; ``python -m pytest --noconftest -m chip -s
tests/test_torch_tracing.py``, since the suite's conftest imports JAX,
which that machine lacks): the launch counts in the spans are the kernels'
own, and the spans' host and device times sit on the profiler's clock.
This file imports no JAX.
"""

from __future__ import annotations

import json
import threading
from collections import Counter

import pytest
import torch

from tml_image_editing_defense_torch.api import training_sampler_kind
from tml_image_editing_defense_torch.attack import pgd
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.samplers import make_sampler
from tml_image_editing_defense_torch.models import layers
from tml_image_editing_defense_torch.models.model_zoo import PromptBank, build_model
from tml_image_editing_defense_torch.utils import profiling

SIZE, IMAGES, ITERS, REPS = 32, 2, 2, 2
#: the clock check's slack on the card: the profiler converts the device's
#: timestamps to the host clock itself, the recorder through one event
CLOCK_SLACK_NS = 200_000


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Attack:
    """The tiny family's batched attack on ``device``: ``run()`` is one
    ``run_pgd`` call of ``ITERS`` iterations over ``IMAGES`` images."""

    def __init__(self, device, chunk=1):
        self.model = build_model("tiny", image_size=SIZE, device=device,
                                 generator=torch.Generator(device=device).manual_seed(0),
                                 attn_kv_chunk=32)
        g = torch.Generator().manual_seed(1)
        self.cfg = TrainConfig(image_size=SIZE, n_optimization_steps=ITERS, grad_reps=REPS,
                               eot_chunk=chunk, n_noise=1, derive_norm_hyperparams=False,
                               enable_visualization=False)
        self.sampler = make_sampler(training_sampler_kind(self.model.base_family,
                                                          self.cfg.use_lcm), self.model.schedule)
        self.plan = self.sampler.plan(self.cfg.n_denoising_steps_per_iteration,
                                      limit_t=700 if self.cfg.limit_timesteps else None)
        src = (torch.rand((IMAGES, 3, SIZE, SIZE), generator=g) * 2 - 1).to(device)
        tgt = (torch.rand((IMAGES, 3, SIZE, SIZE), generator=g) * 2 - 1).to(device)
        ctx = self.model.unet.config.cross_attention_dim
        bank = PromptBank(torch.randn((4, 77, ctx), generator=g).to(device),
                          torch.randn((77, ctx), generator=g).to(device))
        lat = self.model.latent_shape
        pools = torch.randn((IMAGES, 1, *lat), generator=g).to(device)
        self.batched = pgd.batch_attack_data([
            pgd.make_attack_data(self.model, self.cfg, src[i:i + 1], tgt[i:i + 1], bank,
                                 pools[i]) for i in range(IMAGES)])
        self.step = pgd.make_batched_pgd_step(self.model, self.sampler, self.plan, self.cfg)

    def run(self):
        return pgd.run_pgd(self.model, self.sampler, self.plan, self.cfg, self.batched,
                           list(range(IMAGES)), step_fn=self.step, vis_needs_image=False)


def _raise(*args, **kwargs):
    raise AssertionError("a CUDA event was made with no recording open")


@pytest.fixture(scope="module")
def runs(one_thread):
    """The attack run with the recorder off, then under ``torch.profiler``
    (on); the routes ``attention_route`` gave in the off run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "MIN_CHUNKED_SEQ", 64)
        mp.setattr(layers, "KERNEL_HEAD_DIMS", (32,))
        routes = Counter()
        rule = layers.attention_route

        def counted_rule(*args):
            route = rule(*args)
            routes[route] += 1
            return route

        with torch.enable_grad():
            attack = Attack("cpu")
            before = profiling.last_recording()
            with mp.context() as off:
                off.setattr(layers, "attention_route", counted_rule)
                off.setattr(torch.cuda, "Event", _raise)
                x_off, h_off = attack.run()
            off_recording = profiling.last_recording()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                x_on, h_on = attack.run()
            rec = profiling.last_recording()
    return dict(attack=attack, before=before, off_recording=off_recording, x_off=x_off,
                h_off=h_off, x_on=x_on, h_on=h_on, rec=rec, routes=routes)


def test_recorder_changes_no_iterate_and_no_loss(runs):
    assert torch.equal(runs["x_off"], runs["x_on"])
    assert runs["h_off"] == runs["h_on"] and len(runs["h_on"]) == IMAGES
    assert runs["rec"] is not runs["before"] and not runs["rec"].is_open


def test_off_records_nothing(runs):
    """The off run made no CUDA event (``torch.cuda.Event`` raised there)
    and left the last recording as it was; outside a recording a span is
    the shared no-op and a count and a marker do nothing."""
    assert runs["off_recording"] is runs["before"]
    assert profiling.span("tid.x", a=1) is profiling._NOOP
    profiling.count("launches.x")
    x = torch.ones(3, requires_grad=True)
    with torch.enable_grad():
        y = profiling.backward_span("tid.x.backward", lambda t: t * 2, x)
    assert type(y.grad_fn).__name__ == "MulBackward0"


def _children(rec, parent, name):
    return [s for s in rec.spans if s.parent == parent.id and s.name == name]


def test_span_tree_is_the_iterations_structure(runs):
    rec, attack = runs["rec"], runs["attack"]
    chunks = REPS // attack.cfg.eot_chunk
    steps = attack.plan.num_steps
    iters = rec.iterations()
    assert [s.attrs["iteration"] for s in iters] == list(range(ITERS))
    assert all(s.parent is None and s.attrs["images"] == IMAGES for s in iters)
    for it in iters:
        assert len(_children(rec, it, "tid.pgd.draws")) == 1
        assert len(_children(rec, it, "tid.vae.encode")) == 1
        assert len(_children(rec, it, "tid.pgd.update")) == 1
        assert len(_children(rec, it, "tid.eot.encoder_backward")) == 1
        assert not _children(rec, it, "tid.eot.reduce")
        fwd = _children(rec, it, "tid.eot.forward")
        assert len(fwd) == len(_children(rec, it, "tid.eot.backward")) == chunks
        assert len(_children(rec, it, "tid.eot.inputs")) == chunks
        assert [f.attrs["rep"] for f in fwd] == list(range(0, REPS, attack.cfg.eot_chunk))
        for f in fwd:
            unets = _children(rec, f, "tid.unet")
            assert len(unets) == steps and len(_children(rec, f, "tid.vae.decode")) == 1
            # a UNet span's nth under its chunk is the denoising step
            assert [u.nth for u in unets] == list(range(steps))
            assert [u.attrs["t"] for u in unets] == [int(t) for t in attack.plan.t_eval]
    per_iter = Counter((s.iteration, s.name) for s in rec.spans)
    for it in range(ITERS):
        assert per_iter[it, "tid.unet"] == per_iter[it, "tid.unet.backward"] == chunks * steps
        assert per_iter[it, "tid.vae.decode"] == per_iter[it, "tid.vae.decode.backward"] == chunks
        assert per_iter[it, "tid.vae.encode.backward"] == 1


def test_attention_spans_follow_the_route_rule(runs):
    rec = runs["rec"]
    fwd = Counter(s.attrs["route"] for s in rec.spans if s.name == "tid.attention")
    bwd = Counter(s.attrs["route"] for s in rec.spans if s.name == "tid.attention.backward")
    assert fwd == runs["routes"]
    assert fwd["flash"] and fwd["chunked"]
    # plain attention has no backward of its own to span
    assert bwd == Counter({r: n for r, n in fwd.items() if r != "plain"})
    # the CPU's chunks run eager, one counted a chunk; every group norm runs
    # the plain route, 20 a tiny UNet call, 10 an encode, 14 a decode
    # (tests/test_torch_group_norm.py counts them by hand)
    chunks = ITERS * REPS // runs["attack"].cfg.eot_chunk
    calls = Counter(s.name for s in rec.spans)
    norms = 20 * calls["tid.unet"] + 10 * calls["tid.vae.encode"] + 14 * calls["tid.vae.decode"]
    assert rec.totals == {**{f"attention.{r}": n for r, n in fwd.items()},
                          "eot.chunks.eager": chunks, "group_norm.plain": norms}
    for s in rec.spans:
        if s.name == "tid.attention":
            assert s.counts == {f"attention.{s.attrs['route']}": 1}


def _ancestors(rec, s):
    by_id = {x.id: x for x in rec.spans}
    out = []
    while s.parent is not None:
        s = by_id[s.parent]
        out.append(s.name)
    return out


def test_backward_spans_hang_under_the_waiting_span(runs):
    rec = runs["rec"]
    for s in rec.spans:
        assert s.closed and s.iteration is not None and s.host_ms >= 0
        up = _ancestors(rec, s)
        if s.name in ("tid.unet.backward", "tid.vae.decode.backward"):
            assert up[0] == "tid.eot.backward"
        if s.name == "tid.vae.encode.backward":
            assert up[0] == "tid.eot.encoder_backward"
        if s.name == "tid.attention.backward":
            assert up[0] in ("tid.unet.backward", "tid.vae.decode.backward",
                             "tid.vae.encode.backward")
        if s.name == "tid.attention":
            assert up[0] in ("tid.unet", "tid.vae.decode", "tid.vae.encode")
        assert s.device_ms is None and s.lead_ms is None              # no card


def test_an_sdxl_unet_spans_its_added_embedding(one_thread):
    """``text_time`` models span their added embedding inside ``tid.unet``
    (``rows``, the rows of the call); the plain UNet has none."""
    g = torch.Generator().manual_seed(2)
    for family, spans_ in (("tiny-sdxl", 1), ("tiny", 0)):
        unet = build_model(family, image_size=SIZE, device="cpu", generator=g).unet
        cfg = unet.config
        x = torch.randn((3, 4, 8, 8), generator=g)
        ctx = torch.randn((3, 77, cfg.cross_attention_dim), generator=g)
        kw = {}
        if cfg.addition_embed_type == "text_time":
            pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
            kw = dict(text_embeds=torch.randn((3, pooled), generator=g),
                      time_ids=torch.full((3, 6), 32.0))
        with torch.no_grad(), profiling.recording("cpu") as rec:
            unet(x, 501, ctx, **kw)
        added = [s for s in rec.spans if s.name == "tid.unet.add_embed"]
        assert len(added) == spans_
        for s in added:
            assert s.attrs == {"rows": 3} and _ancestors(rec, s) == ["tid.unet"] and s.closed


def test_a_span_on_a_thread_with_none_open_takes_the_waiting_span():
    """The rule for autograd's device thread, shown with a plain thread."""
    seen = {}

    def worker():
        with profiling.span("tid.worker") as sp:
            profiling.count("n", 2)
            seen["span"] = sp

    with profiling.recording() as rec:
        with profiling.span("tid.outer", waits=True) as outer:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
        with profiling.span("tid.after"):
            pass
    sp = seen["span"]
    assert sp.parent == outer.id and sp.thread != outer.thread and sp.counts == {"n": 2}
    assert rec.spans[-1].parent is None and rec.totals == {"n": 2}
    assert profiling.last_recording() is rec and profiling._ACTIVE is None


def test_backward_span_values_and_gradients_are_fns(one_thread):
    w = torch.randn(4, 4, generator=torch.Generator().manual_seed(1))

    def fn(t):
        return torch.tanh(t @ w), t.sum()

    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(2), requires_grad=True)
    with torch.enable_grad():
        a, b = fn(x)
        ga = torch.autograd.grad((a * a).sum() + b, x)[0]
        with profiling.recording() as rec:
            with profiling.span("tid.outer", waits=True):
                c, d = profiling.backward_span("tid.fn.backward", fn, x, rows=2)
                gc = torch.autograd.grad((c * c).sum() + d, x)[0]
    assert torch.equal(a, c) and torch.equal(b, d) and torch.equal(ga, gc)
    (s,) = [s for s in rec.spans if s.name == "tid.fn.backward"]
    assert s.closed and s.attrs == {"rows": 2} and s.parent == rec.spans[0].id


def test_trace_writes_the_spans_into_both_files(tmp_path, runs):
    attack = runs["attack"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "MIN_CHUNKED_SEQ", 64)
        mp.setattr(layers, "KERNEL_HEAD_DIMS", (32,))
        with torch.enable_grad(), profiling.trace(tmp_path / "t"):
            x, _ = attack.run()
    assert torch.equal(x, runs["x_on"])
    rec = profiling.last_recording()
    rows = [json.loads(line) for line in (tmp_path / "t" / "spans.jsonl").read_text().splitlines()]
    assert [r["name"] for r in rows] == [s.name for s in rec.spans]
    assert all(r["closed"] and r["host_ms"] is not None for r in rows)
    assert rows[0]["name"] == profiling.ITERATION and rows[0]["attrs"]["iteration"] == 0
    chrome = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    ranges = Counter(e["name"] for e in chrome if e.get("name", "").startswith("tid."))
    assert ranges == Counter(s.name for s in rec.spans)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    with torch.enable_grad():
        attack = Attack("cuda")
        attack.run()                                    # builds the kernels, warms every shape
    torch.cuda.synchronize()
    return attack


def _all_kernels():
    from tml_image_editing_defense_torch.ops import flash_attention, group_norm, pgd_kernels

    return flash_attention.KERNELS + pgd_kernels.KERNELS + group_norm.KERNELS


@pytest.mark.chip
def test_launch_counts_in_the_spans_are_the_kernels_own(card):
    before = {k.symbol: k.launches for k in _all_kernels()}
    with torch.enable_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        card.run()
    rec = profiling.last_recording()
    delta = {k.symbol: k.launches - before[k.symbol] for k in _all_kernels()}
    in_spans = Counter()
    for s in rec.spans:
        in_spans.update({n: c for n, c in s.counts.items() if n.startswith("launches.")})
    assert delta["tid_pgd_l2_update"] == ITERS
    assert dict(in_spans) == {f"launches.{k}": n for k, n in delta.items() if n}
    assert {n: c for n, c in rec.totals.items() if n.startswith("launches.")} == dict(in_spans)
    for s in rec.spans:
        if s.counts.get("launches.tid_pgd_l2_update"):
            assert s.name == "tid.pgd.update"


def _thread_ids():
    """The ids this thread may carry in the profiler's runtime events: the
    OS thread id, or ``pthread_self()`` whole or cut to 32 signed bits."""
    ident = threading.get_ident()
    low = ident & 0xFFFFFFFF
    return {threading.get_native_id(), ident, low, low - (1 << 32) if low >= 1 << 31 else low}


def _inside(a0, a1, spans_):
    """The part of [a0, a1] inside the union of ``spans_`` ([(s, e)], sorted)."""
    return sum(max(0, min(a1, e) - max(a0, s)) for s, e in spans_)


def _profiler_drift_ns(delays, window_ns=50_000_000):
    """How far the profiler's device timestamps wander against its own host
    timestamps: ``delays`` are (launch time, kernel start - launch time);
    the least delay of each 50 ms window is the launch latency where the
    conversion holds, and its spread over the windows is the wander."""
    least = {}
    for t, d in delays:
        w = t // window_ns
        least[w] = min(least.get(w, d), d)
    return max(least.values()) - min(least.values()) if least else 0


@pytest.mark.chip
def test_spans_sit_on_the_profilers_clock(card):
    """The spans' host times hold this thread's launch calls; their device
    times never precede the host's enqueue; and the kernels the profiler
    saw lie inside them, allowing for the profiler's own wander (its device
    timestamps drifted by up to 32 ms from its host ones in traced runs of
    SD-1.5, PERF.md)."""
    from torch.profiler import ProfilerActivity, profile

    me = _thread_ids()
    with torch.enable_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        card.run()
    rec = profiling.last_recording()
    kernels, launch_at, ids = {}, {}, Counter()
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                kernels[e.correlation_id()] = (e.start_ns(), e.end_ns(), e.name())
        elif "Launch" in e.name():
            ids[e.device_resource_id()] += 1
            if e.device_resource_id() in me:
                launch_at[e.correlation_id()] = e.start_ns()
    assert launch_at, f"no launch event on this thread {me}; threads seen {dict(ids)}"
    # the host clock: launches inside the iterations, K4's inside the updates
    host = sorted((s.host_start_ns, s.host_end_ns) for s in rec.iterations())
    hosted = sum(any(a <= t <= b for a, b in host) for t in launch_at.values())
    assert hosted >= 0.99 * len(launch_at), (hosted, len(launch_at))
    k4 = {c: k for c, k in kernels.items() if "pgd_l2" in k[2]}
    updates = [s for s in rec.spans if s.name == "tid.pgd.update"]
    assert len(updates) == ITERS and k4 and set(k4) <= set(launch_at)
    for c in k4:
        assert any(u.host_start_ns <= launch_at[c] <= u.host_end_ns for u in updates)
    # the device times: after their enqueue, and around the profiler's kernels
    assert min(s.device_start_ns - s.host_start_ns for s in rec.spans) > -CLOCK_SLACK_NS
    assert min(s.lead_ms for s in rec.spans) > -CLOCK_SLACK_NS / 1e6
    drift = _profiler_drift_ns([(launch_at[c], kernels[c][0] - launch_at[c])
                                for c in kernels if c in launch_at])
    slack = CLOCK_SLACK_NS + drift
    margins = []
    for s, e, _ in k4.values():
        u = min(updates, key=lambda u: abs(u.device_start_ns - s))
        margins.append((s - u.device_start_ns, u.device_end_ns - e))
        assert u.device_start_ns - slack <= s and e <= u.device_end_ns + slack, margins
    iters = sorted((s.device_start_ns - slack, s.device_end_ns + slack) for s in rec.iterations())
    busy = sum(e - s for s, e, _ in kernels.values())
    inside = sum(_inside(s, e, iters) for s, e, _ in kernels.values())
    assert inside >= 0.99 * busy, (inside, busy)
    print(f"[clock] K4 start after the update span's start, update end after K4's end (ns): "
          f"{margins}; the profiler's wander {drift} ns; kernel time inside iterations "
          f"{inside / busy:.6f}; launches on this thread inside iterations "
          f"{hosted}/{len(launch_at)}; least lead ms {min(s.lead_ms for s in rec.spans):.3f}; "
          f"event timer against the host clock {(rec.clock_rate - 1) * 1e6:.2f} ppm")
