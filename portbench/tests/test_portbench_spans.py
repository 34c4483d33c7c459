"""The readers of the program's spans (``source: program_span``) on a
hand-built recording, with none, and on a traced run of the tiny cell."""

from types import SimpleNamespace

import pytest

from portbench import cells, spans
from tml_image_editing_defense_torch.utils import profiling

READERS = ("host_issue_ms_per_iter", "queue_lead_ms", "unet_ms_per_iter", "vae_ms_per_iter",
           "attn_span_ms_per_iter")
DEVICE_READERS = READERS[1:]


def _span(i, name, parent=None, it=0, host=None, device=None, lead=None, **attrs):
    return SimpleNamespace(id=i, name=name, parent=parent, iteration=it, attrs=attrs,
                           host_ms=host, device_ms=device, lead_ms=lead)


def _recording():
    """Two iterations; in each one UNet call with a flash and a plain
    attention, its backward with the flash backward, an encode, a decode
    and their backwards.  Iteration 1's UNet backward holds a forward
    recomputed inside it, which is counted once."""
    out = []
    for it, base in ((0, 0), (1, 100)):
        b = base
        out += [
            _span(b, spans.ITERATION, None, it, host=2800.0 + it * 100, device=2600.0, lead=1.0),
            _span(b + 1, "tid.vae.encode", b, it, device=30.0, lead=2.0),
            _span(b + 2, "tid.attention", b + 1, it, device=1.0, lead=3.0, route="flash"),
            _span(b + 3, "tid.eot.forward", b, it, device=500.0, lead=4.0),
            _span(b + 4, "tid.unet", b + 3, it, device=200.0, lead=5.0),
            _span(b + 5, "tid.attention", b + 4, it, device=10.0, lead=6.0, route="flash"),
            _span(b + 6, "tid.attention", b + 4, it, device=7.0, lead=7.0, route="plain"),
            _span(b + 7, "tid.vae.decode", b + 3, it, device=40.0, lead=8.0),
            _span(b + 8, "tid.eot.backward", b, it, device=900.0, lead=9.0),
            _span(b + 9, "tid.vae.decode.backward", b + 8, it, device=80.0, lead=10.0),
            _span(b + 10, "tid.unet.backward", b + 8, it, device=400.0, lead=11.0),
            _span(b + 11, "tid.attention.backward", b + 10, it, device=20.0, lead=12.0,
                  route="flash"),
            _span(b + 12, "tid.vae.encode.backward", b, it, device=60.0, lead=13.0),
        ]
    # iteration 1: a UNet forward recomputed inside the UNet's backward
    out.append(_span(113, "tid.unet", 110, 1, device=150.0, lead=14.0))
    return SimpleNamespace(spans=out)


TRACE = SimpleNamespace(steps=2)


def _read(name, trace=TRACE):
    return cells.reader("metrics", name).read(trace)


def test_readers_on_a_hand_built_recording(monkeypatch):
    rec = _recording()
    monkeypatch.setattr(profiling, "last_recording", lambda: rec)
    assert _read("host_issue_ms_per_iter") == pytest.approx(2850.0)
    leads = sorted(s.lead_ms for s in rec.spans)            # 27: the 14th is the median
    assert len(leads) == 27 and _read("queue_lead_ms") == leads[13]
    assert _read("unet_ms_per_iter") == pytest.approx((200 + 400) * 2 / 2)
    assert _read("vae_ms_per_iter") == pytest.approx((30 + 40 + 80 + 60) * 2 / 2)
    assert _read("attn_span_ms_per_iter") == pytest.approx((1 + 10 + 20) * 2 / 2)


@pytest.mark.parametrize("name", READERS)
def test_no_recording_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(profiling, "last_recording", lambda: None)
    assert _read(name) is None
    monkeypatch.delattr(profiling, "last_recording")        # a program without the recorder
    assert _read(name) is None


@pytest.mark.parametrize("name", DEVICE_READERS)
def test_device_readers_need_device_times(monkeypatch, name):
    rec = _recording()
    for s in rec.spans:
        s.device_ms = s.lead_ms = None                          # recorded on the CPU
    monkeypatch.setattr(profiling, "last_recording", lambda: rec)
    assert _read(name) is None
    assert _read("host_issue_ms_per_iter") == pytest.approx(2850.0)


@pytest.mark.parametrize("name", READERS)
def test_iterations_must_be_the_traced_ones(monkeypatch, name):
    rec = _recording()
    monkeypatch.setattr(profiling, "last_recording", lambda: rec)
    with pytest.raises(ValueError, match="traced run 3 iterations"):
        _read(name, SimpleNamespace(steps=3))


def test_traced_tiny_run_reads_the_programs_recording(tiny_cell, tiny_root):
    from portbench import run

    out = run.run_cell(tiny_cell, 2**31 + 91, 1.0, True, device="cpu", root=tiny_root)
    rec = profiling.last_recording()
    assert out["correct"] and not rec.is_open
    assert len(rec.iterations()) == tiny_cell.traffic["trace_steps"]
    assert all(s.closed and s.iteration is not None for s in rec.spans)
    assert out["metrics"]["host_issue_ms_per_iter"]["value"] > 0
    # no card: no device times, no device metric
    assert not set(DEVICE_READERS) & set(out["metrics"])
