"""A whole run of the tiny cell on the CPU, the look for a card skipped:
sound, then with the timed step broken underneath, and the fp8 control
(``portbench/controls.py``, which runs the same on the card)."""

import math

import pytest
import torch

from portbench import controls, readings, run

SEED = 2**31 + 77


def _run(cell, root, factory=None, trace=False):
    return run.run_cell(cell, SEED, 1.0, trace, device="cpu", root=root, step_factory=factory)


def test_sound_run_is_correct(tiny_cell, tiny_root):
    out = _run(tiny_cell, tiny_root)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= tiny_cell.traffic["images"]
    assert set(out["metrics"]) == {"image_iters_per_s", "setup_s"}      # no card: no peak
    assert list(out)[-1] == "checks"


def test_traced_run_takes_a_metric_added_as_a_file(tiny_cell, tiny_root):
    out = _run(tiny_cell, tiny_root, trace=True)
    assert out["correct"]
    assert out["metrics"]["dummy_steps"]["value"] == tiny_cell.traffic["trace_steps"]
    assert "idle_share" in out["metrics"] and out["device"]["window_s"] > 0
    assert "breakdown" in out


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_broken_step_is_not_correct(tiny_cell, tiny_root, kind):
    out = _run(tiny_cell, tiny_root, controls.KINDS[kind])
    assert not out["correct"], out["checks"]
    assert out["checks"]["update_gap"]["value"] > out["checks"]["update_gap"]["limit"]


def test_control_in_the_programs_place_is_not_correct(tiny_cell, tiny_root):
    row = controls.run_kind(tiny_cell, "fp8", SEED, 1.0, device="cpu", root=tiny_root)
    assert not row["correct"], row["checks"]
    assert all(math.isfinite(v["value"]) for v in row["checks"].values())


def test_control_is_not_correct(tiny_cell, monkeypatch, tiny_root):
    from portbench import cells

    monkeypatch.setattr(cells, "ROOT", tiny_root)
    row = readings.read_seed(tiny_cell, SEED, "cpu", control="fp8", witness="float64")
    ctl, lim = row["control"], tiny_cell.limits
    compared = [k for k in ("loss_gap", "update_gap") if k in lim]
    assert all(row[k] <= lim[k] for k in compared)
    assert any(ctl[k] > lim[k] for k in compared)
    assert all(math.isfinite(v) for v in ctl.values())
    # the second witness, the reference's networks in float64, within the limit of both
    for it, w in row["witness"].items():
        assert max(w["program"] + w["reference"]) <= lim["update_gap"], (it, w)
