"""The port's MetricsLogger: a failed wandb sink pins none of the caller's
objects.  wandb is optional; a stand-in module behaves as wandb does on a
machine without an API key: ``init`` raises, and the exception is kept."""

from __future__ import annotations

import gc
import sys
import types
import weakref

import pytest

from tml_image_editing_defense_torch.utils.logging import MetricsLogger


class _Payload:
    """Stands for the model a caller of ``immunize`` holds."""


@pytest.fixture
def failing_wandb(monkeypatch):
    kept = []

    def init(**kwargs):
        try:
            raise RuntimeError("No API key configured")
        except RuntimeError as e:
            kept.append(e)                     # as wandb keeps a failed init's error
            raise

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    return kept


def test_failed_wandb_init_keeps_no_caller_alive(tmp_path, failing_wandb, capsys):
    def caller():
        payload = _Payload()
        logger = MetricsLogger(name="run", output_dir=tmp_path, verbose=False)
        logger.log({"avg_loss": 1.0}, step=0)
        logger.finish()
        return weakref.ref(payload)

    ref = caller()
    gc.collect()
    assert len(failing_wandb) == 1 and "wandb sink disabled" in capsys.readouterr().out
    assert ref() is None
    assert (tmp_path / "metrics.jsonl").read_text().count('"step": 0') == 1
