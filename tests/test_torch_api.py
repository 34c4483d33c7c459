"""``immunize`` of the port end to end on the CPU, on the tiny family: the
artifacts (PNG, a ``noise.npz`` the JAX package reads back, one finite
``metrics.jsonl`` row per iteration, ``attack_state.npz``), the eps-ball,
and the refusals of what later slices bring (real weights:
tests/test_torch_real_weights.py)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from PIL import Image

from tml_image_editing_defense_tpu.core.rng import load_noise_pool as j_load_noise_pool

from tml_image_editing_defense_torch import api
from tml_image_editing_defense_torch.configs import InferenceConfig, TrainConfig
from tml_image_editing_defense_torch.core.image_ops import load_image
from test_torch_models import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _images(tmp_path, size=40):
    rng = np.random.default_rng(0)
    paths = []
    for name in ("source.png", "target.png"):
        arr = rng.integers(0, 256, (size, size + 8, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / name)
        paths.append(tmp_path / name)
    return paths


def _cfg(tmp_path, **kw):
    src, tgt = _images(tmp_path)
    base = dict(source_image_path=src, target_image_path=tgt, output_path=tmp_path / "out",
                model_family="tiny", image_size=32, n_optimization_steps=3,
                derive_norm_hyperparams=False, eps=2.0, step_size=1.0, grad_reps=2,
                image_visualization_interval=2, prompts=["a", "b", "c"])
    base.update(kw)
    return TrainConfig(**base)


def test_immunize_tiny_on_cpu_writes_the_artifacts(tmp_path, monkeypatch):
    from tml_image_editing_defense_torch.ops import pgd_kernels

    seen = []
    plain = pgd_kernels.l2_perturbation_step

    def contiguous_only(*args, **kw):       # what the CUDA kernel takes on the card
        seen.append(all(t.is_contiguous() for t in args[:3]))
        return plain(*args, **kw)

    monkeypatch.setattr(pgd_kernels, "l2_perturbation_step", contiguous_only)
    cfg = _cfg(tmp_path)
    result = api.immunize(cfg, device="cpu")
    assert seen == [True] * cfg.n_optimization_steps
    out = cfg.output_path

    png = Image.open(out / "adversarial_image.png")
    assert png.size == (32, 32) and png.mode == "RGB"
    src = torch.from_numpy(load_image(cfg.source_image_path, 32))
    assert result.x_adv.shape == src.shape
    assert float(torch.linalg.vector_norm(result.x_adv - src)) <= cfg.eps + 1e-4
    assert result.x_adv.min() >= -1 and result.x_adv.max() <= 1

    pool = j_load_noise_pool(out / "noise.npz")          # the JAX package reads it
    assert pool.shape == (1, 1, 16, 16, 4)
    np.testing.assert_array_equal(np.asarray(pool),
                                  result.noise_pool.numpy().transpose(0, 1, 3, 4, 2))

    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert sorted(r["step"] for r in rows) == [0, 1, 2]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in ("avg_loss", "rec_loss", "pert_loss"))
    assert [h["avg_loss"] for h in result.history] == [
        r["avg_loss"] for r in sorted(rows, key=lambda r: r["step"])]


def test_immunize_is_deterministic_from_the_seed(tmp_path):
    runs = []
    for sub in ("a", "b"):
        (tmp_path / sub).mkdir()
        cfg = _cfg(tmp_path / sub, n_optimization_steps=2, enable_visualization=False)
        runs.append(api.immunize(cfg, device="cpu"))
    a, b = runs
    assert torch.equal(a.x_adv, b.x_adv)
    assert a.history == b.history


def test_immunize_draws_the_same_with_a_passed_model(tmp_path):
    """The set-up draws have a stream of their own: a run handed the model
    that another run built ends on that run's iterate (resuming on a passed
    model relies on it)."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    built = api.immunize(_cfg(tmp_path / "a", n_optimization_steps=1), device="cpu")
    handed = api.immunize(_cfg(tmp_path / "b", n_optimization_steps=1), device="cpu",
                          model=built.model)
    assert torch.equal(built.x_adv, handed.x_adv)
    assert torch.equal(built.noise_pool, handed.noise_pool)


def test_fresh_noise_run_keeps_no_pool(tmp_path):
    """use_fixed_noise=False draws a fresh init noise per rep (pgd.py:229-232)
    and, as the reference, writes no noise.npz."""
    cfg = _cfg(tmp_path, use_fixed_noise=False, n_optimization_steps=1)
    result = api.immunize(cfg, device="cpu")
    assert result.noise_pool is None
    assert not (cfg.output_path / "noise.npz").exists()
    assert np.isfinite(result.history[0]["avg_loss"])


def test_immunize_without_a_device_raises_where_cuda_is_absent(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only machine's error")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.immunize(_cfg(tmp_path))


def test_evaluate_without_a_device_raises_where_cuda_is_absent(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only machine's error")
    src, _ = _images(tmp_path)
    cfg = InferenceConfig(source_image_path=src, target_image_path=src, model_family="tiny",
                          image_size=32, output_path=tmp_path / "eval")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.evaluate(cfg, Image.open(src))


@pytest.mark.parametrize("kw", [
    {"eval_shards": 2},
])
def test_evaluate_later_slices_raise_not_implemented(tmp_path, kw):
    """``eval_shards=2`` needs two ranks; without a process group the world
    is one rank, and ``evaluate`` raises ``ValueError`` before it builds a
    model, as JAX api.py:659-663 does past the local device count (the
    cells over ranks: tests/test_torch_parallel.py)."""
    src, _ = _images(tmp_path)
    cfg = InferenceConfig(source_image_path=src, target_image_path=src, model_family="tiny",
                          image_size=32, output_path=tmp_path / "eval", **kw)
    with pytest.raises(ValueError, match="eval_shards=2 exceeds local device count 1"):
        api.evaluate(cfg, Image.open(src), device="cpu")


def test_resume_raises_not_implemented(tmp_path):
    """Resuming works (tests/test_torch_checkpoint.py), but not from a state
    the JAX package wrote: its threefry key cannot drive the port's
    per-iteration generators, so that state is refused."""
    import jax
    import jax.numpy as jnp

    from tml_image_editing_defense_tpu.utils.checkpoint import save_attack_state

    state = tmp_path / "state.npz"
    save_attack_state(state, jnp.zeros((1, 32, 32, 3)), 1, jax.random.key(0))
    with pytest.raises(ValueError, match="seed"):
        api.immunize(_cfg(tmp_path), device="cpu", resume_from=state)


def test_checkpoint_interval_writes_the_attack_state(tmp_path):
    """``checkpoint_interval`` works: after iteration 2 of 3 the state says 3."""
    from tml_image_editing_defense_torch.utils.checkpoint import load_attack_state

    cfg = _cfg(tmp_path, checkpoint_interval=2, enable_visualization=False)
    result = api.immunize(cfg, device="cpu")
    x, it, seed, pool = load_attack_state(cfg.output_path / "attack_state.npz")
    assert (it, seed) == (3, cfg.seed)
    assert torch.equal(x, result.x_adv) and torch.equal(pool, result.noise_pool)
