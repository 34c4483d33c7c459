"""The port's grid sweep on the CPU, against the JAX package's: the cells
(``_sweep_cells``) with both packages' unseeded ``random.Random`` replaced
by one seeded generator, the image list (``list_sweep_images``), the
data-parallel route through ``immunize_batch`` against the serial one on
the tiny family (pools bit-equal, ``x_adv`` within 1e-5, PNGs within one
uint8 level: tests/test_torch_batch.py says why), and the evaluation
stage, run and skipped."""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_configs import DROPPED
from test_torch_models import one_torch_thread  # noqa: F401
from tml_image_editing_defense_tpu import api as japi
from tml_image_editing_defense_tpu.configs import SweepConfig as JSweepConfig
from tml_image_editing_defense_tpu.core.rng import load_noise_pool as j_load_noise_pool
from tml_image_editing_defense_tpu.parallel.hosts import list_sweep_images as j_list_sweep_images

from tml_image_editing_defense_torch import api
from tml_image_editing_defense_torch.configs import SweepConfig
from tml_image_editing_defense_torch.models.model_zoo import build_model
from tml_image_editing_defense_torch.parallel.hosts import list_sweep_images

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 32
#: the generator class, kept before a test replaces ``random.Random``
_SEEDED = random.Random
#: the cells' attack on the tiny family: L2, 2 reps, 2 iterations
OVERRIDES = dict(model_family="tiny", image_size=SIZE, n_denoising_steps_per_iteration=2,
                 limit_timesteps=False, derive_norm_hyperparams=False, grad_reps=2, eps=2.0,
                 step_size=1.0, enable_visualization=False)


def _write_images(d, n, seed=7):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(d / f"im{i}.png")
    return d


@pytest.fixture(scope="module")
def tiny_model():
    return build_model("tiny", image_size=SIZE, device="cpu",
                       generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("seed", [0, None])
def test_sweep_cells_match_jax(tmp_path, monkeypatch, seed):
    """Grid (1, 3, all) x (1, fresh): the same directories, names, prompts,
    noise settings, seeds and overrides, cell for cell, when both draw from
    one seeded generator (the packages share the ``random`` module)."""
    monkeypatch.setattr(random, "Random", lambda: _SEEDED(3))
    paths = sorted(_write_images(tmp_path / "imgs", 2).glob("*.png"))
    kw = dict(images_dir=tmp_path / "imgs", output_root=tmp_path / "out",
              n_prompts_grid=(1, 3, None), n_noises_grid=(1, None), seed=seed,
              n_optimization_steps=7)
    overrides = {"model_family": "tiny", "image_size": SIZE}
    want = japi._sweep_cells(JSweepConfig(**kw), paths, overrides)
    got = api._sweep_cells(SweepConfig(**kw), paths, overrides)
    assert len(got) == len(want) == 2 * 3 * 2
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("image", "n_prompts", "prompts", "n_noises", "seed", "dir")} == \
            {k: w[k] for k in ("image", "n_prompts", "prompts", "n_noises", "seed", "dir")}
        jcfg = {k: v for k, v in w["train_cfg"].asdict().items() if k not in DROPPED}
        assert g["train_cfg"].asdict() == jcfg
    assert got[2]["prompts"] == got[3]["prompts"] and len(got[2]["prompts"]) == 3
    assert got[2]["prompts"][0] == "" and got[4]["prompts"] == got[5]["prompts"]
    assert {c["train_cfg"].use_fixed_noise for c in got if c["n_noises"] is None} == {False}
    if seed is None:
        assert len({c["seed"] for c in got}) == len(got)


def test_list_sweep_images_matches_jax(tmp_path):
    for name in ("b.png", "a.jpg", "c.jpeg", "d.txt", "e.PNG", "f.gif", "g.png"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "sub.png").mkdir()
    assert list_sweep_images(tmp_path) == j_list_sweep_images(tmp_path)
    assert [p.name for p in list_sweep_images(tmp_path)] == ["a.jpg", "b.png", "c.jpeg", "g.png",
                                                             "sub.png"]


def test_data_parallel_sweep_reproduces_the_serial_sweep(tmp_path, monkeypatch, tiny_model):
    """Four images at one grid point: data_parallel=True runs them as one
    batch through immunize_batch with each cell's seed, and writes the
    serial sweep's artifacts (JAX tests/test_api.py:555)."""
    monkeypatch.setattr(api, "evaluate", lambda *a, **k: [])
    imgs = _write_images(tmp_path / "imgs", 4)
    x_advs = {}
    real_immunize, real_batch = api.immunize, api.immunize_batch

    def spy_immunize(cfg, **kw):
        res = real_immunize(cfg, **kw)
        x_advs[("serial", cfg.output_path.parts[-3])] = res.x_adv
        return res

    batches = []

    def spy_batch(cfg, image_paths, **kw):
        results = real_batch(cfg, image_paths, **kw)
        batches.append(len(image_paths))
        for p, r in zip(image_paths, results):
            x_advs[("par", p.stem)] = r.x_adv
        return results

    monkeypatch.setattr(api, "immunize", spy_immunize)
    monkeypatch.setattr(api, "immunize_batch", spy_batch)

    def cfg(root):
        return SweepConfig(images_dir=imgs, output_root=root, n_prompts_grid=(1,),
                           n_noises_grid=(2,), n_optimization_steps=2, seed=3)

    serial = api.sweep(cfg(tmp_path / "serial"), device="cpu", model=tiny_model,
                       data_parallel=False, train_overrides=OVERRIDES)
    par = api.sweep(cfg(tmp_path / "par"), device="cpu", model=tiny_model, data_parallel=True,
                    train_overrides=OVERRIDES)
    assert batches == [4]
    assert [(r["image"], r["seed"]) for r in serial] == [(r["image"], r["seed"]) for r in par]
    for i in range(4):
        cell = f"im{i}/n_noises_2/n_prompts_1"
        pa = j_load_noise_pool(tmp_path / "serial" / cell / "noise.npz")
        pb = j_load_noise_pool(tmp_path / "par" / cell / "noise.npz")
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
        np.testing.assert_allclose(x_advs[("par", f"im{i}")].numpy(),
                                   x_advs[("serial", f"im{i}")].numpy(), rtol=0, atol=1e-5)
        a, b = (np.asarray(Image.open(tmp_path / side / cell / "adversarial_image.png"), np.int16)
                for side in ("serial", "par"))
        assert np.abs(a - b).max() <= 1


def test_single_cell_sweep_evaluates_into_the_cell(tmp_path, tiny_model):
    """The evaluation stage at the SweepConfig defaults (LCM, 4 steps at
    strength 0.6, the 18 INFERENCE_PROMPTS, one pinned noise) writes one
    grid per prompt into the cell (named by the first 30 characters, as
    evaluate names them), at the cell's trained geometry."""
    from tml_image_editing_defense_torch.configs import INFERENCE_PROMPTS, format_prompt

    imgs = _write_images(tmp_path / "imgs", 1)
    cfg = SweepConfig(images_dir=imgs, output_root=tmp_path / "out", n_prompts_grid=(1,),
                      n_noises_grid=(1,), n_optimization_steps=1, seed=0)
    results = api.sweep(cfg, device="cpu", model=tiny_model, train_overrides=OVERRIDES)
    cell = tmp_path / "out" / "im0" / "n_noises_1" / "n_prompts_1"
    assert results == [{"image": str(imgs / "im0.png"), "n_prompts": 1, "n_noises": 1, "seed": 0,
                        "output": str(cell)}]
    grids = sorted(cell.glob("*_noise_0.png"))
    names = {"-".join(format_prompt(p)[:30].split()) + "_noise_0.png" for p in INFERENCE_PROMPTS}
    assert len(grids) == len(INFERENCE_PROMPTS) and {g.name for g in grids} == names
    with Image.open(grids[0]) as g:
        assert g.size[0] == 5 * SIZE


def test_sweep_without_inference_reports_the_cells(tmp_path, monkeypatch, tiny_model):
    called = []
    monkeypatch.setattr(api, "evaluate", lambda *a, **k: called.append(1) or [])
    imgs = _write_images(tmp_path / "imgs", 2)
    cfg = SweepConfig(images_dir=imgs, output_root=tmp_path / "out", n_prompts_grid=(1,),
                      n_noises_grid=(None,), n_optimization_steps=1, seed=5,
                      run_inference=False)
    results = api.sweep(cfg, device="cpu", model=tiny_model, train_overrides=OVERRIDES)
    assert called == []
    assert [r["n_noises"] for r in results] == [None, None]
    for r in results:
        out = tmp_path / "out" / f"{r['image'].split('/')[-1][:-4]}" / "n_noises_None" / "n_prompts_1"
        assert r["output"] == str(out)
        assert (out / "adversarial_image.png").exists() and not (out / "noise.npz").exists()


def test_sweep_config_knobs_reach_the_cells(tmp_path):
    """n_optimization_steps, use_lcm and use_sdxl go into every cell, the
    guidance is the reference's 3.0, and overrides apply last."""
    cfg = dataclasses.replace(SweepConfig(), n_prompts_grid=(1,), n_noises_grid=(3,),
                              n_optimization_steps=9, use_lcm=False, seed=1)
    (cell,) = api._sweep_cells(cfg, [tmp_path / "x.png"], {"guidance_scale": 5.0})
    tc = cell["train_cfg"]
    assert (tc.n_optimization_steps, tc.use_lcm, tc.use_sdxl, tc.n_noise, tc.seed) == (
        9, False, False, 3, 1)
    assert tc.guidance_scale == 5.0 and tc.use_fixed_noise
