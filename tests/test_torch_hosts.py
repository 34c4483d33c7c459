"""The port's machine tier (``parallel/hosts.py``, ``launch_host.py``):
the host-sharding helpers against the JAX package's, and the launcher's
local mode, which spawns 2 "machines" of 1 rank each on gloo, against one
machine's sweep of the whole list (JAX tests/test_hosts.py:21-50, :178).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from PIL import Image

from tml_image_editing_defense_tpu.parallel import hosts as jhosts

from tml_image_editing_defense_torch import api, launch_host
from tml_image_editing_defense_torch.configs import SweepConfig
from tml_image_editing_defense_torch.parallel import hosts

#: a tiny sweep: one grid point, two iterations, no evaluation (the training
#: artifacts are what the machines split)
TRAIN_OVERRIDES = dict(model_family="tiny", image_size=32, n_denoising_steps_per_iteration=2,
                       limit_timesteps=False, derive_norm_hyperparams=False, grad_reps=1,
                       apply_loss_on_latents=True, apply_loss_on_images=False,
                       perturbation_loss_lambda=0.0, enable_visualization=False, eps=2.0,
                       step_size=1.0, norm_type="l2")
SWEEP_FIELDS = dict(n_prompts_grid=[1], n_noises_grid=[1], n_optimization_steps=2, seed=3,
                    run_inference=False)


@pytest.mark.parametrize("n", [0, 1, 5, 11])
def test_shard_for_host_equals_jax(n):
    items = [f"im{i}" for i in range(n)]
    for count in (1, 2, 3, 4, 8, 13):
        shards = [hosts.shard_for_host(items, h, count) for h in range(count)]
        assert shards == [jhosts.shard_for_host(items, h, count) for h in range(count)]
        assert sorted(x for s in shards for x in s) == sorted(items)


@pytest.mark.parametrize("index,count", [(0, 0), (2, 2), (-1, 2)])
def test_shard_for_host_refuses_as_jax(index, count):
    with pytest.raises(ValueError) as want:
        jhosts.shard_for_host([1], index, count)
    with pytest.raises(ValueError) as got:
        hosts.shard_for_host([1], index, count)
    assert str(got.value) == str(want.value)


def test_describe_host_shards_equals_jax(tmp_path):
    for name in ("b.png", "a.jpg", "c.jpeg", "skip.txt", "d.gif", "e.png"):
        (tmp_path / name).write_bytes(b"x")
    assert hosts.list_sweep_images(tmp_path) == jhosts.list_sweep_images(tmp_path)
    for count in (1, 3, 6):
        assert hosts.describe_host_shards(tmp_path, count) == jhosts.describe_host_shards(
            tmp_path, count)


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_local_launcher_matches_one_machine_sweep(tmp_path, capfd, one_torch_thread):
    """``launch_host --local 2`` (2 machines x 1 rank, gloo on the CPU): the
    machines take im0, im2 and im1, and their artifacts are those of one
    machine sweeping all three cell after cell: ``noise.npz`` byte for
    byte, the PNGs within one uint8 level (a machine batches its two cells
    through ``immunize_batch``)."""
    images = tmp_path / "imgs"
    images.mkdir()
    rng = np.random.default_rng(21)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
            images / f"im{i}.png")
    config = tmp_path / "sweep.json"
    config.write_text(json.dumps({"sweep": SWEEP_FIELDS, "train_overrides": TRAIN_OVERRIDES}))
    launch_host.main([str(images), str(tmp_path / "multi"), "--local", "2", "--backend", "gloo",
                      "--device", "cpu", "--config-json", str(config)])
    out = capfd.readouterr().out
    assert "HOST_SWEEP_DONE node=0/2 images=['im0.png', 'im2.png']" in out
    assert "HOST_SWEEP_DONE node=1/2 images=['im1.png']" in out

    cfg = SweepConfig(images_dir=images, output_root=tmp_path / "single",
                      **{k: tuple(v) if isinstance(v, list) else v
                         for k, v in SWEEP_FIELDS.items()})
    api.sweep(cfg, device="cpu", data_parallel=False, train_overrides=TRAIN_OVERRIDES)
    singles = sorted(p.relative_to(tmp_path / "single")
                     for p in (tmp_path / "single").rglob("adversarial_image.png"))
    assert len(singles) == 3
    for rel in singles:
        a, b = (tmp_path / root / rel.parent for root in ("single", "multi"))
        assert (a / "noise.npz").read_bytes() == (b / "noise.npz").read_bytes()
        pa, pb = (np.asarray(Image.open(d / "adversarial_image.png"), np.int16) for d in (a, b))
        assert np.abs(pa - pb).max() <= 1
