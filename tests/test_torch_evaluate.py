"""The port's ``evaluate`` and ``transfer_perturbation`` on the CPU, against
the JAX package's: the file names of the grids (JAX api.py:734-736,
761-763), the ``noise.npz`` that the JAX ``immunize`` writes, batched edits
equal to sequential ones, and the sigma-ratio transfer bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import one_torch_thread  # noqa: F401
from tml_image_editing_defense_tpu.api import transfer_perturbation as j_transfer_perturbation

from tml_image_editing_defense_torch import api
from tml_image_editing_defense_torch.configs import InferenceConfig
from tml_image_editing_defense_torch.core.image_ops import resize_crop_pil
from tml_image_editing_defense_torch.core.rng import load_noise_pool
from tml_image_editing_defense_torch.models.model_zoo import build_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _image(path, seed, size=(48, 40)):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(path)
    return path


@pytest.mark.parametrize("seed", range(4))
def test_transfer_perturbation_is_bit_equal_to_jax(seed):
    """Random uint8 images (as f32, as evaluate passes them) and a random
    perturbation; the validation image's sigma above and below the
    source's, so the ratio clips at 1 and does not."""
    rng = np.random.default_rng(seed)
    spread = (40, 200)[seed % 2]
    src = rng.integers(0, 256, (16, 24, 3)).astype(np.float32)
    new = np.clip(rng.normal(128, spread, (16, 24, 3)), 0, 255).astype(np.uint8).astype(np.float32)
    pert = rng.normal(0, 15, (16, 24, 3)).astype(np.float32)
    got = api.transfer_perturbation(pert, src, new)
    want = j_transfer_perturbation(pert, src, new)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.fixture(scope="module")
def tiny():
    return build_model("tiny", image_size=32, device="cpu",
                       generator=torch.Generator().manual_seed(0))


def test_evaluate_writes_the_jax_file_names(tmp_path, tiny):
    """Grids for each (prompt x noise) on the source image and on each
    validation image, named as the JAX evaluate names them: the formatted
    prompt (caption prefix, ", detailed") cut at 30 characters, its words
    joined by '-'.  Batched edits (padded to eval_batch_size) give the
    sequential edits' images."""
    src, tgt, val = (_image(tmp_path / f"{n}.png", i) for i, n in enumerate(("s", "t", "v")))
    (tmp_path / "val.txt").write_text(f"{val}\n")
    prompts = ["gold", "in the style of a very long prompt"]
    grids = {}
    for batch in (True, False):
        cfg = InferenceConfig(source_image_path=src, target_image_path=tgt,
                              default_source_image_caption="a photo", n_steps=4, n_noise=2,
                              model_family="tiny", image_size=32,
                              output_path=tmp_path / f"out_{batch}",
                              validation_images_path=tmp_path / "val.txt")
        adv = resize_crop_pil(Image.open(src), 32)
        grids[batch] = api.evaluate(cfg, adv, prompts, model=tiny, batch_edits=batch,
                                    eval_batch_size=3)
        names = sorted(p.name for p in cfg.output_path.glob("*.png"))
        stems = ["a-photo-gold,-detailed", "a-photo-in-the-style-of-a-very"]
        want = [f"{pre}{stem}_noise_{i}.png" for pre in ("", "val_v_") for stem in stems
                for i in (0, 1)]
        assert names == sorted(want)
    assert len(grids[True]) == 4
    for a, b in zip(grids[True], grids[False]):
        diff = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
        assert diff.max() <= 1, diff.max()


def test_evaluate_reads_the_noise_of_a_jax_immunize(tmp_path, tiny):
    """The JAX ``immunize`` writes ``noise.npz`` (its api.py:371-373); the
    port reads it into its layout and ``evaluate`` edits with every entry
    (one grid per pool entry, whatever ``cfg.n_noise`` says)."""
    from tml_image_editing_defense_tpu import api as japi
    from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
    from tml_image_editing_defense_tpu.core.rng import load_noise_pool as j_load_noise_pool

    src = _image(tmp_path / "s.png", 3)
    jcfg = JTrainConfig(source_image_path=src, target_image_path=src, output_path=tmp_path / "j",
                        model_family="tiny", image_size=32, n_optimization_steps=1,
                        n_denoising_steps_per_iteration=1, grad_reps=1, limit_timesteps=False,
                        derive_norm_hyperparams=False, apply_loss_on_images=False,
                        apply_loss_on_latents=True, perturbation_loss_lambda=0, n_noise=2,
                        enable_visualization=False, prompts=["a"], use_pallas_update=False)
    japi.immunize(jcfg)
    pool = load_noise_pool(tmp_path / "j" / "noise.npz")
    want = np.asarray(j_load_noise_pool(tmp_path / "j" / "noise.npz"))
    assert pool.shape == (2, 1, 4, 16, 16)
    np.testing.assert_array_equal(pool.numpy(), want.transpose(0, 1, 4, 2, 3))
    cfg = InferenceConfig(source_image_path=src, target_image_path=src, n_steps=3,
                          model_family="tiny", image_size=32, output_path=tmp_path / "eval",
                          validation_images_path=None)
    grids = api.evaluate(cfg, Image.open(tmp_path / "j" / "adversarial_image.png"), ["gold"],
                         model=tiny, noises=pool)
    assert len(grids) == 2
    assert sorted(p.name for p in cfg.output_path.glob("*.png")) == [
        "gold,-detailed_noise_0.png", "gold,-detailed_noise_1.png"]
