"""The port's CLI on the CPU (``--device cpu``), as tests/test_cli.py drives
the JAX package's: flags made from the configs, ``immunize`` then
``evaluate`` on its artifacts (the port's own ``noise.npz``), the inpaint
route, a resume from ``--resume-from``, ``immunize-batch`` and ``sweep``."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from PIL import Image

from test_torch_models import one_torch_thread  # noqa: F401

from tml_image_editing_defense_torch import cli
from tml_image_editing_defense_torch.configs import InferenceConfig, SweepConfig, TrainConfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_FAST_FLAGS = [
    "--model-family", "tiny",
    "--image-size", "32",
    "--n-optimization-steps", "2",
    "--n-denoising-steps-per-iteration", "2",
    "--grad-reps", "2",
    "--limit-timesteps", "false",
    "--derive-norm-hyperparams", "false",
    "--norm-type", "linf",
    "--eps", "0.1",
    "--step-size", "0.02",
    "--apply-loss-on-images", "false",
    "--apply-loss-on-latents", "true",
    "--perturbation-loss-lambda", "0",
    "--enable-visualization", "false",
    "--device", "cpu",
]


def _write_img(path, seed=0, size=(64, 48)):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.uniform(0, 255, (size[1], size[0], 3)).astype(np.uint8)).save(path)
    return path


def test_cli_immunize_then_evaluate(tmp_path):
    src = _write_img(tmp_path / "src.jpg", 0)
    tgt = _write_img(tmp_path / "tgt.jpg", 1)
    out = tmp_path / "out"
    rc = cli.main(["immunize", "--source-image-path", str(src), "--target-image-path", str(tgt),
                   "--output-path", str(out), "--prompts", "a", "b", *_FAST_FLAGS])
    assert rc == 0
    assert (out / "adversarial_image.png").exists() and (out / "noise.npz").exists()

    eval_out = tmp_path / "eval"
    rc = cli.main([
        "evaluate",
        "--adversarial-image", str(out / "adversarial_image.png"),
        "--noise-pool", str(out / "noise.npz"),
        "--source-image-path", str(src),
        "--target-image-path", str(tgt),
        "--output-path", str(eval_out),
        "--model-family", "tiny",
        "--image-size", "32",
        "--n-steps", "2",
        "--n-noise", "1",
        "--use-lcm", "true",
        "--prompts", "a",
        "--validation-images-path", str(tmp_path / "no_such_list.txt"),
        "--device", "cpu",
    ])
    assert rc == 0
    assert sorted(p.name for p in eval_out.glob("*.png")) == ["a,-detailed_noise_0.png"]


def test_cli_immunize_inpaint_route(tmp_path):
    src = _write_img(tmp_path / "src.jpg", 2)
    out = tmp_path / "out_inpaint"
    rc = cli.main([
        "immunize", "--source-image-path", str(src), "--target-image-path", str(src),
        "--output-path", str(out), "--prompts", "a", "b", "--attack-mode", "inpaint",
        "--model-family", "tiny-inpaint", "--image-size", "32", "--n-optimization-steps", "2",
        "--n-denoising-steps-per-iteration", "2", "--grad-reps", "2",
        "--derive-norm-hyperparams", "false", "--norm-type", "l2", "--eps", "4.0",
        "--step-size", "1.0", "--apply-loss-on-images", "false",
        "--apply-loss-on-latents", "true", "--perturbation-loss-lambda", "0",
        "--enable-visualization", "false", "--device", "cpu",
    ])
    assert rc == 0
    assert (out / "adversarial_image.png").exists()


def test_cli_resume_from_a_checkpoint(tmp_path):
    """``--checkpoint-interval 1`` then ``--resume-from``: the resumed run
    writes the iterations after the saved one only."""
    src = _write_img(tmp_path / "src.jpg", 3)
    common = ["--source-image-path", str(src), "--target-image-path", str(src), *_FAST_FLAGS]
    assert cli.main(["immunize", "--output-path", str(tmp_path / "a"),
                     "--checkpoint-interval", "1", *common]) == 0
    state = tmp_path / "a" / "attack_state.npz"
    assert state.exists()
    assert cli.main(["immunize", "--output-path", str(tmp_path / "b"), "--resume-from", str(state),
                     *common, "--n-optimization-steps", "3"]) == 0
    rows = (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 1 and '"step": 2' in rows[0]


@pytest.mark.parametrize("cls", [TrainConfig, InferenceConfig, SweepConfig])
def test_cli_flag_generation_and_bool_parsing(cls):
    """Every config field but ``prompts`` is a flag; BOOL flags take
    true/false/1/0; Optional[int] fields parse as int."""
    p = cli.argparse.ArgumentParser()
    cli._add_dataclass_args(p, cls)
    args = p.parse_args(["--use-lcm", "0", "--use-sdxl", "TRUE", "--seed", "7"]
                        + (["--eval-shards", "1"] if cls is InferenceConfig else []))
    assert args.use_lcm is False and args.use_sdxl is True and args.seed == 7
    if cls is InferenceConfig:
        assert args.eval_shards == 1
    for f in dataclasses.fields(cls):
        if f.name not in cli._SKIP_FIELDS:
            assert hasattr(args, f.name), f"flag missing for {cls.__name__}.{f.name}"


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    """Without --device the CLI asks for CUDA."""
    from tml_image_editing_defense_torch import api

    seen = {}
    monkeypatch.setattr(api, "immunize", lambda cfg, device, resume_from: seen.update(d=device))
    assert cli.main(["immunize", "--output-path", str(tmp_path)]) == 0
    assert seen["d"] == "cuda"


def test_cli_immunize_batch(tmp_path):
    """Each image's artifacts in <output-path>/<stem>, one metrics file."""
    imgs = [_write_img(tmp_path / f"im{i}.png", 10 + i) for i in range(2)]
    out = tmp_path / "batch"
    rc = cli.main(["immunize-batch", "--images", *map(str, imgs), "--output-path", str(out),
                   "--prompts", "a", "b", *_FAST_FLAGS])
    assert rc == 0
    for img in imgs:
        assert sorted(p.name for p in (out / img.stem).iterdir()) == ["adversarial_image.png",
                                                                      "noise.npz"]
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 2


def test_cli_sweep_on_the_tiny_family(tmp_path):
    """One image, grid 1 x 1, one iteration, evaluated at the SweepConfig
    defaults on the tiny family at 32x32."""
    images = tmp_path / "images"
    images.mkdir()
    _write_img(images / "im0.png", 20)
    rc = cli.main(["sweep", "--images-dir", str(images), "--output-root", str(tmp_path / "out"),
                   "--n-prompts-grid", "1", "--n-noises-grid", "1", "--n-optimization-steps", "1",
                   "--seed", "0", "--model-family", "tiny", "--image-size", "32",
                   "--device", "cpu"])
    assert rc == 0
    cell = tmp_path / "out" / "im0" / "n_noises_1" / "n_prompts_1"
    assert (cell / "adversarial_image.png").exists() and (cell / "noise.npz").exists()
    assert len(list(cell.glob("*_noise_0.png"))) > 0


def test_cli_sweep_grid_parsing(tmp_path, monkeypatch):
    """"all" and "none" in a grid are None; the cells' model flags reach
    train_overrides only when given."""
    from tml_image_editing_defense_torch import api

    seen = {}
    monkeypatch.setattr(api, "sweep", lambda cfg, device, train_overrides: seen.update(
        cfg=cfg, device=device, overrides=train_overrides) or [])
    assert cli.main(["sweep", "--n-prompts-grid", "1", "10", "all", "--n-noises-grid", "3",
                     "none", "None"]) == 0
    assert seen["cfg"].n_prompts_grid == (1, 10, None)
    assert seen["cfg"].n_noises_grid == (3, None, None)
    assert seen["device"] == "cuda" and seen["overrides"] is None
    assert cli.main(["sweep", "--image-size", "64"]) == 0
    assert seen["cfg"].n_prompts_grid == SweepConfig().n_prompts_grid
    assert seen["overrides"] == {"image_size": 64}
