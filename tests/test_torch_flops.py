"""The port's measurement utilities against the JAX package's:
``utils/flops.py`` (useful model FLOPs, MFU) and ``utils/profiling.py``
(trace, measure_seed, sync, StepTimer, device_memory_stats), and the attack
step's new flags on the CLI.

FLOPs: the port counts the convolutions and matrix products a forward
dispatches (``torch.utils.flop_counter.FlopCounterMode`` on a ``meta``
build with the plain attention: ``aten.convolution``, ``mm``, ``addmm``,
``bmm``), the JAX package the ``conv_general_dilated`` and ``dot_general``
of the traced jaxpr.  Both count 2 per multiply-accumulate, attention's
batched products included, and neither counts norms, softmax or
elementwise work; on the tiny families the two counts are equal, held
at 1 %.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import one_torch_thread  # noqa: F401
from tml_image_editing_defense_tpu.models import build_model as jax_build_model
from tml_image_editing_defense_tpu.models.vae import AutoencoderKL as JVAE
from tml_image_editing_defense_tpu.utils import flops as jflops
from tml_image_editing_defense_tpu.utils import profiling as jprofiling

from tml_image_editing_defense_torch import cli
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.utils import flops, profiling

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 32


@pytest.fixture(scope="module")
def counts():
    """The forward FLOPs of the tiny families, counted by both packages
    (the JAX bundles with fast random weights: a count reads shapes only)."""
    out = {}
    for family in ("tiny", "tiny-sdxl", "tiny-inpaint"):
        jm = jax_build_model(family, key=jax.random.key(0), image_size=SIZE, fast_init=True)
        ucfg = jm.unet.config
        kw = {}
        if ucfg.addition_embed_type == "text_time":
            pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
            kw = dict(text_embeds=jnp.zeros((2, pooled)), time_ids=jnp.zeros((2, 6)))
        sample = jnp.zeros((2, SIZE // 2, SIZE // 2, ucfg.in_channels))
        ctx = jnp.zeros((2, 16, ucfg.cross_attention_dim))
        want = {
            "unet": jflops.count_fn_flops(
                lambda s, c: jm.apply_unet(jm.params["unet"], s, jnp.asarray(500), c, **kw),
                sample, ctx),
            "vae_encode": jflops.count_fn_flops(
                lambda x: jm.vae.apply({"params": jm.params["vae"]}, x, method=JVAE.encode),
                jnp.zeros((1, SIZE, SIZE, 3))),
            "vae_decode": jflops.count_fn_flops(
                lambda z: jm.decode_latent(jm.params["vae"], z, scaled=False),
                jnp.zeros((1, SIZE // 2, SIZE // 2, 4))),
        }
        out[family] = (flops.diffusion_model_flops(family, SIZE), want)
    return out


@pytest.mark.parametrize("family", ["tiny", "tiny-sdxl", "tiny-inpaint"])
def test_forward_flops_match_jax(counts, family):
    """A UNet call for the CFG pair, a VAE encode and a decode: within 1 %
    of the JAX count (equal on these models)."""
    got, want = counts[family]
    assert set(got) == set(want)
    for part in want:
        assert got[part] > 0
        assert got[part] == pytest.approx(want[part], rel=1e-2), part


def test_pgd_step_model_flops_match_jax(counts):
    """One tiny PGD iteration's useful FLOPs (LCM K = 4 with t < 700: 2 UNet
    steps, 3 reps, the image loss, with and without the vis decode), and the
    backward rules, from each package's own counts."""
    got, want = counts["tiny"]
    for vis in (False, True):
        p = flops.pgd_step_model_flops(2 * got["unet"], got["vae_encode"], got["vae_decode"], 3,
                                       True, vis_decode=vis)
        j = jflops.pgd_step_model_flops(2 * want["unet"], want["vae_encode"],
                                        want["vae_decode"], 3, True, vis_decode=vis)
        assert p == pytest.approx(j, rel=1e-2)
    assert flops.training_flops(7) == jflops.training_flops(7) == 21
    assert flops.input_grad_flops(7) == jflops.input_grad_flops(7) == 14


def test_peak_and_mfu_are_unknown_on_the_cpu():
    """No peak for the CPU, so no MFU: None, as the JAX package gives for
    unknown hardware; the H100's data-sheet peaks by dtype."""
    assert flops.device_peak_flops("cpu") is None
    assert flops.mfu(1e12, 1.0, device="cpu") is None
    if not torch.cuda.is_available():
        assert flops.device_peak_flops() is None and flops.mfu(1e12, 1.0) is None
    assert flops.PEAK_FLOPS["h100"][torch.bfloat16] == 989e12
    assert flops.PEAK_FLOPS["h100"][torch.float32] == 67e12


def test_step_timer_memory_stats_and_trace_on_the_cpu(tmp_path):
    """StepTimer times by the host clock on the CPU, the first step apart;
    device_memory_stats is {} there; trace writes a Chrome trace; sync
    returns the first element; measure_seed is the JAX package's rule."""
    timer = profiling.StepTimer("cpu")
    for _ in range(3):
        with timer:
            torch.ones(64, 64) @ torch.ones(64, 64)
    summary = timer.summary()
    assert summary["n_steps"] == 2 and summary["device"] == "cpu"
    assert summary["first_s"] > 0 and summary["steady_min_s"] <= summary["steady_mean_s"]
    assert timer.last == timer.times[-1] and timer.steady_state == min(timer.times)
    assert profiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
    with profiling.trace(tmp_path / "trace") as prof:
        torch.ones(8).sum()
    assert prof is not None
    assert "traceEvents" in json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert profiling.sync(torch.tensor([[2.5, 1.0]])) == 2.5
    assert all(profiling.measure_seed(i) ^ profiling._ENTROPY
               == jprofiling.measure_seed(i) ^ jprofiling._ENTROPY for i in range(16))
    assert len({profiling.measure_seed(i) for i in range(16)}) == 16


def test_attack_step_flags_parse_into_train_config():
    """The new TrainConfig fields are CLI flags (``_add_dataclass_args``);
    ``--eot-shards`` keeps its None default unless given, as the JAX CLI."""
    parser = argparse.ArgumentParser()
    cli._add_dataclass_args(parser, TrainConfig)
    cfg = cli._build_cfg(TrainConfig, parser.parse_args(
        ["--remat-policy", "full", "--remat-vae", "true", "--eot-chunk", "2",
         "--eot-mode", "vmap"]))
    assert (cfg.remat_policy, cfg.remat_vae, cfg.eot_chunk, cfg.eot_mode) == (
        "full", True, 2, "vmap")
    assert cfg.eot_shards is None
    cfg = cli._build_cfg(TrainConfig, parser.parse_args(["--eot-shards", "2"]))
    assert cfg.eot_shards == 2 and cfg.remat_policy == "none" and cfg.remat_vae is False


def test_cli_immunize_tiny_sdxl_with_remat(tmp_path):
    """The README's CPU command for the slice's path at small size: a
    tiny-sdxl immunize with ``--remat-policy full --remat-vae true``."""
    rng = np.random.default_rng(0)
    for name in ("src", "tgt"):
        Image.fromarray(rng.uniform(0, 255, (48, 64, 3)).astype(np.uint8)).save(
            tmp_path / f"{name}.png")
    out = tmp_path / "out"
    rc = cli.main(["immunize", "--device", "cpu", "--model-family", "tiny-sdxl",
                   "--use-sdxl", "true", "--image-size", "32", "--n-optimization-steps", "2",
                   "--remat-policy", "full", "--remat-vae", "true", "--eot-chunk", "2",
                   "--source-image-path", str(tmp_path / "src.png"),
                   "--target-image-path", str(tmp_path / "tgt.png"), "--output-path", str(out),
                   "--enable-visualization", "false"])
    assert rc == 0
    rows = [json.loads(r) for r in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["avg_loss"]) for r in rows)
    assert (out / "adversarial_image.png").exists()
