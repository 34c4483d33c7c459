"""The masked immunization (``use_segmentation_mask=True``, reference
main.py:260-261, 311-322) of the port against the JAX package's, through
``immunize`` on the tiny family at 32x32.

Both packages run ``immunize`` for 2 iterations on the goldens' tiny model
(the port's twin carries its weights).  ``torch_salient_mask`` raises in
both, so with no checkpoint the mask is the heuristic one and no hub is
contacted.  The port replays the JAX draws: its noise pool, target
posterior noise and per-iteration draws are the JAX ``KeyStream`` ones
(api.py:196-265 of the JAX package; ``fold_in(loop_key, it)`` per
iteration).  x_adv must agree within 2e-4 (the goldens' tolerance) and
equal the source bit for bit outside the mask in both; the losses agree
within a relative 2e-4.  Under L-inf both ignore the mask.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import nchw, nhwc, one_torch_thread, port_model_from_jax  # noqa: F401
from test_torch_pgd import golden_jax_model, replay_draws
from tml_image_editing_defense_tpu import api as j_api
from tml_image_editing_defense_tpu.aux_models import segment as j_segment
from tml_image_editing_defense_tpu.configs import TrainConfig as JTrainConfig
from tml_image_editing_defense_tpu.core.rng import KeyStream

from tml_image_editing_defense_torch import api, cli
from tml_image_editing_defense_torch.aux_models import segment
from tml_image_editing_defense_torch.configs import TrainConfig
from tml_image_editing_defense_torch.core.image_ops import load_image, resize_crop_pil

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE, ITERATIONS = 32, 2
LAT = (1, SIZE // 2, SIZE // 2, 4)      # the tiny VAE halves the size


def _no_pipeline(*args, **kwargs):
    raise RuntimeError("the transformers pipeline is not reached in this test")


@pytest.fixture()
def offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(segment, "torch_salient_mask", _no_pipeline)
    monkeypatch.setattr(j_segment, "torch_salient_mask", _no_pipeline)


@pytest.fixture(scope="module")
def models():
    jmodel = golden_jax_model("tiny")
    return jmodel, port_model_from_jax(jmodel)


def _images(tmp_path):
    """A textured block on a smooth background (40x48), and a target."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:40, 0:48]
    src = np.stack([60 + 40 * np.sin(xx / 9.0), 80 + 30 * np.cos(yy / 7.0), 70 + 0 * xx], -1)
    src[10:30, 14:34] = rng.integers(100, 256, (20, 20, 3))
    paths = (tmp_path / "source.png", tmp_path / "target.png")
    Image.fromarray(src.astype(np.uint8)).save(paths[0])
    Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(paths[1])
    return paths


def _cfgs(tmp_path, **kw):
    src, tgt = _images(tmp_path)
    base = dict(source_image_path=src, target_image_path=tgt, image_size=SIZE,
                n_optimization_steps=ITERATIONS, derive_norm_hyperparams=False, eps=4.0,
                step_size=1.5, grad_reps=2, guidance_scale=3.0, prompts=["a", "b", "c"],
                use_segmentation_mask=True, enable_visualization=False)
    base.update(kw)
    jcfg = JTrainConfig(output_path=tmp_path / "jax", eot_shards=1, **base)
    return jcfg, TrainConfig(output_path=tmp_path / "port", model_family="tiny", **base)


def _replay_jax_draws(monkeypatch, cfg):
    """Make the port's immunize draw what the JAX immunize draws from
    ``KeyStream(cfg.seed)``: the noise pool, the target's posterior noise,
    then ``fold_in(loop_key, it)`` for iteration ``it``."""
    ks = KeyStream(cfg.seed)
    k_pool, k_target, k_loop = ks.next(), ks.next(), ks.next()
    n = max(cfg.n_noise, 1)
    # the JAX pool [n, 1, h, w, C] as the port's [n, 1, C, h, w]
    pool = nchw(jax.random.normal(k_pool, (n, *LAT))[:, 0])[:, None]
    target_eps = nchw(jax.random.normal(k_target, LAT))
    monkeypatch.setattr(api, "make_noise_pool", lambda *a, **k: pool.clone())
    make_data = api.make_attack_data
    monkeypatch.setattr(api, "make_attack_data", lambda *a, target_latent_eps=None, **k:
                        make_data(*a, target_latent_eps=target_eps, **k))
    run = api.run_pgd
    seen = {}

    def run_replayed(model, sampler, plan, cfg_, data, seed, **kw):
        its = iter(range(cfg_.n_optimization_steps))
        seen["mask"] = data.mask
        kw["draw_sampler"] = lambda gen: replay_draws(
            jax.random.fold_in(k_loop, next(its)), cfg_.grad_reps, data.bank_embeds.shape[0],
            data.noise_pool.shape[0], plan.num_steps, LAT)
        return run(model, sampler, plan, cfg_, data, seed, **kw)

    monkeypatch.setattr(api, "run_pgd", run_replayed)
    return seen


def _heuristic(cfg):
    crop = np.asarray(resize_crop_pil(Image.open(cfg.source_image_path).convert("RGB"), SIZE),
                      np.float32) / 255.0
    return segment._heuristic_saliency(crop)


def test_masked_immunize_matches_jax(tmp_path, models, offline, monkeypatch):
    jmodel, pm = models
    jcfg, cfg = _cfgs(tmp_path)
    jres = j_api.immunize(jcfg, model=jmodel)
    seen = _replay_jax_draws(monkeypatch, cfg)
    res = api.immunize(cfg, device="cpu", model=pm)

    mask = _heuristic(cfg)
    assert 0.05 < mask.mean() < 0.95
    assert seen["mask"].shape == (1, 1, SIZE, SIZE) and seen["mask"].dtype == torch.float32
    np.testing.assert_array_equal(seen["mask"][0, 0].numpy(), mask)

    src = load_image(cfg.source_image_path, SIZE)
    got, want = nhwc(res.x_adv), np.asarray(jres.x_adv)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    outside = np.broadcast_to(mask[None, :, :, None] == 0, got.shape)
    src_nhwc = src.transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got[outside], src_nhwc[outside])
    np.testing.assert_array_equal(want[outside], src_nhwc[outside])
    assert np.abs(got - src_nhwc)[~outside].max() > 1e-3
    assert res.mask_route == "heuristic"
    assert len(res.history) == len(jres.history) == ITERATIONS
    for h, jh in zip(res.history, jres.history):
        for k in ("avg_loss", "rec_loss", "pert_loss"):
            np.testing.assert_allclose(h[k], float(jh[k]), rtol=2e-4, err_msg=k)


def test_linf_leaves_the_mask_unused_in_both(tmp_path, models, offline, monkeypatch):
    """The mask is computed, and the L-inf step ignores it (main.py:270-274):
    the JAX iterate moves outside the mask, and the port's iterate is the
    same with the mask and without it."""
    jmodel, pm = models
    linf = dict(norm_type="linf", eps=0.1, step_size=0.02, n_optimization_steps=1)
    jcfg, cfg = _cfgs(tmp_path, **linf)
    jres = j_api.immunize(jcfg, model=jmodel)
    mask = _heuristic(cfg)
    src = load_image(cfg.source_image_path, SIZE).transpose(0, 2, 3, 1)
    outside = np.broadcast_to(mask[None, :, :, None] == 0, src.shape)
    assert np.abs(np.asarray(jres.x_adv) - src)[outside].max() > 1e-3

    masked = api.immunize(cfg, device="cpu", model=pm)
    plain = api.immunize(dataclasses.replace(cfg, use_segmentation_mask=False,
                                             output_path=tmp_path / "plain"),
                         device="cpu", model=pm)
    assert torch.equal(masked.x_adv, plain.x_adv)
    assert np.abs(nhwc(masked.x_adv) - src)[outside].max() > 1e-3


def test_cli_runs_the_masked_attack_on_the_cpu(tmp_path, offline, monkeypatch):
    """``--use-segmentation-mask true --segmentation-model-path DIR`` reach
    the mask (an empty DIR: the heuristic), and the written image equals
    the source's outside it."""
    _, cfg = _cfgs(tmp_path)
    calls = []
    real = segment.salient_mask_and_route
    monkeypatch.setattr(segment, "salient_mask_and_route",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    empty = tmp_path / "rmbg"
    empty.mkdir()
    out = tmp_path / "cli"
    assert cli.main(["immunize", "--device", "cpu", "--model-family", "tiny", "--image-size",
                     str(SIZE), "--n-optimization-steps", "2", "--grad-reps", "2",
                     "--derive-norm-hyperparams", "false", "--eps", "4", "--step-size", "1.5",
                     "--prompts", "a", "b", "--enable-visualization", "false",
                     "--use-segmentation-mask", "true", "--segmentation-model-path", str(empty),
                     "--source-image-path", str(cfg.source_image_path),
                     "--target-image-path", str(cfg.target_image_path),
                     "--output-path", str(out)]) == 0
    assert len(calls) == 1 and calls[0][1]["model_path"] == str(empty)
    mask = _heuristic(cfg)
    adv = np.asarray(Image.open(out / "adversarial_image.png"), np.int16)
    src = np.asarray(resize_crop_pil(Image.open(cfg.source_image_path).convert("RGB"), SIZE),
                     np.int16)
    assert np.abs(adv - src)[mask == 0].max() <= 1       # the uint8 round trip of the source
    assert np.abs(adv - src)[mask == 1].max() > 1
