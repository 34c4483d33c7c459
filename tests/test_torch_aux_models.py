"""The port's aux models (``aux_models/segment.py``, ``aux_models/caption.py``)
against the JAX package's, on the CPU and offline.

- The heuristic saliency, the fallback of the masked attack without a
  checkpoint, is bit-equal to the JAX one.
- ``get_salient_mask`` tries ISNet, the ``transformers`` pipeline and the
  heuristic in the JAX order; ``torch_salient_mask`` is made to raise
  wherever the chain would reach it, so no hub is contacted.
- A tiny BLIP-2 checkpoint built here (random weights, a BPE vocabulary
  trained on one sentence, as ``tests/test_aux_models.py`` builds it) gives
  the same caption through both packages, and that caption prefixes the
  prompts of ``immunize`` and ``evaluate``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_api import _cfg
from test_torch_models import one_torch_thread  # noqa: F401
from tml_image_editing_defense_tpu.aux_models import segment as j_segment

from tml_image_editing_defense_torch import api
from tml_image_editing_defense_torch.aux_models import caption, segment
from tml_image_editing_defense_torch.configs import InferenceConfig
from tml_image_editing_defense_torch.core.image_ops import resize_crop_pil
from tml_image_editing_defense_torch.models.isnet import build_isnet, salient_mask

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _no_pipeline(*args, **kwargs):
    raise RuntimeError("the transformers pipeline is not reached in this test")


@pytest.fixture()
def offline(monkeypatch):
    """Both packages' ``torch_salient_mask`` raise (no hub lookup)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(segment, "torch_salient_mask", _no_pipeline)
    monkeypatch.setattr(j_segment, "torch_salient_mask", _no_pipeline)


@pytest.fixture()
def sample_image(tmp_path):
    """A textured square on a flat background, 96x104."""
    rng = np.random.default_rng(0)
    arr = np.full((96, 104, 3), 40, np.uint8)
    arr[24:72, 28:76] = rng.integers(120, 255, (48, 48, 3), dtype=np.uint8)
    p = tmp_path / "img.png"
    Image.fromarray(arr).save(p)
    return p


@pytest.mark.parametrize("size", [32, 33, 64, 97])
def test_heuristic_saliency_is_bit_equal_to_jax(size):
    img = np.random.default_rng(size).uniform(0, 1, (size, size + 3, 3)).astype(np.float32)
    img[size // 4: 3 * size // 4, size // 4: 3 * size // 4] *= 0.2
    got = segment._heuristic_saliency(img)
    np.testing.assert_array_equal(got, j_segment._heuristic_saliency(img))
    assert got.dtype == np.float32 and 0 < got.mean() < 1


def test_a_passed_isnet_wins(sample_image, offline, monkeypatch):
    """With a model passed, ISNet gives the mask, on the cropped frame."""
    called = []
    monkeypatch.setattr(segment, "torch_salient_mask", lambda *a, **k: called.append(a))
    model = build_isnet("tiny", device="cpu", generator=torch.Generator().manual_seed(2))
    got = segment.get_salient_mask(sample_image, 32, isnet_bundle=model)
    crop = np.asarray(resize_crop_pil(Image.open(sample_image).convert("RGB"), 32),
                      np.float32) / 255.0
    np.testing.assert_array_equal(got, salient_mask(model, crop, 32))
    assert not called
    again, route = segment.salient_mask_and_route(sample_image, 32, isnet_bundle=model)
    assert route == "isnet" and np.array_equal(again, got)


def test_without_a_checkpoint_both_packages_give_the_heuristic_mask(sample_image, offline,
                                                                    tmp_path, capsys):
    """No model, no checkpoint (and an empty checkpoint directory): the
    ISNet route fails quietly, the pipeline raises, and each package gives
    the same heuristic mask."""
    empty = tmp_path / "empty"
    empty.mkdir()
    for model_path in (None, str(empty)):
        got = segment.get_salient_mask(sample_image, 48, model_path=model_path, device="cpu")
        want = j_segment.get_salient_mask(sample_image, 48, model_path=model_path)
        np.testing.assert_array_equal(got, want)
        out = capsys.readouterr().out
        assert "heuristic" in out and "ISNet path failed" not in out
        again, route = segment.salient_mask_and_route(sample_image, 48, model_path=model_path,
                                                      device="cpu")
        assert route == "heuristic" and np.array_equal(again, got)
    crop = np.asarray(resize_crop_pil(Image.open(sample_image).convert("RGB"), 48),
                      np.float32) / 255.0
    np.testing.assert_array_equal(got, segment._heuristic_saliency(crop))


def test_a_broken_checkpoint_says_why_and_falls_through(sample_image, offline, tmp_path, capsys):
    (tmp_path / "model.safetensors").write_bytes(b"\x00" * 4)
    got = segment.get_salient_mask(sample_image, 32, model_path=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "ISNet path failed (ValueError" in out and "heuristic" in out
    np.testing.assert_array_equal(got, j_segment.get_salient_mask(sample_image, 32,
                                                                  model_path=str(tmp_path)))
    assert segment.salient_mask_and_route(sample_image, 32, model_path=str(tmp_path),
                                          device="cpu")[1] == "heuristic"


def test_the_mask_needs_the_card_unless_asked_for_the_cpu(sample_image):
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only machine's error")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        segment.get_salient_mask(sample_image, 32)


# ---------------------------------------------------------------------------
# the BLIP-2 caption
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_blip2_dir(tmp_path_factory):
    """A tiny offline BLIP-2 checkpoint (tests/test_aux_models.py:28-65)."""
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import ByteLevel
    from tokenizers.trainers import BpeTrainer
    from transformers import (
        Blip2Config,
        Blip2ForConditionalGeneration,
        Blip2Processor,
        Blip2QFormerConfig,
        Blip2VisionConfig,
        BlipImageProcessor,
        OPTConfig,
        PreTrainedTokenizerFast,
    )

    torch.manual_seed(0)
    d = tmp_path_factory.mktemp("tiny_blip2")
    tok = Tokenizer(BPE(unk_token=None))
    tok.pre_tokenizer = ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(
        ["what is shown in the image? a photo of things"] * 10,
        BpeTrainer(vocab_size=300, special_tokens=["</s>", "<pad>"]),
    )
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, eos_token="</s>", pad_token="<pad>",
        bos_token="</s>", unk_token="<pad>",
    )
    improc = BlipImageProcessor(size={"height": 32, "width": 32})
    proc = Blip2Processor(image_processor=improc, tokenizer=fast, num_query_tokens=4)
    vis = Blip2VisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                            num_attention_heads=2, image_size=32, patch_size=8)
    qf = Blip2QFormerConfig(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=32, encoder_hidden_size=16)
    txt = OPTConfig(hidden_size=16, ffn_dim=32, num_hidden_layers=2,
                    num_attention_heads=2, vocab_size=len(fast),
                    max_position_embeddings=64)
    cfg = Blip2Config.from_vision_qformer_text_configs(vis, qf, txt, num_query_tokens=4)
    cfg.image_token_index = fast.convert_tokens_to_ids("<image>")
    Blip2ForConditionalGeneration(cfg).save_pretrained(d)
    proc.save_pretrained(d)
    return str(d)


def test_caption_equals_the_jax_packages(tiny_blip2_dir, sample_image):
    from tml_image_editing_defense_tpu.aux_models.caption import get_image_caption as j_caption

    img = Image.open(sample_image).convert("RGB")
    got = caption.get_image_caption(img, model_path=tiny_blip2_dir, max_new_tokens=5,
                                    device="cpu")
    assert isinstance(got, str) and got
    assert got == j_caption(img, model_path=tiny_blip2_dir, max_new_tokens=5)


def test_without_blip2_the_caption_is_empty(tmp_path, sample_image, capsys):
    got = caption.get_image_caption(Image.open(sample_image).convert("RGB"),
                                    model_path=str(tmp_path), device="cpu")
    assert got == "" and "empty caption" in capsys.readouterr().out


def _format_spy(monkeypatch):
    prompts = []
    real = api.format_prompt
    monkeypatch.setattr(api, "format_prompt", lambda p, c="": prompts.append(real(p, c))
                        or prompts[-1])
    return prompts


def test_immunize_prefixes_the_prompts_with_the_caption(tmp_path, tiny_blip2_dir, monkeypatch,
                                                        capsys):
    """The BLIP-2 caption of the source (the full image, as JAX api.py:213-219
    takes it) prefixes every prompt of the bank; a set
    ``default_source_image_caption`` wins without loading BLIP-2."""
    prompts = _format_spy(monkeypatch)
    cfg = _cfg(tmp_path, n_optimization_steps=1, enable_visualization=False,
               add_image_caption_to_prompts=True, caption_model_path=tiny_blip2_dir)
    want = caption.get_image_caption(Image.open(cfg.source_image_path).convert("RGB"),
                                     model_path=tiny_blip2_dir, device="cpu")
    assert want
    api.immunize(cfg, device="cpu")
    assert prompts == [f"{want} {p}, detailed" for p in cfg.prompts]
    assert f"Running with prefix: {want}" in capsys.readouterr().out

    prompts.clear()
    monkeypatch.setattr(caption, "get_image_caption", _no_pipeline)
    (tmp_path / "b").mkdir()
    cfg = _cfg(tmp_path / "b", n_optimization_steps=1, enable_visualization=False,
               add_image_caption_to_prompts=True, default_source_image_caption="a photo")
    api.immunize(cfg, device="cpu")
    assert prompts == [f"a photo {p}, detailed" for p in cfg.prompts]


def test_evaluate_prefixes_the_prompts_with_the_caption(tmp_path, tiny_blip2_dir, monkeypatch):
    """evaluate captions the cropped source (JAX api.py:618-624)."""
    prompts = _format_spy(monkeypatch)
    src = tmp_path / "source.png"
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (40, 48, 3), np.uint8)).save(src)
    cfg = InferenceConfig(source_image_path=src, target_image_path=src, model_family="tiny",
                          image_size=32, n_steps=2, n_noise=1, output_path=tmp_path / "eval",
                          validation_images_path=None, add_image_caption_to_prompts=True,
                          caption_model_path=tiny_blip2_dir)
    want = caption.get_image_caption(resize_crop_pil(Image.open(src).convert("RGB"), 32),
                                     model_path=tiny_blip2_dir, device="cpu")
    assert want
    adv = resize_crop_pil(Image.open(src).convert("RGB"), 32)
    api.evaluate(cfg, adv, inference_prompts=["a dog"], device="cpu")
    assert prompts == [f"{want} a dog, detailed"]
