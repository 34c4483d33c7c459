"""The port's own CLIP BPE tokenizer against ``transformers.CLIPTokenizer``
on the same directory (``padding="max_length", truncation=True``): fixed
cases, a ``tokenizer_2``-style directory that pads with ``!``, and a
hypothesis property over Unicode text; then the ``load_tokenizer`` rule
and ``build_model(tokenizer_paths=)``."""

from __future__ import annotations

import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tml_image_editing_defense_torch.models.model_zoo import build_model
from tml_image_editing_defense_torch.models.tokenizer import (
    N_MERGES,
    HashTokenizer,
    HFCLIPTokenizer,
    bytes_to_unicode,
    load_tokenizer,
)

transformers = pytest.importorskip("transformers")

MAX_LEN = 16


def _write_dir(d, pad=None, decoder=False):
    """A CLIP-format BPE directory: every byte-level symbol (plain and with
    ``</w>``), merges that build a few words, BOS/EOS last (as in
    tests/test_tokenizer.py, with the full byte alphabet so every text has
    ids).  ``pad`` writes the tokenizer_2 layout's pad token, through
    ``added_tokens_decoder`` when ``decoder`` else special_tokens_map.json."""
    d.mkdir(parents=True, exist_ok=True)
    vocab = {}
    for ch in bytes_to_unicode().values():
        vocab[ch] = len(vocab)
    for ch in bytes_to_unicode().values():
        vocab[ch + "</w>"] = len(vocab)
    merges = ["c a", "ca t</w>", "p h", "o t", "ph ot", "phot o</w>", "t h", "th e</w>",
              "' s</w>", "1 2</w>", "a n", "an d</w>", "c a", "r a", "ra in</w>", "i n</w>"]
    for m in merges:
        vocab.setdefault("".join(m.split()), len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    if pad is not None:
        if decoder:
            cfg = {"pad_token": pad, "added_tokens_decoder": {
                str(vocab[t]): {"content": t, "lstrip": False, "normalized": False,
                                "rstrip": False, "single_word": False, "special": True}
                for t in (pad, "<|startoftext|>", "<|endoftext|>")}}
            (d / "tokenizer_config.json").write_text(json.dumps(cfg))
        else:
            (d / "special_tokens_map.json").write_text(json.dumps(
                {"pad_token": {"content": pad, "lstrip": False, "normalized": False,
                               "rstrip": False, "single_word": False}}))
    return d


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip_tok")
    return {"sd15": _write_dir(root / "sd15"),
            "bang_decoder": _write_dir(root / "bang_decoder", pad="!", decoder=True),
            "bang_map": _write_dir(root / "bang_map", pad="!")}


@pytest.fixture(scope="module")
def pairs(dirs):
    return {k: (HFCLIPTokenizer(d, MAX_LEN), transformers.CLIPTokenizer.from_pretrained(str(d)))
            for k, d in dirs.items()}


def _ref_ids(ref, texts, max_length=MAX_LEN):
    enc = ref(list(texts), padding="max_length", max_length=max_length, truncation=True)
    return np.asarray(enc["input_ids"], np.int32)


CASES = [
    "a photo of a cat",
    "It's the cat's photo, they'll go; we'd've",
    "rain 12 2012 ½ ² 3.14 x²",
    "Hello!!! What?? (yes) -- ok... #tag @you $5",
    "café naïve Ångström façade ŒUVRE ΑΣ",
    "写真の猫 in tokyo 東京",
    "  leading   and\ttrailing\nspaces  ",
    "",
    "<|endoftext|> inside <|startoftext|>text",
    "word " * 40,
    "emoji 🐈 and ​ zero width \x00 null �",
]


@pytest.mark.parametrize("layout", ["sd15", "bang_decoder", "bang_map"])
@pytest.mark.parametrize("text", CASES)
def test_ids_match_transformers(pairs, layout, text):
    mine, ref = pairs[layout]
    np.testing.assert_array_equal(mine(text), _ref_ids(ref, [text]))


@pytest.mark.parametrize("max_length", [3, 5, 77])
def test_truncation_and_batch_match_transformers(pairs, max_length):
    mine, ref = pairs["sd15"]
    texts = ["the cat and the rain " * 20, "photo", ""]
    np.testing.assert_array_equal(mine(texts, max_length=max_length),
                                  _ref_ids(ref, texts, max_length))


def test_tokenizer_2_pads_with_bang(pairs):
    """SDXL's tokenizer_2 pads with '!', id 0, and '!' in the text is that
    added token (not '!</w>')."""
    mine, ref = pairs["bang_decoder"]
    ids = mine("the cat!")[0]
    assert mine.pad_id == ref.pad_token_id == 0
    assert ids[-1] == 0 and list(ids[:5]) == list(_ref_ids(ref, ["the cat!"])[0][:5])
    assert 0 in ids[2:4]
    sd15 = pairs["sd15"][0]
    assert sd15.pad_id == sd15.eos_id == len(sd15.encoder) - 1


def test_bpe_merges_apply_and_the_merge_limit(dirs):
    tok = HFCLIPTokenizer(dirs["sd15"], MAX_LEN)
    assert tok.tokenize("the cat") == ["the</w>", "cat</w>"]
    assert tok.tokenize("cats") == ["ca", "t", "s</w>"]
    assert N_MERGES == 49152 - 256 - 2 == 48894


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.text(st.characters(codec="utf-8"), max_size=40))
def test_ids_match_transformers_on_any_text(pairs, text):
    for layout in ("sd15", "bang_decoder"):
        mine, ref = pairs[layout]
        np.testing.assert_array_equal(mine(text, max_length=24),
                                      _ref_ids(ref, [text], max_length=24))


def test_load_tokenizer_rule(dirs, tmp_path):
    assert isinstance(load_tokenizer(dirs["sd15"]), HFCLIPTokenizer)
    assert isinstance(load_tokenizer(None), HashTokenizer)
    assert isinstance(load_tokenizer(tmp_path / "missing"), HashTokenizer)


def test_build_model_pads_tokenizer_paths_with_none(dirs):
    """One directory for SDXL's two encoders: the second takes the hash
    tokenizer, as JAX model_zoo.py:343-352 pads the list."""
    m = build_model("tiny-sdxl", image_size=32, device="meta",
                    tokenizer_paths=[str(dirs["sd15"])])
    assert isinstance(m.tokenizers[0], HFCLIPTokenizer)
    assert isinstance(m.tokenizers[1], HashTokenizer)
    assert all(isinstance(t, HashTokenizer)
               for t in build_model("tiny", image_size=32, device="meta").tokenizers)
