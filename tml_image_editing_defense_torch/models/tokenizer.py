"""Prompt tokenization (port of ``models/tokenizer.py``).

- :class:`HashTokenizer`: the deterministic stand-in, byte for byte the JAX
  package's; the test and random-weight path.
- :class:`HFCLIPTokenizer`: CLIP's byte-level BPE read from a local
  ``vocab.json`` / ``merges.txt`` directory, with no ``transformers``: the
  ids ``transformers.CLIPTokenizer`` gives for the same directory with
  ``padding="max_length", truncation=True`` (the reference gets its
  tokenizers through ``from_pretrained``, main.py:284-301).
- :func:`load_tokenizer`: BPE for an existing directory, else the hash
  tokenizer (the JAX rule, tokenizer.py:66-70).

What the BPE path reproduces of ``tokenization_clip.py`` (transformers
4.57): without ``ftfy`` the text is cleaned by its
``BasicTokenizer(strip_accents=False, do_split_on_punc=False)`` (control
characters dropped, whitespace normalised, CJK ideographs spaced, NFC,
lowercased, split on whitespace); added tokens (the special tokens, and
``added_tokens_decoder``) are split out first and map to their ids; words
come from CLIP's pattern, whose ``\\p{L}`` / ``\\p{N}`` classes are built
here from ``unicodedata`` categories for the standard ``re``; each word's
UTF-8 bytes pass through ``bytes_to_unicode`` and merge by rank with a
``</w>`` word end, using the first ``49152 - 256 - 2`` merges.
"""

from __future__ import annotations

import functools
import hashlib
import json
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


class HashTokenizer:
    """Deterministic stand-in tokenizer: stable word-hash ids, BOS/EOS/pad
    framing identical to CLIP's (BOS, tokens..., EOS, pad with EOS-style id)."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77,
                 bos_id: int = None, eos_id: int = None):
        self.vocab_size = vocab_size
        self.model_max_length = max_length
        self.bos_id = vocab_size - 2 if bos_id is None else bos_id
        self.eos_id = vocab_size - 1 if eos_id is None else eos_id

    def _word_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
        return h % (self.vocab_size - 2)

    def __call__(self, text: Union[str, Sequence[str]], max_length: int = None) -> np.ndarray:
        if isinstance(text, str):
            text = [text]
        L = max_length or self.model_max_length
        out = np.full((len(text), L), self.eos_id, np.int32)
        for i, t in enumerate(text):
            ids = [self.bos_id] + [self._word_id(w) for w in t.lower().split()][: L - 2] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


# ---------------------------------------------------------------------------
# CLIP BPE
# ---------------------------------------------------------------------------

#: merges CLIP reads after the version line (tokenization_clip.py:313)
N_MERGES = 49152 - 256 - 2


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _class(categories) -> str:
    """A regex character class body of every code point whose
    ``unicodedata`` category starts with one of ``categories``."""
    ranges, start, prev = [], None, None
    for cp in range(0x110000):
        if unicodedata.category(chr(cp)).startswith(categories):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            ranges.append((start, prev))
            start = None
    if start is not None:
        ranges.append((start, prev))
    esc = lambda c: f"\\U{c:08x}"                                            # noqa: E731
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in ranges)


@functools.lru_cache(maxsize=None)
def clip_pattern() -> "re.Pattern":
    """CLIP's word pattern (tokenization_clip.py:318-321) with ``\\p{L}``
    (categories L*) and ``\\p{N}`` (N*) spelled out; Python's ``[^\\W\\d_]``
    would also take No / Nl characters such as '²' and '½'."""
    L, N = _class(("L",)), _class(("N",))
    # case-insensitive for the literals only.  Under ``regex.IGNORECASE``
    # U+0345 (Mn, which case-folds to a letter) matches neither \p{L} nor
    # the negated class, so CLIP drops it; the negated class here leaves it
    # out as well
    return re.compile(rf"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
                      rf"|[{L}]+|[{N}]|[^\s{L}{N}\u0345]+")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """transformers' ``BasicTokenizer(strip_accents=False,
    do_split_on_punc=False).tokenize`` joined by spaces: CLIP's cleaning
    where ``ftfy`` is absent."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(" ".join(w.lower() for w in words).split())


def _token_content(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


class HFCLIPTokenizer:
    """CLIP's BPE tokenizer read from a local directory (``vocab.json``,
    ``merges.txt``, and ``tokenizer_config.json`` / ``special_tokens_map.json``
    when present), with the JAX ``HFCLIPTokenizer``'s interface: a call
    returns int32 ids [B, max_length], BOS first, then the text's tokens
    truncated to ``max_length - 2``, EOS, and the pad id (SD-1.5 pads with
    ``<|endoftext|>``, SDXL's ``tokenizer_2`` with ``!``)."""

    def __init__(self, path: Union[str, Path], max_length: int = 77):
        path = Path(path)
        self.encoder: Dict[str, int] = json.loads((path / "vocab.json").read_text("utf-8"))
        merges = (path / "merges.txt").read_text("utf-8").strip().split("\n")[1:N_MERGES + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.model_max_length = max_length
        self.vocab_size = len(self.encoder)

        cfg = self._json(path / "tokenizer_config.json")
        specials = {"unk_token": "<|endoftext|>", "bos_token": "<|startoftext|>",
                    "eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>"}
        added: Dict[str, int] = {}
        if "added_tokens_decoder" in cfg:
            added = {_token_content(v): int(k) for k, v in cfg["added_tokens_decoder"].items()}
            overrides = cfg
        else:                 # the older layout: special_tokens_map.json wins
            overrides = {**cfg, **self._json(path / "special_tokens_map.json")}
            added = {k: int(v) for k, v in self._json(path / "added_tokens.json").items()}
        for name in specials:
            if overrides.get(name) is not None:
                specials[name] = _token_content(overrides[name])
        self.added_ids: Dict[str, int] = dict(added)
        for content in specials.values():
            if content not in self.added_ids:
                self.added_ids[content] = self.encoder.get(content, len(self.encoder)
                                                           + len(self.added_ids))
        self.unk_id = self.added_ids[specials["unk_token"]]
        self.bos_id = self.added_ids[specials["bos_token"]]
        self.eos_id = self.added_ids[specials["eos_token"]]
        self.pad_id = self.added_ids[specials["pad_token"]]
        # added tokens are split out of the text first, longest first
        self._split = re.compile("(" + "|".join(
            re.escape(t) for t in sorted(self.added_ids, key=len, reverse=True)) + ")")

    @staticmethod
    def _json(path: Path) -> dict:
        return json.loads(path.read_text("utf-8")) if path.exists() else {}

    def bpe(self, token: str) -> str:
        """One word's merged symbols, space-separated (``CLIPTokenizer.bpe``)."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new.extend(word[i:])
                    break
                new.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        """The BPE tokens of ``text`` (added tokens as themselves)."""
        tokens = []
        for part in self._split.split(text):
            if not part:
                continue
            if part in self.added_ids:
                tokens.append(part)
                continue
            for word in clip_pattern().findall(basic_clean(part)):
                word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                tokens.extend(self.bpe(word).split(" "))
        return tokens

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        L = max_length or self.model_max_length
        ids = [self.added_ids[t] if t in self.added_ids else self.encoder.get(t, self.unk_id)
               for t in self.tokenize(text)]
        ids = [self.bos_id] + ids[:max(L - 2, 0)] + [self.eos_id]
        return ids + [self.pad_id] * (L - len(ids))

    def __call__(self, text: Union[str, Sequence[str]], max_length: int = None) -> np.ndarray:
        if isinstance(text, str):
            text = [text]
        return np.asarray([self.encode(t, max_length) for t in text], np.int32)


def load_tokenizer(path_or_none, vocab_size: int = 49408, max_length: int = 77):
    """The BPE tokenizer for an existing directory, the hash fallback
    otherwise (JAX ``load_tokenizer``, tokenizer.py:66-70)."""
    if path_or_none is not None and Path(path_or_none).exists():
        return HFCLIPTokenizer(path_or_none, max_length)
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
