"""Prompt tokenization: the deterministic hash tokenizer (port of
``models/tokenizer.py::HashTokenizer``, byte for byte).  The local Hugging
Face CLIP tokenizer path comes with the real-weight slice."""

from __future__ import annotations

import hashlib
from typing import Sequence, Union

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
