"""Byte-level tokenizer — port of ``repro.data.tokenizer`` (numpy only):
reversible, with a bounded vocabulary."""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """ids 1..256 = bytes 0..255 (0 = EOS/pad); ids >= 257 wrap into the
    configured vocab via modulo (toy vocab compression)."""

    def __init__(self, vocab_size: int = 512):
        assert vocab_size >= 258
        self.vocab_size = vocab_size

    def encode(self, text: str) -> np.ndarray:
        b = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)
        return (b.astype(np.int32) + 1)

    def decode(self, ids) -> str:
        b = bytes(int(i) - 1 for i in ids if 0 < int(i) <= 256)
        return b.decode("utf-8", errors="replace")
