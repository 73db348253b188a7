"""Synthetic-corpus data pipeline — port of ``repro.data.pipeline`` (numpy
only, the same draws in the same order, so a seed gives the reference's
batches bit for bit): a deterministic mixture of Zipfian "language",
arithmetic strings and repeated patterns, packed with EOS separators into
{"tokens", "labels", "mask"} batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.data.tokenizer import ByteTokenizer


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 512
    seed: int = 0
    pack: bool = True           # document packing with EOS separators
    eos_token: int = 0


def synthetic_documents(rng: np.random.Generator, n: int,
                        tokenizer: ByteTokenizer) -> list:
    docs = []
    for _ in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:       # zipfian babble
            ln = int(rng.integers(20, 200))
            toks = rng.zipf(1.5, size=ln) % (tokenizer.vocab_size - 2) + 1
            docs.append(toks.astype(np.int32))
        elif kind == 1:     # arithmetic strings (structure to learn)
            a, b = rng.integers(0, 99, size=2)
            s = f"{a}+{b}={a + b};" * int(rng.integers(1, 8))
            docs.append(tokenizer.encode(s))
        else:               # repeated patterns
            pat = rng.integers(1, tokenizer.vocab_size - 1, size=int(rng.integers(2, 8)))
            docs.append(np.tile(pat, 32)[:256].astype(np.int32))
    return docs


class Pipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.tokenizer = ByteTokenizer(vocab_size=cfg.vocab_size)
        self._rng = np.random.default_rng(cfg.seed)
        self._buffer = np.zeros((0,), np.int32)

    def _refill(self) -> None:
        docs = synthetic_documents(self._rng, 64, self.tokenizer)
        eos = np.asarray([self.cfg.eos_token], np.int32)
        joined = [np.concatenate([d % self.cfg.vocab_size, eos]) for d in docs]
        self._buffer = np.concatenate([self._buffer] + joined)

    def batches(self, steps: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        B, L = self.cfg.batch_size, self.cfg.seq_len
        need = B * (L + 1)
        i = 0
        while steps is None or i < steps:
            while self._buffer.size < need:
                self._refill()
            flat, self._buffer = self._buffer[:need], self._buffer[need:]
            arr = flat.reshape(B, L + 1)
            yield {"tokens": arr[:, :-1].copy(), "labels": arr[:, 1:].copy(),
                   "mask": (arr[:, 1:] != self.cfg.eos_token).astype(np.float32)}
            i += 1
