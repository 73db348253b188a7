"""DRAM-Flash hybrid storage (paper §4.1, C2) — the parts of
``repro.core.hybrid_storage`` the serving main path uses.

"Flash" is a directory of disk-backed ``numpy.memmap`` arrays; "DRAM" is the
device.  The embedding table lives on Flash and never occupies device
memory: every step gathers only the rows of the tokens it feeds (one
3584-wide bf16 row, 7 KiB, per token at qwen2-7b).

Unlike the reference, which stores the table in float32 and casts the
gathered rows to bf16, the port stores the bf16 bits themselves (as
uint16, since numpy has no bf16): the same round-to-nearest-even cast done
once at export time, so every lookup returns the reference's bf16 rows bit
for bit at half the Flash footprint.  Reads are not throttled: the
reference builds its serving engines with ``simulate=False`` as well.
Rows reach the device through a pinned ``StagedBuffer`` with a
non-blocking copy, as every host-to-device input of the serving loop does.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

# rows converted per chunk when a table is written to Flash
EXPORT_CHUNK_ROWS = 8192


class FlashStore:
    """Directory of memmap'd arrays; counts the bytes read."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._maps: Dict[str, np.memmap] = {}
        self.bytes_read = 0

    def path(self, name: str) -> str:
        return os.path.join(self.root, name + ".bin")

    def create(self, name: str, shape, dtype) -> np.memmap:
        """A writable zero-filled array on Flash (filled by the caller)."""
        mm = np.memmap(self.path(name), dtype=dtype, mode="w+",
                       shape=tuple(shape))
        self._maps[name] = mm
        return mm

    def read_rows(self, name: str, rows: np.ndarray) -> np.ndarray:
        """Gather rows[i] along axis 0 (the embedding access pattern)."""
        out = np.asarray(self._maps[name][rows])
        self.bytes_read += out.nbytes
        return out

    def nbytes(self, name: str) -> int:
        return int(self._maps[name].nbytes)


class StagedBuffer:
    """A device tensor ``target`` that the host fills through a twin in
    pinned memory: ``put`` writes the twin, enqueues a non-blocking copy
    into ``target`` on the current stream and records an event after it, so
    the host never waits for the device to take the values; the next
    ``put`` first waits on that event, as the copy out of the twin must
    have finished before the host overwrites it.  ``target`` keeps its
    storage, so a CUDA graph that reads it sees every ``put``.  On the CPU
    the twin is plain memory and the copy is immediate."""

    def __init__(self, target: torch.Tensor):
        self.target = target
        on_card = target.device.type == "cuda"
        self.host = torch.empty(target.shape, dtype=target.dtype,
                                pin_memory=on_card)
        self._copied = torch.cuda.Event() if on_card else None

    def put(self, values) -> torch.Tensor:
        """Write ``values`` (broadcast to the target's shape; bf16 as its
        int16 bits) and copy them to ``target``, which is returned."""
        if self._copied is not None:
            self._copied.synchronize()
        host = self.host.view(torch.int16) if self.host.dtype == torch.bfloat16 \
            else self.host
        host.numpy()[...] = values
        self.target.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()
        return self.target


class EmbeddingStore:
    """The bf16 embedding table on Flash; ``lookup`` returns bf16 rows on
    the requested device."""

    def __init__(self, flash: FlashStore, name: str = "embedding"):
        self.flash = flash
        self.name = name

    @classmethod
    def create(cls, flash: FlashStore, rows: int, dim: int, fill,
               name: str = "embedding") -> "EmbeddingStore":
        """Write a [rows, dim] table in chunks: ``fill(start, stop)`` returns
        rows [start, stop) as a float tensor (any device); they are rounded
        to bf16 and stored as their uint16 bit patterns."""
        mm = flash.create(name, (rows, dim), np.uint16)
        for start in range(0, rows, EXPORT_CHUNK_ROWS):
            stop = min(rows, start + EXPORT_CHUNK_ROWS)
            chunk = fill(start, stop).to(torch.bfloat16).view(torch.int16)
            mm[start:stop] = chunk.cpu().numpy().view(np.uint16)
        mm.flush()
        return cls(flash, name)

    def lookup(self, token_ids: np.ndarray,
               device: torch.device = torch.device("cpu"), *,
               out: Optional[StagedBuffer] = None) -> torch.Tensor:
        """bf16 rows [*ids.shape, d] on ``device``; with ``out`` (a bf16
        ``StagedBuffer`` of that shape) the rows go through its pinned twin
        into its target, which is returned: no copy the host waits for."""
        ids = np.asarray(token_ids)
        rows = self.flash.read_rows(self.name, ids.reshape(-1))
        if out is not None:
            if out.target.dtype != torch.bfloat16 or \
                    tuple(out.target.shape) != (*ids.shape, rows.shape[-1]):
                raise ValueError(f"out {out.target.dtype} {tuple(out.target.shape)} "
                                 f"for ids {ids.shape} of width {rows.shape[-1]}")
            return out.put(rows.view(np.int16).reshape(out.target.shape))
        t = torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16)
        return t.reshape(*ids.shape, rows.shape[-1]).to(device)

    @property
    def dram_bytes_saved(self) -> int:
        return self.flash.nbytes(self.name)
