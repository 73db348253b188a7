"""DRAM-Flash hybrid storage (paper §4.1, C2) — port of
``repro.core.hybrid_storage``: the Flash embedding table and the paged-KV
spill tier.

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

``PageSpillStore`` keeps KV pages the serving loop moved off the device:
row snapshots of preempted requests and page-granular blobs of running
rows' cold pages, each one layer group's raw bytes (int8 keys, float32
scales and zeros, fp8 values as uint8, since numpy has no fp8).  Its
``_FlashPrefetcher`` worker thread reads blobs ahead of the consumer; it
uses numpy only and never touches the device.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

# rows converted per chunk when a table is written to Flash
EXPORT_CHUNK_ROWS = 8192


class FlashStore:
    """Directory of memmap'd arrays; counts the bytes read and written
    (from any thread)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._maps: Dict[str, np.memmap] = {}
        self._count = threading.Lock()
        self.bytes_read = 0
        self.bytes_written = 0

    def path(self, name: str) -> str:
        return os.path.join(self.root, name + ".bin")

    def _read(self, nbytes: int) -> None:
        with self._count:
            self.bytes_read += nbytes

    def create(self, name: str, shape, dtype) -> np.memmap:
        """A writable zero-filled array on Flash (filled by the caller)."""
        mm = np.memmap(self.path(name), dtype=dtype, mode="w+",
                       shape=tuple(shape))
        self._maps[name] = mm
        return mm

    def put(self, name: str, array: np.ndarray) -> None:
        """Write one whole array to Flash."""
        mm = self.create(name, array.shape, array.dtype)
        mm[...] = array
        mm.flush()
        with self._count:
            self.bytes_written += mm.nbytes

    def open(self, name: str, shape, dtype) -> None:
        """Map an array an earlier process wrote, read-only."""
        self._maps[name] = np.memmap(self.path(name), dtype=dtype, mode="r",
                                     shape=tuple(shape))

    def read_rows(self, name: str, rows: np.ndarray) -> np.ndarray:
        """Gather rows[i] along axis 0 (the embedding access pattern)."""
        out = np.asarray(self._maps[name][rows])
        self._read(out.nbytes)
        return out

    def read_view(self, name: str) -> np.memmap:
        """A whole stored array as its memmap (no host copy), counted as
        read."""
        mm = self._maps[name]
        self._read(mm.nbytes)
        return mm

    def delete(self, name: str) -> None:
        """Drop a stored array and its backing file."""
        self._maps.pop(name, None)
        try:
            os.remove(self.path(name))
        except FileNotFoundError:
            pass

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


# ---------------------------------------------------------------------------
# the paged-KV spill tier
# ---------------------------------------------------------------------------

class _LoadFailed:
    """What the worker stores for a key whose load raised: ``_obtain``
    raises the error in the consumer's thread."""

    def __init__(self, error: BaseException):
        self.error = error


class _FlashPrefetcher:
    """Background prefetch pump: a daemon worker thread loads keyed blobs
    from Flash into an in-memory cache ahead of the consumer (the §4.1
    compute/IO overlap).  Subclasses implement ``_load(key)`` and
    ``_has(key)``.  The worker starts at the first request (a store that is
    never asked ahead starts no thread) and runs numpy only.  After
    ``close()`` requests are ignored and every fetch reads synchronously."""

    def __init__(self):
        self._cache: Dict = {}
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._inflight: set = set()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.prefetch_hits = 0
        self.prefetch_misses = 0

    def _load(self, key):
        raise NotImplementedError

    def _has(self, key) -> bool:
        return True

    def _worker(self) -> None:
        while True:
            key = self._q.get()
            if key is None:
                return
            try:
                data = self._load(key)
            except Exception as e:       # handed to the consumer by _obtain
                data = _LoadFailed(e)
            with self._cv:
                self._cache[key] = data
                self._inflight.discard(key)
                self._cv.notify_all()

    def _request(self, key) -> None:
        with self._lock:
            if self._closed or key in self._cache or key in self._inflight \
                    or not self._has(key):
                return
            self._inflight.add(key)
            if self._thread is None:
                self._thread = threading.Thread(target=self._worker, daemon=True,
                                                name="flash-prefetch")
                self._thread.start()
        self._q.put(key)

    def _obtain(self, key):
        """Blocking on an in-flight prefetch; synchronous load on a miss."""
        with self._cv:
            while key in self._inflight:
                self._cv.wait()
            if key in self._cache:
                self.prefetch_hits += 1
                data = self._cache.pop(key)
                if isinstance(data, _LoadFailed):
                    raise data.error
                return data
            self.prefetch_misses += 1
        return self._load(key)

    @property
    def hit_rate(self) -> float:
        """Fraction of fetches served through the prefetch pipeline; 1.0
        before any traffic."""
        total = self.prefetch_hits + self.prefetch_misses
        return self.prefetch_hits / total if total else 1.0

    def close(self) -> None:
        """Stop the worker (it finishes the load in hand first)."""
        with self._lock:
            self._closed = True
            thread = self._thread
            self._thread = None
        if thread is not None:
            self._q.put(None)
            thread.join(timeout=10)
            if thread.is_alive():
                raise RuntimeError("the Flash prefetch worker did not stop")


class PageSpillStore(_FlashPrefetcher):
    """Paged-KV spill tier: row snapshots of preempted requests and
    page-granular blobs of running rows' cold pages, as the reference's.

    ``put(uid, group, arrays, pages=)`` writes one layer group's arrays
    under ``(uid, group)``; ``pages`` counts the pool pages the call moves
    to Flash (pass it on one group per row or page).  ``put_page`` /
    ``fetch_page`` key one logical page of one layer group as
    ``(uid, "p<idx>/<group>")``: the unit the decode loop stages, reading
    group g + 1 ahead while group g installs.  Bytes round-trip exactly, so
    a restored row decodes bit for bit as if it had never left."""

    def __init__(self, flash: FlashStore):
        self.flash = flash
        self._meta: Dict[tuple, list] = {}      # (uid, group) -> [(file, name)]
        self._key_pages: Dict[tuple, int] = {}
        self.pages_on_flash = 0
        super().__init__()

    def put(self, uid: int, group: str, arrays: Dict[str, np.ndarray], *,
            pages: int = 0) -> None:
        names = []
        for name, arr in arrays.items():
            # files named per store: two loops may spill the same uid to one directory
            key = f"pspill{id(self):x}_u{uid}_{group}_{name}".replace("/", "-")
            self.flash.put(key, np.ascontiguousarray(arr))
            names.append((key, name))
        with self._lock:
            k = (uid, group)
            self._meta[k] = names
            self.pages_on_flash += pages - self._key_pages.get(k, 0)
            self._key_pages[k] = pages
            self._cache.pop(k, None)          # stale

    @staticmethod
    def _page_group(page_idx: int, group: str) -> str:
        return f"p{page_idx}/{group}"

    def put_page(self, uid: int, page_idx: int, group: str,
                 arrays: Dict[str, np.ndarray], *,
                 count_page: bool = False) -> None:
        """One logical page of one layer group; ``count_page`` counts the
        page once in ``pages_on_flash`` (pass True on one group a page)."""
        self.put(uid, self._page_group(page_idx, group), arrays,
                 pages=1 if count_page else 0)

    def _load(self, key: tuple) -> Dict[str, np.ndarray]:
        with self._lock:
            names = list(self._meta[key])
        return {name: np.array(self.flash.read_view(fkey))
                for fkey, name in names}

    def _has(self, key: tuple) -> bool:
        return key in self._meta

    def prefetch_async(self, uid: int, group: str) -> None:
        self._request((uid, group))

    def fetch(self, uid: int, group: str) -> Dict[str, np.ndarray]:
        """One group's arrays (blocking on an in-flight prefetch;
        synchronous Flash read on a miss)."""
        return self._obtain((uid, group))

    def prefetch_page(self, uid: int, page_idx: int, group: str) -> None:
        self.prefetch_async(uid, self._page_group(page_idx, group))

    def fetch_page(self, uid: int, page_idx: int, group: str
                   ) -> Dict[str, np.ndarray]:
        return self.fetch(uid, self._page_group(page_idx, group))

    def has_page(self, uid: int, page_idx: int, group: str) -> bool:
        with self._lock:
            return (uid, self._page_group(page_idx, group)) in self._meta

    def _drop_key(self, key: tuple) -> None:
        for fkey, _ in self._meta.pop(key):
            self.flash.delete(fkey)
        self._cache.pop(key, None)
        self.pages_on_flash -= self._key_pages.pop(key, 0)

    def drop(self, uid: int) -> None:
        """Forget a request's spilled pages: row snapshots and cold page
        blobs alike."""
        with self._lock:
            for key in [k for k in self._meta if k[0] == uid]:
                self._drop_key(key)

    def drop_groups(self, uid: int, groups) -> None:
        """Forget some groups of one request (a restored row snapshot,
        whose cold page blobs stay)."""
        with self._lock:
            for group in groups:
                if (uid, group) in self._meta:
                    self._drop_key((uid, group))
