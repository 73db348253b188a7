"""DRAM-Flash hybrid storage (paper §4.1, C2) — port of
``repro.core.hybrid_storage``: the Flash embedding table, the paged-KV
spill tier, the weight groups of streamed stacks, §4.1's per-layer KV
spill (``KVSpillManager``) and the placement policy.

"Flash" is a directory of disk-backed ``numpy.memmap`` arrays; "DRAM" is the
device.  ``FlashSpec`` describes the simulated Flash, the reference's: the
paper's UFS 4.0 at ~1 GB/s and 15 us a read.  With ``simulate`` on (the
default, as in the reference) every read sleeps its latency plus its bytes
over the bandwidth and adds that to ``read_time_s``: ``read_rows``,
``read_slice``, ``read_all``, ``read_view`` and the port's
``read_blob_into`` alike, so the paper's DRAM-Flash crossover reproduces
on any disk.  Unlike the reference, which sleeps each read's own time, a
store sleeps off its running debt and keeps a sleep's overshoot as credit
(``FlashStore._throttle``): on a host with coarse timers a read of a few
microseconds would otherwise wait a whole timer tick.  Every serving path builds its stores with
``FlashSpec(simulate=False)``, as the reference's engine does, and so reads
at the disk's (or the page cache's) own speed.

The embedding table lives on Flash and never occupies device memory: every
step gathers only the rows of the tokens it feeds (one 3584-wide bf16 row,
7 KiB, per token at qwen2-7b).

Unlike the reference, which stores the table in float32 and casts the
gathered rows to bf16, the port stores the bf16 bits themselves (as
uint16, since numpy has no bf16): the same round-to-nearest-even cast done
once at export time, so every lookup returns the reference's bf16 rows bit
for bit at half the Flash footprint.  Rows reach the device through a
pinned ``StagedBuffer`` with a non-blocking copy, as every host-to-device
input of the serving loop does.

``PageSpillStore`` keeps KV pages the serving loop moved off the device:
row snapshots of preempted requests and page-granular blobs of running
rows' cold pages, each one layer group's raw bytes (int8 keys, float32
scales and zeros, fp8 values as uint8, since numpy has no fp8).  Its
``_FlashPrefetcher`` worker thread reads blobs ahead of the consumer.

``WeightGroupStore`` keeps the layer groups of streamed weight stacks: one
blob per (stack, group) and, for an expert-granular MoE stack, one per
(stack, group, expert), each holding its leaves' raw bytes back to back
(bf16 as its bits) with the leaves' offsets kept in memory.  Its worker
reads a blob into one host buffer -- pinned on the card, so the serving
loop only enqueues a non-blocking copy into a device ring slot -- where each
leaf starts on a ``WEIGHT_ALIGN`` boundary, the layout of the slot itself.

``KVSpillManager`` is §4.1's dense KV spill: a layer's oldest KV blocks
(int8 key codes, fp8 values as uint8 bits, [B, block, H, D] each) go to
Flash, and the decode loop asks for layer i + 1's blocks
(``prefetch_async``) before it takes layer i's (``gather``), so the read
overlaps layer i's compute.  ``plan_embedding_placement`` is the paper's
utilization-ordered DRAM/Flash placement (``runtime.plan.placement_for``
sizes its entries).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# rows converted per chunk when a table is written to Flash
EXPORT_CHUNK_ROWS = 8192
# A blob is read in pieces of at most IO_PIECE_BYTES by IO_THREADS threads
# at once: one thread copies out of the page cache at a few GB/s, and a
# streamed step reads gigabytes.  A piece is large, and a blob of one piece
# is one scatter read on the caller's thread, because every thread that
# wakes takes the interpreter lock from the serving thread (an
# expert-granular step reads thousands of blobs of a few MB).  Writes go
# whole blobs a thread, since a file's buffered writes take its inode lock
# in turn.
IO_PIECE_BYTES = 32 << 20
IO_THREADS = 4
# blobs a WeightGroupStore export may hold in host memory while they are
# written
EXPORT_PENDING = 8

_IOV_MAX = 1024          # buffers a preadv call takes (Linux's UIO_MAXIOV)

_IO = {"pool": None}
_IO_LOCK = threading.Lock()


def _io_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The threads of the Flash reads and writes, started at first use."""
    with _IO_LOCK:
        if _IO["pool"] is None:
            _IO["pool"] = concurrent.futures.ThreadPoolExecutor(
                IO_THREADS, thread_name_prefix="flash-io")
        return _IO["pool"]


def _run_all(fn, jobs) -> None:
    """``fn(*job)`` for every job, on the I/O threads where there are
    several; waits for all of them before the first error is raised."""
    if len(jobs) < 2:
        for job in jobs:
            fn(*job)
        return
    futures = [_io_pool().submit(fn, *job) for job in jobs]
    concurrent.futures.wait(futures)
    for f in futures:
        f.result()


def _pwrite_full(fd: int, view: memoryview, offset: int) -> None:
    done = 0
    while done < len(view):
        done += os.pwrite(fd, view[done:], offset + done)


def _pieces(views: Sequence[memoryview], limit: int) -> list:
    """Cut byte views that lie back to back in a file into runs of at most
    ``limit`` bytes (at most ``_IOV_MAX`` views each): [(file offset,
    [views])], each run one scatter read."""
    pieces, cur, cur_n, off = [], [], 0, 0
    for view in views:
        pos = 0
        while pos < len(view):
            take = min(len(view) - pos, limit - cur_n)
            cur.append(view[pos:pos + take])
            cur_n += take
            pos += take
            if cur_n == limit or len(cur) == _IOV_MAX:
                pieces.append((off, cur))
                off, cur, cur_n = off + cur_n, [], 0
    if cur:
        pieces.append((off, cur))
    return pieces


def _pread_full(fd: int, offset: int, views: List[memoryview], name: str) -> None:
    """Fill ``views`` in turn from ``offset`` on (a short read goes on)."""
    views = list(views)
    while views:
        k = os.preadv(fd, views, offset)
        if not k:
            raise EOFError(f"{name}: short blob")
        offset += k
        while views and k >= len(views[0]):
            k -= len(views[0])
            views.pop(0)
        if k:
            views[0] = views[0][k:]


@dataclasses.dataclass
class FlashSpec:
    """Simulated Flash characteristics (defaults ~ UFS 4.0 mid-range, the
    reference's)."""
    bandwidth_bytes_per_s: float = 1e9      # paper assumes ~1 GB/s continuous
    latency_s: float = 15e-6                # paper: ~15us slower than LPDDR5X
    simulate: bool = True                   # throttle reads to the above


class FlashStore:
    """Directory of memmap'd arrays; counts the bytes read and written
    and, under a simulating ``spec``, the seconds the throttle charged
    (from any thread)."""

    def __init__(self, root: str, spec: Optional[FlashSpec] = None):
        self.root = root
        self.spec = spec or FlashSpec()
        os.makedirs(root, exist_ok=True)
        self._maps: Dict[str, np.memmap] = {}
        self._count = threading.Lock()
        self.bytes_read = 0
        self.bytes_written = 0
        self.read_time_s = 0.0
        self._owed = 0.0          # seconds charged and not yet slept (< 0: credit)

    def path(self, name: str) -> str:
        return os.path.join(self.root, name + ".bin")

    def _throttle(self, nbytes: int) -> None:
        """Charge one read's latency plus ``nbytes`` over the bandwidth (a
        zero-byte read still pays the latency) to ``read_time_s``, and sleep
        it off.  A sleep pays the store's running debt, not the read's own
        time: where a host's sleeps overshoot (~1 ms a call on the card's
        machine, whose timers are coarse) the reference's sleep a read
        stretches an 80-us read to ~1 ms, so the overshoot is kept as
        credit against the next reads, and a run waits the seconds it is
        charged, to within one sleep's overshoot."""
        if not self.spec.simulate:
            return
        t = self.spec.latency_s + nbytes / self.spec.bandwidth_bytes_per_s
        with self._count:
            self.read_time_s += t
            owed = self._owed + t
            self._owed = min(owed, 0.0)       # a positive debt is slept below
        if owed <= 0:
            return
        t0 = time.perf_counter()
        time.sleep(owed)
        over = time.perf_counter() - t0 - owed
        with self._count:
            self._owed -= over

    def _read(self, nbytes: int) -> None:
        with self._count:
            self.bytes_read += nbytes
        self._throttle(nbytes)

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

    def read_slice(self, name: str, start: int, stop: int) -> np.ndarray:
        """Rows [start, stop) along axis 0, clamped as a numpy slice is."""
        out = np.asarray(self._maps[name][start:stop])
        self._read(out.nbytes)
        return out

    def read_all(self, name: str) -> np.ndarray:
        """One whole stored array."""
        out = np.asarray(self._maps[name])
        self._read(out.nbytes)
        return out

    def read_view(self, name: str) -> np.memmap:
        """A whole stored array as its memmap (no host copy), counted as
        read."""
        mm = self._maps[name]
        self._read(mm.nbytes)
        return mm

    def write_blob(self, name: str,
                   arrays: Sequence[np.ndarray]) -> concurrent.futures.Future:
        """Write the arrays' bytes back to back as one file, on an I/O
        thread: the bytes are counted at once, the future ends with the
        write (the caller keeps ``arrays`` as they are until then)."""
        with self._count:
            self.bytes_written += sum(int(a.nbytes) for a in arrays)
        return _io_pool().submit(self._write_file, self.path(name), arrays)

    @staticmethod
    def _write_file(path: str, arrays: Sequence[np.ndarray]) -> None:
        with open(path, "wb") as f:
            for a in arrays:
                f.write(memoryview(np.ascontiguousarray(a)).cast("B"))

    def read_blob_into(self, name: str, outs: Sequence[np.ndarray]) -> None:
        """Fill the byte arrays ``outs`` in turn from one file that
        ``write_blob`` wrote, in pieces read in parallel."""
        views = [memoryview(out).cast("B") for out in outs]
        fd = os.open(self.path(name), os.O_RDONLY)
        try:
            _run_all(lambda off, run: _pread_full(fd, off, run, name),
                     _pieces(views, IO_PIECE_BYTES))
        finally:
            os.close(fd)
        self._read(sum(len(v) for v in views))

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
        row_bytes = dim * np.dtype(np.uint16).itemsize
        pending: list = []
        with open(flash.path(name), "wb") as f:
            f.truncate(rows * row_bytes)
            try:
                for start in range(0, rows, EXPORT_CHUNK_ROWS):
                    stop = min(rows, start + EXPORT_CHUNK_ROWS)
                    chunk = fill(start, stop).to(torch.bfloat16).view(torch.int16)
                    data = memoryview(chunk.cpu().numpy()).cast("B")
                    # the next chunk is made while this one is written
                    pending.append(_io_pool().submit(_pwrite_full, f.fileno(), data,
                                                     start * row_bytes))
                    if len(pending) > 2:
                        pending.pop(0).result()
            finally:
                concurrent.futures.wait(pending)
            for w in pending:
                w.result()
        flash.open(name, (rows, dim), np.uint16)
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
    never asked ahead starts no thread).  It makes no CUDA stream call: a
    load reads files into host memory, which ``WeightGroupStore`` takes
    pinned from PyTorch's caching host allocator (the consumer's copy out
    of it records the event that keeps the buffer until the copy has run).
    After ``close()`` requests are ignored and every fetch reads
    synchronously."""

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


@dataclasses.dataclass
class SpillBlock:
    layer: int
    start: int            # token offset of this block
    length: int


class KVSpillManager(_FlashPrefetcher):
    """Spill the oldest KV blocks of each layer to Flash; prefetch ahead
    (paper §4.1, the reference's).  The decode loop calls, per layer:

        mgr.prefetch_async(layer + 1)        # overlaps with layer's compute
        hist = mgr.gather(layer)             # spilled K/V for this layer
        ... attention over [hist ++ device part] ...

    ``spill`` writes one block: key codes as ``k_dtype`` (int8), values as
    ``v_dtype`` (uint8: the fp8 e4m3 bits, since numpy has no fp8).
    ``gather`` concatenates a layer's blocks along the token axis in the
    order they were spilled; with none spilled it returns two empty 1-d
    arrays (and counts a miss), as the reference does.  Which blocks to
    spill, and when (the reference's ``dram_budget_tokens``), is the
    caller's choice: the class keeps the budget and the block length for
    it.  Blob names carry the manager's id, so managers and the other
    stores share one Flash root; ``drop_all`` stops the worker and deletes
    every block."""

    def __init__(self, flash: FlashStore, num_layers: int, kv_heads: int,
                 head_dim: int, *, dram_budget_tokens: int,
                 block_tokens: int = 128,
                 k_dtype=np.int8, v_dtype=np.uint8):
        self.flash = flash
        self.num_layers = num_layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.dram_budget_tokens = dram_budget_tokens
        self.block_tokens = block_tokens
        self.k_dtype = k_dtype
        self.v_dtype = v_dtype
        self.blocks: Dict[int, List[SpillBlock]] = {i: [] for i in range(num_layers)}
        super().__init__()

    def _name(self, layer: int, start: int) -> str:
        return f"kv{id(self):x}_l{layer}_s{start}"

    def spill(self, layer: int, k_block: np.ndarray, v_block: np.ndarray,
              start: int) -> None:
        """Write one KV block (shape [B, block, H, D]) to Flash."""
        blk = SpillBlock(layer=layer, start=start, length=k_block.shape[1])
        name = self._name(layer, start)
        self.flash.put(name + "_k", np.ascontiguousarray(k_block, dtype=self.k_dtype))
        self.flash.put(name + "_v", v_block.view(self.v_dtype)
                       if v_block.dtype != self.v_dtype else v_block)
        with self._lock:
            self.blocks[layer].append(blk)
            self._cache.pop(layer, None)      # stale

    def spilled_tokens(self, layer: int) -> int:
        return sum(b.length for b in self.blocks[layer])

    def _load(self, layer: int) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            blocks = list(self.blocks[layer])
        ks, vs = [], []
        for b in blocks:
            name = self._name(layer, b.start)
            ks.append(self.flash.read_all(name + "_k"))
            vs.append(self.flash.read_all(name + "_v"))
        if not ks:
            return (np.zeros((0,), self.k_dtype), np.zeros((0,), self.v_dtype))
        return np.concatenate(ks, axis=1), np.concatenate(vs, axis=1)

    def _has(self, layer: int) -> bool:
        return bool(self.blocks[layer])

    def prefetch_async(self, layer: int) -> None:
        self._request(layer % self.num_layers)

    def gather(self, layer: int) -> Tuple[np.ndarray, np.ndarray]:
        """Spilled K/V for ``layer`` (blocking on an in-flight prefetch; a
        synchronous load on a miss)."""
        return self._obtain(layer)

    def drop_all(self) -> None:
        """Stop the worker and delete every spilled block from Flash."""
        self.close()
        with self._lock:
            for layer, blocks in self.blocks.items():
                for b in blocks:
                    name = self._name(layer, b.start)
                    self.flash.delete(name + "_k")
                    self.flash.delete(name + "_v")
                blocks.clear()
            self._cache.clear()


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


# ---------------------------------------------------------------------------
# the weight groups of streamed stacks
# ---------------------------------------------------------------------------

# byte alignment of every leaf in a host buffer and a device ring slot
WEIGHT_ALIGN = 256


def _spec_nbytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize


def leaf_offsets(specs: Sequence[Tuple[tuple, torch.dtype]]) -> Tuple[List[int], int]:
    """Byte offsets of leaves ``specs`` ((shape, dtype) each) laid out in
    order, each on a ``WEIGHT_ALIGN`` boundary, and the layout's size."""
    offsets, end = [], 0
    for shape, dtype in specs:
        start = -(-end // WEIGHT_ALIGN) * WEIGHT_ALIGN
        offsets.append(start)
        end = start + _spec_nbytes(shape, dtype)
    return offsets, -(-end // WEIGHT_ALIGN) * WEIGHT_ALIGN


def leaf_views(buf: torch.Tensor, specs, offsets) -> List[torch.Tensor]:
    """Typed views of the leaves laid out in the byte tensor ``buf``."""
    return [buf[o:o + _spec_nbytes(shape, dtype)].view(dtype).view(shape)
            for (shape, dtype), o in zip(specs, offsets)]


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes on the host as a flat numpy array (bf16 as its
    bits: numpy has no bf16)."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()


class WeightBlob:
    """One fetched weight blob: the host byte buffer (pinned when the store
    pins) and a typed view of each leaf in it."""

    def __init__(self, buffer: torch.Tensor, leaves: List[torch.Tensor]):
        self.buffer = buffer
        self.leaves = leaves


class WeightGroupStore(_FlashPrefetcher):
    """Per-layer weight groups of streamed stacks on Flash, as the
    reference's: at engine build time each streamed stack is exported one
    layer group at a time (``put_group``), an expert-granular MoE stack's
    expert tables one expert at a time (``put_expert_group``; the group's
    blob then holds its shared leaves only: router, norms, attention).  At
    serve time the loop prefetches the next group while one computes.

    Keys are ``(stack, group)`` and ``(stack, group, expert)``.  A fetch
    returns a ``WeightBlob`` whose leaves come in the order they were put;
    its buffer is read in the worker (a hit moves no byte on the consumer's
    thread), pinned when ``pin_memory``.  Blob names carry the store's id,
    so stores and the page spill tier share one Flash root."""

    def __init__(self, flash: FlashStore, pin_memory: bool = False):
        self.flash = flash
        self.pin_memory = pin_memory
        self._names: Dict[tuple, str] = {}
        self._specs: Dict[tuple, list] = {}
        self._group_nbytes: Dict[tuple, int] = {}
        self._writes: Dict[tuple, concurrent.futures.Future] = {}
        super().__init__()

    # -- export (engine build time) -----------------------------------------
    def _put(self, key: tuple, name: str, tensors: Sequence[torch.Tensor]) -> None:
        """Copy the leaves to the host and hand their blob to a writer
        thread; ``flush`` (or a fetch of the key) waits for the write."""
        name = f"wgrp{id(self):x}_{name}"
        arrays = [_host_bytes(t) for t in tensors]
        self._wait_written(key)
        with self._lock:
            oldest = next(iter(self._writes), None) \
                if len(self._writes) >= EXPORT_PENDING else None
        if oldest is not None:
            self._wait_written(oldest)
        write = self.flash.write_blob(name, arrays)
        with self._lock:
            self._writes[key] = write
            self._names[key] = name
            self._specs[key] = [(tuple(t.shape), t.dtype) for t in tensors]
            self._group_nbytes[key] = sum(int(a.nbytes) for a in arrays)
            self._cache.pop(key, None)          # stale

    def put_group(self, stack: int, group: int,
                  tensors: Sequence[torch.Tensor]) -> None:
        """Persist one layer group's leaves (an expert-granular stack's
        shared leaves only)."""
        self._put((stack, group), f"s{stack}_g{group}", tensors)

    def put_expert_group(self, stack: int, group: int, expert: int,
                         tensors: Sequence[torch.Tensor]) -> None:
        """Persist ONE expert's slice of one layer group's expert tables."""
        self._put((stack, group, expert), f"s{stack}_g{group}_e{expert}", tensors)

    def _wait_written(self, key: tuple) -> None:
        with self._lock:
            write = self._writes.pop(key, None)
        if write is not None:
            write.result()

    def flush(self) -> None:
        """Wait until every blob put so far is on Flash (raising a failed
        write's error)."""
        with self._lock:
            writes, self._writes = list(self._writes.values()), {}
        concurrent.futures.wait(writes)
        for w in writes:
            w.result()

    # -- prefetch pump -------------------------------------------------------
    def _load(self, key: tuple) -> WeightBlob:
        self._wait_written(key)
        with self._lock:
            name, specs = self._names[key], self._specs[key]
        offsets, total = leaf_offsets(specs)
        buf = torch.empty((total,), dtype=torch.uint8, pin_memory=self.pin_memory)
        host = buf.numpy()
        self.flash.read_blob_into(name, [host[o:o + _spec_nbytes(*sp)]
                                         for sp, o in zip(specs, offsets)])
        return WeightBlob(buf, leaf_views(buf, specs, offsets))

    def _has(self, key: tuple) -> bool:
        return key in self._names

    def prefetch_group(self, stack: int, group: int) -> None:
        """Queue group (stack, group) for a background read."""
        self._request((stack, group))

    def fetch_group(self, stack: int, group: int) -> WeightBlob:
        """One group's leaves (blocking on an in-flight prefetch; a
        synchronous Flash read on a miss)."""
        return self._obtain((stack, group))

    def prefetch_expert(self, stack: int, group: int, expert: int) -> None:
        """Queue one expert's slice of a group for a background read."""
        self._request((stack, group, expert))

    def fetch_expert(self, stack: int, group: int, expert: int) -> WeightBlob:
        """One expert slice's leaves (blocking on an in-flight prefetch; a
        synchronous Flash read on a cold-expert miss)."""
        return self._obtain((stack, group, expert))

    # -- accounting ----------------------------------------------------------
    def group_nbytes(self, stack: int, group: int = 0) -> int:
        return self._group_nbytes.get((stack, group), 0)

    def expert_nbytes(self, stack: int, group: int = 0, expert: int = 0) -> int:
        return self._group_nbytes.get((stack, group, expert), 0)

    def stack_nbytes(self, stack: int) -> int:
        return sum(n for k, n in self._group_nbytes.items() if k[0] == stack)

    @property
    def total_nbytes(self) -> int:
        return sum(self._group_nbytes.values())

    def groups(self) -> list:
        with self._lock:
            return sorted(self._names)

    def drop_all(self) -> None:
        """Stop the worker and delete every blob from Flash."""
        self.close()
        self.flush()
        with self._lock:
            for name in self._names.values():
                self.flash.delete(name)
            self._names.clear()
            self._specs.clear()
            self._group_nbytes.clear()
            self._cache.clear()


def plan_embedding_placement(param_sizes: Dict[str, int],
                             dram_budget_bytes: int) -> Dict[str, str]:
    """The paper's placement policy, utilization-ordered: the embedding
    (1/vocab of it read a step) goes to Flash first; the layers and
    ``lm_head`` (read whole every step) stay in DRAM while they fit."""
    def utilization(name: str) -> int:
        return 0 if "embedding" in name else 1
    placement: Dict[str, str] = {}
    used = 0
    for name in sorted(param_sizes, key=utilization, reverse=True):
        sz = param_sizes[name]
        if used + sz <= dram_budget_bytes:
            placement[name] = "dram"
            used += sz
        else:
            placement[name] = "flash"
    return placement
