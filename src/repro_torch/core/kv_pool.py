"""Block-paged quantized KV pool — port of ``repro.core.kv_pool`` (the
full-attention pool, the sliding-window rings, their reference attention,
and the host allocator).

* ``PagedLayerKV`` — the page pools of a stack of layers: ``k_q`` int8
  ``[L, P, page, H_kv, D]``, ``k_scale``/``k_zero`` float32
  ``[L, P, page, H_kv]``, ``v`` fp8 ``[L, P, page, H_kv, D]``.  Page
  ``num_pages`` is the trash page (table entries of unallocated logical
  pages point at it); the reference's staging reserve sits past it.
  Unlike the reference's immutable arrays, appends write the pool in
  place — the pool is the largest device allocation and is never copied.
* Sliding-window layers keep a fixed ring of ``ppw`` pages per row instead
  (``pages_per_window``): position p lives in ring page ``(p // page) %
  ppw`` of its row, so the oldest page is recycled by the index alone and
  no table is needed.  A ring pool has one spare ring past the rows'
  rings: the writes of rows outside a decode step and of a chunk's padded
  tail land in its first page, the trash page (the reference rolls such
  writes back instead, ``transformer.freeze_inactive_rows``; the bytes are
  the same), and a warm-up chunk aimed at row ``batch`` writes only there.
* ``KVPoolManager`` — the host-side allocator, with the reference's
  deterministic free list, page refcounts, SHA-256 token-hash prefix index
  and Flash residency machine (spill / stage / commit / unstage / restore,
  the LIFO staging free list and its LRU), so allocation, adoption and
  staging follow the reference page id for page id.
* ``read_pages`` / ``write_pages`` — the device side of the spill tier:
  every layer's bytes of some physical pages to host arrays and back, in
  place on the pool tensors (a CUDA graph keeps reading the same storage).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.core import quantization as q
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import quant_attention as QA


@dataclasses.dataclass(frozen=True)
class PoolGeometry:
    """``page_size`` tokens per page, ``num_pages`` allocatable pages (the
    trash page is extra), ``pages_per_row`` table width, ``staging_pages``
    the staging reserve past the trash page: device pages that Flash-resident
    cold pages are gathered into before the paged kernels run."""
    page_size: int
    num_pages: int
    pages_per_row: int
    staging_pages: int = 0

    @property
    def trash_page(self) -> int:
        return self.num_pages

    @property
    def staging_base(self) -> int:
        """First staging page id: [staging_base, staging_base + staging_pages)."""
        return self.num_pages + 1

    @property
    def total_device_pages(self) -> int:
        return self.num_pages + 1 + self.staging_pages

    @property
    def max_seq(self) -> int:
        return self.page_size * self.pages_per_row

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)


@dataclasses.dataclass(frozen=True)
class SpillPolicy:
    """Proactive-spill knobs (``plan.kv_spill_policy``): the staging reserve
    (a row's cap on Flash-resident pages), the trailing full pages a row
    keeps in DRAM, the free-page watermarks that start and stop the spill,
    and the cap on pages resident on Flash."""
    staging_pages: int
    hot_pages: int
    low_watermark: int
    high_watermark: int
    flash_budget_pages: int


# Per-(row, logical page) residency states of the spill tier.
RES_DRAM, RES_FLASH, RES_INFLIGHT, RES_STAGED = range(4)


def pages_per_window(window: int, page_size: int) -> int:
    """Ring length (in pages) for a sliding-window layer.  One extra page
    beyond ceil(window/page) keeps a key from being recycled while the
    window mask can still reach it (the newest page is partially filled)."""
    if window % page_size == 0:
        return window // page_size + 1
    return window // page_size + 2


@dataclasses.dataclass
class PagedLayerKV:
    """Page pools of one layer, or of a stack of layers (leading [L] axis);
    ``layer(i)`` is a view of layer i's pools."""
    k_q: torch.Tensor
    k_scale: torch.Tensor
    k_zero: torch.Tensor
    v: torch.Tensor
    window: int = 0
    key_bits: int = 8
    staging: int = 0
    ppw: int = 0                      # pages per window ring (window > 0)

    @property
    def page_size(self) -> int:
        return self.k_q.shape[-3]

    @property
    def num_pages(self) -> int:
        return self.k_q.shape[-4]

    @property
    def ring_trash(self) -> int:
        """A ring pool's trash page: the first of the spare ring past every
        row's ring."""
        return self.num_pages - self.ppw

    def ring_pages(self, slot: int) -> List[int]:
        """The physical pages of row ``slot``'s ring, in ring-lane order."""
        return list(range(slot * self.ppw, (slot + 1) * self.ppw))

    def layer(self, i: int) -> "PagedLayerKV":
        return PagedLayerKV(self.k_q[i], self.k_scale[i], self.k_zero[i],
                            self.v[i], window=self.window,
                            key_bits=self.key_bits, staging=self.staging,
                            ppw=self.ppw)


def init_paged_layer(geom: PoolGeometry, kv_heads: int, head_dim: int, *,
                     layers: int = 0, batch: int = 0, window: int = 0,
                     key_bits: int = 8, value_fp8: bool = True,
                     device: torch.device = torch.device("cpu")) -> PagedLayerKV:
    """Zero-initialized pool (scales start at 1, as in the reference):
    ``geom.total_device_pages`` pages for full attention; for a window, a
    ring of ``ppw`` pages for each of ``batch`` rows and the spare ring."""
    ps = geom.page_size
    ppw = pages_per_window(window, ps) if window else 0
    pages = (batch + 1) * ppw if window else geom.total_device_pages
    kd = head_dim // 2 if key_bits == 4 else head_dim
    lead = (layers,) if layers else ()
    vdt = q.FP8_DTYPE if value_fp8 else torch.bfloat16
    return PagedLayerKV(
        k_q=torch.zeros((*lead, pages, ps, kv_heads, kd), dtype=torch.int8,
                        device=device),
        k_scale=torch.ones((*lead, pages, ps, kv_heads), dtype=torch.float32,
                           device=device),
        k_zero=torch.zeros((*lead, pages, ps, kv_heads), dtype=torch.float32,
                           device=device),
        v=torch.zeros((*lead, pages, ps, kv_heads, head_dim), dtype=vdt,
                      device=device),
        window=window, key_bits=key_bits, ppw=ppw,
        staging=0 if window else geom.staging_pages)


def _write(pool: PagedLayerKV, page, off, kq, ks, kz, v_cast) -> None:
    pool.k_q[page, off] = kq
    pool.k_scale[page, off] = ks
    pool.k_zero[page, off] = kz
    pool.v[page, off] = v_cast


def append_paged(pool: PagedLayerKV, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor, table: Optional[torch.Tensor],
                 active: Optional[torch.Tensor] = None) -> None:
    """Append one decode token per row (k_new/v_new [B, 1, Hkv, D]) at
    per-row positions ``pos`` [B], in place.  Full-attention pools write
    through ``table`` [B, pages_per_row] (rows masked to the trash page
    write there); a ring pool writes row b's ring page of the position,
    and the rows outside ``active`` [B] (None: every row) write its trash
    page, so their rings keep the bytes the reference's rollback leaves."""
    b, t = k_new.shape[:2]
    if t != 1:
        raise ValueError("paged append is the decode hot path (one token per row)")
    ps = pool.page_size
    kq, ks, kz = kvc.quantize_keys(k_new, bits=pool.key_bits)
    v_cast = kvc.cast_values(v_new, pool.v.dtype)
    pos = pos.long()
    rows = torch.arange(b, device=pos.device)
    if pool.window:
        page = rows * pool.ppw + (pos // ps) % pool.ppw
        if active is not None:
            page = torch.where(active, page, torch.full_like(page, pool.ring_trash))
    else:
        page = table[rows, pos // ps].long()
    off = pos % ps
    _write(pool, page, off, kq[:, 0], ks[:, 0], kz[:, 0], v_cast[:, 0])


def device_scalar(value, device: torch.device) -> torch.Tensor:
    """An int as an int32 tensor [1] on ``device``, filled in on the device
    (no copy from the host); a one-element tensor (the device scalar a CUDA
    graph reads) passes through."""
    if torch.is_tensor(value):
        return value.reshape(1).to(torch.int32)
    return torch.full((1,), int(value), dtype=torch.int32, device=device)


def ring_view(pool: PagedLayerKV, pos: torch.Tensor, batch: int):
    """A windowed pool's per-row rings as (table int32 [B, ppw], base int32
    [B]) in logical page order for rows holding ``pos`` [B] (or one scalar)
    tokens: table column j is the ring page of logical page base + j.
    ``base`` is negative while a row holds fewer than ppw pages; those
    positions are masked."""
    ppw, ps = pool.ppw, pool.page_size
    pos = torch.as_tensor(pos, device=pool.k_q.device).to(torch.int32)
    if pos.dim() == 0:
        pos = pos.expand(batch)
    cur = torch.clamp(pos - 1, min=0) // ps
    base = cur - (ppw - 1)
    rows = torch.arange(batch, device=pos.device, dtype=torch.int32)[:, None]
    lanes = torch.arange(ppw, device=pos.device, dtype=torch.int32)[None]
    table = rows * ppw + torch.remainder(base[:, None] + lanes, ppw)
    return table.to(torch.int32).contiguous(), base.contiguous()


def append_paged_prompt(pool: PagedLayerKV, k_new: torch.Tensor,
                        v_new: torch.Tensor, pos0,
                        table_row: Optional[torch.Tensor] = None, slot=None,
                        valid_len=None) -> None:
    """Append a C-token prompt chunk for ONE row (k_new/v_new [1, C, Hkv,
    D]) at positions [pos0, pos0 + C), in place; quantization matches the
    decode append bit for bit.  ``pos0``, ``slot`` and ``valid_len`` are
    ints or one-element device tensors.  Full-attention pools write
    through ``table_row`` [pages_per_row] (positions past the table land
    in the trash page).  A ring pool writes row ``slot``'s ring and keeps
    only the first ``valid_len`` tokens of a padded chunk (a padded
    position would wrap onto a ring page holding a live key): each ring
    page receives the newest logical page that maps to it, tokens of an
    older page on the same ring page (a chunk longer than the ring) and
    the padded tail go to the trash page -- the reference's winner
    selection, with distinct targets for every kept token."""
    b, C = k_new.shape[:2]
    if b != 1:
        raise ValueError("prompt chunks are per-row (B=1)")
    ps = pool.page_size
    kq, ks, kz = kvc.quantize_keys(k_new, bits=pool.key_bits)
    v_cast = kvc.cast_values(v_new, pool.v.dtype)
    dev = k_new.device
    positions = device_scalar(pos0, dev).long() + torch.arange(C, device=dev)
    if pool.window:
        vl = C if valid_len is None else device_scalar(valid_len, dev).long()
        logical = positions // ps
        cur = torch.clamp(positions[0] + vl - 1, min=0) // ps
        keep = (torch.arange(C, device=dev) < vl) & (logical > cur - pool.ppw)
        page = device_scalar(slot, dev).long() * pool.ppw + logical % pool.ppw
        page = torch.where(keep, page, torch.full_like(page, pool.ring_trash))
        _write(pool, page, positions % ps, kq[0], ks[0], kz[0], v_cast[0])
        return
    logical = positions // ps
    n_p = table_row.shape[0]
    trash = pool.num_pages - 1 - pool.staging
    page = torch.where(logical < n_p,
                       table_row[logical.clamp(0, n_p - 1)].long(),
                       torch.full_like(logical, trash))
    _write(pool, page, positions % ps, kq[0], ks[0], kz[0], v_cast[0])


def gather_pages(pool: PagedLayerKV, table: torch.Tensor):
    """Page-table-indexed dense view [B, n_pages*page, ...] of each field."""
    return tuple(QA.gather_rows(x, table)
                 for x in (pool.k_q, pool.k_scale, pool.k_zero, pool.v))


KV_FIELDS = ("k_q", "k_scale", "k_zero", "v")


def _bytes_view(x: torch.Tensor) -> torch.Tensor:
    """fp8 and bf16 have no numpy dtype: their bytes travel as uint8 and
    int16."""
    if x.dtype == q.FP8_DTYPE:
        return x.view(torch.uint8)
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def read_pages(pool: PagedLayerKV, phys: Sequence[int]) -> Dict[str, np.ndarray]:
    """Every layer's bytes of physical pages ``phys`` of a stacked pool, as
    host arrays [L, len(phys), page, ...] by field (fp8 values as uint8,
    bf16 values as int16).  On
    the card the pages are gathered on the device and copied into pinned
    memory without blocking, then the host waits once for the stream: the
    bytes are those of every kernel enqueued before."""
    on_card = pool.k_q.device.type == "cuda"
    out = {}
    for f in KV_FIELDS:
        x = _bytes_view(getattr(pool, f))
        g = (torch.stack([x[:, int(p)] for p in phys], 1) if len(phys)
             else x[:, :0])
        host = torch.empty(g.shape, dtype=g.dtype, pin_memory=on_card)
        host.copy_(g, non_blocking=True)
        out[f] = host
    if on_card:
        torch.cuda.current_stream(pool.k_q.device).synchronize()
    return {f: t.numpy() for f, t in out.items()}


def write_pages(pool: PagedLayerKV, phys: Sequence[int],
                arrays: Dict[str, np.ndarray]) -> None:
    """Write host arrays [L, len(phys), page, ...] (as ``read_pages`` gives
    them) into physical pages ``phys`` of a stacked pool, in place.  On the
    card the bytes go through pinned memory in one non-blocking copy a field
    on the current stream, then into each page: the host does not wait, and
    PyTorch's pinned allocator holds each buffer until its copy has run."""
    on_card = pool.k_q.device.type == "cuda"
    for f in KV_FIELDS:
        x = _bytes_view(getattr(pool, f))
        src = arrays[f]
        if src.shape[:2] != (x.shape[0], len(phys)) or src.shape[2:] != x.shape[2:]:
            raise ValueError(f"{f}: {src.shape} for {len(phys)} pages of {tuple(x.shape)}")
        host = torch.empty(src.shape, dtype=x.dtype, pin_memory=on_card)
        if host.numpy().dtype != src.dtype:
            raise ValueError(f"{f}: {src.dtype} bytes for a {x.dtype} pool")
        host.numpy()[...] = src
        staged = host.to(x.device, non_blocking=True)
        for j, p in enumerate(phys):
            x[:, int(p)].copy_(staged[:, j])


def paged_prefill_attention_ref(qh: torch.Tensor, pool: PagedLayerKV,
                                table: torch.Tensor, pos0,
                                policy: PrecisionPolicy = DEFAULT_POLICY
                                ) -> torch.Tensor:
    """Chunk prefill attention through the page table (reference path):
    qh [1, C, H, D] pre-scaled at absolute positions [pos0, pos0 + C)
    (``pos0`` an int or a one-element tensor); table [1, pages_per_row].
    Returns the compute dtype."""
    pos0 = device_scalar(pos0, qh.device).expand(qh.shape[0]).contiguous()
    out = FP.paged_flash_prefill_attention_plain(
        qh, pool.k_q, pool.k_scale, pool.k_zero, pool.v, table, pos0,
        key_bits=pool.key_bits, policy=policy)
    return out.to(policy.compute_dtype)


def paged_prefill_window_ref(qh: torch.Tensor, pool: PagedLayerKV, slot, pos0,
                             valid_len, window: int, n_pages: int,
                             policy: PrecisionPolicy = DEFAULT_POLICY
                             ) -> torch.Tensor:
    """Chunk prefill attention over row ``slot``'s ring (the reference's
    ``kv_pool.paged_prefill_window_ref``): qh [1, C, H, D] pre-scaled at
    absolute positions [pos0, pos0 + C), the chunk's K/V already appended,
    ``valid_len`` real tokens; ``n_pages`` the row's logical page capacity.

    Each live ring page goes back to its logical place -- position p at
    view index p, the dense layout -- in an [n_pages * page] view whose
    other pages are zero, and the blockwise ``flash_attention`` runs over
    it with the window and the chunk's query offset.  Every position a
    chunk query can reach is still in the ring while chunks are at most
    one page (``plan.prefill_chunk_schedule``); every other view position
    is causally dead or out of the window, an exact no-op of the online
    softmax.  ``slot``, ``pos0`` and ``valid_len`` may be one-element
    device tensors: the view is built by device index arithmetic and every
    K block runs under device masks, so the host never waits and a CUDA
    graph can capture the call.  This path has no TPU kernel in the
    reference (its paged kernel refuses windowed pools); it runs as plain
    PyTorch on the card too.  Returns the compute dtype."""
    ppw, ps = pool.ppw, pool.page_size
    dev = qh.device
    pos0 = device_scalar(pos0, dev)
    lanes = torch.arange(ppw, device=dev)
    ring = device_scalar(slot, dev).long() * ppw + lanes            # [ppw]
    end = pos0.long() + device_scalar(valid_len, dev).long()
    cur = torch.clamp(end - 1, min=0) // ps                          # newest page
    group = cur - torch.remainder(cur - lanes, ppw)                  # lane -> page
    # lanes whose page is not yet written (negative) go to a spare page
    dst = torch.where(group >= 0, group, torch.full_like(group, n_pages))

    def to_logical(x: torch.Tensor) -> torch.Tensor:
        pages = _bytes_view(x).index_select(0, ring)                 # [ppw, ps, ...]
        out = torch.zeros((n_pages + 1, *pages.shape[1:]), dtype=pages.dtype,
                          device=dev)
        out.index_copy_(0, dst, pages)
        return out[:n_pages].reshape(1, n_pages * ps, *pages.shape[2:]).view(x.dtype)

    k = kvc.dequantize_keys(to_logical(pool.k_q), to_logical(pool.k_scale),
                            to_logical(pool.k_zero), policy.compute_dtype,
                            bits=pool.key_bits)
    v = to_logical(pool.v).to(policy.compute_dtype)
    return FP.flash_attention(qh, k, v, causal=True, window=window, q_offset=pos0,
                              policy=policy)


def paged_decode_attention_ref(qh: torch.Tensor, pool: PagedLayerKV,
                               table: torch.Tensor, base: Optional[torch.Tensor],
                               pos: torch.Tensor,
                               policy: PrecisionPolicy = DEFAULT_POLICY
                               ) -> torch.Tensor:
    """One-token attention over the paged pool (reference path): qh
    [B, 1, H, D] pre-scaled; ``pos`` [B] live lengths; ``base`` the logical
    page of table column 0 (None => 0).  Returns the compute dtype."""
    B, T = qh.shape[:2]
    if T != 1:
        raise ValueError("paged decode attends one query token per row")
    if base is None:
        base = torch.zeros((B,), dtype=torch.int32, device=qh.device)
    out = QA.paged_quant_decode_attention_plain(
        qh[:, 0], pool.k_q, pool.k_scale, pool.k_zero, pool.v, table, base,
        pos, window=pool.window, key_bits=pool.key_bits,
        compute_dtype=policy.compute_dtype)
    return out[:, None].to(policy.compute_dtype)


class KVPoolManager:
    """Free-list page allocator + page-table bookkeeping (host side), a
    copy of the reference's: deterministic allocation (low page ids
    first), allocate-on-append, refcounted copy-free reclaim, and the
    token-hash chain prefix index (full prompt pages registered after
    prefill hold one pin each and are adopted copy-free by later prompts
    with the same prefix, capped before the prompt's last token; pins are
    evicted newest-first when the free list runs short).

    The spill tier: every (row, logical page) has a residency — RES_DRAM
    (``row_pages`` holds its pool page), RES_FLASH (bytes on Flash only;
    ``row_pages`` holds -1 and the table the trash page), RES_INFLIGHT (a
    staging copy is under way; still the trash page) or RES_STAGED (bytes in
    one of the ``geom.staging_pages`` staging pages, which the table names,
    so the kernels read it like any page).  Only full, single-owner pages
    outside a row's hot tail spill; they are immutable, so the Flash copy is
    authoritative and staging is a cache (``unstage`` writes nothing back).
    ``spilled_pages`` counts pages of preempted rows on Flash."""

    def __init__(self, geom: PoolGeometry, num_slots: int,
                 prefix_sharing: bool = True):
        self.geom = geom
        self.num_slots = num_slots
        self.prefix_sharing = prefix_sharing
        self._free: List[int] = list(range(geom.num_pages - 1, -1, -1))
        self.table = np.full((num_slots, geom.pages_per_row),
                             geom.trash_page, np.int32)
        self.row_pages: List[List[int]] = [[] for _ in range(num_slots)]
        self.row_pos = np.zeros(num_slots, np.int64)
        self.refcount = np.zeros(geom.num_pages, np.int64)
        self._page_of_chain: Dict[bytes, int] = {}
        self._chain_of_page: Dict[int, bytes] = {}
        self._index_order: List[int] = []
        self.row_shared = np.zeros(num_slots, np.int64)
        self.spilled_pages = 0
        self.alloc_failures = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        # residency per (row, logical page); the staging reserve is a LIFO
        # free list of staging pages with an LRU over the staged ones
        self.row_res: List[List[int]] = [[] for _ in range(num_slots)]
        self._staging_free: List[int] = list(
            range(geom.staging_base + geom.staging_pages - 1,
                  geom.staging_base - 1, -1))
        self._staged: Dict[Tuple[int, int], int] = {}    # (row, idx) -> page
        self._stage_lru: List[Tuple[int, int]] = []      # oldest first
        self.cold_spills = 0

    # --- accounting --------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def reclaimable_pages(self) -> int:
        """Indexed pages held only by their index pin."""
        return sum(1 for p in self._chain_of_page if self.refcount[p] == 1)

    @property
    def available_pages(self) -> int:
        return len(self._free) + self.reclaimable_pages

    @property
    def pages_in_use(self) -> int:
        return self.geom.num_pages - len(self._free)

    def pages_for(self, tokens: int) -> int:
        return self.geom.pages_for(tokens)

    def pages_held(self, row: int) -> int:
        """Logical pages the row holds (DRAM and Flash)."""
        return len(self.row_pages[row])

    def dram_pages_held(self, row: int) -> int:
        return sum(1 for p in self.row_pages[row] if p >= 0)

    def flash_idxs(self, row: int) -> List[int]:
        """Logical pages of the row off DRAM (FLASH, IN_FLIGHT or STAGED):
        the pages a decode step must stage."""
        return [i for i, s in enumerate(self.row_res[row]) if s != RES_DRAM]

    def flash_pages_of(self, row: int) -> int:
        return len(self.flash_idxs(row))

    @property
    def flash_page_count(self) -> int:
        """Cold pages of running rows off DRAM (preempted rows' pages are
        counted in ``spilled_pages``)."""
        return sum(self.flash_pages_of(r) for r in range(self.num_slots))

    @property
    def staged_count(self) -> int:
        return len(self._staged)

    @property
    def staging_free(self) -> int:
        return len(self._staging_free)

    def residency(self) -> Dict[str, int]:
        return {"dram_pages": self.pages_in_use,
                "free_pages": self.free_pages,
                "flash_pages": self.spilled_pages + self.flash_page_count,
                "staged_pages": self.staged_count}

    # --- prefix index ------------------------------------------------------
    def _chain_keys(self, token_ids, salt: str) -> List[bytes]:
        """One key per full prompt page: a chained SHA-256 digest of
        (salt, every token through that page), over int64 token bytes."""
        ps = self.geom.page_size
        h = hashlib.sha256(("kv-prefix:" + salt).encode()).digest()
        out = []
        for i in range(len(token_ids) // ps):
            page = np.asarray(token_ids[i * ps:(i + 1) * ps], np.int64)
            h = hashlib.sha256(h + page.tobytes()).digest()
            out.append(h)
        return out

    def _shareable_pages(self, n_tokens: int) -> int:
        """Adoption cap: full pages covering at most tokens [0, T-1)."""
        return max(0, (int(n_tokens) - 1) // self.geom.page_size)

    def _lookup_chain(self, token_ids, salt: str) -> List[int]:
        if not self.prefix_sharing:
            return []
        pages = []
        cap = self._shareable_pages(len(token_ids))
        for key in self._chain_keys(token_ids, salt)[:cap]:
            p = self._page_of_chain.get(key)
            if p is None:
                break
            pages.append(p)
        return pages

    def probe_shared_pages(self, token_ids, salt: str = "") -> int:
        """Pages a fresh prompt would adopt from the index now."""
        return len(self._lookup_chain(token_ids, salt))

    def probe_admission_discount(self, token_ids, salt: str = "") -> int:
        """Adoptable pages another row still holds (refcount >= 2) — they
        cost an admission nothing."""
        return sum(1 for p in self._lookup_chain(token_ids, salt)
                   if self.refcount[p] >= 2)

    def retract_prompt_stats(self, row: int, tokens: int) -> None:
        """Undo a row's adoption statistics when its prefill restarts (the
        re-admission counts the same prompt again)."""
        if not self.prefix_sharing:
            return
        adopted = int(self.row_shared[row]) // self.geom.page_size
        self.prefix_hits -= adopted
        self.prefix_misses -= max(0, self._shareable_pages(tokens) - adopted)

    def register_prefix(self, row: int, token_ids, salt: str = "") -> int:
        """Index the row's full prompt pages; returns pages newly pinned
        (Flash-resident pages are never indexed)."""
        if not self.prefix_sharing:
            return 0
        pages = self.row_pages[row]
        pinned = 0
        for i, key in enumerate(self._chain_keys(token_ids, salt)):
            if key in self._page_of_chain or i >= len(pages):
                continue
            p = pages[i]
            if p < 0 or p in self._chain_of_page:
                continue
            self._page_of_chain[key] = p
            self._chain_of_page[p] = key
            self.refcount[p] += 1
            self._index_order.append(p)
            pinned += 1
        return pinned

    def _unpin(self, page: int) -> None:
        key = self._chain_of_page.pop(page)
        del self._page_of_chain[key]
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)
        self.prefix_evictions += 1

    def _reserve(self, need: int) -> bool:
        """Make ``need`` pages free, evicting index pins newest first."""
        while len(self._free) < need:
            victim = next((p for p in reversed(self._index_order)
                           if p in self._chain_of_page
                           and self.refcount[p] == 1), None)
            if victim is None:
                return False
            self._index_order.remove(victim)
            self._unpin(victim)
        return True

    # --- transitions -------------------------------------------------------
    def alloc_row(self, row: int, tokens: int, token_ids=None,
                  salt: str = "", flash_idxs=()) -> bool:
        """All-or-nothing allocation of the pages holding ``tokens``; with
        ``token_ids`` the longest indexed prefix is adopted copy-free and
        ``row_shared[row]`` records the adopted token count.
        ``flash_idxs``: logical pages that stay on Flash (a preempted row
        resuming with its cold pages there): no pool page for them, and
        their table entries stay on the trash page until staged."""
        if self.row_pages[row]:
            raise RuntimeError(f"row {row} still holds pages")
        total = self.pages_for(tokens)
        flash = set(int(i) for i in flash_idxs)
        if not all(0 <= i < total for i in flash):
            raise ValueError(f"Flash pages {sorted(flash)} outside {total}")
        shared = (self._lookup_chain(token_ids, salt)
                  if token_ids is not None else [])
        if shared and flash:
            raise ValueError("adoption and a Flash restore never mix")
        need = total - len(flash)
        for p in shared:                 # adoption refs BEFORE reserving
            self.refcount[p] += 1
        if not self._reserve(need - len(shared)):
            for p in shared:
                self.refcount[p] -= 1
            self.alloc_failures += 1
            return False
        fresh = [self._free.pop() for _ in range(need - len(shared))]
        for p in fresh:
            self.refcount[p] = 1
        it = iter(shared + fresh)
        pages, res = [], []
        for i in range(total):
            if i in flash:
                pages.append(-1)
                res.append(RES_FLASH)
                self.table[row, i] = self.geom.trash_page
            else:
                p = next(it)
                pages.append(p)
                res.append(RES_DRAM)
                self.table[row, i] = p
        self.row_pages[row] = pages
        self.row_res[row] = res
        self.row_shared[row] = len(shared) * self.geom.page_size
        self.prefix_hits += len(shared)
        if token_ids is not None:
            self.prefix_misses += self._shareable_pages(tokens) - len(shared)
        return True

    def ensure(self, row: int, pos: int) -> bool:
        """Allocate-on-append for an append at position ``pos``; False when
        the pool is out of pages (the engine spills and retries)."""
        idx = int(pos) // self.geom.page_size
        held = self.row_pages[row]
        if idx < len(held):
            return True
        if idx != len(held):
            raise RuntimeError(f"row {row}: append at {pos} skips a page")
        if not self._reserve(1):
            self.alloc_failures += 1
            return False
        page = self._free.pop()
        self.refcount[page] = 1
        held.append(page)
        self.row_res[row].append(RES_DRAM)
        self.table[row, idx] = page
        return True

    def free_row(self, row: int) -> int:
        """Refcount-decrement reclaim; staged and in-flight pages give back
        their staging page, Flash pages are forgotten (the engine drops
        their blobs by uid).  Returns pages actually freed."""
        pages = self.row_pages[row]
        freed = 0
        for i in reversed(range(len(pages))):
            p = pages[i]
            if p < 0:
                if self.row_res[row][i] in (RES_STAGED, RES_INFLIGHT):
                    key = (row, i)
                    self._staging_free.append(self._staged.pop(key))
                    self._stage_lru.remove(key)
                continue
            self.refcount[p] -= 1
            if self.refcount[p] < 0:
                raise RuntimeError(f"double free of page {p}")
            if self.refcount[p] == 0:
                self._free.append(p)
                freed += 1
        self.row_pages[row] = []
        self.row_res[row] = []
        self.table[row, :] = self.geom.trash_page
        self.row_pos[row] = 0
        self.row_shared[row] = 0
        return freed

    # --- the spill tier: residency transitions -----------------------------
    def cold_pages(self, row: int, hot_pages: int = 1) -> List[int]:
        """Spill candidates for one row, oldest first: full DRAM pages
        outside the trailing ``hot_pages`` owned by this row alone and not
        pinned by the prefix index."""
        full = int(self.row_pos[row]) // self.geom.page_size
        out = []
        for i in range(min(full - hot_pages, len(self.row_pages[row]))):
            if self.row_res[row][i] != RES_DRAM:
                continue
            p = self.row_pages[row][i]
            if self.refcount[p] != 1 or p in self._chain_of_page:
                continue
            out.append(i)
        return out

    def _expect(self, row: int, idx: int, *states: int) -> None:
        if self.row_res[row][idx] not in states:
            raise RuntimeError(f"page ({row}, {idx}) is in state "
                               f"{self.row_res[row][idx]}, not {states}")

    def spill_page(self, row: int, idx: int) -> int:
        """DRAM -> FLASH for one cold page whose bytes the caller has written
        to the spill store; its table entry flips to the trash page.
        Returns the freed pool page."""
        self._expect(row, idx, RES_DRAM)
        p = self.row_pages[row][idx]
        if self.refcount[p] != 1 or p in self._chain_of_page:
            raise RuntimeError(f"page {p} is shared or pinned")
        self.refcount[p] = 0
        self._free.append(p)
        self.row_pages[row][idx] = -1
        self.row_res[row][idx] = RES_FLASH
        self.table[row, idx] = self.geom.trash_page
        self.cold_spills += 1
        return p

    def begin_stage(self, row: int, idx: int) -> Optional[int]:
        """FLASH -> IN_FLIGHT: claim a staging page (None when the reserve
        is exhausted: evict with ``stage_victim``/``unstage`` first).  The
        table keeps the trash page until ``commit_stage``.  A STAGED page
        is an LRU touch and returns its staging page."""
        key = (row, idx)
        if self.row_res[row][idx] == RES_STAGED:
            self._stage_lru.remove(key)
            self._stage_lru.append(key)
            return self._staged[key]
        self._expect(row, idx, RES_FLASH)
        if not self._staging_free:
            return None
        sid = self._staging_free.pop()
        self._staged[key] = sid
        self._stage_lru.append(key)
        self.row_res[row][idx] = RES_INFLIGHT
        return sid

    def commit_stage(self, row: int, idx: int) -> None:
        """IN_FLIGHT -> STAGED: the bytes are in the staging page; only now
        does the table name it."""
        self._expect(row, idx, RES_INFLIGHT)
        self.row_res[row][idx] = RES_STAGED
        self.table[row, idx] = self._staged[(row, idx)]

    def unstage(self, row: int, idx: int) -> None:
        """STAGED -> FLASH: evict from the staging cache (no writeback)."""
        self._expect(row, idx, RES_STAGED)
        key = (row, idx)
        self._staging_free.append(self._staged.pop(key))
        self._stage_lru.remove(key)
        self.row_res[row][idx] = RES_FLASH
        self.table[row, idx] = self.geom.trash_page

    def stage_victim(self, protect) -> Optional[Tuple[int, int]]:
        """The LRU-oldest staged page not in ``protect`` (the pages the
        current wave needs)."""
        for key in self._stage_lru:
            if key not in protect \
                    and self.row_res[key[0]][key[1]] == RES_STAGED:
                return key
        return None

    def restore_page(self, row: int, idx: int) -> int:
        """FLASH/STAGED -> DRAM: a pool page again (the caller writes the
        bytes back); -1 when no page could be reserved."""
        self._expect(row, idx, RES_FLASH, RES_STAGED)
        if self.row_res[row][idx] == RES_STAGED:
            self.unstage(row, idx)
        if not self._reserve(1):
            self.alloc_failures += 1
            return -1
        p = self._free.pop()
        self.refcount[p] = 1
        self.row_pages[row][idx] = p
        self.row_res[row][idx] = RES_DRAM
        self.table[row, idx] = p
        return p

    def device_table(self, device=torch.device("cpu")) -> torch.Tensor:
        """The page table [num_slots, pages_per_row] as an int32 tensor on
        ``device`` (a copy: the serving loop's graphs read theirs through a
        ``StagedBuffer`` instead)."""
        return torch.tensor(self.table, dtype=torch.int32, device=device)
