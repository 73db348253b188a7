"""Load-time layout and geometry decisions — the parts of
``repro.runtime.plan`` the serving main path uses.

* ``PackedLinear`` — a quantized linear weight in the kernel-native padded
  layout: reduction dim padded to a multiple of 128, output channels to a
  multiple of 256 (int4 nibble pairs never straddle the pad).  Padding is
  exact: pad columns hold q=0 with scale=1/zero=0 and dequantize to 0, pad
  rows hold q=0 and only ever meet the zero-padded activation columns.
  ``PackedExpertLinear`` is the same carrier with a leading expert axis
  (the grouped kernel's operand).
* KV pool geometry (page size, pages per row, the DRAM page inventory),
  the decode batch-bucket ladder and the prefill chunk cap — the same
  geometry as the reference, so allocation and scheduling follow it step
  for step.
* The weight placement under a device byte budget (``weight_stream_policy``):
  which stacks stay resident and which stream from Flash through a ring of
  layer-group slots, with the reference's byte counts — taken over the same
  packed leaves, so every decision and counter follows it.

* The paper's DRAM/Flash placement of the embedding, the layers and
  ``lm_head`` (``placement_for``), which every engine's plan starts from.

The reference's TPU tile solver (``solve_tpu_blocks``, VMEM tiles on the
(8, 128) lane grid) and the tile solving of ``MatmulPlan`` /
``build_plan`` / ``ExecutionPlan.presolve_tiles`` have no counterpart:
tiles are the CUDA kernels' own, chosen at each launch.  ``core.tiling``
holds the paper's CPU solver (Table 2) and reads the W4A8 kernel's tile
choice (``kernel_tiles``).  The ``abstract_packed`` / ``spec_packed``
builders are replaced by ``meta`` tensors (``packed_layout``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import hybrid_storage as HS
from repro_torch.core import kv_pool
from repro_torch.core import quantization as q

LANE = 128            # K alignment
N_ALIGN = 2 * LANE    # output-channel alignment (nibble pairs stay aligned)
M_ALIGN = 8
# prompt chunks are multiples of this: the mamba scan's fixed block
# (models/ssm.py SCAN_BLOCK, which asserts the two equal)
CHUNK_ALIGN = 8


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class PackedLinear:
    """data:  int8 [..., Kp, Np//2] (bits=4) or [..., Kp, Np] (bits=8);
    scale/zero: float32 [..., g, Np]; k, n: the logical dims."""
    data: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    k: int
    n: int

    @property
    def kp(self) -> int:
        return _ceil_to(self.k, LANE)

    @property
    def np_pad(self) -> int:
        return _ceil_to(self.n, N_ALIGN)

    def layer(self, i: int) -> "PackedLinear":
        """Slice one layer of a stacked [L, ...] weight (a contiguous view)."""
        return type(self)(self.data[i], self.scale[i], self.zero[i],
                          self.bits, self.k, self.n)


def pack_linear(qt: q.QuantizedTensor) -> PackedLinear:
    """Repack a QuantizedTensor into the padded kernel-native layout."""
    k, n = int(qt.shape[-2]), int(qt.shape[-1])
    kp, np_ = _ceil_to(k, LANE), _ceil_to(n, N_ALIGN)
    dcols = n // 2 if qt.bits == 4 else n
    pcols = np_ // 2 if qt.bits == 4 else np_
    data = F.pad(qt.data, (0, pcols - dcols, 0, kp - k))
    scale = F.pad(qt.scale, (0, np_ - n), value=1.0)
    zero = F.pad(qt.zero, (0, np_ - n), value=0.0)
    return PackedLinear(data=data, scale=scale, zero=zero, bits=qt.bits,
                        k=k, n=n)


def packed_layout(k: int, n: int, bits: int, group_size: int = 0) -> tuple:
    """(shape, dtype) of the data, scale and zero carriers that
    ``pack_linear(q.quantize(w [k, n], bits, group_size=...))`` gives, from
    the dims alone (an abstract parameter tree draws and quantizes nothing)."""
    kp, np_ = _ceil_to(k, LANE), _ceil_to(n, N_ALIGN)
    g = k // group_size if group_size and group_size < k else 1
    return (((kp, np_ // 2 if bits == 4 else np_), torch.int8),
            ((g, np_), torch.float32), ((g, np_), torch.float32))


def unpack_linear(pl: PackedLinear) -> q.QuantizedTensor:
    """Slice the padding back off -> the original QuantizedTensor values."""
    dcols = pl.n // 2 if pl.bits == 4 else pl.n
    data = pl.data[..., :pl.k, :dcols]
    return q.QuantizedTensor(data=data, scale=pl.scale[..., :pl.n],
                             zero=pl.zero[..., :pl.n], bits=pl.bits,
                             shape=(*data.shape[:-2], pl.k, pl.n))


@dataclasses.dataclass
class PackedExpertLinear(PackedLinear):
    """A stacked per-expert quantized linear in the kernel-native layout:
    data int8 [..., E, Kp, Np//2] (bits=4) or [..., E, Kp, Np]; scale/zero
    float32 [..., E, g, Np].  The grouped kernel takes the expert axis as a
    grid dimension; the selected-expert decode path gathers along it."""

    @property
    def experts(self) -> int:
        return int(self.data.shape[-3])


def pack_expert_linear(qt: q.QuantizedTensor) -> PackedExpertLinear:
    """Repack a stacked expert table ([..., E, K, N]) into the padded layout
    (the K/N pads are shared across experts)."""
    if qt.data.dim() < 3:
        raise ValueError(f"expert table needs an expert axis, got {tuple(qt.data.shape)}")
    p = pack_linear(qt)
    return PackedExpertLinear(data=p.data, scale=p.scale, zero=p.zero,
                              bits=p.bits, k=p.k, n=p.n)


def unpack_expert_linear(pel: PackedExpertLinear) -> q.QuantizedTensor:
    """Slice the padding back off every expert slab."""
    return unpack_linear(pel)


def take_experts(pel: PackedExpertLinear, ids: torch.Tensor) -> PackedExpertLinear:
    """Gather expert slabs along the expert axis (axis -3): the
    selected-expert decode path's per-token weight gather (a copy)."""
    ids = ids.long()
    return PackedExpertLinear(
        data=torch.index_select(pel.data, -3, ids),
        scale=torch.index_select(pel.scale, -3, ids),
        zero=torch.index_select(pel.zero, -3, ids),
        bits=pel.bits, k=pel.k, n=pel.n)


# parameter-tree keys whose leaves carry a per-expert axis (MoE tables);
# every other leaf of an MoE layer (router, norms, attention) is shared
EXPERT_PARAM_KEYS = ("w_gate", "w_up", "w_down")


def is_expert_path(path) -> bool:
    """True when a key path (dict keys, or path entries with a ``key``
    attribute) names an expert table."""
    return any(getattr(p, "key", p) in EXPERT_PARAM_KEYS for p in path)


_CARRIER_FIELDS = ("data", "scale", "zero")


def tree_leaves_with_path(tree, path: tuple = ()) -> Iterator[Tuple[tuple, torch.Tensor]]:
    """(key path, tensor) of every array leaf of a parameter tree: dicts by
    sorted key and tuples by index (the reference's flattening order), a
    packed or quantized linear as its ``data``, ``scale`` and ``zero``
    fields; ``None`` (a stack exported to Flash) has no leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (i,))
    elif isinstance(tree, (PackedLinear, q.QuantizedTensor)):
        for f in _CARRIER_FIELDS:
            yield path + (f,), getattr(tree, f)
    else:
        yield path, tree


def map_tree(fn, tree):
    """``tree`` with every array leaf replaced by ``fn(leaf)``, called in
    ``tree_leaves_with_path`` order (the same structure and packed-linear
    metadata)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return tuple(map_tree(fn, v) for v in tree)
    if isinstance(tree, (PackedLinear, q.QuantizedTensor)):
        return dataclasses.replace(tree, **{f: fn(getattr(tree, f))
                                            for f in _CARRIER_FIELDS})
    return fn(tree)


# ---------------------------------------------------------------------------
# Weight streaming: the placement of the weights under a device byte budget
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamedStackPlan:
    """One stack whose layer groups stream through a ring of device slots."""
    stack: int                 # index into cfg.layer_plan()
    count: int                 # layer groups in the stack
    group_bytes: int           # bytes of one group's leaf slices
    ring_groups: int           # ring slots (>= 2: double-buffered)
    experts: int = 0           # > 0: expert-granular streaming (MoE stack)
    expert_bytes: int = 0      # bytes of ONE expert's slice of one group
    shared_bytes: int = 0      # bytes of a group's non-expert (shared) leaves

    @property
    def ring_bytes(self) -> int:
        return self.ring_groups * self.group_bytes


@dataclasses.dataclass(frozen=True)
class WeightStreamPolicy:
    """Device/Flash placement of the weights under a byte budget, the
    reference's: ``lm_head`` and ``final_norm`` (read whole every step) stay
    resident; stacks stay resident in layer order while they fit, and each
    overflowing stack streams group by group through a ring whose slot count
    is sized from the budget left.  ``placement`` maps each entry to "dram"
    or "stream"."""
    dram_budget_bytes: Optional[int]
    head_bytes: int                     # lm_head + final_norm (resident)
    resident_bytes: int                 # head + resident stacks + rings
    streamed: Tuple[StreamedStackPlan, ...]
    placement: Dict[str, str]

    @property
    def active(self) -> bool:
        return bool(self.streamed)

    @property
    def ring_bytes(self) -> int:
        return sum(s.ring_bytes for s in self.streamed)

    def streamed_stack(self, stack: int) -> Optional[StreamedStackPlan]:
        for s in self.streamed:
            if s.stack == stack:
                return s
        return None


def _tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _p, t in tree_leaves_with_path(tree))


def _expert_group_bytes(stack_tree, count: int, experts: int) -> Tuple[int, int]:
    """(per-expert bytes, shared bytes) of ONE layer group of a stack: the
    ``w_gate``/``w_up``/``w_down`` leaves split per expert, every other leaf
    (router, norms, attention) is shared.  (0, group bytes) for a stack
    without expert leaves."""
    leaves = list(tree_leaves_with_path(stack_tree))
    nb = lambda t: t.numel() * t.element_size()
    expert_total = sum(nb(t) for p, t in leaves if is_expert_path(p))
    shared_total = sum(nb(t) for p, t in leaves if not is_expert_path(p))
    if not expert_total or not experts:
        return 0, -(-(expert_total + shared_total) // count)
    return -(-expert_total // (count * experts)), -(-shared_total // count)


def weight_stream_policy(cfg, params, dram_budget_bytes: Optional[int] = None,
                         ring_groups: int = 2,
                         expert_granular: bool = True) -> WeightStreamPolicy:
    """The weight placement of ``params`` under ``dram_budget_bytes`` (the
    budget for the weights; ``None``: everything resident).  A stack streams
    only when its ring would be smaller than the stack (``ring < count``);
    the ring takes the budget left, up to ``count - 1`` slots, floored at
    ``ring_groups`` (2: group g computes while g + 1 installs)."""
    plan_stacks = cfg.layer_plan()
    head_bytes = _tree_nbytes(params["final_norm"]) + _tree_nbytes(params["lm_head"])
    placement: Dict[str, str] = {"final_norm": "dram", "lm_head": "dram"}
    if dram_budget_bytes is None:
        for si in range(len(plan_stacks)):
            placement[f"stacks/{si}"] = "dram"
        resident = head_bytes + sum(_tree_nbytes(s) for s in params["stacks"])
        return WeightStreamPolicy(dram_budget_bytes=None, head_bytes=head_bytes,
                                  resident_bytes=resident, streamed=(),
                                  placement=placement)
    left = int(dram_budget_bytes) - head_bytes
    resident = head_bytes
    streamed = []
    for si, (_patterns, count) in enumerate(plan_stacks):
        stack_bytes = _tree_nbytes(params["stacks"][si])
        group_bytes = -(-stack_bytes // count)
        if stack_bytes <= left:
            placement[f"stacks/{si}"] = "dram"
            resident += stack_bytes
            left -= stack_bytes
            continue
        ring = max(ring_groups, min(count - 1, left // group_bytes if group_bytes
                                    else ring_groups))
        # a 2-group stack cannot double-buffer a strict subset: resident
        if ring >= count or count < 3:
            placement[f"stacks/{si}"] = "dram"
            resident += stack_bytes
            left -= stack_bytes
            continue
        placement[f"stacks/{si}"] = "stream"
        experts = expert_bytes = shared_bytes = 0
        if expert_granular and getattr(cfg, "num_experts", 0):
            eb, sb = _expert_group_bytes(params["stacks"][si], count, cfg.num_experts)
            if eb:
                experts, expert_bytes, shared_bytes = cfg.num_experts, eb, sb
        streamed.append(StreamedStackPlan(
            stack=si, count=count, group_bytes=group_bytes, ring_groups=int(ring),
            experts=experts, expert_bytes=expert_bytes, shared_bytes=shared_bytes))
        resident += ring * group_bytes
        left -= ring * group_bytes
    return WeightStreamPolicy(dram_budget_bytes=int(dram_budget_bytes),
                              head_bytes=head_bytes, resident_bytes=resident,
                              streamed=tuple(streamed), placement=placement)


def decode_buckets(max_slots: int, uniform: bool = True) -> Tuple[int, ...]:
    """Batch-size ladder for bucketed decode: 1/2/4/... below
    ``max_slots``, topped by ``max_slots`` itself."""
    if not uniform or max_slots <= 1:
        return (max(1, int(max_slots)),)
    ladder = []
    b = 1
    while b < max_slots:
        ladder.append(b)
        b *= 2
    ladder.append(max_slots)
    return tuple(ladder)


def kv_page_size(max_seq: int) -> int:
    """Largest power-of-two divisor of ``max_seq`` capped at LANE and at
    max_seq // 4 (floored at M_ALIGN)."""
    cap = max(M_ALIGN, min(LANE, max_seq // 4))
    ps = 1
    while ps * 2 <= cap and max_seq % (ps * 2) == 0:
        ps *= 2
    return ps


def prefill_chunk_schedule(cfg, prefill_chunk: int, page_size: int) -> int:
    """The engine's prefill chunk cap: a multiple of ``CHUNK_ALIGN``;
    windowed stacks round down to the largest power of two <= min(cap,
    page_size)."""
    cap = max(CHUNK_ALIGN, (int(prefill_chunk) // CHUNK_ALIGN) * CHUNK_ALIGN)
    windowed = any(pat.kind == "attn" and pat.window > 0
                   for pats, _count in cfg.layer_plan() for pat in pats)
    if windowed:
        b = CHUNK_ALIGN
        while b * 2 <= min(cap, page_size):
            b *= 2
        cap = b
    return cap


def kv_page_bytes(cfg, page_size: int) -> int:
    """Device bytes one pool page costs across every full-attention layer."""
    H, D = cfg.num_kv_heads, cfg.resolved_head_dim
    kd = D // 2 if cfg.quant.kv_key_bits == 4 else D
    vb = 1 if cfg.quant.kv_value_fp8 else 2
    per_tok = H * kd + 2 * 4 * H + H * D * vb
    n_full = sum(count for pats, count in cfg.layer_plan()
                 for pat in pats if pat.kind == "attn" and pat.window == 0)
    return page_size * per_tok * n_full


@dataclasses.dataclass
class ExecutionPlan:
    """Decided once per model: the packed params, the pool geometry and the
    weights' placement."""
    quant_tag: str
    params: Any
    placement: Dict[str, str] = dataclasses.field(default_factory=dict)

    def decode_buckets(self, max_slots: int,
                       uniform: bool = True) -> Tuple[int, ...]:
        return decode_buckets(max_slots, uniform=uniform)

    def kv_pool_geometry(self, cfg, max_seq: int, max_slots: int,
                         dram_budget_bytes: Optional[int] = None,
                         staging_pages: Optional[int] = None
                         ) -> kv_pool.PoolGeometry:
        """Page size from the lane grid; page inventory from the DRAM
        budget, clamped to [one full row, the full per-slot reservation].
        ``staging_pages`` sizes the staging reserve past the trash page
        (default ``pages_per_row - 2``, at least 2: a row can stage every
        page that may spill for one decode wave; 0 turns the reserve off)."""
        ps = kv_page_size(max_seq)
        ppr = -(-max_seq // ps)
        if dram_budget_bytes is None:
            num = max_slots * ppr
        else:
            pb = kv_page_bytes(cfg, ps)
            num = dram_budget_bytes // pb if pb else max_slots * ppr
        num = max(min(int(num), max_slots * ppr), ppr)
        if staging_pages is None:
            staging_pages = max(2, ppr - 2)
        return kv_pool.PoolGeometry(page_size=ps, num_pages=num,
                                    pages_per_row=ppr,
                                    staging_pages=int(staging_pages))

    def kv_spill_policy(self, cfg, geom: kv_pool.PoolGeometry,
                        max_slots: int,
                        flash_budget_bytes: Optional[int] = None
                        ) -> kv_pool.SpillPolicy:
        """Proactive-spill watermarks and budgets: the loop spills cold pages
        of running rows when the free list drops below ``low_watermark``
        (refilling to ``high_watermark``), keeps the last ``hot_pages`` full
        pages of every row in DRAM, and puts at most ``flash_budget_pages``
        on Flash (default: the full per-slot reservation)."""
        if flash_budget_bytes is None:
            budget = max_slots * geom.pages_per_row
        else:
            pb = kv_page_bytes(cfg, geom.page_size)
            budget = flash_budget_bytes // pb if pb else 0
        low = max(1, geom.num_pages // 8)
        high = max(low, geom.num_pages // 4)
        return kv_pool.SpillPolicy(
            staging_pages=geom.staging_pages, hot_pages=1,
            low_watermark=low, high_watermark=high,
            flash_budget_pages=int(budget))

    def weight_placement(self, cfg, dram_budget_bytes: Optional[int] = None,
                         ring_groups: int = 2,
                         expert_granular: bool = True) -> WeightStreamPolicy:
        """The weights' placement under a byte budget (``weight_stream_policy``);
        its per-entry decisions merge into ``self.placement``."""
        policy = weight_stream_policy(cfg, self.params,
                                      dram_budget_bytes=dram_budget_bytes,
                                      ring_groups=ring_groups,
                                      expert_granular=expert_granular)
        self.placement.update(policy.placement)
        return policy


def placement_for(cfg, dram_budget_bytes: Optional[int] = None) -> Dict[str, str]:
    """Utilization-ordered DRAM/Flash placement (paper §4.1, C2), with the
    reference's byte counts: a bf16 embedding, ``weight_bits`` layers and
    ``lm_head`` at ``max(lm_head_bits, 8)``.  The default budget fits
    exactly the layers and ``lm_head``, so the embedding goes to Flash."""
    pc = cfg.param_count()
    sizes = {
        "embedding": pc["embedding"] * 2,
        "layers": pc["layers"] * cfg.quant.weight_bits // 8,
        "lm_head": pc["lm_head"] * max(cfg.quant.lm_head_bits, 8) // 8,
    }
    if dram_budget_bytes is None:
        dram_budget_bytes = sizes["layers"] + sizes["lm_head"]
    return HS.plan_embedding_placement(sizes, dram_budget_bytes)
