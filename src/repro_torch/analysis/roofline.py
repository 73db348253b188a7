"""Roofline of the port's steps on one card -- port of
``repro.analysis.roofline``.

Two readings, each the least time the card could take for the work:

* Per dry-run case (``analyze_case``, ``render_table``), the reference's
  three terms::

      compute term    = FLOPs / (chips x peak FLOP/s of the linears' type)
      memory term     = argument bytes / (chips x HBM bytes/s)
      collective term = collective bytes / (chips x link bytes/s)   (0 here)

  The port compiles nothing ahead of time, so the FLOPs are the analytic
  ``model_flops`` (the reference's formula: 6 N D to train, 2 N D to
  prefill, 2 N_active a decoded token plus attention over the cache) and
  the bytes the case's arguments read once (``launch.dryrun``).  The
  reference's HLO counts (compiled FLOPs, temp bytes) and
  ``Roofline.useful_flop_ratio`` (analytic over compiled FLOPs) have no
  counterpart: no compiled HLO exists, so those columns read "not
  measured" (``analysis.trace`` is the port's record of a step).
* Per ``EngineLoop`` decode step (``decode_step_bound``), counted from
  shapes: the packed bytes of every weight the step reads (int4 nibbles,
  scales and zeros, the int8 ``lm_head``; of an MoE layer's expert tables
  only the distinct experts the step routed to), each row's live KV bytes
  at the pool's layout and the new key and value it appends, the recurrent
  states read and written, the activation in (embeds) and out (float32
  logits), each byte once; and the operations by type.  Set against the
  profiler's device time and the step's wall time
  (``analysis.trace.summarize``), it gives the step's roofline shares.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at the full 700 W power
limit): 3.35 TB/s of HBM, 1,979 TOP/s int8, 989 TFLOP/s bf16, 67 TFLOP/s
float32 outside the tensor cores.  A card set below 700 W runs slower, so a
share is stated beside the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.runtime import dispatch as D
from repro_torch.runtime import plan as RP

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def _case_peak(cfg: ModelConfig, kind: str) -> str:
    """The type the case's linears run in: training's are float32 dots
    (``runtime.dispatch.linear`` on bf16 weights), serving's int8 (A8) or,
    under A16, float32 (the float path)."""
    if kind == "train" or cfg.quant.act_bits == 16:
        return "f32"
    return "int8"


@dataclasses.dataclass
class Roofline:
    case: str
    chips: int
    flops: float                    # the analytic model_flops: no compiled count
    argument_bytes: int             # read once a step
    peak: str                       # the key of PEAK_OPS_PER_S the FLOPs run at
    fits: bool

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_OPS_PER_S[self.peak])

    @property
    def memory_s(self) -> float:
        return self.argument_bytes / (self.chips * HBM_BYTES_PER_S)

    @property
    def collective_s(self) -> float:
        """One card: no collective traffic."""
        return 0.0

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs for the step (the reference's formula)."""
    cfg = registry.get(arch)
    shape = INPUT_SHAPES[shape_name]
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the cache
    dec_tokens = shape.global_batch
    attn = 0.0
    hd = cfg.resolved_head_dim
    for patterns, count in cfg.layer_plan():
        for pat in patterns:
            if pat.kind != "attn":
                continue
            s_eff = min(pat.window or shape.seq_len, shape.seq_len)
            attn += count * 2 * 2 * cfg.num_heads * hd * s_eff * dec_tokens
    return 2.0 * n_active * dec_tokens + attn


def analyze_case(rec_or_path) -> Optional[Roofline]:
    """The roofline of one dry-run record (a dict, or its JSON file); None
    unless the case ran."""
    rec = rec_or_path
    if not isinstance(rec, dict):
        with open(rec_or_path) as f:
            rec = json.load(f)
    if rec.get("status") != "OK":
        return None
    cfg = registry.get(rec["arch"])
    return Roofline(case=rec["case"], chips=rec["n_chips"],
                    flops=model_flops(rec["arch"], rec["shape"]),
                    argument_bytes=rec["argument_bytes"], peak=_case_peak(cfg, rec["kind"]),
                    fits=rec["fits"])


def suggest(r: Roofline) -> str:
    """One sentence on what would move the dominant term down."""
    if not r.fits:
        return "does not fit one card: fewer layers, lower bits, or streaming from Flash"
    if r.bottleneck == "compute" and r.peak == "f32":
        return "compute-bound on float32 dots: bf16 or int8 tensor cores (15x, 30x)"
    if r.bottleneck == "compute":
        return "compute-bound at the int8 tensor-core peak: the kernels' share of it"
    return ("memory-bound: lower weight/KV bits (W4, int4-KV), fuse elementwise chains, "
            "read each weight once a step")


def load_records(artifact_dir: str) -> list:
    """The dry run's records in a directory (``launch.dryrun``'s JSON files)."""
    out = []
    for fn in sorted(os.listdir(artifact_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(artifact_dir, fn)) as f:
                out.append(json.load(f))
    return out


def render_table(artifact_dir_or_records) -> str:
    """The reference's table over dry-run records (a directory of them, or
    a list), with the port's columns."""
    recs = (load_records(artifact_dir_or_records) if isinstance(artifact_dir_or_records, str)
            else artifact_dir_or_records)
    rows = []
    for rec in recs:
        if rec.get("status") == "SKIP":
            rows.append(f"| {rec['case']} | SKIP | — | — | — | — | — | — | "
                        f"{rec['reason'][:60]} |")
            continue
        r = analyze_case(rec)
        if r is None:
            rows.append(f"| {rec['case']} | FAIL | — | — | — | — | — | — | "
                        f"{rec.get('error', '')[:60]} |")
            continue
        rows.append(
            f"| {r.case} | {r.bottleneck} ({r.peak}) | {r.compute_s * 1e3:.2f} | "
            f"{r.memory_s * 1e3:.2f} | {r.collective_s * 1e3:.2f} | "
            f"{r.argument_bytes / 2**30:.2f} | {'yes' if r.fits else 'no'} | "
            f"not measured | {suggest(r)[:70]} |")
    header = ("| case | bottleneck | compute ms | memory ms | collective ms "
              "| args GiB | fits | temp GiB | next lever |\n"
              "|---|---|---|---|---|---|---|---|---|")
    return header + "\n" + "\n".join(rows)


# ---------------------------------------------------------------------------
# an EngineLoop decode step, counted from shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepBound:
    """What a decode step must move and compute: ``bytes`` by part,
    ``ops`` by type; ``bound_s`` the larger of the bytes over the HBM rate
    and the operations over their types' peaks (summed)."""
    bytes: Dict[str, float]
    ops: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())

    @property
    def bytes_s(self) -> float:
        return self.total_bytes / HBM_BYTES_PER_S

    @property
    def ops_s(self) -> float:
        return sum(n / PEAK_OPS_PER_S[t] for t, n in self.ops.items())

    @property
    def bound_s(self) -> float:
        return max(self.bytes_s, self.ops_s)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_s >= self.ops_s else "operations"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _linears(tree):
    """Every linear's weight (packed, or a bf16 tensor) of a parameter
    subtree: the ``w`` of each ``{"w": ...}`` dict."""
    for v in tree.values():
        if isinstance(v, dict):
            if "w" in v and not isinstance(v["w"], dict):
                yield v["w"]
            else:
                yield from _linears(v)


def _state_bytes(cfg: ModelConfig, kind: str) -> int:
    from repro_torch.models import ssm as S
    init = S.init_mamba_state if kind == "mamba" else S.init_rwkv_state
    return sum(_nbytes(t) for t in init(1, cfg, device=torch.device("meta")).values())


def decode_step_bound(cfg: ModelConfig, params: dict, rows: int,
                      context_lens: Sequence[int],
                      expert_ids: Optional[Sequence] = None) -> StepBound:
    """The least work of one ``EngineLoop`` decode step over ``rows`` batch
    rows whose attention reads ``context_lens[r]`` keys (the new one
    included; inactive rows of the bucket read none) from the paged pool
    with ``params`` the engine's resident tree.  ``expert_ids``: for an MoE
    model, one entry a MoE layer in the order the step runs them (stack by
    stack, layer by layer, pattern by pattern), each the expert ids the
    layer's router chose for the step's tokens (the port's
    ``collect["moe_ids"]``); only those distinct experts' slabs are read.
    Elementwise work (RoPE, activations, the scans' recurrences) is not
    counted."""
    if len(context_lens) > rows:
        raise ValueError(f"{len(context_lens)} context lengths for {rows} rows")
    lens = [int(n) for n in context_lens]
    qc = cfg.quant
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kd = hd // 2 if qc.kv_key_bits == 4 else hd
    vb = hd if qc.kv_value_fp8 else 2 * hd
    key_bytes = cfg.num_kv_heads * (kd + 8 + vb)       # codes, scale and zero, value
    by = dict.fromkeys(("weights", "experts", "kv", "state", "activations"), 0.0)
    ops = dict.fromkeys(PEAK_OPS_PER_S, 0.0)
    moe_ids = list(expert_ids) if expert_ids is not None else None
    n_moe = 0                     # MoE layers of the stacks before this one

    def linear_ops(w, n_rows: int, count: int = 1) -> None:
        if torch.is_tensor(w):                      # bf16 weight: float32 dot
            k, n = w.shape[-2], w.shape[-1]
            ops["f32"] += 2.0 * n_rows * k * n * count
            return
        ops["f32" if D.float_path(qc, w) else "int8"] += 2.0 * n_rows * w.k * w.n * count

    for (patterns, count), stack in zip(cfg.layer_plan(), params["stacks"]):
        # the step runs a stack layer by layer, each layer's patterns in order
        moe_order = [(i, pi) for i in range(count)
                     for pi, p in enumerate(patterns) if p.moe]
        for pi, (pat, pp) in enumerate(zip(patterns, stack)):
            if pp is None:
                raise ValueError("a stack streamed from Flash has no resident weights")
            experts = pp.get("moe", {})
            for path, t in RP.tree_leaves_with_path(pp):
                if path[0] == "moe" and path[1] != "router":
                    continue
                by["weights"] += _nbytes(t)
            for w in _linears({k: v for k, v in pp.items() if k != "moe"}):
                linear_ops(w, rows, count)
            if pat.kind == "attn":
                S_live = [min(n, pat.window) if pat.window else n for n in lens]
                by["kv"] += count * (sum(S_live) + len(lens)) * key_bytes
                ops["bf16"] += count * 4.0 * sum(S_live) * cfg.num_heads * hd
            else:
                by["state"] += count * 2 * rows * _state_bytes(cfg, pat.kind)
            if experts:
                E, K = cfg.num_experts, cfg.experts_per_tok
                ops["f32"] += count * 2.0 * rows * d * E         # the router
                tables = [experts[k]["w"] for k in ("w_gate", "w_up", "w_down")]
                slab = sum(_nbytes(t) for w in tables for t in (w.data, w.scale, w.zero)) \
                    / (count * E)
                for w in tables:
                    linear_ops(w, rows * K, count)
                if moe_ids is None:
                    raise ValueError(f"{cfg.name}: an MoE step's bound needs the "
                                     "expert ids it routed (expert_ids)")
                if len(moe_ids) < n_moe + len(moe_order):
                    raise ValueError(f"{len(moe_ids)} expert-id entries: too few")
                for i in range(count):
                    ids = moe_ids[n_moe + moe_order.index((i, pi))]
                    ids = ids.reshape(-1).tolist() if torch.is_tensor(ids) else list(ids)
                    by["experts"] += slab * len(set(ids))
            norms = sum(k.startswith("ln") for k in pp)
            ops["f32"] += count * norms * 4.0 * rows * d            # RMSNorms
        n_moe += len(moe_order)
    if moe_ids is not None and n_moe != len(moe_ids):
        raise ValueError(f"{len(moe_ids)} expert-id entries for {n_moe} MoE layers")
    for key in ("final_norm", "lm_head"):
        by["weights"] += sum(_nbytes(t) for _p, t in RP.tree_leaves_with_path(params[key]))
    linear_ops(params["lm_head"]["w"], rows)
    ops["f32"] += 4.0 * rows * d
    by["activations"] += rows * d * 2 + rows * cfg.padded_vocab_size * 4
    return StepBound(bytes=by, ops={t: n for t, n in ops.items() if n})


def shares(bound_s: float, device_s: Optional[float], wall_s: float) -> dict:
    """The step's roofline shares: bound over the device's kernel time and
    over the wall time ("not measured" where the profiler saw no device
    time)."""
    return {"device_share": bound_s / device_s if device_s else "not measured",
            "wall_share": bound_s / wall_s}
