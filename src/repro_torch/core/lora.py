"""Multi-LoRA runtime (paper §5.5, C7) — port of ``repro.core.lora``.

A base model plus K online-loaded adapters sharing base weights.  The
bypass computation is ordered by matmul associativity:

    naive:     y = (A_l @ B_l) @ x        cost  r*h^2 + h^3   (Table 3 left)
    optimized: y = A_l @ (B_l @ x)        cost  2*r*h^2       (Table 3 right)

``lora_apply`` is the step-side op; ``LoraRegistry`` is the adapter store
with online load/unload and per-request adapter selection (batched
multi-LoRA: gather adapter weights by request id, two batched matmuls).

As in the reference, the bypass runs in float32 on a bf16 activation
(JAX promotes bf16 x f32 to f32): the reference computes it outside any
Pallas kernel, so here it is two ``torch.bmm`` calls.  On the card they
run in full float32 (``torch.backends.cuda.matmul.allow_tf32`` is off by
default and the port does not turn it on).

The registry keeps the reference's host tables bit for bit, and beside
them device tables of fixed storage, made once on ``device``: ``load`` and
``unload`` write them in place on the current stream, so a CUDA graph
captured over them reads the new weights at its next replay.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class LoraWeights:
    """One adapter for one Linear: delta W = a @ b, a: [in, r], b: [r, out]."""
    a: torch.Tensor
    b: torch.Tensor

    @property
    def rank(self) -> int:
        return self.a.shape[-1]


def _promoted(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def lora_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
               optimized: bool = True, scale: float = 1.0) -> torch.Tensor:
    """Bypass output for activations x: [..., in].

    optimized=True  -> x @ a then @ b: never forms the [in, out] delta.
    optimized=False -> the paper's naive order (materializes a @ b);
    kept for the Table-3 benchmark."""
    x, a, b = _promoted(x, a, b)
    if optimized:
        return (x @ a) @ b * scale
    delta = a @ b                      # [in, out]  (the expensive order)
    return x @ delta * scale


def lora_apply_batched(x: torch.Tensor, a_all: torch.Tensor, b_all: torch.Tensor,
                       adapter_ids: torch.Tensor, *, scale: float = 1.0
                       ) -> torch.Tensor:
    """Per-request adapters in one batch.

    x: [B, T, in]; a_all: [K, in, r]; b_all: [K, r, out];
    adapter_ids: [B] integer ids into K (0 may be an identity/zero adapter)."""
    ids = adapter_ids.to(device=a_all.device, dtype=torch.long)
    x, a, b = _promoted(x, a_all.index_select(0, ids), b_all.index_select(0, ids))
    y = torch.bmm(torch.bmm(x, a), b)
    # multiplying by 1.0 changes no bit: skip the launch
    return y if scale == 1.0 else y * scale


def table3_costs(h: int, r: int) -> Dict[str, Dict[str, float]]:
    """The paper's Table 3 computation/memory model (x is [h, h])."""
    return {
        "naive":     {"compute": r * h * h + h ** 3,
                      "memory": 2 * (r * h * h + h * h + h ** 3)},
        "optimized": {"compute": 2 * r * h * h,
                      "memory": 4 * r * h * h + h * h + r * h},
    }


class LoraRegistry:
    """Store of online-loaded adapters (paper: LoRA weights are small, so
    keeping several resident costs little memory).  Slot 0 is the identity
    (zero) adapter.  ``device`` defaults to ``cuda``."""

    def __init__(self, in_dim: int, out_dim: int, max_rank: int,
                 max_adapters: int = 8, device=None):
        self.in_dim, self.out_dim = in_dim, out_dim
        self.max_rank = max_rank
        self.max_adapters = max_adapters
        self._a = np.zeros((max_adapters, in_dim, max_rank), np.float32)
        self._b = np.zeros((max_adapters, max_rank, out_dim), np.float32)
        self._names: Dict[str, int] = {}
        self._free = list(range(1, max_adapters))
        self.device = torch.device("cuda" if device is None else device)
        self._device = (torch.zeros(self._a.shape, dtype=torch.float32, device=self.device),
                        torch.zeros(self._b.shape, dtype=torch.float32, device=self.device))

    def _write(self, slot: int) -> None:
        """Copy slot ``slot`` of the host tables into the device tables."""
        self._device[0][slot].copy_(torch.from_numpy(self._a[slot]))
        self._device[1][slot].copy_(torch.from_numpy(self._b[slot]))

    def load(self, name: str, a: np.ndarray, b: np.ndarray) -> int:
        """Online-load an adapter; pads rank up to max_rank. Returns slot."""
        if name in self._names:
            slot = self._names[name]
        else:
            if not self._free:
                raise RuntimeError("adapter slots exhausted")
            slot = self._free.pop(0)
            self._names[name] = slot
        r = a.shape[-1]
        assert r <= self.max_rank, (r, self.max_rank)
        self._a[slot] = 0.0
        self._b[slot] = 0.0
        self._a[slot, :, :r] = a
        self._b[slot, :r, :] = b
        self._write(slot)
        return slot

    def unload(self, name: str) -> None:
        slot = self._names.pop(name)
        self._a[slot] = 0.0
        self._b[slot] = 0.0
        self._free.insert(0, slot)
        self._write(slot)

    def slot(self, name) -> int:
        return 0 if name is None else self._names[name]

    def device_tables(self):
        """The device tables (a [K, in, r], b [K, r, out]): the same two
        tensors for the registry's life, rewritten in place by load/unload."""
        return self._device

    @property
    def resident_bytes(self) -> int:
        return self._a.nbytes + self._b.nbytes
