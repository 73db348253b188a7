"""The device layout -- port of ``repro.launch.mesh``.

The port runs on one card.  ``make_host_mesh`` gives its layout in the
reference's terms: axes ``("data", "model")`` of shape ``(1, 1)``, the
device and its memory capacity, which the dry run (``launch.dryrun``) and
the roofline (``analysis.roofline``) read their chip count and capacity
from.  The reference's 256- and 512-chip pod meshes (``make_production_mesh``,
``adapt_spec``, ``tree_shardings``) place a sharded program over many TPU
chips and have no counterpart on one card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The one-card layout: ``shape`` over ``axis_names``; ``memory_bytes``
    the device's capacity (``torch.cuda.get_device_properties`` on a card,
    given by the caller elsewhere)."""
    device: torch.device
    memory_bytes: int
    name: str
    axis_names: Tuple[str, str] = ("data", "model")
    shape: Tuple[int, int] = (1, 1)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


def make_host_mesh(device=None, memory_bytes: Optional[int] = None) -> HostMesh:
    """The layout of one device: a CUDA device reports its own name and
    memory (``memory_bytes`` must then be None or equal it); any other
    device needs ``memory_bytes`` from the caller, since nothing can be
    assumed about it."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass a CPU device and its memory capacity")
        props = torch.cuda.get_device_properties(dev)
        if memory_bytes is not None and memory_bytes != props.total_memory:
            raise ValueError(f"{props.name} has {props.total_memory} bytes, "
                             f"not {memory_bytes}")
        return HostMesh(dev, int(props.total_memory), props.name)
    if memory_bytes is None:
        raise ValueError(f"no memory capacity for {dev}: pass memory_bytes")
    return HostMesh(dev, int(memory_bytes), str(dev))
