"""Convert the JAX reference's serving parameters into the port's, leaf by
leaf and by name, without importing jax.

The input is the reference's parameter tree (``repro.models.transformer.
init_params(..., quantized=True, pack=True)``) whose array leaves are
anything ``numpy.asarray`` accepts — JAX arrays included — and whose packed
linears carry ``data``/``scale``/``zero``/``bits``/``k``/``n`` attributes
(expert tables are recognised by their class name, ``PackedExpertLinear``).
Every leaf is copied exactly: int8 carriers and int4 nibble bytes, float32
scale/zero and norms, bf16 biases and MoE routers (by their bit patterns,
so no numpy bf16 type is needed).  ``embedding_from_reference`` exports the
reference engine's float32 embedding table to the port's bf16 Flash store
(the reference casts the rows it gathers to bf16 the same way).
``float_params_from_reference`` converts the reference's float training
tree the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hybrid_storage as HS
from repro_torch.core import quantization as q
from repro_torch.runtime import plan as RP

# numpy dtype names of the reference's leaves without a numpy counterpart
# here -> (bit-pattern carrier, torch dtype)
_BIT_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
              "float8_e4m3fn": (np.int8, torch.float8_e4m3fn)}
_TO_NUMPY = {torch.bfloat16: np.int16, torch.float8_e4m3fn: np.int8}

_PACKED_ATTRS = ("data", "scale", "zero", "bits", "k", "n")
_QUANT_ATTRS = ("data", "scale", "zero", "bits", "shape")


def to_tensor(leaf, device=torch.device("cpu")) -> torch.Tensor:
    """One array leaf -> a tensor with the same bytes, shape and dtype."""
    a = np.asarray(leaf)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        carrier, dtype = view
        t = torch.from_numpy(np.ascontiguousarray(a).view(carrier).copy()).view(dtype)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> numpy with the same bytes (bf16 and fp8 as their int16 /
    int8 bit patterns)."""
    t = t.detach().cpu().contiguous()
    carrier = _TO_NUMPY.get(t.dtype)
    if carrier is not None:
        return t.view(torch.int16 if carrier is np.int16 else torch.int8).numpy()
    return t.numpy()


def _is_packed(x) -> bool:
    return not isinstance(x, np.ndarray) and all(hasattr(x, a) for a in _PACKED_ATTRS)


def _is_quantized(x) -> bool:
    return not isinstance(x, np.ndarray) and all(hasattr(x, a) for a in _QUANT_ATTRS)


def params_from_reference(tree, device=torch.device("cpu")):
    """The reference's parameter tree -> the port's (same keys and nesting,
    an encoder-decoder's ``encoder``, ``enc_norm``, ``ln_cross`` and
    ``cross`` leaves included; packed linears become
    ``runtime.plan.PackedLinear`` or ``PackedExpertLinear``)."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_reference(v, device) for v in tree)
    if _is_packed(tree):
        cls = (RP.PackedExpertLinear if type(tree).__name__ == "PackedExpertLinear"
               else RP.PackedLinear)
        return cls(data=to_tensor(tree.data, device),
                   scale=to_tensor(tree.scale, device),
                   zero=to_tensor(tree.zero, device),
                   bits=int(tree.bits), k=int(tree.k), n=int(tree.n))
    if _is_quantized(tree):
        return q.QuantizedTensor(data=to_tensor(tree.data, device),
                                 scale=to_tensor(tree.scale, device),
                                 zero=to_tensor(tree.zero, device),
                                 bits=int(tree.bits), shape=tuple(tree.shape))
    return to_tensor(tree, device)


def float_params_from_reference(tree, device=torch.device("cpu")):
    """The reference's float (training) tree (``init_params(...,
    quantized=False)``) -> the port's: the same keys and nesting, every leaf
    copied exactly (bf16 linears, embedding and router by their bit
    patterns, float32 norms as they are).  A quantized leaf raises: serving
    trees convert through ``params_from_reference``."""
    if isinstance(tree, dict):
        return {k: float_params_from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(float_params_from_reference(v, device) for v in tree)
    if _is_packed(tree) or _is_quantized(tree):
        raise ValueError("a quantized leaf in a float tree: convert serving "
                         "trees with params_from_reference")
    return to_tensor(tree, device)


def params_to_numpy(tree):
    """The port's parameter tree -> nested dicts/tuples of numpy arrays with
    the leaves' exact bytes (packed linears as dicts of their fields)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_to_numpy(v) for v in tree)
    if isinstance(tree, (RP.PackedLinear, q.QuantizedTensor)):
        return {"data": to_numpy(tree.data), "scale": to_numpy(tree.scale),
                "zero": to_numpy(tree.zero), "bits": tree.bits}
    return to_numpy(tree)


def embedding_from_reference(table: np.ndarray, flash_dir: str,
                             name: str = "embedding") -> HS.EmbeddingStore:
    """Export the reference engine's float32 embedding table (its Flash
    memmap) to the port's bf16 Flash store, in chunks."""
    rows, dim = table.shape
    flash = HS.FlashStore(flash_dir, HS.FlashSpec(simulate=False))
    return HS.EmbeddingStore.create(
        flash, rows, dim,
        lambda a, b: torch.from_numpy(np.asarray(table[a:b], np.float32)),
        name=name)
