"""Arguments of every (architecture x input shape) case on the ``meta``
device -- port of ``repro.launch.specs``.

``build_case(cfg, shape)`` returns a ``DryRunCase`` whose ``args`` are the
step's inputs as ``torch.device("meta")`` tensors: shapes and dtypes, no
storage.  The step follows ``shape.kind`` as in the reference:

  train   -> the float parameter tree, the optimizer state of
             ``training.train_loop.default_opt_for`` and a batch (labels
             and tokens, or embeds and M-RoPE positions for the vision
             frontend; an encoder-decoder's source embeds);
  prefill -> the quantized serving parameters in the port's packed layout
             and the prompt's embeds (rows come from Flash, C2), with the
             source embeds or M-RoPE positions where the model takes them;
  decode  -> the serving parameters, one token's embeds a sequence and the
             dense cache at ``shape.seq_len`` (an encoder-decoder's cross
             caches over ``cross_src_len`` source frames).

The reference's partition specs (``kv_spec``, ``in_specs``/``out_specs``
over a 16 x 16 pod mesh) have no counterpart on one card
(``launch.mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as TL

META = torch.device("meta")


@dataclasses.dataclass
class DryRunCase:
    name: str
    kind: str
    args: tuple
    static: dict


def tensors(tree) -> Iterator[torch.Tensor]:
    """Every tensor of an argument tree: dicts, tuples and lists, and the
    tensor fields of dataclasses (packed linears, KV caches)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensors(getattr(tree, f.name))


def tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def cross_src_len(shape: InputShape) -> int:
    """Encoder-source length for enc-dec decode shapes (self cache is
    seq_len; the encoded source is a fixed frame count)."""
    return min(shape.seq_len, 4096)


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def build_train_case(cfg: ModelConfig, shape: InputShape) -> DryRunCase:
    B, Tk = shape.global_batch, shape.seq_len
    opt = TL.default_opt_for(cfg)
    aparams = T.abstract_params(cfg, quantized=False)
    astate = O.init_state(opt, aparams)
    batch = {"labels": _empty((B, Tk), torch.int32)}
    if cfg.frontend == "vision":
        batch["embeds"] = _empty((B, Tk, cfg.d_model), torch.bfloat16)
        batch["positions"] = _empty((B, Tk, 3), torch.int32)
    else:
        batch["tokens"] = _empty((B, Tk), torch.int32)
    if cfg.is_encdec:
        batch["src_embeds"] = _empty((B, Tk, cfg.d_model), torch.bfloat16)
    return DryRunCase(name=f"{cfg.name}:{shape.name}", kind="train",
                      args=(aparams, astate, batch), static={"opt": opt.kind})


def build_prefill_case(cfg: ModelConfig, shape: InputShape) -> DryRunCase:
    B, Tk = shape.global_batch, shape.seq_len
    args = [T.abstract_params(cfg, quantized=True),
            _empty((B, Tk, cfg.d_model), torch.bfloat16)]
    if cfg.is_encdec:
        args.append(_empty((B, Tk, cfg.d_model), torch.bfloat16))
    if cfg.rope_kind == "mrope":
        args.append(_empty((B, Tk, 3), torch.int32))
    return DryRunCase(name=f"{cfg.name}:{shape.name}", kind="prefill",
                      args=tuple(args), static={})


def build_decode_case(cfg: ModelConfig, shape: InputShape) -> DryRunCase:
    B, Sq = shape.global_batch, shape.seq_len
    cross = cross_src_len(shape) if cfg.is_encdec else 0
    args = [T.abstract_params(cfg, quantized=True),
            _empty((B, 1, cfg.d_model), torch.bfloat16),
            T.init_cache(cfg, B, Sq, cross_len=cross, device=META)]
    if cfg.rope_kind == "mrope":
        args.append(_empty((B, 1, 3), torch.int32))
    return DryRunCase(name=f"{cfg.name}:{shape.name}", kind="decode",
                      args=tuple(args), static={})


def build_case(cfg: ModelConfig, shape: InputShape) -> DryRunCase:
    if shape.kind == "train":
        return build_train_case(cfg, shape)
    if shape.kind == "prefill":
        return build_prefill_case(cfg, shape)
    return build_decode_case(cfg, shape)


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: long_500k requires sub-quadratic "
                "attention (DESIGN.md skip list)")
    return None
