"""The training step — port of ``repro.training.train_loop``: cross-entropy
LM loss (the lm_head and the loss in 512-token chunks, each under
``torch.utils.checkpoint``), the MoE auxiliary losses, and the optimizer
update.

``make_train_step(cfg, opt, remat, dispatch)`` returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
with the reference's functional contract: new parameter and state trees,
the inputs left as they were.  The gradients are autograd's: on the card
the forward's RMSNorms and attention run kernels 4 and 7 under their
``autograd.Function``s (``runtime.dispatch``), whose backward is autograd
of the plain versions, as the reference's is XLA's autodiff of its own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime import dispatch as D
from repro_torch.training import optimizer as O

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 0.001


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logsumexp minus the gold logit, per token (float32)."""
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL: logits float32 [B, T, V], labels [B, T]; with
    ``mask`` [B, T] the mean over the masked-in tokens."""
    nll = _nll(logits, labels)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _chunk_nll(h: torch.Tensor, lm_head: dict, labels: torch.Tensor, mask: torch.Tensor,
               cfg: ModelConfig, dispatch: D.Dispatcher) -> torch.Tensor:
    logits = L.apply_linear(h, lm_head, cfg.quant, dispatch, out_dtype=torch.float32)
    return (_nll(logits, labels) * mask).sum()


def chunked_cross_entropy(hidden: torch.Tensor, lm_head: dict, labels: torch.Tensor,
                          mask: Optional[torch.Tensor], cfg: ModelConfig,
                          chunk: int = 512,
                          dispatch: Optional[D.Dispatcher] = None) -> torch.Tensor:
    """The lm_head and ``cross_entropy`` over ``chunk``-token slices of the
    sequence, each under ``torch.utils.checkpoint``: only [B, chunk, V]
    logits exist at a time, and the backward recomputes them.  A sequence
    that ``chunk`` does not divide, or no longer than it, takes one pass,
    as in the reference."""
    dispatch = dispatch or D.Dispatcher()
    B, Tk, _ = hidden.shape
    if Tk % chunk or Tk <= chunk:
        logits = L.apply_linear(hidden, lm_head, cfg.quant, dispatch, out_dtype=torch.float32)
        return cross_entropy(logits, labels, mask)
    s = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(Tk // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        m_i = (torch.ones((B, chunk), dtype=torch.float32, device=hidden.device)
               if mask is None else mask[:, sl])
        s = s + checkpoint(_chunk_nll, hidden[:, sl], lm_head, labels[:, sl], m_i, cfg,
                           dispatch, use_reentrant=False)
        n = n + m_i.sum()
    return s / torch.clamp(n, min=1)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, ctx: T.StepCtx
            ) -> Tuple[torch.Tensor, dict]:
    """(total loss, {"loss", "moe_lb", "moe_z"}): the LM loss plus, on an
    MoE model, the weighted load-balance and router z losses."""
    hidden, aux = T.forward_hidden(params, cfg, batch, ctx)
    loss = chunked_cross_entropy(hidden, params["lm_head"], batch["labels"],
                                 batch.get("mask"), cfg, dispatch=ctx.dispatch)
    total = loss
    if cfg.num_experts:
        total = total + MOE_LB_WEIGHT * aux[0] + MOE_Z_WEIGHT * aux[1]
    return total, {"loss": loss, "moe_lb": aux[0], "moe_z": aux[1]}


def value_and_grad(params: dict, cfg: ModelConfig, batch: dict, ctx: T.StepCtx):
    """((total, metrics), grads): ``jax.value_and_grad(loss_fn,
    has_aux=True)`` over every parameter leaf (a leaf the loss does not
    reach gets zeros)."""
    flat = O.leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    total, metrics = loss_fn(O.unflatten(params, live), cfg, batch, ctx)
    grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), O.unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt: O.OptConfig, remat: bool = True,
                    dispatch: Optional[D.Dispatcher] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; batch {"tokens", "labels", "mask"?} tensors on the
    parameters' device.  ``dispatch`` None: a kernel ``Dispatcher``."""
    ctx = T.StepCtx(cfg, remat=remat, dispatch=dispatch)

    def train_step(params, opt_state, batch):
        (total, metrics), grads = value_and_grad(params, cfg, batch, ctx)
        new_params, new_state, gnorm = O.update(opt, params, grads, opt_state)
        return new_params, new_state, dict(metrics, total=total, grad_norm=gnorm)

    return train_step


def default_opt_for(cfg: ModelConfig) -> O.OptConfig:
    """AdamW below ~30B parameters, Adafactor above (its state is
    O(rows + cols) a matrix)."""
    n = cfg.param_count()["total"]
    return O.OptConfig(kind="adamw" if n < 30e9 else "adafactor")
