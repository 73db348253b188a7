"""Optimizers — port of ``repro.training.optimizer``: AdamW (float32 m and
v) and Adafactor (factored second moments, no momentum), the warmup-cosine
schedule and global-norm clipping, as functional updates over a parameter
tree of tensors (dicts by sorted key, tuples by index: the reference's
flattening order).  Every step's arithmetic is float32 in the reference's
op order; ``step`` is an int32 tensor, so nothing makes the host wait.
The reference's ``abstract_state`` / ``state_specs`` (shapes and partition
specs over a pod mesh) have no counterpart: ``meta`` tensors give the
state's shapes on one card.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.runtime import plan as RP


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    grad_clip: float = 1.0


def leaves(tree) -> list:
    """The tensors of ``tree`` in the reference's flattening order."""
    return [t for _, t in RP.tree_leaves_with_path(tree)]


def leaves_up_to(structure, tree) -> list:
    """``tree``'s subtrees at the leaves of ``structure`` (``jax``'s
    ``flatten_up_to``): a per-parameter state dict stays whole."""
    if isinstance(structure, dict):
        return [x for k in sorted(structure) for x in leaves_up_to(structure[k], tree[k])]
    if isinstance(structure, (tuple, list)):
        return [x for s, t in zip(structure, tree) for x in leaves_up_to(s, t)]
    return [tree]


def unflatten(structure, items) -> object:
    """``structure`` with its leaves replaced by ``items``, in order."""
    it = iter(items)
    return RP.map_tree(lambda _: next(it), structure)


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to a tenth of it at
    ``decay_steps``; float32 from the int32 ``step``."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step.float() / float(max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).float()
                       / float(max(cfg.decay_steps - cfg.warmup_steps, 1)), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def clip_scale(grads, max_norm: float):
    """(the factor that scales ``grads`` to a global norm of at most
    ``max_norm``, the norm before clipping): the reference's
    ``clip_by_global_norm`` is ``g.float() * scale`` a leaf, which the
    updates below apply to each leaf as they reach it, so no float32 copy
    of the whole tree exists at once."""
    norm = _global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params) -> dict:
    flat = leaves(params)
    zeros = lambda: unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device) for p in flat])
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=flat[0].device)}


def adamw_update(cfg: OptConfig, params, grads, state):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    scale, gnorm = clip_scale(grads, cfg.grad_clip)
    stepf = step.float()
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m2 / b1c
        vh = v2 / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(state["m"]), leaves(state["v"]))]
    return (unflatten(params, [o[0] for o in out]),
            {"m": unflatten(params, [o[1] for o in out]),
             "v": unflatten(params, [o[2] for o in out]), "step": step}, gnorm)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params) -> dict:
    def state_for(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}
    flat = leaves(params)
    return {"f": unflatten(params, [state_for(p) for p in flat]),
            "step": torch.zeros((), dtype=torch.int32, device=flat[0].device)}


def adafactor_update(cfg: OptConfig, params, grads, state):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    scale, gnorm = clip_scale(grads, cfg.grad_clip)
    decay = 1.0 - torch.pow(step.float() + 1.0, -0.8)

    def upd(p, g, s):
        # each float32 temporary of a leaf's size is dropped once used: at
        # gemma3-27b's embedding (262144 x 5376) one is 5.25 GiB
        g = g.float() * scale
        g2 = g * g + 1e-30
        if _factored(p.shape):
            vr = decay * s["vr"] + (1 - decay) * g2.mean(-1)
            vc = decay * s["vc"] + (1 - decay) * g2.mean(-2)
            del g2
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=1e-30))
            update = g * torch.rsqrt(denom + 1e-30)
            del denom
            new_s = {"vr": vr, "vc": vc}
        else:
            v = decay * s["v"] + (1 - decay) * g2
            del g2
            update = g * torch.rsqrt(v + 1e-30)
            new_s = {"v": v}
        del g
        # update clipping (Adafactor's RMS rule)
        rms = torch.sqrt(torch.mean(update * update) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        pf = p.float()
        newp = pf - lr * update - lr * cfg.weight_decay * pf
        del pf, update
        return newp.to(p.dtype), new_s

    out = [upd(p, g, s) for p, g, s in zip(leaves(params), leaves(grads),
                                           leaves_up_to(params, state["f"]))]
    return (unflatten(params, [o[0] for o in out]),
            {"f": unflatten(params, [o[1] for o in out]), "step": step}, gnorm)


def init_state(cfg: OptConfig, params) -> dict:
    return adamw_init(params) if cfg.kind == "adamw" else adafactor_init(params)


def update(cfg: OptConfig, params, grads, state):
    """(new params, new state, the gradients' global norm before clipping)."""
    fn = adamw_update if cfg.kind == "adamw" else adafactor_update
    return fn(cfg, params, grads, state)
