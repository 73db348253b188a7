"""Training driver — the counterpart of ``python -m repro.launch.train``:
train ``--arch`` on the synthetic pipeline for ``--steps`` AdamW steps,
with checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 20 --batch 4 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b@tiny \\
      --device cpu --steps 3 --batch 2 --seq 32

``--arch`` takes ``<arch>`` or ``<arch>@reduced`` / ``@tiny`` / ``@tiny-moe``:
the reference's ``--reduced`` flag is on whatever is passed (``store_true``
with ``default=True``), so the port names the variant in ``--arch``
instead.  Weights are random, drawn from ``--seed``.  It runs on ``cuda``
(kernels 4 and 7 in the forward, and kernel 6 in an encoder-decoder's
cross attention); ``--device cpu`` runs the plain PyTorch path.  Every
layer kind trains.  The batches follow the reference's launcher: an
encoder-decoder also gets ``src_embeds`` of zeros [batch, seq // 4,
d_model]; a vision model gets ``embeds`` [batch, seq, d_model] of N(0, 1) x
0.02 in place of its tokens, drawn on the device from a generator seeded
with ``--seed`` and the step (``jax.random`` draws other numbers).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models import transformer as T
from repro_torch.serving.engine import resolve_device
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as TL


def frontend_batch(cfg, batch: dict, seed: int, step: int) -> dict:
    """The pipeline's batch {"tokens", "labels", "mask"} as the reference's
    launcher hands it to a model: an encoder-decoder's gains ``src_embeds``
    (zeros, bf16 [B, T // 4, d]); a vision model's has ``embeds`` (bf16 [B,
    T, d], N(0, 1) x 0.02 from a generator seeded with ``seed`` and
    ``step``) in place of ``tokens``."""
    B, T = batch["tokens"].shape
    dev = batch["tokens"].device
    if cfg.is_encdec:
        batch = dict(batch, src_embeds=torch.zeros((B, T // 4, cfg.d_model),
                                                   dtype=torch.bfloat16, device=dev))
    if cfg.frontend == "vision":
        gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + step)
        emb = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
        batch = {"embeds": emb.to(torch.bfloat16) * 0.02, "labels": batch["labels"],
                 "mask": batch["mask"]}
    return batch


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b@reduced")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    dev = resolve_device(args.device)
    print(f"[train] arch={cfg.name} params~{cfg.param_count()['total']:,} on {dev}")

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    opt = O.OptConfig(lr=args.lr, warmup_steps=10, decay_steps=args.steps)
    opt_state = O.init_state(opt, params)
    step_fn = TL.make_train_step(cfg, opt, remat=False)

    data = Pipeline(DataConfig(batch_size=args.batch, seq_len=args.seq,
                               vocab_size=cfg.vocab_size, seed=args.seed))
    start = 0
    if args.ckpt_dir and CKPT.latest_step(args.ckpt_dir) is not None:
        bundle, start = CKPT.restore(args.ckpt_dir, {"params": params, "opt_state": opt_state})
        params, opt_state = bundle["params"], bundle["opt_state"]
        print(f"[train] restored step {start}")

    t0 = time.perf_counter()
    losses = []
    for i, batch in enumerate(data.batches(args.steps - start)):
        step = start + i + 1
        tb = frontend_batch(cfg, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                            args.seed, step)
        params, opt_state, metrics = step_fn(params, opt_state, tb)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps:
            dt = time.perf_counter() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"({dt / max(i + 1, 1):.2f}s/step)", flush=True)
        if args.ckpt_dir and args.ckpt_every and step % args.ckpt_every == 0:
            CKPT.save(args.ckpt_dir, step, params, opt_state)
    if args.ckpt_dir:
        CKPT.save(args.ckpt_dir, args.steps, params, opt_state)
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "params": params, "opt_state": opt_state}


if __name__ == "__main__":
    main()
