#!/usr/bin/env python3
"""How far one training step's gradients move under a change of summation
order, at full width on one card, and whether ``chip_smoke.py``'s
``[train18a]`` check (a) tells a wrong kernel route from a right one.

    python3 tools/train_conditioning.py            # the cases and controls below
    python3 tools/train_conditioning.py --jamba    # and jamba's full-width prefix

Each case takes one step (``value_and_grad`` under remat) of a model from
seed 0 on one batch, through three routes on the same parameters:

* K, the kernel route (``Dispatcher()``);
* P, the plain route (``Dispatcher("reference")``);
* P64, the plain route with the prefill attention over key blocks of 64
  (``chip_smoke.plain_key_blocks``): the same math in another order.

Per gradient leaf it gives the relative L2 distance of K from P (``err``)
and of P64 from P (``spread``).  The cases separate the model from its
input: qwen2-1.5b (``[train]``'s model) on the pipeline's tokens, on tokens
drawn uniformly, and on N(0, 1) x 0.02 ``embeds`` (the launcher's vision
batch); qwen2-vl-2b (the same widths, M-RoPE, an untied ``lm_head``) on
``embeds`` and on the pipeline's tokens; seamless-m4t-large-v2 as
``[train18a]`` feeds it.  The controls are kernel routes with one layer
wrong (its attention windowed where the model has none), which check (a)
must fail.  ``--jamba`` then tries one Adafactor step of
jamba-1.5-large-398b's first two layers (attention, then mamba with an MoE
FFN) at every width, at 4 x 512 and 1 x 512 tokens, and prints its peak
device memory or the allocation that failed.

Prints a line ``COND {json}`` a case and writes every reading to
``chiprun_out/train_conditioning.json``.  Needs one CUDA card.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

B, T = 4, 512


def batch_for(cfg, inputs: str, dev):
    """[train18a]'s first batch for ``cfg``: the pipeline's (seed 0) as the
    launcher hands it to the model, with ``inputs`` in place of its
    frontend's: "tokens" (the pipeline's), "uniform" (tokens drawn
    uniformly, seed 3) or "embeds" (N(0, 1) x 0.02, the launcher's)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch.train import frontend_batch
    b = next(iter(Pipeline(DataConfig(batch_size=B, seq_len=T, vocab_size=cfg.vocab_size,
                                      seed=0)).batches(1)))
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    if inputs == "uniform":
        b["tokens"] = torch.randint(0, cfg.vocab_size, (B, T), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(3),
                                    dtype=b["tokens"].dtype)
    distinct = int(b["tokens"].unique().numel())
    front = dataclasses.replace(cfg, frontend="vision" if inputs == "embeds" else "none")
    b = frontend_batch(front, b, 0, 1)
    if cfg.is_encdec:
        gen = torch.Generator(device=dev).manual_seed(7)
        b["src_embeds"] = torch.randn((B, T // 4, cfg.d_model), generator=gen,
                                      device=dev).to(torch.bfloat16)
    return b, distinct


class WrongLayer:
    """While entered, the decoder layer ``index`` of stack 0 runs its
    attention windowed at ``window`` (its forward and remat's recompute)."""

    def __init__(self, params, index: int, window: int):
        self.ptr = params["stacks"][0][0]["ln1"][index].data_ptr()
        self.window = window

    def __enter__(self):
        from repro_torch.models import transformer as T_
        self.saved = T_._train_layer
        orig, ptr, window = self.saved, self.ptr, self.window

        def layer(x, pp, cfg, pat, *args):
            if pp["ln1"].data_ptr() == ptr:
                pat = dataclasses.replace(pat, window=window)
            return orig(x, pp, cfg, pat, *args)
        T_._train_layer = layer
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as T_
        T_._train_layer = self.saved


def case(dev, arch: str, inputs: str, controls=()) -> dict:
    import torch
    import chip_smoke as C
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T_
    from repro_torch.runtime import dispatch as D
    from repro_torch.runtime import plan as RP
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL

    cfg = registry.get(arch)
    params = T_.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch, distinct = batch_for(cfg, inputs, dev)
    names = ["/".join(map(str, k)) for k, _ in RP.tree_leaves_with_path(params)]

    def step(dispatch=None):
        ctx = T_.StepCtx(cfg, remat=True,
                         **({} if dispatch is None else {"dispatch": dispatch}))
        (_t, m), g = TL.value_and_grad(params, cfg, batch, ctx)
        return float(m["loss"]), g
    t0 = time.perf_counter()
    p_loss, pg = step(D.Dispatcher("reference"))
    live = [i for i, g in enumerate(O.leaves(pg)) if bool(g.any())]
    pl = [O.leaves(pg)[i] for i in live]

    def dist(g):
        return C._tree_rel_l2(pl, [O.leaves(g)[i] for i in live])[2]
    with C.plain_key_blocks(C.PLAIN_SPREAD_BK):
        s_loss, sg = step(D.Dispatcher("reference"))
    spread = dist(sg)
    del sg
    k_loss, kg = step()
    err = dist(kg)
    del kg

    def summary(e, loss):
        over = [i for i, x in enumerate(e) if x >= C.TRAIN_GRAD_REL_L2]
        ratios = [e[i] / max(spread[i], 1e-30) for i in over]
        return {"loss": loss, "loss_rel": abs(loss - p_loss) / abs(p_loss),
                "worst": max(e), "median": sorted(e)[len(e) // 2],
                "leaves_over_tol": len(over),
                "ratio_min": min(ratios) if ratios else None,
                "ratio_max": max(ratios) if ratios else None,
                "check_a_passes": (abs(loss - p_loss) / abs(p_loss) < C.TRAIN_LOSS_REL
                                   and all(r <= C.TRAIN_SPREAD_FACTOR for r in ratios))}
    out = {"arch": arch, "inputs": inputs, "distinct_tokens": distinct,
           "plain_loss": p_loss, "plain64_loss": s_loss,
           "kernel": summary(err, k_loss),
           "spread_worst": max(spread), "spread_median": sorted(spread)[len(spread) // 2],
           "leaves": {names[i]: {"err": err[j], "spread": spread[j]}
                      for j, i in enumerate(live)},
           "controls": {}}
    for index, window in controls:
        index = index % cfg.num_layers
        with WrongLayer(params, index, window):
            c_loss, cg = step()
        out["controls"][f"layer {index} windowed at {window}"] = summary(dist(cg), c_loss)
        del cg
    out["seconds"] = time.perf_counter() - t0
    del params, pg, pl
    gc.collect()
    torch.cuda.empty_cache()
    return out


def jamba_prefix(dev) -> list:
    """One Adafactor step of jamba-1.5-large-398b's first two layers at every
    width: the peak device memory, or the allocation that failed."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T_
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL
    full = registry.get("jamba-1.5-large-398b")
    cfg = dataclasses.replace(full, num_layers=2)
    kinds = [(p.kind, p.moe) for pats, n in cfg.layer_plan() for _ in range(n) for p in pats]
    opt = dataclasses.replace(TL.default_opt_for(cfg), kind="adafactor", warmup_steps=1)
    rows = []
    for b, t in ((4, 512), (1, 512)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        row = {"layers": kinds, "batch": b, "seq": t}
        params = state = None
        try:
            params = T_.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
            row["parameters"] = sum(x.numel() for x in O.leaves(params))
            state = O.init_state(opt, params)
            gen = torch.Generator(device=dev).manual_seed(1)
            tok = torch.randint(0, cfg.vocab_size, (b, t), device=dev, generator=gen)
            batch = {"tokens": tok, "labels": tok.roll(-1, 1),
                     "mask": torch.ones((b, t), device=dev)}
            step = TL.make_train_step(cfg, opt, remat=True)
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                params, state, m = step(params, state, batch)
                row.setdefault("losses", []).append(float(m["loss"]))
                walls.append(time.perf_counter() - t0)
            row.update(fits=True, step_wall_ms=[w * 1e3 for w in walls],
                       grad_norm=float(m["grad_norm"]))
        except torch.cuda.OutOfMemoryError as e:
            row.update(fits=False, error=str(e).splitlines()[0][:300])
        row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
        rows.append(row)
        print("COND " + json.dumps({"jamba_prefix": row}), flush=True)
        if row["fits"]:
            break
    return rows


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.kernels import loader
    loader.build()
    dev = torch.device("cuda", 0)
    res = {"card": C.card_line(), "cases": []}
    print(res["card"], flush=True)
    plan = [("qwen2-1.5b", "tokens", ()), ("qwen2-1.5b", "uniform", ()),
            ("qwen2-1.5b", "embeds", ()),
            ("qwen2-vl-2b", "embeds", ((0, T // 2), (-1, T - 32))),
            ("qwen2-vl-2b", "tokens", ()),
            ("seamless-m4t-large-v2", "tokens", ((0, T // 2), (-1, T - 32)))]
    for arch, inputs, controls in plan:
        r = case(dev, arch, inputs, controls)
        res["cases"].append(r)
        print("COND " + json.dumps({k: v for k, v in r.items() if k != "leaves"}), flush=True)
    if "--jamba" in argv:
        res["jamba_prefix"] = jamba_prefix(dev)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_conditioning.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
