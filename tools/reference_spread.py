#!/usr/bin/env python3
"""One training step of a case of ``tests/test_torch_training_kinds.py`` on
the CPU: for every gradient leaf, the port's relative L2 distance from the
JAX reference compiled with ``xla_allow_excess_precision`` off (the tests'
reference) beside the distance of the same reference compiled with it on
(the reference's own spread, which the tests' whole-model checks fall back
to where it exceeds the tolerance).

    PYTHONPATH=src python3 tools/reference_spread.py rwkv6   # or gemma3, seamless, ...

Prints a line a leaf and a last line with the leaves past 2e-2 and the
range of their ratio port / spread.  Run from the root of a checkout (or of
a copy of one with a deliberate fault, as a control of the checks).
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]


def main(case: str) -> int:
    import jax
    import numpy as np
    import torch
    import test_torch_training_kinds as M
    from repro.configs import registry as JR
    from repro.models import transformer as JT
    from repro.training import train_loop as JTL
    from repro_torch import convert as CV
    from repro_torch.configs import registry as PR
    from repro_torch.models import transformer as PT
    from repro_torch.training import optimizer as PO
    from repro_torch.training import train_loop as PTL

    arch, T = M.CASES[case]
    jcfg, cfg = JR.get(arch), PR.get(arch)
    jp = JT.init_params(jcfg, key=M.KEY)
    pp = CV.float_params_from_reference(jp)
    jb, pb = M._batch(jcfg, T)
    ctx = JT.StepCtx(jcfg, remat=True)
    low = jax.jit(jax.value_and_grad(lambda p, b: JTL.loss_fn(p, jcfg, b, ctx),
                                     has_aux=True)).lower(jp, jb)
    (_jt, jm), jg = low.compile(M.STRICT)(jp, jb)
    (_at, am), ag = low.compile()(jp, jb)
    (_pt, pm), pg = PTL.value_and_grad(pp, cfg, pb, PT.StepCtx(cfg, remat=True))
    print(f"loss: reference {float(jm['loss']):.6f}, excess precision {float(am['loss']):.6f}, "
          f"port {float(pm['loss']):.6f}")
    over = []
    for (path, a), (_, b), c in zip(M._paths(jg), M._paths(ag), PO.leaves(pg)):
        if not a.any():
            print(f"{path:50s} zero on the reference")
            continue
        err = M._rel_l2(a, c)
        spread = M._rel_l2(a, torch.from_numpy(np.array(b, np.float32)))
        print(f"{path:50s} port {err:.3e}  spread {spread:.3e}")
        if err > M.GRAD_REL_L2:
            over.append(err / spread)
    print(f"{len(over)} leaves past {M.GRAD_REL_L2}"
          + (f"; port / spread {min(over):.2f}-{max(over):.2f}, {sum(r > 1 for r in over)} "
             "over 1" if over else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
