"""Single-card dry run: what each (architecture x input shape) case asks of
one device -- the counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles every case for a 256- or 512-chip TPU
mesh and reads XLA's memory and cost analyses.  On one card the port builds
each case's arguments on the ``meta`` device (``launch.specs``: shapes and
dtypes, no storage, no draw) and records:

  * ``status``: OK, SKIP (the reference's skip list: full-attention archs
    at ``long_500k``) or FAIL with the error;
  * ``argument_bytes``: the case's parameters, optimizer state, caches and
    inputs on one card;
  * ``fits``: whether they fit the device's memory capacity, which comes
    from the card (``torch.cuda.get_device_properties``) or, without one,
    from ``--device-memory``: nothing is assumed;
  * ``temp_bytes``: "not measured" -- XLA reports a compiled step's
    activation (temp) bytes; a meta dry run runs nothing.

``engine_bytes`` predicts a serving engine's device memory (the packed
parameters and the KV pool of its ``EngineLoop``) the same way.  Records
land in ``build/dryrun/<case>.json`` (``--out``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device-memory 80000000000
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape decode_32k
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as SP

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def case_id(arch: str, shape: str) -> str:
    return f"{arch}__{shape}__1chip"


def run_case(arch: str, shape_name: str, mesh: M.HostMesh,
             out_dir: Optional[str] = None) -> dict:
    """One case's record (also written to ``out_dir``/<case>.json)."""
    cfg = registry.get(arch)
    shape = INPUT_SHAPES[shape_name]
    cid = case_id(arch, shape_name)
    reason = SP.skip_reason(cfg, shape)
    if reason:
        rec = {"case": cid, "status": "SKIP", "arch": arch, "shape": shape_name,
               "reason": reason}
    else:
        t0 = time.perf_counter()
        case = SP.build_case(cfg, shape)
        nbytes = SP.tree_bytes(case.args)
        rec = {"case": cid, "status": "OK", "arch": arch, "shape": shape_name,
               "kind": shape.kind, "n_chips": mesh.size, "device": mesh.name,
               "device_memory_bytes": mesh.memory_bytes, "argument_bytes": nbytes,
               "fits": nbytes <= mesh.memory_bytes, "temp_bytes": "not measured",
               "static": case.static, "build_s": time.perf_counter() - t0}
    if out_dir is not None:
        _save(out_dir, cid, rec)
    return rec


def engine_bytes(cfg: ModelConfig, max_seq: int, max_slots: int = 4) -> dict:
    """A serving engine's device memory, predicted from shapes: the packed
    parameters ``build_engine`` draws (the embedding stays on Flash) and the
    KV pool (with the recurrent states) of an ``EngineLoop`` over
    ``max_slots`` slots, at the loop's default geometry."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime import plan as RP
    geom = RP.ExecutionPlan(quant_tag=cfg.quant.tag(), params=None).kv_pool_geometry(
        cfg, max_seq, max_slots)
    pool = T.init_paged_cache(cfg, max_slots, geom, SP.META)
    return {"params": SP.tree_bytes(T.abstract_params(cfg, quantized=True)),
            "kv_pool": SP.tree_bytes(pool)}


def _save(out_dir: str, cid: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cid + ".json"), "w") as f:
        json.dump(rec, f, indent=2)


def _gib(x) -> str:
    return f"{x / 2**30:.2f}" if isinstance(x, (int, float)) else "—"


def summary_table(records: List[dict]) -> str:
    """status, argument GiB and fit of every record, as a markdown table."""
    rows = []
    for r in records:
        if r["status"] == "OK":
            rows.append(f"| {r['case']} | OK | {_gib(r['argument_bytes'])} | "
                        f"{'yes' if r['fits'] else 'no'} | {r['temp_bytes']} |")
        elif r["status"] == "SKIP":
            rows.append(f"| {r['case']} | SKIP | — | — | {r['reason'][:50]} |")
        else:
            rows.append(f"| {r['case']} | FAIL | — | — | {r['error'][:50]} |")
    ok = sum(r["status"] == "OK" for r in records)
    sk = sum(r["status"] == "SKIP" for r in records)
    fl = sum(r["status"] == "FAIL" for r in records)
    return (f"**{ok} OK, {sk} SKIP, {fl} FAIL**\n\n"
            "| case | status | args GiB | fits | temp GiB / note |\n"
            "|---|---|---|---|---|\n" + "\n".join(rows))


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device-memory", type=int, default=None, metavar="BYTES",
                    help="the device's memory capacity; required without a card "
                         "(on a card its own capacity is read)")
    args = ap.parse_args(argv)
    if torch.cuda.is_available():
        mesh = M.make_host_mesh("cuda", args.device_memory)
    elif args.device_memory is None:
        ap.error("no CUDA device: pass the capacity to size against (--device-memory)")
    else:
        mesh = M.make_host_mesh("cpu", args.device_memory)

    archs = list(registry.ASSIGNED) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    print(f"[dryrun] {mesh.name}: {mesh.size} chip ({mesh.axis_names} = {mesh.shape}), "
          f"{mesh.memory_bytes / 2**30:.2f} GiB", flush=True)
    results = []
    for arch in archs:
        for shape in shapes:
            cid = case_id(arch, shape)
            try:
                rec = run_case(arch, shape, mesh, out_dir=args.out)
            except Exception as e:      # recorded and reported; the run exits 1
                rec = {"case": cid, "status": "FAIL", "arch": arch, "shape": shape,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()}
                _save(args.out, cid, rec)
            extra = ""
            if rec["status"] == "OK":
                extra = (f" args={_gib(rec['argument_bytes'])}GiB "
                         f"fits={'yes' if rec['fits'] else 'no'} temp=not measured")
            elif rec["status"] == "FAIL":
                extra = " " + rec["error"][:200]
            print(f"[dryrun] {cid}: {rec['status']}{extra}", flush=True)
            results.append(rec)
    print()
    print(summary_table(results))
    if any(r["status"] == "FAIL" for r in results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
