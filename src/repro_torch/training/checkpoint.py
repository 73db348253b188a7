"""Checkpoints — port of ``repro.training.checkpoint``, in its layout:

  <dir>/step_<n>/          (n zero-padded to 8 digits)
    manifest.json          step, leaf count, the tree's key paths, dtypes,
                           shapes, extra
    arrays.npz             leaf i as ``a<i>`` (bf16 as its uint16 bits)

Leaves are numbered in the reference's flattening order (dicts by sorted
key, tuples by index), so the two packages read each other's files;
``treedef`` holds the port's key paths where the reference writes its
``PyTreeDef`` (neither restore reads it)."""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime import plan as RP
from repro_torch.training import optimizer as O


def save(directory: str, step: int, params, opt_state=None,
         extra: Optional[dict] = None) -> str:
    out = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(out, exist_ok=True)
    bundle = {"params": params}
    if opt_state is not None:
        bundle["opt_state"] = opt_state
    leaves = O.leaves(bundle)
    arrays, dtypes = {}, []
    for i, x in enumerate(leaves):
        t = x.detach().cpu().contiguous()
        dtypes.append(str(t.dtype).removeprefix("torch."))
        if t.dtype == torch.bfloat16:
            arrays[f"a{i}"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[f"a{i}"] = t.numpy()
    np.savez(os.path.join(out, "arrays.npz"), **arrays)
    paths = ("/".join(map(str, path)) for path, _ in RP.tree_leaves_with_path(bundle))
    manifest = {"step": step, "n_leaves": len(leaves), "treedef": " ".join(paths),
                "dtypes": dtypes, "shapes": [list(x.shape) for x in leaves],
                "extra": extra or {}}
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return out


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_")]
    return max(steps) if steps else None


def restore(directory: str, like, step: Optional[int] = None) -> Tuple[Any, int]:
    """``like``: a tree of the saved structure (say, freshly initialized
    {"params": ..., "opt_state": ...}); returns (the restored tree, its
    leaves on ``like``'s devices, and the step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    src = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = O.leaves(like)
    if len(like_leaves) != manifest["n_leaves"]:
        raise ValueError(f"{len(like_leaves)} leaves to restore, "
                         f"{manifest['n_leaves']} saved")
    out = []
    with np.load(os.path.join(src, "arrays.npz")) as data:
        for i, ref in enumerate(like_leaves):
            a = data[f"a{i}"]
            if manifest["dtypes"][i] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
            out.append(t.to(ref.device))
    return O.unflatten(like, out), step
