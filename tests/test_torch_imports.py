"""The PyTorch port stands alone: it imports torch and numpy, never jax and
never the JAX package ``repro``; its entry points refuse to run on the CPU
unless asked; ``chip_smoke.py`` fails without a card or outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + [
    "chip_smoke.py", "tools/ab_trees.py", "tools/host_time.py",
    "tools/matmul_splits_sweep.py", "tools/train_conditioning.py"]


def _forbidden_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                yield f"{path.name}:{node.lineno} imports {name}"


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_or_reference_import(rel):
    """AST scan: no file of the port (nor chip_smoke.py and the tool that
    runs it across checkouts) imports jax or anything from the reference
    package."""
    assert list(_forbidden_imports(ROOT / rel)) == []


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None        # any 'import jax' now raises ImportError
sys.modules["repro"] = None
sys.path.insert(0, {src!r}); sys.path.insert(0, {root!r})
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(len(mods))
"""


def test_port_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke.py, imports in a process
    where jax and repro cannot be imported at all."""
    code = _BLOCKED_IMPORT.format(src=str(ROOT / "src"), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


def test_entry_points_refuse_silent_cpu_fallback(monkeypatch):
    """Without a card, the default device raises instead of running on the
    CPU; an explicit device='cpu' is honoured."""
    from repro_torch.serving import engine as E
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.resolve_device("cuda")
    assert E.resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    """No result line and a non-zero exit: here (no CUDA device), and in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
