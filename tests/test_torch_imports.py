"""The port stands alone: no file of calibr8_tpu_torch/ (nor chip_smoke.py)
imports JAX or calibr8_tpu, and importing the package loads neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "calibr8_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "calibr8_tpu")


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_import_loads_no_jax():
    code = (
        "import sys, calibr8_tpu_torch, calibr8_tpu_torch.problem, calibr8_tpu_torch.cli.main;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'calibr8_tpu')];"
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
