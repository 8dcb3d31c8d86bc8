"""The PyTorch port stands alone: it imports no JAX, no flax and nothing of
the JAX package ``ifseg_tpu``.

Two checks: a fresh interpreter imports ``ifseg_torch`` and every submodule
and reports what ended up in ``sys.modules``; an AST scan of the package and
of ``chip_smoke.py`` finds no import statement naming those packages.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ifseg_tpu")

SCRIPT = r"""
import importlib, json, pkgutil, sys
FORBIDDEN = %r
def bad():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
before = bad()
import ifseg_torch
names = [m.name for m in pkgutil.walk_packages(ifseg_torch.__path__, "ifseg_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"before": before, "after": bad(), "modules": names}))
""" % (FORBIDDEN,)


def test_importing_every_module_loads_no_jax():
    import json

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["after"] == report["before"] == [], report
    # the walk reached the whole package
    for name in ("ifseg_torch.eval.serving", "ifseg_torch.ops.flash_attention",
                 "ifseg_torch.ops.histogram", "ifseg_torch.train.trainer",
                 "ifseg_torch.train.criterion", "ifseg_torch.train.optim",
                 "ifseg_torch.train.ema", "ifseg_torch.data.artificial",
                 "ifseg_torch.tools.profile_training"):
        assert name in report["modules"], name


def _sources():
    files = sorted((REPO / "ifseg_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            found.append(str(node.args[0].value))
    bad = [m for m in found if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
