"""Import hygiene of the PyTorch port: ``repro_torch`` (and the chip smoke
script) never import ``jax`` or anything of the reference ``repro``
package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_package_imports_without_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(ROOT).as_posix()
                   for p in list(PKG.rglob("*.py")) +
                   [ROOT / "chip_smoke.py"]))
def test_source_has_no_jax_or_reference_import(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path} imports {hits}"
