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
# modules every walk must reach (the XNOR GEMM, the NullaNet flow, the
# front door, its traffic, the tools, the serving examples, the Verilog
# front end and the quickstart, the LM serving path, and the LM training
# path: optimizer, trainer, checkpoints, launcher and examples, and the
# MoE, SSM and RG-LRU layers of the other model families, and the
# sharding rules, meshes, activation constraints, tensor parallelism and
# sharded step of the sharded trainer)
EXPECTED = ("repro_torch.kernels.native", "repro_torch.kernels.xnor_gemm.ops",
            "repro_torch.kernels.xnor_gemm.kernel",
            "repro_torch.kernels.xnor_gemm.ref", "repro_torch.data.synthetic",
            "repro_torch.core.nullanet", "repro_torch.core.simulator",
            "repro_torch.flow.convert", "repro_torch.flow.classifier",
            "repro_torch.flow.report", "repro_torch.examples.e2e_nullanet",
            "repro_torch.serve.frontdoor", "repro_torch.serve.traffic",
            "repro_torch.tools.calibrate", "repro_torch.tools.precompile",
            "repro_torch.examples.serve_logic",
            "repro_torch.examples.serve_frontdoor",
            "repro_torch.examples.warm_start",
            "repro_torch.core.verilog", "repro_torch.core.synth",
            "repro_torch.examples.quickstart",
            "repro_torch.tools.verify_program",
            "repro_torch.models.config", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.transformer",
            "repro_torch.models.logic_mlp", "repro_torch.configs.registry",
            "repro_torch.configs.qwen3_8b", "repro_torch.configs.minicpm_2b",
            "repro_torch.serve.engine", "repro_torch.launch.serve",
            "repro_torch.examples.serve_lm",
            "repro_torch.optim", "repro_torch.optim.schedule",
            "repro_torch.optim.clip", "repro_torch.optim.adamw",
            "repro_torch.optim.compression", "repro_torch.train",
            "repro_torch.train.resilience", "repro_torch.train.checkpoint",
            "repro_torch.train.trainer", "repro_torch.launch.train",
            "repro_torch.convert", "repro_torch.examples.train_lm",
            "repro_torch.examples.logic_mlp_swap",
            "repro_torch.models.moe", "repro_torch.models.mamba2",
            "repro_torch.models.rglru", "repro_torch.train.sharding",
            "repro_torch.launch.mesh", "repro_torch.models.pspec_utils",
            "repro_torch.models.tensor_parallel",
            "repro_torch.train.parallel")


def test_package_imports_without_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        f"missing = sorted(set({EXPECTED!r}) - set(names))\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 38 else 0)\n")
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
