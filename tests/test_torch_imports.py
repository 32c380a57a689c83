"""The port stands alone: no module under ``src/repro_torch/`` and no script
under ``examples_torch/`` imports JAX or the reference package ``repro``, and
importing the port loads neither."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT_MODULES = sorted((SRC / "repro_torch").rglob("*.py"))
EXAMPLES = sorted((SRC.parent / "examples_torch").glob("*.py"))
FORBIDDEN = ("jax", "repro")


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".") for top in FORBIDDEN)


def _forbidden_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    return bad


@pytest.mark.parametrize("path", PORT_MODULES,
                         ids=[str(p.relative_to(SRC)) for p in PORT_MODULES])
def test_port_module_imports_no_jax_and_no_reference(path):
    bad = _forbidden_imports(path)
    assert not bad, f"{path.relative_to(SRC)} imports {bad}"


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.name for p in EXAMPLES])
def test_port_example_imports_no_jax_and_no_reference(path):
    bad = _forbidden_imports(path)
    assert not bad, f"examples_torch/{path.name} imports {bad}"


def test_chip_smoke_imports_no_jax_and_no_reference():
    bad = _forbidden_imports(SRC.parent / "chip_smoke.py")
    assert not bad, f"chip_smoke.py imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = ["repro_torch", "repro_torch.configs", "repro_torch.convert",
            "repro_torch.core", "repro_torch.core.quantization", "repro_torch.kernels",
            "repro_torch.models", "repro_torch.models.decode",
            "repro_torch.models.ssm", "repro_torch.serving",
            "repro_torch.launch.serve", "repro_torch.launch.ppr_run",
            "repro_torch.ppr_serving", "repro_torch.autotune", "repro_torch.obs",
            "repro_torch.ppr_serving.http", "repro_torch.launch.mesh",
            "repro_torch.configs.ppr_paper", "repro_torch.data", "repro_torch.training",
            "repro_torch.launch.train", "repro_torch.models.transformer",
            "repro_torch.distributed", "repro_torch.distributed.sharding",
            "repro_torch.distributed.collectives", "repro_torch.roofline",
            "repro_torch.roofline.structured", "repro_torch.launch.specs",
            "repro_torch.launch.dryrun", "repro_torch.launch.roofline_run",
            "repro_torch.launch.ppr_dryrun", "repro_torch.analysis",
            "repro_torch.analysis.cli"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
              " or m == 'repro' or m.startswith('repro.'))\n"
              "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
