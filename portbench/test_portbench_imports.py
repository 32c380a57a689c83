"""Nothing in portbench imports JAX or the JAX package, and the yardstick's
modules import nothing of the port."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the yardstick: reference, check, generators, peaks, trace reading
YARDSTICK = {"reference.py", "verdict.py", "graphgen.py", "arrivals.py",
             "peaks.py", "devtrace.py"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", sorted(YARDSTICK))
def test_yardstick_imports_nothing_of_the_port(name):
    assert "repro_torch" not in top_level_imports(HERE / name)


def test_forbidden_modules_are_matched_by_whole_top_level_name():
    from portbench import run

    clean = ["repro_torch", "repro_torch.ppr_serving", "jaxlib_like", "numpy"]
    assert run.loaded_forbidden(clean) == []
    assert run.loaded_forbidden(clean + ["repro.core", "jax._src"]) == ["jax", "repro"]

