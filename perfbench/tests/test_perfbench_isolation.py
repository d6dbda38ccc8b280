"""What the benchmark may import: no module under ``perfbench/`` imports
JAX or the JAX package ``repro`` (top-level names compared whole), none
reads the JAX package's ``benchmarks/``, and the reference, the weights,
the traffic, the data and the counts import nothing of the program."""
import ast
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
YARDSTICK = ["reference", "weights.py", "traffic.py", "data.py",
             "counts.py"]


def imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(HERE))
                                             for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN
    paths = [n.value for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and re.fullmatch(r"(\./)?benchmarks/.*", n.value)]
    assert not paths


@pytest.mark.parametrize("part", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(part):
    base = HERE / part
    for path in ([base] if base.is_file() else sorted(base.rglob("*.py"))):
        assert "repro_torch" not in imported(path), path
