"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and no script of ``tools/`` imports JAX or the JAX
package (``repro``)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
BANNED = ("jax", "jaxlib", "repro")


def _imported(tree: ast.AST) -> list[str]:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [n for n in _imported(ast.parse(path.read_text()))
           if n.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_guard_sees_every_import_form():
    src = "import jax.numpy\nfrom repro.models import x\nimport repro_torch\n"
    assert [n.split(".")[0] in BANNED for n in
            _imported(ast.parse(src))] == [True, True, False]
