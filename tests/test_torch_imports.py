"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and no script of ``tools/`` imports JAX or the JAX
package (``repro``); and every module of the port imports as the first
import of a process (no import cycle among its packages).

One tool is the reference's side by design: ``tools/located_golden.py``
writes ``tests/golden/located_scenario.json`` from the JAX package (inside
its ``main``); its module level, which ``chip_smoke.py`` and the tests
import for the scenario's summary, is checked to import neither."""
import _torch_threads  # noqa: F401  (one torch thread a process)
import ast
import importlib
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# golden writers: they run the JAX reference, in a function
REFERENCE_TOOLS = ("located_golden.py",)
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted(
        p for p in (ROOT / "tools").glob("*.py")
        if p.name not in REFERENCE_TOOLS)
BANNED = ("jax", "jaxlib", "repro")
SRC = ROOT / "src"
MODULES = sorted(".".join(p.relative_to(SRC).with_suffix("").parts)
                 .removesuffix(".__init__")
                 for p in (SRC / "repro_torch").rglob("*.py"))


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


@pytest.mark.parametrize("name", REFERENCE_TOOLS)
def test_golden_writer_imports_the_reference_only_inside_main(name):
    tree = ast.parse((ROOT / "tools" / name).read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not [n for n in _imported(ast.Module(body=top, type_ignores=[]))
                if n.split(".")[0] in BANNED]
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    assert any(n.split(".")[0] == "repro" for n in _imported(main))
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name != "main":
            assert not [n for n in _imported(fn)
                        if n.split(".")[0] in BANNED], fn.name


def test_the_guard_sees_every_import_form():
    src = "import jax.numpy\nfrom repro.models import x\nimport repro_torch\n"
    assert [n.split(".")[0] in BANNED for n in
            _imported(ast.parse(src))] == [True, True, False]


def _port_modules() -> dict:
    return {k: v for k, v in sys.modules.items()
            if k == "repro_torch" or k.startswith("repro_torch.")}


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_first(name):
    """Import ``name`` with no module of the port loaded yet (as a user's
    first ``import repro_torch.stream.engine`` would), then put the
    process's modules back."""
    saved = _port_modules()
    for key in saved:
        del sys.modules[key]
    try:
        importlib.import_module(name)
    finally:
        for key in _port_modules():
            del sys.modules[key]
        sys.modules.update(saved)
