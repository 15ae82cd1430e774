"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no script of ``tools/`` imports JAX (``jax``,
``jaxlib``) or the JAX package (``repro``, ``repro.*``).  Walks each
file's syntax tree, so an import inside a function counts too."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_the_port_has_modules_to_check():
    assert len(FILES) > 30 and (ROOT / "chip_smoke.py").is_file()
    assert ROOT / "tools" / "k8_k11_ablation.py" in FILES


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imports(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
