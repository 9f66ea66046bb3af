"""The repo's lint gates over the PyTorch/CUDA port (``src/repro_torch``).

``tests/test_skimlint.py`` gates the JAX package; this file holds the
port to the same rules: no unsuppressed skimlint finding (a bare
``# skimlint: ignore`` is itself one, X001), no bare ``extras[...]``
write (``tools/check_extras.py``), and no example module that imports
JAX or the JAX package.
"""

import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tools import check_extras  # noqa: E402
from tools.skimlint import lint_paths  # noqa: E402

PORT = ROOT / "src" / "repro_torch"
EXAMPLE_FILES = sorted((PORT / "examples").glob("*.py"))


def test_src_repro_torch_is_clean():
    res = lint_paths([str(PORT)])
    assert res.findings == [], [f.render() for f in res.findings]
    assert res.files > 45  # the walk actually saw the tree


def test_src_repro_torch_has_no_bare_extras_write():
    assert check_extras.scan([PORT]) == []
    assert check_extras.main([str(PORT)]) == 0


def imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_every_example_has_a_module():
    assert [p.stem for p in EXAMPLE_FILES] == sorted(
        ["__init__", "quickstart", "skim_expr", "skim_service",
         "skim_service_async", "skim_cluster"])


@pytest.mark.parametrize("path", EXAMPLE_FILES, ids=lambda p: p.stem)
def test_example_imports_neither_jax_nor_the_jax_package(path):
    names = imported_modules(path)
    assert any(n.startswith("repro_torch") for n in names), names
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert bad == [], bad
