"""Nothing the benchmark runs loads JAX, the JAX package (``repro``), its
harness (``benchmarks``) or ``chip_smoke``, compared by top-level module
name whole: ``repro_torch`` is the port and passes."""

import ast
import json
import subprocess
import sys

from conftest import CELLS, ROOT

from portbench.run import FORBIDDEN


def top_names(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_import_statement_under_portbench_names_them():
    sources = [p for p in (ROOT / "portbench").rglob("*.py") if "tests" not in p.parts]
    assert len(sources) > 20
    found = {str(p): top_names(p) & set(FORBIDDEN) for p in sources}
    assert not any(found.values()), found
    assert "repro_torch" in set().union(*(top_names(p) for p in sources))


def test_the_top_level_name_is_compared_whole(monkeypatch):
    from portbench import run

    before = run.forbidden_modules()
    for name in ("repro_torch.core.engine", "reprox", "jax_like", "benchmarks_torch"):
        monkeypatch.setitem(sys.modules, name, None)
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro.core", None)
    assert "repro" in run.forbidden_modules()


def test_a_run_loads_none_of_them():
    """Every module a run of each cell loads, in a fresh process (the card's
    look skipped: the CPU route, small files)."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from portbench import run
for cell in {json.dumps(CELLS)}:
    r = run.run(cell, 11, 0.2, True, "cpu", time.perf_counter(), overrides={{"n_events": 9000}})
    assert r["correct"], r
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
