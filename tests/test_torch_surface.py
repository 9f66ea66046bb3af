"""The port's public surface against the JAX package's, read from source.

One parity test must be able to drive both packages, so the port mirrors
the JAX package's layout and names (ROADMAP "Names that differ on
purpose").  These tests read both packages' sources with ``ast`` and
import neither, so they run where only one of them can be imported (the
card's machine has no JAX).  For each module of ``src/repro/``:

* a module of the same path exists under ``src/repro_torch/``;
* every name in its ``__all__`` is in the port's ``__all__``;
* every public top-level name it defines (a function, a class or an
  assignment) is bound in the port's module (defined or imported);
* every public function, and every public method (``__init__``
  included) of a public class, exists in the port with the same
  positional arguments in the same order, leaving out the Pallas-only
  keywords; the port may add arguments after them (``backend``,
  ``device``);
* each of its keyword-only arguments is one the port's function takes
  by keyword, each default value is the port's for the argument of that
  name (source text, ``jnp.X`` read as ``torch.X``), and every argument
  the port adds has a default: so a call the JAX function takes, the
  port's takes with the same meaning.

The names the port leaves out or keeps elsewhere are the one literal
list below, which ROADMAP's "Names that differ on purpose" repeats.
"""

import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
JAX_PKG, PORT = SRC / "repro", SRC / "repro_torch"

# keywords that mean something only under Pallas or XLA; the port's
# ``backend`` and ``device`` take their place
PALLAS_KEYWORDS = frozenset(
    {"use_pallas", "interpret", "donate", "block_q", "block_k", "event_tile"})

# (module, name) -> None where the port has no such name (it means
# something only under Pallas or XLA), or the port's module that holds it
DIFFER_ON_PURPOSE = {
    ("kernels/ops.py", "default_interpret"): None,
    ("kernels/ops.py", "donate_supported"): None,
    ("kernels/skim_fused.py", "stitch_tiles"): None,
    ("kernels/basket_decode.py", "basket_decode_ref"): None,  # ref.basket_decode_ref
    ("kernels/flash_attention.py", "DEFAULT_BQ"): None,
    ("kernels/flash_attention.py", "DEFAULT_BK"): None,
    ("kernels/flash_attention.py", "NEG_INF"): None,
    ("kernels/predicate_eval.py", "EVENT_TILE"): None,
    ("kernels/predicate_eval.py", "compile_query"): "kernels/program.py",
    ("kernels/predicate_eval.py", "Program"): "kernels/program.py",
    ("kernels/predicate_eval.py", "Group"): "kernels/program.py",
    ("kernels/ref.py", "OP_IDS"): "kernels/program.py",
}

MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _all(tree: ast.Module) -> set[str] | None:
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def _defined(tree: ast.Module) -> set[str]:
    """Public names the module's top level defines."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _bound(tree: ast.Module) -> set[str]:
    """Names the module's top level defines or imports."""
    names = _defined(tree)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def _callables(tree: ast.Module) -> dict[str, list[str]]:
    """Public functions and public classes' public methods (and
    ``__init__``) -> their positional arguments, Pallas keywords left out."""
    out = {}

    def args(fn) -> list[str]:
        return [a.arg for a in fn.args.posonlyargs + fn.args.args
                if a.arg not in PALLAS_KEYWORDS]

    for node in tree.body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = args(node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not sub.name.startswith("_") or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = args(sub)
    return out


def _parameters(tree: ast.Module) -> dict[str, dict[str, tuple[str, str | None]]]:
    """Public functions and public classes' public methods (and
    ``__init__``) -> {argument: (kind, default's source or None)}, kind
    "positional" (positional-only or positional-or-keyword), "keyword"
    (keyword-only) or "star" (``*args``, ``**kwargs``), the default's
    source with ``jnp.`` read as ``torch.``."""
    def params(fn) -> dict[str, tuple[str, str | None]]:
        a = fn.args
        pos = a.posonlyargs + a.args
        defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
        out = {}
        for arg, d in zip(pos + a.kwonlyargs, defaults + list(a.kw_defaults)):
            kind = "keyword" if arg in a.kwonlyargs else "positional"
            src = None if d is None else ast.unparse(d).replace("jnp.", "torch.")
            out[arg.arg] = (kind, src)
        for arg in (a.vararg, a.kwarg):
            if arg is not None:
                out[arg.arg] = ("star", None)
        return out

    out = {}
    for node in tree.body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not sub.name.startswith("_") or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = params(sub)
    return out


def _keyword_faults(module: str, jt: ast.Module, tt: ast.Module) -> list[str]:
    """Where a JAX module's (``jt``) functions' keyword-only arguments or
    default values are not its mirror's (``tt``), as lines (the positional
    order is :func:`_surface_faults`'s)."""
    port = _parameters(tt)
    faults = []
    for name, want in _parameters(jt).items():
        got = port.get(name)
        if got is None or _differs(module, name):
            continue
        for arg, (kind, default) in want.items():
            if arg in PALLAS_KEYWORDS or kind == "star":
                continue
            if arg not in got:
                faults.append(f"{module}: {name} takes no {arg!r} in the port")
            elif default is not None and got[arg][1] != default:
                faults.append(f"{module}: {name}({arg}={got[arg][1]}) in the port, "
                              f"({arg}={default}) in the JAX package")
        faults += [f"{module}: {name}'s port-only {arg!r} has no default"
                   for arg, (kind, default) in got.items()
                   if arg not in want and kind != "star" and default is None]
    return faults


def _differs(module: str, name: str) -> bool:
    return (module, name.split(".")[0]) in DIFFER_ON_PURPOSE


def _surface_faults(module: str) -> list[str]:
    """What the port's ``module`` lacks of the JAX package's, as lines."""
    if not (PORT / module).is_file():
        return [f"{module}: no module of that path in the port"]
    jt, tt = _tree(JAX_PKG / module), _tree(PORT / module)
    faults = []
    j_all, t_all = _all(jt), _all(tt)
    if j_all is not None:
        missing = sorted(n for n in j_all - (t_all or set()) if not _differs(module, n))
        faults += [f"{module}: {n} is in the JAX __all__, not the port's" for n in missing]
    faults += [f"{module}: {n} is not bound in the port"
               for n in sorted(_defined(jt) - _bound(tt)) if not _differs(module, n)]
    port = _callables(tt)
    for name, want in _callables(jt).items():
        if _differs(module, name):
            continue
        got = port.get(name)
        if got is None:
            faults.append(f"{module}: {name} is not in the port")
        elif got[:len(want)] != want:
            faults.append(f"{module}: {name}({', '.join(got)}) in the port, "
                          f"({', '.join(want)}) in the JAX package")
    return faults


@pytest.mark.parametrize("module", MODULES)
def test_port_module_has_the_jax_module_surface(module):
    assert _surface_faults(module) == []


@pytest.mark.parametrize("module", MODULES)
def test_port_functions_take_the_jax_keywords_and_defaults(module):
    assert _keyword_faults(module, _tree(JAX_PKG / module), _tree(PORT / module)) == []


def test_the_keyword_walk_reports_each_kind_of_fault():
    """A default that differs (``jnp.X`` read as ``torch.X``), a JAX
    keyword-only argument the port lacks and a port-only argument with no
    default are each reported; a Pallas keyword, a keyword-only argument
    the port takes positionally and an equal default are not."""
    jax_src = ("def f(a, b=jnp.float32, *, c=1, g=None, use_pallas=None):\n    pass\n"
               "def h(x=jnp.int32):\n    pass\n")
    port_src = ("def f(a, b=torch.float64, g=None, d=None, e=None, *, k):\n    pass\n"
                "def h(x=torch.int32, device=None):\n    pass\n")
    assert _parameters(ast.parse(jax_src))["f"] == {
        "a": ("positional", None), "b": ("positional", "torch.float32"),
        "c": ("keyword", "1"), "g": ("keyword", "None"), "use_pallas": ("keyword", "None")}
    assert _keyword_faults("x.py", ast.parse(jax_src), ast.parse(port_src)) == [
        "x.py: f(b=torch.float64) in the port, (b=torch.float32) in the JAX package",
        "x.py: f takes no 'c' in the port",
        "x.py: f's port-only 'k' has no default",
    ]


def test_every_name_that_differs_on_purpose_still_differs():
    """Each entry names a public name of the JAX module that the port's
    module of the same path does not hold as it is; a name the port
    keeps elsewhere is in that module, with the same positional
    arguments.  So the list cannot outlive what it excuses."""
    for (module, name), home in DIFFER_ON_PURPOSE.items():
        jt, tt = _tree(JAX_PKG / module), _tree(PORT / module)
        assert name in _defined(jt), (module, name)
        if home is None:
            assert name not in _bound(tt), (module, name)
            continue
        ht = _tree(PORT / home)
        assert name in _defined(ht), (module, name, home)
        h_calls = _callables(ht)
        for key, want in _callables(jt).items():
            if key == name or key.startswith(f"{name}."):
                assert h_calls.get(key, [])[:len(want)] == want, (key, home)


def test_the_walk_sees_both_packages():
    assert len(MODULES) > 30 and "kernels/ops.py" in MODULES
    assert {"cascade_stage_step", "cascade_stage_step_staged"} <= _all(
        _tree(PORT / "kernels" / "ops.py"))
