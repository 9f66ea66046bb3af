"""The port's five examples against the JAX scripts, on the CPU.

For each script under ``examples/``, the JAX ``main`` and the port's
``repro_torch.examples.<name>.main(["--device", "cpu", ...])`` run at the
same small size and seed; their stdout must agree line for line.  Only
the values that carry wall-clock time are masked, and
:data:`MASKED` names them per example (``repro_torch.examples.CLOCK_FIELDS``
holds the patterns).  The port prints one line naming its device first.

The JAX scripts are loaded from their files and left as they are:
``quickstart`` and ``skim_expr`` take no ``--events``, so their
``make_nanoaod_like`` is wrapped in the loaded module to build the same
small store.
"""

import contextlib
import importlib
import importlib.util
import io
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.examples import CLOCK_FIELDS, EXAMPLES, mask_clock

ROOT = Path(__file__).resolve().parents[1]

N_EVENTS = 9000  # three basket windows, the last one ragged

# the values each example prints that are measured on the wall clock
# (stage seconds, or modeled links plus measured compute)
MASKED = {
    "quickstart": {"Breakdown stage seconds", "speedup vs legacy client"},
    "skim_expr": set(),
    "skim_service": {"Breakdown.total() at 1 Gb/s", "Breakdown.total() at 10 Gb/s",
                     "Breakdown.total() at 100 Gb/s", "busy_fraction",
                     "Breakdown stage seconds"},
    "skim_service_async": set(),
    "skim_cluster": {"modeled makespan", "merge_s", "wall_s"},
}

TAKES_EVENTS = {"skim_service", "skim_service_async", "skim_cluster"}


def run_jax(name, monkeypatch) -> str:
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    make = mod.make_nanoaod_like
    monkeypatch.setattr(mod, "make_nanoaod_like",
                        lambda n_events, *a, **kw: make(N_EVENTS, *a, **kw))
    argv = ["--events", str(N_EVENTS)] if name in TAKES_EVENTS else []
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def run_port(name, *argv) -> str:
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(list(argv))
    return buf.getvalue()


def test_masked_fields_are_the_named_ones():
    assert set(CLOCK_FIELDS) == set(EXAMPLES) == set(MASKED)
    for name, entries in CLOCK_FIELDS.items():
        assert {f for fields, _ in entries for f in fields} == MASKED[name], name


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_what_the_jax_script_prints(name, monkeypatch):
    want, want_masked = mask_clock(name, run_jax(name, monkeypatch))
    got, got_masked = mask_clock(
        name, run_port(name, "--device", "cpu", "--events", str(N_EVENTS)))
    assert got[0] == "device: cpu"
    assert got[1:] == want
    assert got_masked == want_masked == MASKED[name]


def test_mask_blanks_only_wall_clock_values():
    text = ("   fetch              0.0100s\n"
            "   decompress         0.0200s\n"
            "   total             12.3456s\n"
            "   speedup vs legacy client-side: 3.4x\n"
            "   moved 0.12 MB in 34 requests")
    lines, seen = mask_clock("quickstart", text)
    assert lines == ["   fetch              0.0100s",
                     "   decompress<Breakdown stage seconds>s",
                     "   total<Breakdown stage seconds>s",
                     "   speedup vs legacy client-side: <speedup vs legacy client>x",
                     "   moved 0.12 MB in 34 requests"]
    assert seen == MASKED["quickstart"]
    row, _ = mask_clock("skim_service", "near_data           0.07s       0.04s"
                        "       0.04s     93%")
    assert row == ["near_data<Breakdown.total() at 1 Gb/s>s"
                   "<Breakdown.total() at 10 Gb/s>s<Breakdown.total() at 100 Gb/s>s"
                   "<busy_fraction>%"]
    line = ("cold run: 702 survivors (bit-identical to single node), modeled 20.2 ms "
            "(slowest node + 3.8 ms merge), realized 16 ms")
    assert mask_clock("skim_cluster", line)[0] == [
        "cold run: 702 survivors (bit-identical to single node), modeled "
        "<modeled makespan> ms (slowest node + <merge_s> ms merge), realized "
        "<wall_s> ms"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_card_raises_naming_the_cpu_flag(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_port(name, "--events", str(N_EVENTS))


GUARD = textwrap.dedent(
    """
    import runpy, sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    for name in {examples!r}:
        sys.argv = [name, "--device", "cpu", "--events", "{n}"]
        runpy.run_module("repro_torch.examples." + name, run_name="__main__")
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro."))]
    assert not [m for m in bad if sys.modules[m] is not None], bad
    print("ok")
    """
)


def test_examples_run_as_modules_with_jax_and_the_jax_package_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", GUARD.format(examples=EXAMPLES, n=N_EVENTS)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count("device: cpu") == len(EXAMPLES)
    assert out.stdout.rstrip().endswith("ok")
