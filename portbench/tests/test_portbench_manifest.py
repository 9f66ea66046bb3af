"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of its own."""

import json
import re
import shutil

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys_and_limits(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench).encode()) <= 64 * 1024


def test_entries_have_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
    assert all(one_line(word) for word in bench["command"]) and len(bench["command"]) <= 32


def one_line(text: str) -> bool:
    """A free-text field: 1 to 200 characters, on one line, with no tab."""
    return 1 <= len(text) <= 200 and not any(ch in text for ch in "\n\r\t")


def test_names_and_units_use_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in bench["end_to_end"] + bench["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in bench["end_to_end"] + bench["per_layer"])
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in bench[kind]}) == len(bench[kind])


def test_every_name_resolves_to_its_file(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        config = manifest.config(bench, w["config"])
        assert config["name"] == w["config"]
        manifest.generator(config["generator"])
        assert manifest.traffic(w["traffic"])["name"] == w["traffic"]
        assert manifest.metrics_of(bench, w["name"], "per_layer")
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and set(c["reduced"]) <= set(
            json.loads((manifest.ROOT / c["file"]).read_text()))
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells


def test_a_new_mix_is_found_without_editing_a_file(tmp_path):
    copy = tmp_path / "repo"
    shutil.copytree(manifest.ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (copy / "portbench").rglob("*") if p.is_file()}
    mix = json.loads((copy / "portbench/traffic/quickstart.json").read_text())
    mix.update(name="quickstart-trial", device_batch=8)
    (copy / "portbench/traffic/quickstart-trial.json").write_text(json.dumps(mix))
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "nanoaod-1m.quickstart-trial", "config": "nanoaod-1m",
                               "traffic": "quickstart-trial", "chips": 1, "why": "a trial"})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    cell = manifest.cell(manifest.load(copy), "nanoaod-1m.quickstart-trial")
    assert manifest.traffic(cell["traffic"], copy / "portbench")["device_batch"] == 8
    assert manifest.config(manifest.load(copy), cell["config"], copy)["name"] == "nanoaod-1m"
    with pytest.raises(KeyError):
        manifest.cell(manifest.load(), "nanoaod-1m.quickstart-trial")


def test_a_file_holds_every_published_branch_in_its_type(bench):
    """The configuration's file has ``n_branches`` branches, among them every
    branch of each published group, in its published type."""
    for c in bench["configs"]:
        config = {**manifest.config(bench, c["name"]), "n_events": 5000}
        cols, jagged = manifest.generator(config["generator"]).columns(config, 2**31 + 5)
        assert len(cols) == config["n_branches"] < config["published_n_branches"]
        for group, by_type in config.get("published", {}).items():
            for dtype, names in by_type.items():
                for var in names:
                    assert cols[f"{group}_{var}"].dtype == dtype, (group, var)
                    assert (f"{group}_{var}" in jagged) == (f"n{group}" in cols)
