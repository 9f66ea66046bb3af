"""The plain reference against the port's host route (``device="cpu"``):
survivors a window and every output basket byte for byte, on small files
for every cell's traffic mix, at a basket-aligned size
and one with a short last basket."""

import pytest
from conftest import MIXES

from portbench import judge, manifest, window


def host_skims(config_name: str, traffic_name: str, n_events: int, seed: int):
    config = {**manifest.config(manifest.load(), config_name), "n_events": n_events}
    traffic = manifest.traffic(traffic_name)
    files = window.make_files(config, seed, traffic["files"])
    engines = window.open_engines(config, traffic, files, "cpu")
    skims = [window.skim(e, traffic, f) for f, e in enumerate(engines)]
    for s in skims:
        s.read_output()
    refs = [judge.FileReference(traffic["query"], c, j, config["basket_events"])
            for c, j in files]
    return skims, refs


@pytest.mark.parametrize("n_events", [16384, 13001])
@pytest.mark.parametrize("mix", MIXES)
def test_reference_equals_the_port_host_route(mix, n_events):
    skims, refs = host_skims(*mix, n_events, seed=2**31 + 7)
    verdict = judge.judge(skims, refs)
    assert verdict["correct"], verdict
    for s, r in zip(skims, refs):
        assert s.n_passed == int(r.mask.sum()) > 0
        assert set(s.blobs) == set(r.output()[2])


def test_reference_sees_a_changed_survivor():
    skims, refs = host_skims("nanoaod-1m", "zee", 16384, seed=3)
    ref = refs[0]
    i = int(ref.mask.nonzero()[0][0])
    ref.mask[i] = False
    ref._output = None
    one = judge.judge_skim(skims[0], ref)
    assert one["windows_wrong"] == 1 and one["passed_gap"] == 1 and one["baskets_wrong"] > 0
