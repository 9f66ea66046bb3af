"""On the card: a short run of each cell is correct and its trace reads
the device (``python -m pytest -m cuda portbench/tests``)."""

import time

import pytest
from conftest import CELLS

from portbench import run


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_cuda_cell_is_correct_and_traced(card, cell_name):
    result = run.run(cell_name, 77, 1.0, True, card, time.perf_counter(),
                     overrides={"n_events": 200_000})
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
    assert "kernel_ms_per_skim" in result["metrics"]
