"""A run with the timed path broken underneath comes out not correct, for
each fault a skim can have: the filter returning its input unchanged, half
of the windows' survivors left out of the output, and one value altered
where it is produced.  (No cell spans chips: there is no exchange to
leave out.)  The harness runs on the CPU route at a small size, its look
for a card skipped."""

import time

import numpy as np
import pytest
from conftest import CELLS

from portbench import run


def run_cell(cell_name):
    return run.run(cell_name, 2**31 + 11, 0.3, False, "cpu", time.perf_counter(),
                   overrides={"n_events": 40000})


def unchanged(monkeypatch):
    from repro_torch.core import plan

    one, batch = plan.CascadeExecutor.run_window, plan.CascadeExecutor.run_window_batch

    def keep_all(outcome):
        outcome.mask = np.ones_like(outcome.mask)
        return outcome

    monkeypatch.setattr(plan.CascadeExecutor, "run_window",
                        lambda self, *a, **k: keep_all(one(self, *a, **k)))
    monkeypatch.setattr(plan.CascadeExecutor, "run_window_batch",
                        lambda self, *a, **k: [keep_all(o) for o in batch(self, *a, **k)])


def half_left_out(monkeypatch):
    from repro_torch.core import engine

    concat = engine._concat_output

    def first_half(out_cols, n_passed, plan_, store):
        return concat({k: v[: (len(v) + 1) // 2] for k, v in out_cols.items()},
                      n_passed, plan_, store)

    monkeypatch.setattr(engine, "_concat_output", first_half)


def one_value_altered(monkeypatch):
    from repro_torch.core import engine

    select = engine._select_columns

    def altered(data, mask, store):
        cols, jagged = select(data, mask, store)
        if len(cols.get("MET_pt", ())):
            cols["MET_pt"] = cols["MET_pt"].copy()
            cols["MET_pt"][-1] = np.nextafter(cols["MET_pt"][-1], np.float32(np.inf))
        return cols, jagged

    monkeypatch.setattr(engine, "_select_columns", altered)


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_left_out, one_value_altered])
def test_a_broken_run_is_not_correct(monkeypatch, cell_name, fault):
    assert run_cell(cell_name)["correct"]
    fault(monkeypatch)
    result = run_cell(cell_name)
    assert result["correct"] is False
    assert result["failed"] >= 1
    assert sum(c["value"] for c in result["checks"].values()) > 0
