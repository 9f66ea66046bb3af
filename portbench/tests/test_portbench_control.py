"""The control: the reference one step below the stated precision
(bfloat16 columns, float32 groups) in the program's place comes out not
correct, for every traffic mix, where the reference in its place is
correct."""

import pytest
from conftest import CELLS

from portbench import control, reference


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(cell_name, seed):
    out = control.readings(cell_name, seed, {"n_events": 20000})
    assert out["reference"]["correct"] and not any(out["reference"]["numbers"].values())
    assert not out["control"]["correct"]
    assert out["control"]["numbers"]["baskets_wrong"] > 0


def test_bfloat16_rounds_to_nearest_even():
    import numpy as np

    x = np.array([1.0, 1.00390625, 1.005859375, 20.03125, -2.4], np.float32)
    got = reference.to_bfloat16(x)
    assert got.tolist() == [1.0, 1.0, 1.0078125, 20.0, -2.40625]
