"""The control of each cell on the card, at the cell's own size: the plain
reference put in the program's place in the precision below the
configuration's (TF32 products; bfloat16 for the neural-ODE cell, whose
one-row products TF32 leaves in float32) must fail at least one of the
cell's limits, and the same reference in full float32 must pass them all.
About 8 minutes on an H100; ``python -m pytest -m cuda benchmark/tests``."""

import pytest

from benchmark import harness as H

CELLS = ["nnf.validate", "nnd.validate", "nnd.train", "nnf.node_train"]
LOW = {"nnf.node_train": "bf16"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_float32_passes(name, card):
    cell = H.Cell.find(name, seed=2**31 + 77)
    cell.device = card
    limits = cell.workload["limits"]
    (reading,) = cell.driver().control(cell, [cell.seed]).values()

    def fails(numbers):
        if not isinstance(numbers, dict):
            numbers = {"mae_gap": numbers}
        return [n for n, v in numbers.items() if not v <= limits[n]]

    assert fails(reading[LOW.get(name, "tf32")])
    assert not fails(reading["f32"])
