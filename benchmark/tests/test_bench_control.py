"""On the card, at each cell's own sizes: the program's comparison comes
out correct and its control's does not.  The control is the reference put
in the program's place with TF32 (the precision below the configurations'
float32); for a training cell also each fault that ``calibrate.py``
plants (half of each batch left out, R1 skipped, the path-length step
skipped) fails a limit.  One seed per cell here; ``calibrate.py`` takes more."""

import pytest

from harness import spec

calibrate = spec.load_module(f"{spec.BENCH_DIR}/calibrate.py", "bench_calibrate")
CELLS = [w["name"] for w in spec.benchmark_json()["workloads"]]
SEED = 2**31 + 977


def _ok(numbers, limits):
    return all(numbers[k] <= v for k, v in limits.items())


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, cuda):
    cell = spec.find_cell(name)
    if cell.driver == "train":
        rec = calibrate.train_seed(cell, SEED, control=True)
    else:
        rec = calibrate.edit_seed(cell, SEED, control=True, seconds=2.0)
    assert _ok(rec["numbers"]["program"], cell.limits), rec
    for kind, numbers in rec["numbers"].items():
        if kind != "program":
            assert not _ok(numbers, cell.limits), (kind, rec)
