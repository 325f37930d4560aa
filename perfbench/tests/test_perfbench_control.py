"""The control, on the card at the cell's own size: for one seed the
program's answers pass every limit and the control (the reference one
precision down, TF32, in the program's place) fails one.  Each reads
about two minutes of the card; ``perfbench/control.py`` reads the dozen
seeds the limits were set from."""
import pytest

from perfbench import control, harness

from .small import manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cuda, cell):
    limits = harness.load_json(harness.BENCH / "limits" / f"{cell}.json")
    program, low = control.read(cell, 4100000001, 8.0, device=cuda,
                                man=manifest())
    assert all(program[k] <= limits[k]["limit"] for k in program), program
    assert any(low[k] > limits[k]["limit"] for k in low), low
