"""The control at a size a test run holds: the reference one precision below
the configuration's, in the system's place (the TF32-rounded sweep; for
the model Oracle the fp8 forward), must read past a limit of the cell,
where the system's own readings stay within every limit.  On the card the
same readings are taken at each cell's own size by ``calibrate.py``."""
import pytest

from harness import spec
from harness.session import Session

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_system_passes(workload):
    cell = spec.load_cell(workload, rehearse=True)
    limits = cell.config["limits"]
    s = Session(cell, 20261018, "cpu")
    s.setup()
    try:
        win = s.window(n_queries=1)
        program = s.checks(win)
        control = s.control(win)
    finally:
        s.close()
    assert all(v <= limits[k] for k, v in program.items()), program
    assert any(v > limits[k] for k, v in control.items()), control


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(card, workload):
    """On the card, at the cell's own size, on three seeds."""
    cell = spec.load_cell(workload)
    limits = cell.config["limits"]
    for seed in (20261018, 4294967311, 7):
        s = Session(cell, seed, card)
        s.setup()
        try:
            win = s.window(n_queries=1)
            s.engine = None
            program = s.checks(win)
            control = s.control(win)
        finally:
            s.close()
        assert all(v <= limits[k] for k, v in program.items()), program
        assert any(v > limits[k] for k, v in control.items()), control
