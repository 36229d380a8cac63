"""On the card, at each cell's own sizes: the float8 control and the
planted faults fail the cell's limits on three seeds, and the program's
first steps pass them. Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest ltpbench/tests -m card
"""
import pytest

from ltpbench import cell as cells
from ltpbench.compare import judge
from ltpbench.control import readings

CELLS = [w["name"] for w in cells.manifest()["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_limits_part_program_from_control_and_faults(name, card):
    cell = cells.load(name)
    for seed in SEEDS:
        for rec in readings(cell, seed, ("program", "fp8", "half",
                                         "no_exchange"), card):
            values = {k: rec[k] for k in cell.limits()}
            ok, _ = judge(values, cell.limits())
            assert ok == (rec["variant"] == "program"), rec
