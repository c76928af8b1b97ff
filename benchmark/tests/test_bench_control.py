"""The control comes out not correct: the plain reference computed in
bfloat16 (the precision below the configurations' float32) in the
program's place, read against the float32 reference at the pixels a run
checks, fails the cell's limits, where the program passes them. At the
cells' own sizes the readings come from ``calibrate.py`` on the card; on
the card, the cells themselves run once each (``-m cuda``)."""

import pytest

from bench_common import SEED, TINY

import check  # noqa: E402
import harness  # noqa: E402


@pytest.mark.parametrize("workload", [w["name"] for w in harness.Cell(
    "cbox-spheres.cli-default").spec["workloads"]])
def test_the_control_fails_where_the_program_passes(workload):
    bench = harness.Bench(workload, SEED, device="cpu", traffic=TINY)
    import torch

    win = bench.window(SEED, 0.2, False)
    rows = bench.check(SEED, win["kept"], [torch.bfloat16])
    program = check.readings([g for r in rows for g in check.gaps(r[0], r[1])])
    control = check.readings([g for r in rows for g in check.gaps(r[2], r[1])])
    limits = bench.cell.limits
    assert check.within(program, limits), program
    assert not check.within(control, limits), control


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in harness.Cell(
    "cbox-spheres.cli-default").spec["workloads"]])
def test_each_cell_is_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = harness.run(workload, SEED, 3.0, False)
    assert res["correct"] is True, res["checks"]
