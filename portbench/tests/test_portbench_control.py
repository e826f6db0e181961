"""Each cell's control fails its check, and the program passes it, on three
seeds.

The control is the plain reference with bfloat16 tables in the program's
place, one step below the configurations' float32 (see `control.py`). On
the CPU at a tiny size; on the card at each cell's own size (`card`)."""

import pytest

from portbench import check, control, spec

CELLS = ("arow_kdd12.scan", "scw_kdd10a.scan")
SEEDS = (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3)


def verdicts(cell, device):
    limits = cell.traffic["limits"]
    out = []
    for seed in SEEDS:
        got = control.readings(cell, seed, device, control=True)
        program = {**got["program"], "examples": 0.0}
        control_ = {**got["control"], "examples": 0.0}
        out.append((check.judge(program, limits)[0],
                    check.judge(control_, limits)[0]))
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_cpu(tiny_root, workload):
    cell = spec.cell(spec.load(tiny_root), workload, tiny_root)
    assert verdicts(cell, "cpu") == [(True, False)] * len(SEEDS)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(cuda_device, workload):
    cell = spec.cell(spec.load(), workload)
    assert verdicts(cell, "cuda") == [(True, False)] * len(SEEDS)
