"""A run with the timed path broken underneath comes out not correct: the
whole run (set-up, window, check) with each cell's own limits, on the CPU
at a tiny size, with each fault of `faults.py` planted in the exact scan's
step (`hivemall_tpu_torch.kernels.linear_scan.linear_scan`, its plain
torch version on the CPU)."""

import pytest

from portbench import faults, harness, spec

CELLS = ("arow_kdd12.scan", "scw_kdd10a.scan")


def run(root, workload):
    doc = spec.load(root)
    return harness.run(doc, workload, 2 ** 31 + 99, 0.01, False,
                       device="cpu", root=root)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_root, workload):
    result, lines = run(tiny_root, workload)
    assert result["correct"], lines


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_broken_step_is_not_correct(tiny_root, workload, fault):
    with faults.planted(fault):
        result, lines = run(tiny_root, workload)
    assert not result["correct"], lines
    failed = [n for n, c in result["compared"].items()
              if c["value"] > c["limit"]]
    assert failed and "examples" not in failed, lines
