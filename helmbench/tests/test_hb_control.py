"""The check fails where it must: the control (the key rounded to the
configuration's `control.bsk_bits`) and each planted fault a cell can have
come out not correct; the sound run comes out correct."""

import pytest

from helmbench import control, harness
from helmbench.tests.hbutil import TEST_CONFIGS, run_cpu

CELLS = [("c880_test", "one_vector"), ("chi2_test", "backlog8")]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_control_bsk_rounded_is_not_correct(config, traffic):
    bits = harness.load_config(config, TEST_CONFIGS)["control"]["bsk_bits"]
    with control.bsk_rounded(bits):
        out = run_cpu(config, traffic)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("config,traffic", CELLS)
def test_planted_fault_is_not_correct(fault, config, traffic):
    if fault == "half_batch" and traffic == "one_vector":
        pytest.skip("a batch of one has no half to leave out")
    out = run_cpu(config, traffic, hooks=control.FAULTS[fault])
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.card
def test_control_on_the_card_at_the_cells_size(card):
    import subprocess
    import sys

    from helmbench.harness import ROOT

    proc = subprocess.run(
        [sys.executable, str(ROOT / "helmbench" / "control.py"), "--workload", "c880_gates128.one_vector",
         "--seeds", "101,102,103", "--seconds", "30"],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
    )
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert proc.returncode == 0 and len(lines) == 3
    assert all('"correct": false' in line for line in lines)
