"""helm_tpu_torch.tools.verify_baseline on the CPU: the four boolean
BASELINE configs replay bit-exact at the tiny test sets (`--fast`), and
`check` refuses a golden CSV with one flipped bit.

Chi-squared u32 is not repeated here: test_torch_arith.py's
test_evaluate_arith_equals_the_reference_on_chi_squared_u32 holds the
four recorded sets against helm_tpu. The keys of each set are made once
for the module and shared by every call of `main`.
"""

from pathlib import Path

import pytest

from helm_tpu_torch.tools import verify_baseline
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def keys():
    """(client key, server key) by set name, filled by the first call of
    `main` at each set."""
    return {}


@pytest.mark.parametrize("cfg", ["2-bit-adder", "s27", "8-bit-adder-lut-3-1", "c880-like"])
def test_fast_config_is_bit_exact(cfg, keys, capsys):
    assert verify_baseline.main(["--fast", "--only", cfg], keys) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "ALL BIT-EXACT"
    assert ", cpu, " in out and "MISMATCH" not in out


@pytest.mark.parametrize("typ,golden", [
    ("bool", "c880-like.outputs.csv"),
    ("u32", "chi_squared_arith_1.outputs.csv"),
])
def test_check_refuses_one_flipped_bit(tmp_path, capsys, typ, golden):
    path = ROOT / "benchmarks/test-cases" / golden
    exp = verify_baseline.csv_io.read_input_wires(str(path), typ)
    assert verify_baseline.check("golden", dict(exp), str(path), typ)
    wire = sorted(exp)[0]
    flipped = dict(exp)
    flipped[wire] = (not exp[wire]) if typ == "bool" else int(exp[wire]) ^ 1
    bad = tmp_path / "golden.csv"
    bad.write_text("wire,value\n" + "".join(
        f"{w},{int(v)}\n" for w, v in sorted(flipped.items())
    ))
    assert not verify_baseline.check("flipped", dict(exp), str(bad), typ)
    assert "[!] flipped: MISMATCH" in capsys.readouterr().out


def test_no_card_is_an_error(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        verify_baseline.main([])
