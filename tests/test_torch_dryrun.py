"""`helm_tpu_torch.parallel.dryrun.dryrun_multichip` on four virtual CPU
shards: the reference's four checks (`__graft_entry__.py::dryrun_multichip`:
the noisy multi-bit 8-bit adder, the noisy k=2 LUT adder, the fused 2-bit
adder and chi-squared u8) print their four OK lines. About 50 s alone on
the CPU: every shard runs its own plain blind rotation.
"""

from helm_tpu_torch.parallel.dryrun import dryrun_multichip
from _port_threads import compute_share  # noqa: F401,E402 (autouse)


def test_dryrun_multichip_on_four_virtual_shards(capsys):
    dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and all(line.startswith("dryrun_multichip(4): ") for line in lines)
    assert "OK — 90+33=123 on mesh GateMesh('gates': 4 shards" in lines[0]
    assert lines[1:] == [
        "dryrun_multichip(4): LUT OK — 43+77=120",
        "dryrun_multichip(4): fused shards OK — 1+3+1=5",
        "dryrun_multichip(4): arith OK — chi-squared sharded",
    ]
