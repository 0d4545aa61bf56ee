"""Collect the measurement tools' results from their logs into one JSON
document.

Counterpart of `tools/collect_results.py`, with the reference's three keys
and field names, reading the lines the port's tools print:
  sweeps   `tools/mb_sweep.py`: `{layout} gt={gt} (ignored: ...): X rot/s
           (first call Y s)`: layout, gt, rot_s, compile_s (the first
           call's seconds), ablate "" (the port has no ablation probes)
           and the log's path
  results  every `RESULT {json}` line (family_bench, aes_bench's caller,
           chi2_bench, the noise tools, k1_phases, param_search); a line
           whose JSON does not parse is skipped
  aes      `tools/aes_bench.py`: `AES-128 steady-state: Xs[ for B blocks =
           Ys/block|/block] (set, backend=..., fused=...)`: total_s,
           blocks (1 when no batch), s_per_block, params, backend
Logs that cannot be read are skipped.

    python -m helm_tpu_torch.tools.collect_results [LOG ...]

Default logs: every `*.log` under `chiprun_out/` at the repository root.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

LOG_DIR = Path(__file__).resolve().parents[2] / "chiprun_out"

SWEEP = re.compile(
    r"^(\w+) gt=(\d+) \(ignored: [^)]*\): ([\d.]+) rot/s \(first call ([\d.]+)s\)", re.M)
RESULT = re.compile(r"^RESULT (\{.*\})$", re.M)
AES = re.compile(
    r"AES-128 steady-state: ([\d.]+)s(?: for (\d+) blocks = ([\d.]+)s/block|/block)?"
    r" \((\w+), backend=(.+?)(?:, fused=\w+)?\)$", re.M)


def default_logs() -> list[str]:
    return sorted(str(p) for p in LOG_DIR.rglob("*.log"))


def collect(logs) -> dict:
    """{"sweeps", "results", "aes"} from the log files `logs`."""
    sweeps, results, aes = [], [], []
    for path in logs:
        try:
            text = open(path, errors="replace").read()
        except OSError:
            continue
        for m in SWEEP.finditer(text):
            sweeps.append({"layout": m.group(1), "gt": int(m.group(2)), "ablate": "",
                           "rot_s": float(m.group(3)), "compile_s": float(m.group(4)), "log": str(path)})
        for m in RESULT.finditer(text):
            try:
                results.append(json.loads(m.group(1)))
            except json.JSONDecodeError:
                pass
        for m in AES.finditer(text):
            aes.append({"total_s": float(m.group(1)), "blocks": int(m.group(2) or 1),
                        "s_per_block": float(m.group(3) or m.group(1)), "params": m.group(4),
                        "backend": m.group(5)})
    return {"sweeps": sweeps, "results": results, "aes": aes}


def main(argv=None) -> int:
    logs = (sys.argv[1:] if argv is None else argv) or default_logs()
    print(json.dumps(collect(logs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
