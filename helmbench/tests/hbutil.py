"""Shared pieces of the benchmark's tests: a specification with a test cell
on a test configuration, and one run of it on the CPU."""

import copy
import time
from pathlib import Path

from helmbench import harness

HERE = Path(__file__).resolve().parent
TEST_CONFIGS = HERE / "configs"
SEED = (1 << 31) + 977


def spec_with(config: str, traffic: str, name: str = "test.cell") -> dict:
    """BENCHMARK.json with one more cell, listed by every metric that lists
    cells."""
    spec = copy.deepcopy(harness.load_json(harness.ROOT / "BENCHMARK.json"))
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    return spec


def run_cpu(config: str, traffic: str, seconds: float = 0.2, trace: bool = False, hooks=None,
            configs_dir: Path = TEST_CONFIGS, seed: int = SEED) -> dict:
    spec = spec_with(config, traffic)
    return harness.run_cell(spec, "test.cell", seed, seconds, trace, "cpu", time.perf_counter(),
                            configs_dir=configs_dir, hooks=hooks)
