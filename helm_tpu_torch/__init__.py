"""helm_tpu_torch — the PyTorch / CUDA port of helm_tpu, for NVIDIA Hopper.

Counterpart of `helm_tpu/__init__.py`. The JAX package stays the
reference; this package reuses its numpy-only modules (parameter sets,
client keys, netlist front end, level planner, CSV I/O) and replaces the
JAX pipeline and the Pallas kernels with torch ops and hand-written CUDA.
It imports `torch` and never `jax`.

Top-level API (lazy imports — `import helm_tpu_torch` stays cheap):

    helm_tpu_torch.read_verilog_file(path, is_arith)   netlist frontend
    helm_tpu_torch.Circuit                             scheduler + plaintext oracle
    helm_tpu_torch.BooleanEngine                       gates mode on a torch device
    helm_tpu_torch.params                              parameter sets (ALL_PARAMS)
"""

__version__ = "0.1.0"

__all__ = [
    "BooleanEngine",
    "Circuit",
    "params",
    "read_verilog_file",
]


def __getattr__(name):
    if name == "BooleanEngine":
        from .engines.boolean import BooleanEngine

        return BooleanEngine
    if name == "Circuit":
        from helm_tpu.circuit.graph import Circuit

        return Circuit
    if name == "read_verilog_file":
        from helm_tpu.circuit.verilog import read_verilog_file

        return read_verilog_file
    if name == "params":
        import importlib

        return importlib.import_module("helm_tpu.params")
    raise AttributeError(f"module 'helm_tpu_torch' has no attribute {name!r}")
