"""helm_tpu_torch — the PyTorch / CUDA port of helm_tpu, for NVIDIA Hopper.

Counterpart of `helm_tpu/__init__.py`. The JAX package stays the
reference. This package keeps its own copies of the reference's numpy
modules (parameter sets, client keys, netlist front end, level planner,
CSV I/O) and replaces the JAX pipeline and the Pallas kernels with torch
ops and hand-written CUDA. It imports `torch`, and nothing of `jax` or of
`helm_tpu` (tests/test_torch_isolation.py).

Top-level API (lazy imports — `import helm_tpu_torch` stays cheap):

    helm_tpu_torch.read_verilog_file(path, is_arith)   netlist frontend
    helm_tpu_torch.Circuit                             scheduler + plaintext oracle
    helm_tpu_torch.BooleanEngine                       gates and LUT modes on a torch device
    helm_tpu_torch.ArithEngine                         arith mode (radix integers) on a torch device
    helm_tpu_torch.params                              parameter sets (ALL_PARAMS)

A worked walkthrough of these calls (client keygen, encryption, evaluation,
decryption; gates, sequential, arith, batched and the radix ops on word
tensors) is `helm_tpu_torch/examples/library_api.py`:

    python -m helm_tpu_torch.examples.library_api [--device cpu]
"""

__version__ = "0.3.0"

__all__ = [
    "ArithEngine",
    "BooleanEngine",
    "Circuit",
    "params",
    "read_verilog_file",
]


def __getattr__(name):
    if name == "ArithEngine":
        from .engines.arith import ArithEngine

        return ArithEngine
    if name == "BooleanEngine":
        from .engines.boolean import BooleanEngine

        return BooleanEngine
    if name == "Circuit":
        from .circuit.graph import Circuit

        return Circuit
    if name == "read_verilog_file":
        from .circuit.verilog import read_verilog_file

        return read_verilog_file
    if name == "params":
        import importlib

        return importlib.import_module(".params", __name__)
    raise AttributeError(f"module 'helm_tpu_torch' has no attribute {name!r}")
