"""ctypes binding to the native graph library (`helm_tpu_torch/native/graph.cpp`).

Counterpart of `helm_tpu/circuit/native.py`: parses and levelizes
netlists in C++ for large circuits, with the Python parser's schedule
(tests/test_torch_native.py). The library is built with g++ on first use
into `build/native/` (`ops/build.py` `load_native`); where the reference
falls back to the Python parser without its library, the port raises.
"""

from __future__ import annotations

import ctypes

from ..ops import build
from .gates import Gate, GateType
from .graph import Circuit
from .verilog import Netlist

_TYPE_MAP = {t.value: t for t in GateType}


def _lib() -> ctypes.CDLL:
    lib = build.load_native("graph")
    if lib.helm_parse_netlist.restype is not ctypes.c_void_p:
        lib.helm_parse_netlist.restype = ctypes.c_void_p
        lib.helm_parse_netlist.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.helm_free.restype = None
        lib.helm_free.argtypes = [ctypes.c_void_p]
    return lib


def parse_and_levelize(path: str, is_arith: bool = False):
    """Returns (Netlist, Circuit with level_map populated), parsed in C++;
    a netlist the parser refuses raises ValueError with its message."""
    lib = _lib()
    ptr = lib.helm_parse_netlist(str(path).encode(), 1 if is_arith else 0)
    try:
        text = ctypes.string_at(ptr).decode()
    finally:
        lib.helm_free(ptr)
    lines = text.splitlines()
    if not lines or lines[0].startswith("ERR"):
        raise ValueError(lines[0][4:] if lines else "native parser failed")
    if lines[0] != "OK":
        raise ValueError(f"native parser: unexpected first line {lines[0]!r}")
    flags = lines[1].split()
    has_luts, has_arith = flags[1] == "1", flags[2] == "1"
    inputs = lines[2].split()[1:]
    outputs = lines[3].split()[1:]
    dff_outputs = lines[4].split()[1:]

    gates: list[Gate] = []
    wire_set: set[str] = set()
    level_map: dict[int, list[Gate]] = {}
    for line in lines[5:]:
        if not line.startswith("G "):
            continue
        toks = line.split()
        level = int(toks[1])
        gtype = _TYPE_MAP[toks[2]]
        name, output = toks[3], toks[4]
        lut_const_int = int(toks[5])
        n_in = int(toks[6])
        ins = toks[7 : 7 + n_in]
        lut_const = None
        if gtype == GateType.LUT:
            lut_const = [(lut_const_int >> i) & 1 for i in range(1 << len(ins))]
        g = Gate(name, gtype, ins, output, lut_const, level=level)
        gates.append(g)
        wire_set.add(output)
        level_map.setdefault(level, []).append(g)

    nl = Netlist(gates, wire_set, inputs, outputs, dff_outputs, has_luts, has_arith)
    c = Circuit([], inputs, outputs, dff_outputs)
    c.level_map = level_map
    return nl, c
