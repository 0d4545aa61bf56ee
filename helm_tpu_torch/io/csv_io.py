"""CSV test-vector I/O — same formats as the reference.

Input CSV rows: `wire, value` or (bool mode) `wire, hexvalue, width` which
expands to per-bit wires `wire[i]` little-endian with zero padding
(reference: src/verilog_parser.rs:278-317, hex_to_bitstring src/lib.rs:181-194).
Output CSV rows: `wire, value` (src/verilog_parser.rs:319-349).

The port's own copy of `helm_tpu/io/csv_io.py`, trimmed to what the port
calls, so that helm_tpu_torch imports nothing of the JAX package; the
tests/test_torch_*.py files hold it against the original.
"""

from __future__ import annotations

import csv

PTXT_WIDTHS = {"bool": 1, "u8": 8, "u16": 16, "u32": 32, "u64": 64, "u128": 128}


def hex_to_bitstring(hex_string: str) -> str:
    """Reference src/lib.rs:181-194 (raw hex chars). Lenient superset: an
    optional 0x/0X prefix is tolerated (the reference panics on it)."""
    if hex_string[:2] in ("0x", "0X"):
        hex_string = hex_string[2:]
    return "".join(f"{int(c, 16):04b}" for c in hex_string)


def parse_input_wire(value: str, ptxt_type: str):
    """Reference src/lib.rs:90-106: bool accepts 1/true (else false)."""
    v = value.strip()
    if ptxt_type == "bool":
        return v == "1" or v.lower() == "true"
    if ptxt_type in PTXT_WIDTHS:
        return int(v)
    raise ValueError(f"unknown ptxt type {ptxt_type}")


def read_input_wires(file_name: str, ptxt_type: str) -> dict:
    input_map: dict[str, object] = {}
    with open(file_name, newline="") as f:
        reader = csv.reader(f)
        first = True
        for record in reader:
            if not record:
                continue
            # the reference uses csv::Reader which treats row 1 as a header
            if first:
                first = False
                if record[0].strip().lower() in ("wire", "wire_name", "name"):
                    continue
            _add_record(input_map, record, ptxt_type)
    return input_map


def _add_record(input_map: dict, record: list[str], ptxt_type: str) -> None:
    wire_name = record[0].strip()
    if len(record) == 2:
        input_map[wire_name] = parse_input_wire(record[1], ptxt_type)
    elif len(record) == 3 and ptxt_type == "bool":
        width = int(record[2].strip())
        if width > 1:
            bits = hex_to_bitstring(record[1].strip())[::-1]
            for idx in range(width):
                val = idx < len(bits) and bits[idx] == "1"
                input_map[f"{wire_name}[{idx}]"] = val
        else:
            input_map[wire_name] = parse_input_wire(record[1], ptxt_type)
    else:
        raise ValueError("The CSV should contain either two or three columns")


def write_output_wires(file_name: str | None, output_map: dict) -> None:
    if file_name is None:
        return
    with open(file_name, "w") as f:
        for wire, value in output_map.items():
            if isinstance(value, bool):
                f.write(f"{wire}, {'true' if value else 'false'}\n")
            else:
                f.write(f"{wire}, {value}\n")
    print(f"Decrypted outputs written to {file_name}")
