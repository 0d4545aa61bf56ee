"""The benchmark's yardstick: the card's stated peaks and the least time of
the work a window did, counted from a parameter set and counts of work.

Nothing here reads the program. The least times are the algorithm's:

- a blind rotation (multi-bit, grouping g) of one gate, counted at ONE
  modulus whatever the program's number of CRT primes or its route: per
  group of g mask elements, (rows + k + 1) negacyclic transforms of size
  N at N/2 log2 N butterflies each, rows x (2^g - 1) x (k + 1) x N
  multiply-adds against the key, and (2^g - 1) x (k + 1) x N
  multiply-adds by the subset monomials; at OPS_PER_BUTTERFLY and
  OPS_PER_MULADD integer operations, against INT32_OPS_PER_S;
- a keyswitch call of G slots: the larger of its key read once
  (big_n x ks_level x (n + 1) words of 4 bytes, against HBM_BYTES_PER_S)
  and its multiply-adds (2 operations each, against INT8_OPS_PER_S).

Peaks: one NVIDIA H100 SXM at its full 700 W power limit. 132 SMs x 64
INT32 lanes x 1.98 GHz boost; 3.35 TB/s of HBM3; 1,979 dense int8 TOP/s
on the tensor cores (NVIDIA's data sheet).
"""

from __future__ import annotations

import math

INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

#: integer operations of one radix-2 butterfly mod a prime (a Shoup
#: multiply of 4, an add and a subtract each with a conditional
#: correction) and of one multiply-add into an accumulator
OPS_PER_BUTTERFLY = 10
OPS_PER_MULADD = 2


def rotation_ops(n: int, k: int, N: int, rows: int, g: int) -> int:
    """Integer operations of ONE gate's multi-bit blind rotation at one
    modulus (see the module docstring)."""
    if n % g:
        raise ValueError(f"n = {n} is not a multiple of the grouping {g}")
    kp1, nv1 = k + 1, (1 << g) - 1
    butterflies = (rows + kp1) * (N // 2) * int(math.log2(N))
    muladds = rows * nv1 * kp1 * N + nv1 * kp1 * N
    return (n // g) * (OPS_PER_BUTTERFLY * butterflies + OPS_PER_MULADD * muladds)


def rotation_least_s(params: dict, rotations: int) -> float:
    """Least seconds of `rotations` gate blind rotations at the set
    `params` (a configuration's "params": n, k, N, gadget_rows, grouping)."""
    ops = rotation_ops(params["n"], params["k"], params["N"], params["gadget_rows"], params["grouping"])
    return rotations * ops / INT32_OPS_PER_S


def keyswitch_key_bytes(params: dict) -> int:
    """Bytes of the keyswitching key read once: big_n x ks_level x (n + 1)
    words of 4 bytes."""
    return params["k"] * params["N"] * params["ks_level"] * (params["n"] + 1) * 4


def keyswitch_least_s(params: dict, calls: int, slots: int) -> float:
    """Least seconds of `calls` keyswitch calls over `slots` slots in all:
    the larger of the key read once a call and the multiply-adds of all
    slots. The sum over calls of each call's larger term is at least
    this, so the share it gives is never above the share per call."""
    macs = params["k"] * params["N"] * params["ks_level"] * (params["n"] + 1)
    return max(calls * keyswitch_key_bytes(params) / HBM_BYTES_PER_S, slots * 2 * macs / INT8_OPS_PER_S)
