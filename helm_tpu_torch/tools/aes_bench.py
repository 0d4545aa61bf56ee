"""AES-128 transciphering benchmark on a torch device: the port of
`tools/aes_tpu_bench.py`.

Gates-mode composite-field AES (benchmarks/netlists/aes128-gates.v, 41.4k
gates, 358 levels) on the FIPS-197 C.1 vector; BATCH > 0 evaluates B
blocks in one pass (ECB serving shape: block i = pt XOR i in byte 0).
Each ciphertext is checked against `aes_encrypt`, this module's copy of
`benchmarks/gen_circuits.py:331` (the plaintext oracle the netlist was
generated against) and of its S-box. On the card a fused engine captures
all 358 levels in one CUDA graph at its first call (the reference split
its scan at 128 levels, a TPU-worker limit) and replays it.

    python -m helm_tpu_torch.tools.aes_bench                   # the card
    NETLIST=aes1.v ROUNDS=1 PSET=TEST_PARAMS python -m helm_tpu_torch.tools.aes_bench --device cpu

Env: PSET (default GATES_TPU_MB2, the reference's), FUSE (1/0, unset =
auto), BATCH (default 0), NETLIST (default benchmarks/netlists/
aes128-gates.v), ROUNDS (the netlist's rounds, default 10: a reduced-round
netlist of gen_circuits.aes128_gates_circuit(rounds=R)). BACKEND and GT
are the TPU engine's knobs; a non-empty value exits.
"""

from __future__ import annotations

import os
import sys
import time

from ..circuit.verilog import read_verilog_file
from .family_bench import engine_for, params_named, refuse_tpu_knobs, route, sync
from .probe_timing import device_arg

PT = bytes.fromhex("00112233445566778899aabbccddeeff")
KEY = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
#: FIPS-197 appendix C.1: AES-128 of PT under KEY
C1 = "69c4e0d86a7b0430d8cdb78070b4c55a"
AES_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def aes_sbox() -> list[int]:
    """The AES S-box: the inverse in GF(2^8) mod x^8+x^4+x^3+x+1, then the
    affine map."""

    def gmul(a: int, b: int) -> int:
        r = 0
        while b:
            if b & 1:
                r ^= a
            a <<= 1
            if a & 0x100:
                a ^= 0x11B
            b >>= 1
        return r

    inv = [0] * 256
    for x in range(1, 256):
        for y in range(1, 256):
            if gmul(x, y) == 1:
                inv[x] = y
                break
    out = []
    for x in range(256):
        b = inv[x]
        s = b
        for r in range(1, 5):
            s ^= ((b << r) | (b >> (8 - r))) & 0xFF
        out.append(s ^ 0x63)
    return out


def aes_encrypt(pt: bytes, key: bytes, rounds: int = 10) -> bytes:
    """AES-128 encryption; rounds < 10 gives the reduced-round variant:
    AddRoundKey 0, then `rounds` rounds with MixColumns omitted in the
    last."""
    sbox = aes_sbox()

    def xt(b):
        return ((b << 1) ^ (0x1B if b & 0x80 else 0)) & 0xFF

    w = [list(key[4 * i : 4 * i + 4]) for i in range(4)]
    for i in range(4, 4 * (rounds + 1)):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [sbox[t[1]], sbox[t[2]], sbox[t[3]], sbox[t[0]]]
            t[0] ^= AES_RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    # state[r][c] = block byte c*4+r
    s = [[pt[c * 4 + r] ^ w[c][r] for c in range(4)] for r in range(4)]
    for rnd_i in range(1, rounds + 1):
        s = [[sbox[b] for b in row] for row in s]
        s = [[s[r][(c + r) % 4] for c in range(4)] for r in range(4)]
        if rnd_i != rounds:
            ns = [[0] * 4 for _ in range(4)]
            for c in range(4):
                a = [s[r][c] for r in range(4)]
                ns[0][c] = xt(a[0]) ^ xt(a[1]) ^ a[1] ^ a[2] ^ a[3]
                ns[1][c] = a[0] ^ xt(a[1]) ^ xt(a[2]) ^ a[2] ^ a[3]
                ns[2][c] = a[0] ^ a[1] ^ xt(a[2]) ^ xt(a[3]) ^ a[3]
                ns[3][c] = xt(a[0]) ^ a[0] ^ a[1] ^ a[2] ^ xt(a[3])
            s = ns
        rk = w[4 * rnd_i : 4 * rnd_i + 4]
        s = [[s[r][c] ^ rk[c][r] for c in range(4)] for r in range(4)]
    return bytes(s[r % 4][r // 4] for r in range(16))


def bits(pt: bytes, key: bytes) -> dict:
    m = {}
    for j in range(16):
        for i in range(8):
            m[f"pt[{8 * j + i}]"] = bool((pt[j] >> i) & 1)
            m[f"key[{8 * j + i}]"] = bool((key[j] >> i) & 1)
    return m


def ciphertext(out: dict) -> bytes:
    return bytes(sum(int(out[f"ct[{8 * j + k}]"]) << k for k in range(8)) for j in range(16))


def run(env, device, keys=None) -> dict:
    """One first and one timed evaluation; the ciphertexts against the
    oracle. Returns {"correct", "steady_s", "per_block_s", "first_s",
    "ciphertexts", "params", "backend", "batch"}."""
    refuse_tpu_knobs(env, ("BACKEND", "GT"))
    pset = params_named(env.get("PSET", "GATES_TPU_MB2"))
    fuse = bool(int(env["FUSE"])) if env.get("FUSE", "") else None
    rounds = int(env.get("ROUNDS", "10"))
    nl = read_verilog_file(env.get("NETLIST", "benchmarks/netlists/aes128-gates.v"))
    e = engine_for("gates", pset, fuse, device, keys)
    e.compile(nl)
    B = int(env.get("BATCH", "0"))
    pts = [bytes([PT[0] ^ i]) + PT[1:] for i in range(B or 1)]
    inputs = [bits(p, KEY) for p in pts] if B else bits(PT, KEY)
    wires = e.encrypt_inputs(inputs)
    t0 = time.time()
    wires = e.evaluate(wires)
    sync(device)
    first = time.time() - t0
    print(f"first eval (incl. capture): {first:.1f}s", flush=True)
    w2 = e.encrypt_inputs(inputs)
    t0 = time.time()
    w2 = e.evaluate(w2)
    sync(device)
    dt = time.time() - t0
    per = dt / (B or 1)
    backend = route(pset, device)
    print(steady_line(dt, B, pset.name, backend, e.fused), flush=True)
    out = e.decrypt_outputs(w2)
    outs = out if isinstance(out, list) else [out]
    cts = [ciphertext(o) for o in outs]
    ok = all(ct == aes_encrypt(p, KEY, rounds) for ct, p in zip(cts, pts))
    print("ciphertexts correct:", ok, flush=True)
    print(f"block 0: {cts[0].hex()}", flush=True)
    return {"correct": ok, "steady_s": dt, "per_block_s": per, "first_s": first, "fused": e.fused,
            "ciphertexts": [c.hex() for c in cts], "params": pset.name, "backend": backend, "batch": B}


def steady_line(dt: float, B: int, pset: str, backend: str, fused: bool) -> str:
    """The steady-state line (tools/collect_results.py reads it): `dt`
    seconds for B blocks (B = 0: one unbatched block)."""
    return (f"AES-128 steady-state: {dt:.2f}s" + (f" for {B} blocks = {dt / B:.2f}s/block" if B else "/block")
            + f" ({pset}, backend={backend}, fused={fused})")


def main(argv=None, env=None) -> int:
    env = os.environ if env is None else env
    _, device = device_arg(argv, __doc__.split("\n")[0])
    return 0 if run(env, device)["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
