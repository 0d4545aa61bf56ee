"""A/B of the blind-rotation kernels between two checkouts, on the card.

    python3 helm_tpu_torch/tools/kernel_ab.py time <checkout> <label> [k1,k6,k2,k4,k3]
    python3 helm_tpu_torch/tools/kernel_ab.py sass <checkout A> <checkout B> <out dir>
    python3 helm_tpu_torch/tools/kernel_ab.py probe_sass <checkout A> <checkout B> <out dir>

`time` imports the port and `chip_smoke.py` from <checkout>, builds the
kernels named (default k1,k6,k2) there, and times each wrapper by CUDA
events (one untimed call, then the mean of three) at the full-size sets
and widths of chip_smoke.py's phases k1, k6, k2, k4 and k3 (K4 and K3 at
K1's), on the same inputs (no plain versions). It prints one JSON line per
width with a digest of the output words, so that two checkouts' words can
be compared; each width's inputs are made once, so K1, K6, K4 and K3 (one
function) give one digest. Run it once per checkout, each in its own process, in
turns (A, B, B, A) in one call; both checkouts need the wrappers of the
kernels named, with the signatures of this one.

`sass` compiles K1 (`csrc/blind_rotate_mb.cu`) of both checkouts to
cubins with nvcc, writes their `cuobjdump -sass` into <out dir>, and
compares the machine code of each rotate_tiles instantiation of A,
matched by (grouping, rows, narrow), instruction by instruction (the
encodings and addresses aside); an instantiation only B has is listed as
new, one only A has is a difference. `probe_sass` compiles the probes K8/K9
(`csrc/probe_splat.cu`) and K10 (`csrc/probe_ptw.cu`) of both checkouts
the same way and prints, for each of K8's variants, K9's R=8 A=12 splat
and red and K10's A, NOB and B, the instructions of the function and of
each loop (a backward branch and what it jumps over, innermost first:
K8/K9's step, K10's unit), by opcode. Needs nvcc (under /usr/local/cuda)
and, for `time`, a card.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

CUDA_BIN = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]


def time_checkout(root: str, label: str, only) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np

    import chip_smoke as cs
    from helm_tpu_torch import params as P
    from helm_tpu_torch.fhe import pbs
    from helm_tpu_torch.fhe.ntt import words
    from helm_tpu_torch.ops import build, gm_pbs, mb_pbs, ps_pbs, sb_pbs, ts_pbs

    sources = {"k1": "blind_rotate_mb", "k6": "blind_rotate_ps", "k2": "blind_rotate_sb",
               "k4": "blind_rotate_ts", "k3": "blind_rotate_gm"}
    t0 = time.perf_counter()
    build.load_all([sources[k] for k in only])
    print(f"[{label}] built in {time.perf_counter() - t0:.1f} s", flush=True)
    smoke = cs.Smoke("cuda")
    multibit = ((P.GATES_128_K3, 2024, (8, 16, 32, 37, 64, 128, 200, 256, 1024), False),
                (P.LUT_128_K2, 2025, (2, 256), True), (P.ARITH_128_MB2, 2030, (8, 1024), True))
    single = ((P.GATES_TPU, 2026, (1, 2, 4, 8, 16, 32, 37, 64, 128, 256, 1024), False),
              (P.GATES_PARAMS, 2027, (37,), False), (P.LUT_PARAMS, 2028, (2, 37), True))
    runs = (("k1", mb_pbs.blind_rotate_mb, multibit), ("k6", ps_pbs.blind_rotate_ps, multibit),
            ("k2", sb_pbs.blind_rotate_sb, single), ("k4", ts_pbs.blind_rotate_ts, multibit),
            ("k3", gm_pbs.blind_rotate_gm, multibit))
    inputs = {}  # by (set, G): made once, so that every kernel takes the same words

    def inputs_for(params, ck, G, per_gate):
        if (params.name, G) not in inputs:
            lin, _ = cs._ands(ck, G, 100 + G)  # chip_smoke's inputs for this width
            if per_gate:
                rng = np.random.default_rng(G)
                tv = words(rng.integers(0, 1 << 32, size=(G, params.N), dtype=np.uint64)
                           .astype(np.uint32), "cuda")
            else:
                tv = words(pbs.gates_test_poly(params), "cuda")
            inputs[params.name, G] = (words(lin, "cuda"), tv)
        return inputs[params.name, G]

    for kname, fn, cases in runs:
        if kname not in only:
            continue
        for params, seed, gs, per_gate in cases:
            ck, _, dsk = smoke.keys_for(params, seed)
            for G in gs:
                x, tv = inputs_for(params, ck, G, per_gate)
                ms, out = cs._time_ms(lambda: fn(dsk, x, tv), reps=3)
                digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
                print(json.dumps({"tree": label, "kernel": kname, "set": params.name, "G": G,
                                  "ms": ms, "digest": digest}), flush=True)
    print(f"[{label}] done in {time.perf_counter() - t0:.1f} s", flush=True)


def k1_sass(root: str, out_dir: str, tag: str) -> dict:
    """{(grouping, rows, narrow): [instruction, ...]} of K1 in `root`."""
    cubin = os.path.join(out_dir, f"k1_{tag}.cubin")
    cu = os.path.join(root, "helm_tpu_torch", "csrc", "blind_rotate_mb.cu")
    subprocess.run([os.path.join(CUDA_BIN, "nvcc"), *FLAGS, "-cubin", "-o", cubin, cu], check=True)
    text = subprocess.run([os.path.join(CUDA_BIN, "cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    with open(os.path.join(out_dir, f"k1_{tag}.sass"), "w") as f:
        f.write(text)
    funcs = {}
    for part in text.split("Function : ")[1:]:
        m = re.search(r"rotate_tilesILi(\d+)ELi(\d+)ELb([01])", part.split("\n", 1)[0])
        if m:
            funcs[m.groups()] = [re.sub(r"\s+", " ", i.group(1)) for i in
                                 re.finditer(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", part, re.M)]
    return funcs


def compare_sass(a_root: str, b_root: str, out_dir: str) -> bool:
    os.makedirs(out_dir, exist_ok=True)
    a, b = k1_sass(a_root, out_dir, "a"), k1_sass(b_root, out_dir, "b")
    same = bool(a)
    for key in sorted(set(a) | set(b)):
        x, y = a.get(key, []), b.get(key, [])
        if key not in a:
            print(f"rotate_tiles<{', '.join(key)}>: new, {len(y)} instructions")
            continue
        diff = sum(i != j for i, j in zip(x, y)) + abs(len(x) - len(y))
        print(f"rotate_tiles<{', '.join(key)}>: {len(x)} / {len(y)} instructions, {diff} differ")
        same &= diff == 0
    print("K1 SASS IDENTICAL" if same else "K1 SASS DIFFERS")
    return same


#: the probe builds whose machine code `probe_sass` counts: (source, label,
#: mangled-name pattern)
PROBE_FUNCS = (
    [("probe_splat", f"K8 {v}", rf"splat_bodyILi1ELi1ELi{i}E") for i, v in enumerate(("scalar", "splat", "impl", "i16"))]
    + [("probe_splat", f"K9 R=8 A=12 {v}", rf"splat_bodyILi8ELi12ELi{i}E") for i, v in ((1, "splat"), (4, "red"))]
    + [("probe_ptw", f"K10 {v}", rf"ptw_elemILi{i}E") for i, v in enumerate(("A", "NOB", "B"))]
)


def sass_functions(cu: str, out_dir: str, tag: str) -> dict:
    """{mangled name: [(address, opcode, branch target or None), ...]} of
    the cubin of `cu`, its `cuobjdump -sass` written to out_dir."""
    name = os.path.basename(cu)[:-3]
    cubin = os.path.join(out_dir, f"{name}_{tag}.cubin")
    subprocess.run([os.path.join(CUDA_BIN, "nvcc"), *FLAGS, "-cubin", "-o", cubin, cu], check=True)
    text = subprocess.run([os.path.join(CUDA_BIN, "cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    with open(os.path.join(out_dir, f"{name}_{tag}.sass"), "w") as f:
        f.write(text)
    funcs = {}
    for part in text.split("Function : ")[1:]:
        code = []
        for m in re.finditer(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", part, re.M):
            ins = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())
            op = ins.split()[0] if ins else "?"
            tgt = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins) if op.startswith("BRA") else None
            code.append((int(m.group(1), 16), op, int(tgt.group(1), 16) if tgt else None))
        funcs[part.split("\n", 1)[0].strip()] = code
    return funcs


def opcode_counts(code) -> dict:
    """Instructions by opcode with its modifiers (FADD and FADD.RM apart,
    LDS and LDS.128), most frequent first."""
    counts = {}
    for _, op, _ in code:
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def probe_sass(a_root: str, b_root: str, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for tag, root in (("a", a_root), ("b", b_root)):
        funcs = {}
        for src in ("probe_splat", "probe_ptw"):
            funcs[src] = sass_functions(os.path.join(root, "helm_tpu_torch", "csrc", f"{src}.cu"), out_dir, tag)
        for src, label, pattern in PROBE_FUNCS:
            hit = [(n, c) for n, c in funcs[src].items() if re.search(pattern, n)]
            if not hit:
                print(json.dumps({"tree": tag, "build": label, "found": False}))
                continue
            name, code = hit[0]
            loops = sorted(((t, a) for a, _, t in code if t is not None and t <= a), key=lambda ta: ta[1] - ta[0])
            print(json.dumps({"tree": tag, "build": label, "instructions": len(code),
                              "classes": opcode_counts(code),
                              "loops": [{"from": hex(t), "to": hex(a), "instructions": sum(t <= x <= a for x, _, _ in code),
                                         "classes": opcode_counts([c for c in code if t <= c[0] <= a])}
                                        for t, a in loops]}), flush=True)


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "time":
        time_checkout(os.path.abspath(argv[1]), argv[2], (argv[3] if len(argv) > 3 else "k1,k6,k2").split(","))
        return 0
    if len(argv) == 4 and argv[0] == "sass":
        return 0 if compare_sass(*argv[1:]) else 1
    if len(argv) == 4 and argv[0] == "probe_sass":
        probe_sass(*argv[1:])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
