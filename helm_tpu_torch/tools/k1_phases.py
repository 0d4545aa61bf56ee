"""Where K1's (or K4's) time goes inside one rotation, by phase, on the card.

Builds an instrumented copy of `csrc/blind_rotate_mb.cu` (K1) or
`csrc/blind_rotate_ts.cu` (K4), with the kernel body it includes
(`csrc/rotate_tiles.cuh`) inlined and clock64() read by thread 0 of block
(0, 0) at each barrier of the group loop (the kernel itself is unchanged;
the marks sit in the branches of the body that the kernel takes), into
`build/k1_phases/`, runs one rotation per width through its wrapper with
that build, and prints each phase's share of the clocks per group. K1:

    decompose+pass1  the decomposition fused with the first forward pass
    fwd passes       the other forward register passes
    products         the BSK chunks (of which: waiting on the ring, thread
                     0's own products, its wait at the chunk barriers)
    inv passes       the inverse register passes
    cluster sync 1   waiting for the other primes' residues
    garner           the quarter's Garner and accumulate
    cluster sync 2   waiting for the other quarters

K4 (FourStepTC): the same, with "decompose+stages+limbs" (the
decomposition, the 8-point stages, the twist and the limb split), "fwd
product" (the N2-point product on the tensor cores) and "inv product"
(the inverse product, the inverse twist and 8-point stages) in place of
the passes.

    python -m helm_tpu_torch.tools.k1_phases [mb|ts]

at the sets, groupings and widths of `WIDTHS` (K4 skips grouping 1, which
it has no build for). Each width also prints a `RESULT {json}` line with
its clocks by phase, which tools/collect_results.py gathers
and tools/param_search.py fits its cost model to.

Inputs are `mb_sweep.inputs` (G AND pre-images, the gates test
polynomial); keys from a fixed seed (at grouping 1 `gen_server_key`'s
single-bit key, which holds the same GGSW(s_i) as `gen_bsk_multibit`'s).
Needs nvcc and a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import torch

from .. import params as P
from ..fhe import lwe, pbs
from ..fhe.server_key import gen_server_key
from ..ops import build, mb_pbs, ts_pbs
from .mb_sweep import inputs

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "k1_phases"
#: the phases' names per kernel (counters 0-6)
PHASES = {
    "mb": ("decompose+pass1", "fwd passes", "products", "inv passes", "cluster sync 1", "garner",
           "cluster sync 2"),
    "ts": ("decompose+stages+limbs", "fwd product", "products", "inv product", "cluster sync 1",
           "garner", "cluster sync 2"),
}
#: (set, grouping, widths) the tool runs: the sets at their own grouping,
#: and GATES_128_K3 at grouping 1 (tools/g1_fs_test.py's set)
WIDTHS = (("GATES_128_K3", 2, (8, 64, 1024)), ("LUT_128_K2", 2, (2, 256)), ("ARITH_128_MB2", 2, (8, 1024)),
          ("GATES_128_K3", 1, (1024,)))


def width_params(set_name: str, grouping: int) -> P.TfheParams:
    """The set `set_name` of params.py at `grouping` (named with `_g1` at
    grouping 1 when that is not its own, as tools/g1_fs_test.py names it)."""
    p = getattr(P, set_name)
    return p if p.grouping == grouping else replace(p, name=f"{p.name}_g{grouping}", grouping=grouping)

_SETUP = ("cluster.sync();  // every block's quarter is in place\n",
          "  const bool rec_ = threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0;\n"
          "  long long tp_ = clock64(), tw_ = 0;\n"
          "#define MARK_(n) if (rec_) { const long long t_ = clock64(); k1_clk[n] += t_ - tp_; tp_ = t_; }\n")
#: the marks of the products (counters 9: the ring waits, 10: thread 0's
#: products, 11: its chunk barrier waits) and of the epilogue, the same for
#: both kernels: (anchor, text inserted after it) and (anchor, text inserted
#: before it)
_SHARED_AFTER = (
    ("      mbar_wait(&bar[st], (q / STAGES) & 1);\n",
     "      if (rec_) { k1_clk[9] += clock64() - tw_; tw_ = clock64(); }\n"),
    ("      __syncthreads();  // the chunk's gadget rows are read; its ring stage is free\n",
     "      if (rec_) { k1_clk[11] += clock64() - tw_; }\n"),
    ("    cluster.sync();  // every prime's residues are in its block\n", "    MARK_(4)\n"),
    ("    cluster.sync();  // the quarters are updated, and no peer reads our rows\n", "    MARK_(6)\n"),
)
_SHARED_BEFORE = (
    ("      mbar_wait(&bar[st], (q / STAGES) & 1);\n", "      if (rec_) tw_ = clock64();\n"),
    ("      __syncthreads();  // the chunk's gadget rows are read; its ring stage is free\n",
     "      if (rec_) { k1_clk[10] += clock64() - tw_; tw_ = clock64(); }\n"),
    ("\n    // 3. the inverse NTTs of the k+1 products\n", "    MARK_(2)\n"),
    ("    cluster.sync();  // the quarters are updated, and no peer reads our rows\n",
     "    __syncthreads();\n    MARK_(5)\n"),
)
#: per kernel: (anchor, text inserted after it), (anchor, text inserted before it)
_MARKS = {
    "mb": (
        (("    ntt_passes<false>(rows, S.rows * gt, gt, ng, 1, twf, sw, p);\n", "    MARK_(1)\n"),
         ("    ntt_passes<true>(rows, kp1 * gt, gt, ng, 0, twi, sw, p);\n", "    MARK_(3)\n")),
        (("    ntt_passes<false>(rows, S.rows * gt, gt, ng, 1, twf, sw, p);\n", "    MARK_(0)\n"),),
    ),
    "ts": (
        (("    if constexpr (Xf::kTensor) {  // the N2-point stage on the tensor cores -> F, "
          "four-step order\n", "      MARK_(0)\n"),),
        (("\n    // 2. the products, one BSK chunk at a time\n", "    MARK_(1)\n"),
         ("    cluster.sync();  // every prime's residues are in its block\n", "    MARK_(3)\n")),
    ),
}


def instrumented_source(kernel: str = "mb") -> str:
    """The kernel file's source (K1: mb, K4: ts) with the kernel body
    inlined and the phase counters in it; raises if an anchor has gone
    from the body."""
    src = (build.CSRC / "rotate_tiles.cuh").read_text().replace("#pragma once\n", "")
    after, before = _MARKS[kernel]
    for anchor, text in (_SETUP, *_SHARED_AFTER, *after):
        if src.count(anchor) != 1:
            raise RuntimeError(f"k1_phases: anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    for anchor, text in (*_SHARED_BEFORE, *before):
        if src.count(anchor) != 1:
            raise RuntimeError(f"k1_phases: anchor not found once: {anchor!r}")
        src = src.replace(anchor, text + anchor)
    src = src.replace("namespace {\n", "__device__ unsigned long long k1_clk[16];\nnamespace {\n", 1)
    body = (build.CSRC / f"blind_rotate_{kernel}.cu").read_text()
    include = '#include "rotate_tiles.cuh"\n'
    if body.count(include) != 1:
        raise RuntimeError(f"k1_phases: {include!r} not found once in blind_rotate_{kernel}.cu")
    return body.replace(include, src) + (
        '\nextern "C" int helm_k1_clocks(unsigned long long* out, int reset) {\n'
        "  unsigned long long z[16] = {0};\n"
        "  return (int)(reset ? cudaMemcpyToSymbol(k1_clk, z, sizeof(z))\n"
        "                     : cudaMemcpyFromSymbol(out, k1_clk, sizeof(z)));\n}\n"
    )


def _instrumented_library(kernel: str) -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu = OUT_DIR / f"blind_rotate_{kernel}.cu"
    cu.write_text(instrumented_source(kernel))
    so = OUT_DIR / f"libk1_phases_{kernel}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)],
                   check=True)
    return ctypes.CDLL(str(so))


def main(argv=None) -> int:
    """One instrumented rotation per width (after an untimed one) of K1
    (mb) or K4 (ts); prints the tool's line and a RESULT line per width:
    set (`width_params`' name), grouping, G, gt, ms (CUDA events), groups
    and `clocks`, thread 0's clocks per group by phase (`PHASES[kernel]`)."""
    kernel = (argv if argv is not None else sys.argv[1:] or ["mb"])[0]
    name = f"blind_rotate_{kernel}"
    wrapper = {"mb": mb_pbs.blind_rotate_mb, "ts": ts_pbs.blind_rotate_ts}[kernel]
    lib = _instrumented_library(kernel)
    rotate, slots = getattr(lib, f"helm_{name}"), getattr(lib, f"helm_{name}_clusters")
    slots.argtypes, slots.restype = mb_pbs._SLOT_ARGTYPES, ctypes.c_int
    entry = build.entry

    def patched(name_, argtypes, symbol=None):
        if name_ != name:
            return entry(name_, argtypes, symbol)
        if symbol:
            return slots
        if rotate.argtypes is None:
            rotate.argtypes, rotate.restype = argtypes, ctypes.c_int
        return rotate

    build.entry = patched
    try:
        clk = (ctypes.c_ulonglong * 16)()
        for set_name, grouping, gs in WIDTHS:
            if kernel == "ts" and grouping == 1:
                continue  # K4 has no grouping-1 build
            p = width_params(set_name, grouping)
            ck = lwe.keygen(p, 2024)
            dsk = pbs.DeviceServerKey.from_host(gen_server_key(ck, "cuda"), "cuda")
            for G in gs:
                x, tv = inputs(ck, G, "cuda")
                wrapper(dsk, x, tv)
                torch.cuda.synchronize()
                lib.helm_k1_clocks(clk, 1)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                wrapper(dsk, x, tv)
                end.record()
                torch.cuda.synchronize()
                lib.helm_k1_clocks(clk, 0)
                total = sum(clk[i] for i in range(7))
                t = mb_pbs.plan_for(dsk, G, name)
                groups = p.n // p.grouping
                ms = start.elapsed_time(end)
                shares = ", ".join(f"{n} {100 * clk[i] / total:.1f}%" for i, n in enumerate(PHASES[kernel]))
                print(f"[k1_phases] {kernel} {p.name} G={G} gt={t.gt}: {ms:.3f} ms, "
                      f"{total / groups:.0f} clocks per group: {shares}; of which ring waits "
                      f"{100 * clk[9] / total:.1f}%, thread 0's products {100 * clk[10] / total:.1f}%, its chunk "
                      f"barrier waits {100 * clk[11] / total:.1f}%", flush=True)
                res = {"tool": "k1_phases", "kernel": kernel, "set": p.name, "grouping": p.grouping, "G": G,
                       "gt": t.gt, "ms": ms, "groups": groups,
                       "clocks": {n: clk[i] / groups for i, n in enumerate(PHASES[kernel])}}
                print("RESULT " + json.dumps(res), flush=True)
    finally:
        build.entry = entry  # the process's other kernels load as before
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
