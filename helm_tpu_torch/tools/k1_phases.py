"""Where K1's time goes inside one rotation, by phase, on the card.

Builds an instrumented copy of `csrc/blind_rotate_mb.cu`, with the kernel
body it includes (`csrc/rotate_tiles.cuh`) inlined and clock64() read by
thread 0 of block (0, 0) at each barrier of the group loop (the kernel
itself is unchanged), into `build/k1_phases/`, runs one rotation per width
through `mb_pbs.blind_rotate_mb` with that build, and prints each phase's
share of the clocks per group:

    decompose+pass1  the decomposition fused with the first forward pass
    fwd passes       the other forward register passes
    products         the BSK chunks (of which: waiting on the ring, thread
                     0's own products, its wait at the chunk barriers)
    inv passes       the inverse register passes
    cluster sync 1   waiting for the other primes' residues
    garner           the quarter's Garner and accumulate
    cluster sync 2   waiting for the other quarters

    python -m helm_tpu_torch.tools.k1_phases

at the sets and widths of `WIDTHS`.

Inputs are `mb_sweep.inputs` (G AND pre-images, the gates test
polynomial); keys from a fixed seed. Needs nvcc and a card.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from .. import params as P
from ..fhe import lwe, pbs
from ..fhe.server_key import gen_server_key
from ..ops import build, mb_pbs
from .mb_sweep import inputs

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "k1_phases"
PHASES = ("decompose+pass1", "fwd passes", "products", "inv passes", "cluster sync 1", "garner",
          "cluster sync 2")
#: (set, widths) the tool runs
WIDTHS = (("GATES_128_K3", (8, 64, 1024)), ("LUT_128_K2", (2, 256)), ("ARITH_128_MB2", (8, 1024)))

#: (anchor in the kernel body, text inserted after it); counters 0-6
#: are the phases, 9 the ring waits, 10 thread 0's products, 11 its chunk
#: barrier waits
_MARKS = (
    ("cluster.sync();  // every block's quarter is in place\n",
     "  const bool rec_ = threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0;\n"
     "  long long tp_ = clock64(), tw_ = 0;\n"
     "#define MARK_(n) if (rec_) { const long long t_ = clock64(); k1_clk[n] += t_ - tp_; tp_ = t_; }\n"),
    ("    __syncthreads();\n    ntt_passes<false>(rows, S.rows * gt, gt, ng, 1, twf, sw, p);\n",
     "    MARK_(1)\n"),
    ("      mbar_wait(&bar[st], (q / STAGES) & 1);\n",
     "      if (rec_) { k1_clk[9] += clock64() - tw_; tw_ = clock64(); }\n"),
    ("      __syncthreads();  // the chunk's gadget rows are read; its ring stage is free\n",
     "      if (rec_) { k1_clk[11] += clock64() - tw_; }\n"),
    ("    ntt_passes<true>(rows, kp1 * gt, gt, ng, 0, twi, sw, p);\n", "    MARK_(3)\n"),
    ("    cluster.sync();  // every prime's residues are in its block\n", "    MARK_(4)\n"),
    ("    cluster.sync();  // the quarters are updated, and no peer reads our rows\n", "    MARK_(6)\n"),
)
#: (anchor, text inserted before it)
_BEFORE = (
    ("    ntt_passes<false>(rows, S.rows * gt, gt, ng, 1, twf, sw, p);\n", "    MARK_(0)\n"),
    ("      mbar_wait(&bar[st], (q / STAGES) & 1);\n", "      if (rec_) tw_ = clock64();\n"),
    ("      __syncthreads();  // the chunk's gadget rows are read; its ring stage is free\n",
     "      if (rec_) { k1_clk[10] += clock64() - tw_; tw_ = clock64(); }\n"),
    ("\n    // 3. the inverse NTTs of the k+1 products\n", "    MARK_(2)\n"),
    ("    cluster.sync();  // the quarters are updated, and no peer reads our rows\n",
     "    __syncthreads();\n    MARK_(5)\n"),
)


def instrumented_source() -> str:
    """K1's source with the kernel body inlined and the phase counters in
    it; raises if an anchor has gone from the body."""
    src = (build.CSRC / "rotate_tiles.cuh").read_text().replace("#pragma once\n", "")
    for anchor, text in _MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"k1_phases: anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    for anchor, text in _BEFORE:
        if src.count(anchor) != 1:
            raise RuntimeError(f"k1_phases: anchor not found once: {anchor!r}")
        src = src.replace(anchor, text + anchor)
    src = src.replace("namespace {\n", "__device__ unsigned long long k1_clk[16];\nnamespace {\n", 1)
    k1 = (build.CSRC / "blind_rotate_mb.cu").read_text()
    include = '#include "rotate_tiles.cuh"\n'
    if k1.count(include) != 1:
        raise RuntimeError(f"k1_phases: {include!r} not found once in blind_rotate_mb.cu")
    return k1.replace(include, src) + (
        '\nextern "C" int helm_k1_clocks(unsigned long long* out, int reset) {\n'
        "  unsigned long long z[16] = {0};\n"
        "  return (int)(reset ? cudaMemcpyToSymbol(k1_clk, z, sizeof(z))\n"
        "                     : cudaMemcpyFromSymbol(out, k1_clk, sizeof(z)));\n}\n"
    )


def _instrumented_library() -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu = OUT_DIR / "blind_rotate_mb.cu"
    cu.write_text(instrumented_source())
    so = OUT_DIR / "libk1_phases.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)],
                   check=True)
    return ctypes.CDLL(str(so))


def main() -> int:
    lib = _instrumented_library()
    rotate, slots = lib.helm_blind_rotate_mb, lib.helm_blind_rotate_mb_clusters
    rotate.argtypes, rotate.restype = mb_pbs._ARGTYPES, ctypes.c_int
    slots.argtypes, slots.restype = mb_pbs._SLOT_ARGTYPES, ctypes.c_int
    entry = build.entry
    build.entry = lambda name, argtypes, symbol=None: (
        (slots if symbol else rotate) if name == "blind_rotate_mb" else entry(name, argtypes, symbol)
    )
    clk = (ctypes.c_ulonglong * 16)()
    for name, widths in WIDTHS:
        p = getattr(P, name)
        ck = lwe.keygen(p, 2024)
        dsk = pbs.DeviceServerKey.from_host(gen_server_key(ck, "cuda"), "cuda")
        for G in widths:
            x, tv = inputs(ck, G, "cuda")
            mb_pbs.blind_rotate_mb(dsk, x, tv)
            torch.cuda.synchronize()
            lib.helm_k1_clocks(clk, 1)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            mb_pbs.blind_rotate_mb(dsk, x, tv)
            end.record()
            torch.cuda.synchronize()
            lib.helm_k1_clocks(clk, 0)
            total = sum(clk[i] for i in range(len(PHASES)))
            t = mb_pbs.plan_for(dsk, G)
            shares = ", ".join(f"{n} {100 * clk[i] / total:.1f}%" for i, n in enumerate(PHASES))
            print(f"[k1_phases] {p.name} G={G} gt={t.gt}: {start.elapsed_time(end):.3f} ms, "
                  f"{total / (p.n // p.grouping):.0f} clocks per group: {shares}; of which ring waits "
                  f"{100 * clk[9] / total:.1f}%, thread 0's products {100 * clk[10] / total:.1f}%, its chunk "
                  f"barrier waits {100 * clk[11] / total:.1f}%", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
