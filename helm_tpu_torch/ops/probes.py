"""The pointwise-stage microbenchmarks on Hopper (K7-K10), each beside its
plain torch version.

The JAX package's `tools/` holds four Pallas probes of the pointwise
product stage of a blind rotation (the stage that K1's products spend
most of a group in): the lane expansion, the column splat, the register
live set and the candidate inner loops. Each is ported here as a
hand-written CUDA kernel for sm_90a (`csrc/probe_*.cu`, built by
`ops/build.py` like K1) with the same function, word for word:

  K7  `expand8`  (csrc/probe_expand8.cu) replaces tools/expand8_hw_test.py:18
      (body helm_tpu/ops/mxu_pbs.py:212 `_expand8`)
  K8  `splat`    (csrc/probe_splat.cu) replaces tools/mosaic_splat_repro.py:94
  K9  `liveset`  (csrc/probe_splat.cu) replaces tools/liveset_harness.py:111
  K10 `ptw`      (csrc/probe_ptw.cu) replaces tools/ptw_probe.py:213

The plain versions run the reference's order of operations in float32,
one multiply and one add each (never a fused multiply-add); the kernels
do the same with `__fmul_rn` / `__fadd_rn`, so K7-K9 give the same words
on any input (K9's `red` floors by a rounding that is exact below 2^22).
The probes' own inputs are integers, and wherever every partial sum
stays below 2^24 the words are exact whatever the order and however the
reductions mod P round: K10 reduces and splits integers by magic-number
rounding, and its C takes its products on the tensor cores and its sums
across blocks in any order (`ptw_c`; the `ptw_c_*` functions are the
host's view of its scratch and limb layout).

Dispatch is by the device of the input tensors: on the CPU the plain
version runs; on a CUDA tensor the kernel is launched, or an error is
raised — there is no fallback. Each wrapper counts its launches in
`<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: K8/K9: frequency rows of a tile and terms a step (GATES_128_K3's fs tile)
N2, T = 64, 96
#: K8's variants and K9's; each is a template choice of csrc/probe_splat.cu
SPLAT_VARIANTS = ("scalar", "splat", "impl", "i16")
LIVESET_VARIANTS = ("splat", "red", "two")
_VARIANT_ID = {"scalar": 0, "splat": 1, "impl": 2, "i16": 3, "red": 4, "two": 5}
#: the (R, A) builds of K9 (the reference harness's default sweep)
LIVESET_RS = (1, 2, 4, 8)
LIVESET_AS = (1, 4, 8, 12, 16)
#: K9's `red` modulus
RED_P = 16381.0
#: K8/K9: columns a stage of the ring that streams them into shared memory
#: (one barrier wait a stage), and columns in the ring (csrc/probe_splat.cu
#: CPS, STAGES x CPS)
SPLAT_STAGE, SPLAT_RING = 8, 32

#: K10: rows, term groups ((nv-1) x (k+1)) and the modulus of ptw_probe.py
ROWS, NVC, PTW_P = 8, 12, 18433.0
PTW_PATTERNS = ("A", "NOB", "B", "B2", "C")
_PATTERN_ID = {"A": 0, "NOB": 1, "B": 2, "B2": 2, "C": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entries by symbol, looked up once: `build.entry` hashes the sources at
#: every call, which would put a host-side millisecond before each launch
_ENTRIES: dict = {}


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True when the inputs lie on a CUDA device (launch the kernel), False
    on the CPU (the plain version); raise on any other device, or on
    inputs that do not share one device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for {dev}")
    return True


def _launch(name: str, symbol: str, argtypes: list, args: list, device) -> None:
    """Call the C entry `symbol` of csrc/<name>.cu on `device`'s current
    stream and raise on its cudaError_t. The card is made current only
    when it is not already (a kernel runs on its inputs' card)."""
    fn = _ENTRIES.get(symbol)
    if fn is None:
        fn = _ENTRIES[symbol] = build.entry(name, argtypes + [_P], symbol)
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    build.check(rc, symbol)


def resources(name: str, symbol: str, *ids: int) -> tuple[int, int]:
    """(registers a thread, local-memory bytes a thread: the spills) of
    one template instantiation of csrc/<name>.cu, from
    cudaFuncGetAttributes through its C entry `symbol`."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    argtypes = [_I] * len(ids) + [ctypes.POINTER(_I)] * 2
    fn = build.entry(name, argtypes, symbol)
    build.check(fn(*ids, ctypes.byref(regs), ctypes.byref(local)), symbol)
    return regs.value, local.value


# -- K7: lane expansion ---------------------------------------------------


def expand8_plain(x: torch.Tensor, e8: torch.Tensor) -> torch.Tensor:
    """`_expand8`: out[r, l] = sum_j x[r, j] e8[j, l] in two 8-bit limbs,
    lo @ e8 + (hi @ e8) << 8, each product's f32 sum taken over j in
    order, truncated to int32. x: int32 [R, 8] (u32 bit patterns), e8:
    f32 [8, L]; returns int32 [R, L] (u32 bit patterns)."""
    lo = (x & 255).to(torch.float32)
    hi = (x >> 8).to(torch.float32)

    def mm(a):
        s = a[:, 0:1] * e8[0]
        for j in range(1, a.shape[1]):
            s = s + a[:, j : j + 1] * e8[j]
        return s.to(torch.int32)

    return mm(lo) + (mm(hi) << 8)


def expand8(x: torch.Tensor, e8: torch.Tensor) -> torch.Tensor:
    """K7 (csrc/probe_expand8.cu): `expand8_plain`'s function, a warp two
    rows of a tile of 128 columns, 4 words a thread in one 16-byte store.
    x int32 [R, 8], e8 f32 [8, L]."""
    if x.dim() != 2 or x.shape[1] != 8 or e8.dim() != 2 or e8.shape[0] != 8:
        raise ValueError(f"expand8: x [R, 8] and e8 [8, L], got {tuple(x.shape)} and {tuple(e8.shape)}")
    if not _cuda("expand8", x, e8):
        return expand8_plain(x, e8)
    if x.dtype != torch.int32 or e8.dtype != torch.float32:
        raise TypeError(f"expand8: x int32 and e8 float32, got {x.dtype} and {e8.dtype}")
    x, e8 = x.contiguous(), e8.contiguous()
    R, L = x.shape[0], e8.shape[1]
    out = torch.empty((R, L), dtype=torch.int32, device=x.device)
    _launch("probe_expand8", "helm_probe_expand8", [_P, _P, _P, _I, _I],
            [x.data_ptr(), e8.data_ptr(), out.data_ptr(), R, L], x.device)
    expand8.launches += 1
    return out


expand8.launches = 0


# -- K8 and K9: the column splat and the live set ---------------------------


def liveset_plain(cols: torch.Tensor, rows: torch.Tensor, A: int, variant: str = "splat") -> torch.Tensor:
    """liveset_harness.py's `make_kernel(R, A, G, variant)` over
    cols.shape[0] grid steps, and with A = 1 mosaic_splat_repro.py's
    `make_kernel(variant)`: per step, T terms, term i multiplying row pair
    i % R by the column cols[step, :, i] (broadcast across G; `scalar`: the
    constant 1 + i/2; `two`: row pair (i + 1) % R's first row) into
    accumulator pair i % A, `red` reducing that pair mod 16381 every 8
    terms; each step halves the accumulators; the output is their sum.
    cols f32 (int16 for `i16`) [steps, N2, T], rows f32 [2R, N2, G];
    returns f32 [1, N2, G]."""
    R = rows.shape[0] // 2
    _, n2, G = rows.shape
    ip, p, half = _f32(1.0 / RED_P), _f32(RED_P), _f32(0.5)
    accs = [torch.zeros((n2, G), dtype=torch.float32, device=rows.device) for _ in range(2 * A)]
    for j in range(cols.shape[0]):
        col = cols[j].to(torch.float32)
        for i in range(T):
            r, a = i % R, i % A
            if variant == "scalar":
                b = _f32(1.0 + 0.5 * i)
            elif variant == "two":
                b = rows[2 * ((i + 1) % R)]
            else:
                b = col[:, i : i + 1]
            accs[2 * a] = accs[2 * a] + rows[2 * r] * b
            accs[2 * a + 1] = accs[2 * a + 1] + rows[2 * r + 1] * b
            if variant == "red" and (i + 1) % 8 == 0:
                for c in (2 * a, 2 * a + 1):
                    accs[c] = accs[c] - torch.floor(accs[c] * ip + half) * p
        accs = [x * half for x in accs]
    s = accs[0]
    for x in accs[1:]:
        s = s + x
    return s[None]


def splat_plain(cols: torch.Tensor, rows: torch.Tensor, variant: str = "splat") -> torch.Tensor:
    """mosaic_splat_repro.py's kernel: `liveset_plain` at R = A = 1."""
    return liveset_plain(cols, rows, 1, variant)


def _splat_launch(name, cols, rows, R, A, variant):
    steps, n2, t = cols.shape
    if t != T or rows.dim() != 3 or rows.shape[0] != 2 * R or rows.shape[1] != n2:
        raise ValueError(f"{name}: cols [steps, N2, {T}] and rows [{2 * R}, N2, G], got "
                         f"{tuple(cols.shape)} and {tuple(rows.shape)}")
    want = torch.int16 if variant == "i16" else torch.float32
    if cols.dtype != want or rows.dtype != torch.float32:
        raise TypeError(f"{name} {variant}: cols {want} and rows float32, got {cols.dtype} and {rows.dtype}")
    cols, rows = cols.contiguous(), rows.contiguous()
    if variant in ("splat", "i16", "red") and cols.data_ptr() % 16:
        cols = cols.clone()  # the kernel streams the columns by 16-byte bulk copies
    G = rows.shape[2]
    out = torch.empty((1, n2, G), dtype=torch.float32, device=rows.device)
    _launch("probe_splat", "helm_probe_splat", [_I, _I, _I, _P, _P, _P, _I, _I, _I],
            [R, A, _VARIANT_ID[variant], cols.data_ptr(), rows.data_ptr(), out.data_ptr(), steps, n2, G],
            rows.device)
    return out


def splat(cols: torch.Tensor, rows: torch.Tensor, variant: str = "splat") -> torch.Tensor:
    """K8 (csrc/probe_splat.cu at R = A = 1): `splat_plain`'s function,
    one thread an output element, the grid's steps a loop inside it."""
    if variant not in SPLAT_VARIANTS:
        raise ValueError(f"splat: variant {variant!r}, one of {SPLAT_VARIANTS}")
    if not _cuda("splat", cols, rows):
        return splat_plain(cols, rows, variant)
    out = _splat_launch("splat", cols, rows, 1, 1, variant)
    splat.launches += 1
    return out


splat.launches = 0


def liveset(cols: torch.Tensor, rows: torch.Tensor, A: int, variant: str = "splat") -> torch.Tensor:
    """K9 (csrc/probe_splat.cu): `liveset_plain`'s function with R =
    rows.shape[0] / 2 resident row pairs and A accumulator pairs in
    registers, one thread an output element."""
    R = rows.shape[0] // 2
    if variant not in LIVESET_VARIANTS:
        raise ValueError(f"liveset: variant {variant!r}, one of {LIVESET_VARIANTS}")
    if not _cuda("liveset", cols, rows):
        return liveset_plain(cols, rows, A, variant)
    if R not in LIVESET_RS or A not in LIVESET_AS:
        raise ValueError(f"liveset: no build for R={R}, A={A} (R in {LIVESET_RS}, A in {LIVESET_AS})")
    out = _splat_launch("liveset", cols, rows, R, A, variant)
    liveset.launches += 1
    return out


liveset.launches = 0


def splat_resources(R: int, A: int, variant: str) -> tuple[int, int]:
    """(registers, spill bytes) a thread of K8/K9's build (R, A, variant)."""
    return resources("probe_splat", "helm_probe_splat_resources", R, A, _VARIANT_ID[variant])


# -- K10: the pointwise stage's candidate inner loops -------------------------


def _redfbt(t):
    """ptw_probe.py `_redfbt`: t - floor(t/P + 1/2) P, then into
    [-(P-1)/2, (P-1)/2]."""
    q = torch.floor(t * _f32(1.0 / PTW_P) + _f32(0.5))
    t = t - q * _f32(PTW_P)
    hp = _f32(float(int(PTW_P) // 2))
    t = torch.where(t > hp, t - _f32(PTW_P), t)
    return torch.where(t < -hp, t + _f32(PTW_P), t)


def _split256(t):
    hi = torch.floor(t * _f32(1.0 / 256.0) + _f32(0.5))
    return t - _f32(256.0) * hi, hi


def _ptw_elementwise(pattern: str, slab: torch.Tensor, steps: int, units: int, G: int) -> torch.Tensor:
    """kernel_A / kernel_NOB ([N2, G], slab [N2, NVC*ROWS], the column
    broadcast across G) and _kernel_T (B, B2: [G, L], slab [NVC*ROWS, L],
    the row broadcast across G)."""
    if pattern in ("A", "NOB"):
        shape = (slab.shape[0], G)

        def b_of(k):
            return slab[:, k : k + 1]
    else:
        shape = (G, slab.shape[1])

        def b_of(k):
            return slab[k : k + 1, :]

    acc = torch.zeros(shape, dtype=torch.float32, device=slab.device)
    for _ in range(steps):
        base = _redfbt(acc + _f32(1.0))
        total = None
        for u in range(units):
            splits = [_split256(_redfbt(base + _f32(float(u * ROWS + r)))) for r in range(ROWS)]
            for vc in range(NVC):
                slo = shi = None
                for r in range(ROWS):
                    flo, fhi = splits[r]
                    if pattern == "NOB":
                        plo = flo * _f32(3.0 + r + vc)
                        phi = fhi * _f32(5.0 + r + vc)
                    else:
                        b = b_of(vc * ROWS + r)
                        plo, phi = flo * b, fhi * b
                    slo = plo if slo is None else slo + plo
                    shi = phi if shi is None else shi + phi
                t = _redfbt(slo) + _f32(256.0) * _redfbt(shi)
                total = t if total is None else total + _redfbt(t)
        acc = _redfbt(total)
    return acc


def ptw_c_limbs(w0, w1, bcol) -> torch.Tensor:
    """kernel_C's limb matrices of W diag(b) for every term group: bf16
    [NVC, 3, ROWS*N2, N2], limb 0 s00, 1 m1 = s01 + s10, 2 s11, from w0,
    w1 [ROWS*N2, N2] and group vc's column bcol[:, vc]."""
    out = []
    for vc in range(NVC):
        b = bcol[:, vc : vc + 1]
        s00, s01 = _split256(_redfbt(w0 * b))
        s10, s11 = _split256(_redfbt(w1 * b))
        out.append(torch.stack([s00, s01 + s10, s11]))
    return torch.stack(out).to(torch.bfloat16)


def _ptw_c(w0, w1, bcol, steps: int, units: int, G: int) -> torch.Tensor:
    """kernel_C: per (unit, term group) the limb matrices of W diag(b)
    built from w0, w1 [ROWS*N2, N2] and bcol [ROWS*N2, NVC], and the six
    bf16 products with the feedback's limbs, contracted over ROWS*N2. The
    products here are taken in float64 and rounded once to f32: every
    operand is an integer of at most 8 bits and every sum below 2^24, so
    that is the f32 result in any order of summation."""
    rn, n2 = w0.shape
    acc = torch.zeros((rn, G), dtype=torch.float32, device=w0.device)

    def mm(w, a):
        return (w.to(torch.float64).T @ a.to(torch.float64)).to(torch.float32)

    bf = torch.bfloat16
    for _ in range(steps):
        x = _redfbt(acc + _f32(1.0))
        x0, x1 = _split256(x)
        x0, x1 = x0.to(bf), x1.to(bf)
        total = None
        limbs = ptw_c_limbs(w0, w1, bcol)  # anew every step, as the reference
        for _u in range(units):
            for vc in range(NVC):
                s00, m1, s11 = limbs[vc]
                lo = mm(s00, x0)
                mid = mm(m1, x0) + mm(s00, x1)
                hi2 = mm(m1, x1) + mm(s11, x0)
                hi3 = mm(s11, x1)
                r3 = _redfbt(hi3)
                r2 = _redfbt(hi2 + _f32(256.0) * r3)
                r1 = _redfbt(mid + _f32(256.0) * r2)
                t = _redfbt(lo + _f32(256.0) * r1)
                total = t if total is None else total + t
        acc = _redfbt(total.repeat(rn // n2, 1))
    return acc


def ptw_plain(pattern: str, inputs, steps: int, units: int = 2, G: int = 512) -> torch.Tensor:
    """ptw_probe.py's pattern (A, NOB, B, B2, C) over `steps` grid steps of
    `units` units: the accumulator after the last step. inputs: A, NOB:
    (slab [N2, NVC*ROWS],); B, B2: (slab [NVC*ROWS, L],); C: (w0, w1, bcol)."""
    if pattern == "C":
        return _ptw_c(*inputs, steps, units, G)
    return _ptw_elementwise(pattern, inputs[0], steps, units, G)


def ptw(pattern: str, inputs, steps: int, units: int = 2, G: int = 512) -> torch.Tensor:
    """K10 (csrc/probe_ptw.cu): `ptw_plain`'s function. A, NOB, B, B2:
    one thread an output element, the steps a loop inside it; C: one
    persistent cooperative launch (`ptw_c`)."""
    if pattern not in PTW_PATTERNS:
        raise ValueError(f"ptw: pattern {pattern!r}, one of {PTW_PATTERNS}")
    inputs = tuple(inputs)
    if not _cuda("ptw", *inputs):
        return ptw_plain(pattern, inputs, steps, units, G)
    if any(t.dtype != torch.float32 for t in inputs):
        raise TypeError("ptw: float32 inputs")
    inputs = tuple(t.contiguous() for t in inputs)
    if pattern == "C":
        return ptw_c(inputs, steps, units, G)[0]
    (slab,) = inputs
    if slab.dim() != 2 or slab.shape[0 if pattern in ("B", "B2") else 1] != NVC * ROWS:
        raise ValueError(f"ptw {pattern}: slab {tuple(slab.shape)}")
    dims = (slab.shape[0], G) if pattern in ("A", "NOB") else (G, slab.shape[1])
    if pattern in ("B", "B2") and 128 % dims[1]:
        raise ValueError(f"ptw {pattern}: L={dims[1]} must divide 128")
    out = torch.empty(dims, dtype=torch.float32, device=slab.device)
    _launch("probe_ptw", "helm_probe_ptw", [_I, _P, _P, _I, _I, _I, _I],
            [_PATTERN_ID[pattern], slab.data_ptr(), out.data_ptr(), *dims, steps, units], slab.device)
    ptw.launches += 1
    return out


ptw.launches = 0

# -- K10's C: the host's view of csrc/probe_ptw.cu ptw_c -----------------------

#: columns of gates a work item, limb matrices (s00, m1, s11), contraction
#: rows a chunk (a 128-byte row of bf16), and the phases its clocks split:
#: thread 0's four, which make up a step, and the build warps' (concurrent)
PTW_C_COLS, PTW_C_LIMBS, PTW_C_KC = 48, 3, 64
PTW_C_PHASES = ("feedback", "products", "epilogue", "barrier", "build")
#: bytes of a limb matrix's chunk [N2 x KC] bf16, and of a step's limb matrices
PTW_C_ATILE = N2 * PTW_C_KC * 2
PTW_C_LIMB_BYTES = NVC * PTW_C_LIMBS * (ROWS * N2 // PTW_C_KC) * PTW_C_ATILE
#: bytes of the steps' barrier counter, after the sums
PTW_C_BAR_BYTES = 256


def ptw_c_scratch_bytes(G: int) -> tuple[int, int, int]:
    """(bytes of the limb buffers: two steps' limb matrices, the one a step
    reads and the next one's; bytes of the sums: three [N2, G] f32 planes,
    the step's, the last step's and the one zeroed ahead; bytes of the
    steps' barrier counter)."""
    return 2 * PTW_C_LIMB_BYTES, 3 * N2 * G * 4, PTW_C_BAR_BYTES


def ptw_c_limb_offsets() -> torch.Tensor:
    """Byte offset in a step's limb buffer of word (group, limb, contraction
    row k, frequency m): int64 [NVC, 3, ROWS*N2, N2]. Chunk k // 64 of a
    limb matrix is a tile of 64 rows (frequencies) of 128 bytes (its 64
    contraction rows), wgmma's K-major layout with the 128-byte swizzle:
    16-byte chunk q of row m sits at chunk q ^ (m % 8)."""
    vc = torch.arange(NVC).view(-1, 1, 1, 1)
    limb = torch.arange(PTW_C_LIMBS).view(1, -1, 1, 1)
    k = torch.arange(ROWS * N2).view(1, 1, -1, 1)
    m = torch.arange(N2).view(1, 1, 1, -1)
    kc, kk = k // PTW_C_KC, k % PTW_C_KC
    tile = ((vc * PTW_C_LIMBS + limb) * (ROWS * N2 // PTW_C_KC) + kc) * PTW_C_ATILE
    return tile + m * 128 + (((kk // 8) ^ (m % 8)) * 16) + (kk % 8) * 2


def ptw_c_limb_image(limbs: torch.Tensor) -> torch.Tensor:
    """The bytes of a step's limb buffer as the kernel writes them, from
    `ptw_c_limbs`: uint8 [PTW_C_LIMB_BYTES]."""
    words = torch.zeros(PTW_C_LIMB_BYTES // 2, dtype=torch.int16)
    words[ptw_c_limb_offsets().reshape(-1) // 2] = limbs.cpu().contiguous().view(torch.int16).reshape(-1)
    return words.view(torch.uint8)


def ptw_c_grid(device) -> int:
    """Blocks of C's cooperative launch on `device` (a block per SM), after
    checking that the kernel's constants are the host's."""
    blocks, cols, limb_bytes, phases = (ctypes.c_int(0) for _ in range(4))
    fn = _ENTRIES.get("helm_probe_ptw_c_grid")
    if fn is None:
        fn = _ENTRIES["helm_probe_ptw_c_grid"] = build.entry(
            "probe_ptw", [ctypes.POINTER(_I)] * 4, "helm_probe_ptw_c_grid")
    with torch.cuda.device(device):
        build.check(fn(*(ctypes.byref(v) for v in (blocks, cols, limb_bytes, phases))), "helm_probe_ptw_c_grid")
    got = (cols.value, limb_bytes.value, phases.value)
    if got != (PTW_C_COLS, PTW_C_LIMB_BYTES, len(PTW_C_PHASES)):
        raise RuntimeError(f"csrc/probe_ptw.cu's C constants {got} are not the host's "
                           f"{(PTW_C_COLS, PTW_C_LIMB_BYTES, len(PTW_C_PHASES))}")
    return blocks.value


def ptw_c(inputs, steps: int, units: int = 2, G: int = 512, clocks: bool = False):
    """K10's C on the card, one cooperative launch: (out [ROWS*N2, G], the
    scratch it used (two limb buffers, the three sums, the barrier), the clock64
    sums of each block's thread 0 per phase [blocks, PTW_C_PHASES] or
    None). inputs: w0, w1 [ROWS*N2, N2], bcol [ROWS*N2, NVC] float32 on
    one card."""
    w0, w1, bcol = (t.contiguous() for t in inputs)
    rn, n2 = w0.shape
    if (rn, n2) != (ROWS * N2, N2) or w1.shape != w0.shape or bcol.shape != (rn, NVC) or G % 8 or G <= 0:
        raise ValueError(f"ptw C: w0, w1 [{ROWS * N2}, {N2}], bcol [{ROWS * N2}, {NVC}], G a multiple "
                         f"of 8; got {tuple(w0.shape)}, {tuple(w1.shape)}, {tuple(bcol.shape)}, G={G}")
    dev = w0.device
    out = torch.empty((rn, G), dtype=torch.float32, device=dev)
    scratch = torch.empty(sum(ptw_c_scratch_bytes(G)), dtype=torch.uint8, device=dev)
    clk = None
    if clocks:
        clk = torch.zeros((ptw_c_grid(dev), len(PTW_C_PHASES)), dtype=torch.int64, device=dev)
    _launch("probe_ptw", "helm_probe_ptw_c", [_P, _P, _P, _P, _P, _P, _I, _I, _I],
            [w0.data_ptr(), w1.data_ptr(), bcol.data_ptr(), out.data_ptr(), scratch.data_ptr(),
             0 if clk is None else clk.data_ptr(), G, steps, units], dev)
    ptw.launches += 1
    return out, scratch, clk


def ptw_c_phases(inputs, steps: int, units: int = 2, G: int = 512) -> dict:
    """One instrumented run of C: clock64 cycles a block a step by phase,
    averaged over the blocks. Thread 0's phases make up the step: feedback
    (X written to shared memory), products (the wgmma loop), epilogue (the
    exchange, the recombination, the bulk adds issued) and barrier (their
    completion and the wait at the grid barrier); build is a build warp's busy
    time (the next step's limb matrices and a sum plane zeroed), concurrent
    with them. shares: thread 0's phases over the step, and build over the
    step."""
    _, _, clk = ptw_c(inputs, steps, units, G, clocks=True)
    per = (clk.double().sum(0) / clk.shape[0] / max(steps, 1)).cpu()
    clocks = {name: float(per[i]) for i, name in enumerate(PTW_C_PHASES)}
    step = sum(clocks[name] for name in PTW_C_PHASES[:-1])
    return {"clocks": clocks, "step": step, "shares": {k: v / step for k, v in clocks.items()},
            "blocks": clk.shape[0]}


def ptw_resources(pattern: str) -> tuple[int, int]:
    """(registers, spill bytes) a thread of K10's build for `pattern`."""
    return resources("probe_ptw", "helm_probe_ptw_resources", _PATTERN_ID[pattern])
