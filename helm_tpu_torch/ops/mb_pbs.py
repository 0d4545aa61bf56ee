"""Multi-bit blind rotation on Hopper, and the bootstrap dispatcher.

Counterpart of `helm_tpu/ops/mxu_pbs.py`: `blind_rotate_mb` replaces the
Pallas kernel `blind_rotate_fs_mb` (:2706, which takes grouping 1 too)
with the hand-written CUDA kernel in `csrc/blind_rotate_mb.cu`,
`mb_server_key` replaces the BSK
layout `mxu_server_key_fs` (:1954, cached per key as `_layout_cache`
:1602 does), and `bootstrap` replaces `bootstrap_mxu` (:2839): grouping-1
sets go to the single-bit kernel K2 (`ops/sb_pbs.py`), the others to the
multi-bit kernel that `mb_kernel()` selects (HELM_TPU_MB_KERNEL, as
`helm_tpu/ops/ts_pbs.py:76`): K1, the prime-split K6 (`ops/ps_pbs.py`) or
the transposed K4 (`ops/ts_pbs.py`).

K1 is one launch per rotation: a cluster of NP blocks (one per CRT prime)
owns a tile of gates and walks every group with the tile's accumulator in
shared memory. Its body (`csrc/rotate_tiles.cuh`) is also K6's (with the
CRT fold in place of Garner), K2's (at grouping 1, with the rotated
difference as the decomposed words), K4's (with the four-step transform
on the int8 tensor cores in place of the register passes) and K3's (with
the bit-ladder monomials in place of the power table); `rotate_tiles`
below launches any of the five. `tile_plan` picks the tile for a width
from the shared-memory budget; `mb_server_key` lays the BSK out in the
frequency chunks the kernels stream, and the twiddles in the order their
register passes read them (`pass_stages`, `twiddles_by_pass`,
`bank_swizzle`).

Dispatch is by the device of the input tensor: on the CPU the plain
torch version (`fhe/pbs.py`) runs; on a CUDA tensor the kernel is
launched, or an error is raised — there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..fhe import ntt, ops, pbs
from ..fhe.modring import NUM_PRIMES, primes_for
from ..fhe.ntt import from_i32_bits, to_i32_bits
from ..params import TfheParams
from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [ctypes.POINTER(ctypes.c_uint32)] + [_I] * 12 + [_P]

#: the launch shape of the tile body (csrc/rotate_tiles.cuh): threads per
#: block, BSK ring stages, the dynamic shared memory a block may take (227
#: KB), the largest gate tile, and the bytes of one streamed BSK chunk. The
#: kernel checks every launch against its own copy of these and of
#: `smem_bytes` (`cluster_slots` holds the two shared-memory sums equal on
#: the card)
THREADS = 512
STAGES = 2
SMEM_LIMIT = 232448
MAX_TILE = 8
CHUNK_BYTES = 24 * 1024

#: bank swizzle of K1's shared rows: word x of a row lives at x ^ h(x), h
#: linear over GF(2) in the bits 5.. of x (bit b adds SWIZZLE[b - 5] into
#: the bank bits). One table serves N = 256-2048: every register pass,
#: forward and inverse, and every run of 32 consecutive words are
#: conflict-free (tests/test_torch_mb_tiles.py checks it).
SWIZZLE = (25, 31, 21, 22, 11, 9, 26, 18, 8)


#: (grouping, gadget rows) that K6, K4 and K3 have a build for
#: (blind_rotate_{ps,ts,gm}.cu select_kernel): every multi-bit set of
#: params.py (none has grouping 3)
K6_BUILDS = frozenset({(2, 4), (2, 6), (2, 8), (2, 9), (4, 4)})
K4_BUILDS = K6_BUILDS
K3_BUILDS = K6_BUILDS
#: those of K1 (blind_rotate_mb.cu select_kernel): K6's, and grouping 1
#: with 4, 6 or 8 rows (GATES_TPU, GATES_128_K3 at g = 1 in
#: tools/g1_fs_test.py, the g = 1 rows tools/param_search.py picks)
K1_BUILDS = K6_BUILDS | {(1, 4), (1, 6), (1, 8)}
#: (grouping, gadget rows) that K2 has a build for (blind_rotate_sb.cu
#: select_kernel): every grouping-1 set of params.py, and the tiny k=3 one
#: of chip_smoke.py's phase k2
K2_BUILDS = frozenset({(1, 4), (1, 6), (1, 8)})


def pass_stages(N: int) -> list:
    """Radix-2 stages per register pass of K1's NTTs: threes, then the
    remainder (N = 512: 3, 3, 3; 1024: 3, 3, 3, 1; 2048: 3, 3, 3, 2). The
    forward transform runs them from the widest stride down, the inverse
    from stride 1 up."""
    logn = N.bit_length() - 1
    return [min(3, logn - s) for s in range(0, logn, 3)]


def twiddles_by_pass(w, N: int, inverse: bool):
    """The merged-psi twiddles `w` [.., N] (psi_rev or psi_inv_rev) in
    the order K1's register passes read them, so that the lanes of a warp
    read consecutive words. Forward pass at stage s0 with R stages: stage
    s0 + r's twiddle psi[2^(s0+r) + i0 * 2^r + q] moves to 2^(s0+r) +
    q * 2^s0 + i0 (i0 the lane's block, q its sub-block). Inverse pass at
    stride 2^s: stage r's psi_inv[h + i0 * 2^(R-r-1) + q] (h = N >>
    (s + r + 1)) moves to h + q * (N >> (s + R)) + i0."""
    out = np.zeros_like(w)
    s = 0
    for R in pass_stages(N):
        for r in range(R):
            if inverse:
                h, nq, ni = N >> (s + r + 1), 1 << (R - r - 1), N >> (s + R)
                q, i0 = np.meshgrid(np.arange(nq), np.arange(ni), indexing="ij")
                out[..., h + q * ni + i0] = w[..., h + i0 * nq + q]
            else:
                m, nq, ni = 1 << (s + r), 1 << r, 1 << s
                q, i0 = np.meshgrid(np.arange(nq), np.arange(ni), indexing="ij")
                out[..., m + q * ni + i0] = w[..., m + i0 * nq + q]
        s += R
    return out


def bank_swizzle(N: int) -> np.ndarray:
    """u8 [N]: h of every in-row offset x (`SWIZZLE` over x's bits)."""
    x = np.arange(N)
    h = np.zeros_like(x)
    for b in range(5, N.bit_length() - 1):
        h ^= ((x >> b) & 1) * SWIZZLE[b - 5]
    return h.astype(np.uint8)


def fits_u32(primes, terms: int) -> bool:
    """Whether terms * (p_max - 1)^2 fits 32 bits: K1 then sums products in
    u32 and streams the BSK as u16 (pbs_common.cuh fits_u32)."""
    pm = int(max(primes)) - 1
    return terms * pm * pm < (1 << 32)


@dataclass(frozen=True)
class TilePlan:
    """One launch shape of the tile body: `gt` gates per cluster tile (a
    power of two), `tiles` clusters, the BSK streamed in chunks of `chunk`
    frequencies, `smem` bytes of dynamic shared memory per block, and for
    K4 the directions of its N2-point limb matrices staged in shared memory
    (`staged_mats`). One launch runs every CMux group of the rotation."""

    gt: int
    tiles: int
    chunk: int
    smem: int
    narrow: bool
    staged: int = 0


def _narrow(p) -> bool:
    primes = primes_for(p.N)
    return fits_u32(primes, p.gadget_rows) and fits_u32(primes, (1 << p.grouping) - 1)


def chunk_freqs(p) -> int:
    """Frequencies per streamed BSK chunk: the most (a power of two, at
    most 128 and at most N) whose (2^g-1) x rows x (k+1) words fit
    CHUNK_BYTES, and whose (k+1) x chunk items a block's threads cover."""
    words = ((1 << p.grouping) - 1) * p.gadget_rows * (p.k + 1)
    elt = 2 if _narrow(p) else 4
    cf = min(p.N, 128)
    while cf > 32 and (words * cf * elt > CHUNK_BYTES or (p.k + 1) * cf > THREADS):
        cf //= 2
    return cf


def _up(x: int, a: int = 16) -> int:
    return -(-x // a) * a


def _base_bytes(p, gt: int, chunk: int, kernel: str) -> int:
    N, rows, kp1 = p.N, p.gadget_rows, p.k + 1
    elt = 2 if _narrow(p) else 4
    ring = STAGES * ((1 << p.grouping) - 1) * rows * kp1 * chunk * elt
    subsets = kernel != "blind_rotate_sb"  # the word source scales by P_v
    return (
        _up(ring, 128) + _up(STAGES * 8) + rows * gt * N * 4 + kp1 * gt * (N // 4) * 4
        + 2 * N * 8 + (2 * N * 4 if subsets else 0) + _up(N) + MAX_TILE * 4 * 4
    )


def tc_bytes(p, gt: int, staged: int) -> int:
    """K4's shared memory beyond the body's (rotate_tiles.cuh `TcLayout`,
    `TcGeo`): two mbarriers, the 8-point stages' twiddle pairs [16], the
    staged directions of the limb matrices (2 limbs x Kp x N2 bytes each,
    Kp = N2 rounded up to the mma depth 32), and the data's limb planes:
    limb_count of the largest prime planes of [Mp, Kp + 16] int8, Mp = rows
    x gt x 8 rounded up to 16 (the rows of the forward product)."""
    N2 = p.N // ntt.N1
    kp = _up(N2, 32)
    nlmax = max(ntt.limb_count(q) for q in primes_for(p.N))
    return 16 + 16 * 8 + staged * 2 * kp * N2 + nlmax * _up(p.gadget_rows * gt * ntt.N1) * (kp + 16)


def staged_mats(p, gt: int, chunk: int) -> int:
    """The directions of K4's limb matrices a tile of gt gates stages in
    shared memory: both (2), the forward one (1) or none (0), the most that
    fit SMEM_LIMIT; the rest are read from L2 (csrc/rotate_tiles.cuh
    `prepare` makes the same choice)."""
    base = _base_bytes(p, gt, chunk, "blind_rotate_ts")
    return next((s for s in (2, 1) if base + tc_bytes(p, gt, s) <= SMEM_LIMIT), 0)


def smem_bytes(p, gt: int, chunk: int, kernel: str = "blind_rotate_mb") -> int:
    """Dynamic shared memory of one block of the tile body (rotate_tiles.cuh
    `SmemLayout`): the BSK ring, its mbarriers, the tile's rows [rows, gt,
    N] u32 (gadget rows, then the k+1 products in place), its quarter of
    the accumulators [k+1, gt, N/4] u32, the twiddles of both directions
    (u32 pairs: pass-ordered, or K4's twists), the power table [2N] u32
    (for every kernel whose word source scales by P_v, K1 at grouping 1
    too; not for K2, blind_rotate_sb, which scales by no subset
    polynomial; K3 stages it unread and builds its monomials by the bit
    ladder), the swizzle [N] u8 and the group's a_i [MAX_TILE, 4] i32; for K4 (`kernel`
    blind_rotate_ts) `tc_bytes` more (`TcLayout`), for K3 (blind_rotate_gm)
    the step's monomials [gt, g, N] u16."""
    base = _base_bytes(p, gt, chunk, kernel)
    if kernel == "blind_rotate_ts":
        return base + tc_bytes(p, gt, staged_mats(p, gt, chunk))
    if kernel == "blind_rotate_gm":
        return base + gt * p.grouping * p.N * 2
    return base


def tile_plan(p, G: int, slots, kernel: str = "blind_rotate_mb") -> TilePlan:
    """The launch shape of `kernel` (K1, K6, K2, K4 or K3) for G gates at
    set p. Tiles are powers of two up to the largest that fits SMEM_LIMIT;
    `slots(gt)` is how many clusters the card holds at once
    (`cluster_slots`), so a launch runs in ceil(tiles / slots) waves. A
    tile of gt gates takes about gt + 1 gate-times per wave (its chain of
    barriers costs about a gate's work: 1 : 1.5 : 2.6 : 5.0 at gt = 1, 2,
    4, 8 measured for K1 at GATES_128_K3 on an H100); the plan takes the
    tile of least waves x (gt + 1), the narrowest on a tie."""
    chunk = chunk_freqs(p)
    one = smem_bytes(p, 1, chunk, kernel)
    if one > SMEM_LIMIT:
        raise ValueError(f"{p.name}: one gate takes {one} bytes of shared memory")
    best = None
    gt = 1
    while gt <= MAX_TILE and smem_bytes(p, gt, chunk, kernel) <= SMEM_LIMIT:
        waves = _cdiv(_cdiv(G, gt), max(1, slots(gt)))
        cost = waves * (gt + 1)
        if best is None or cost < best[0]:
            best = (cost, gt)
        gt *= 2
    gt = best[1]
    return TilePlan(gt=gt, tiles=_cdiv(G, gt), chunk=chunk, smem=smem_bytes(p, gt, chunk, kernel),
                    narrow=_narrow(p),
                    staged=staged_mats(p, gt, chunk) if kernel == "blind_rotate_ts" else 0)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_for(dsk: pbs.DeviceServerKey, G: int, kernel: str = "blind_rotate_mb") -> TilePlan:
    """The tile plan `kernel` (K1 blind_rotate_mb, K6 blind_rotate_ps, K2
    blind_rotate_sb, K4 blind_rotate_ts or K3 blind_rotate_gm) launches
    for G gates with key dsk on its card."""
    return tile_plan(dsk.params, G, lambda gt: cluster_slots(dsk, gt, kernel), kernel)


_SLOT_ARGTYPES = [ctypes.POINTER(ctypes.c_uint32)] + [_I] * 11 + [ctypes.POINTER(ctypes.c_int)] * 2
_slots: dict = {}


def cluster_slots(dsk: pbs.DeviceServerKey, gt: int, kernel: str = "blind_rotate_mb") -> int:
    """The clusters of `kernel` (csrc/<kernel>.cu: K1, K6, K2, K4 or K3)
    the card holds at once for tiles of gt gates at dsk's set
    (cudaOccupancyMaxActiveClusters), asked once per kernel, set, tile and
    card (the key's, whichever device is current).
    Raises unless the kernel's shared memory for the tile, from its own
    layout, is `smem_bytes`'s."""
    p = dsk.params
    dev = dsk.bsk_ntt.device
    key = (kernel, p.name, p.n, p.N, p.k, p.grouping, p.component_gadgets, gt, dev.index)
    if key not in _slots:
        (mbl, mlv), (bl, lv) = p.component_gadgets[0], p.component_gadgets[-1]
        kk = mb_server_key(dsk)
        out, smem = ctypes.c_int(0), ctypes.c_int(0)
        symbol = f"helm_{kernel}_clusters"
        # on the key's card, whichever is current (-1, no switch: a CPU key)
        with torch.cuda.device(dev.index if dev.type == "cuda" else -1):
            rc = build.entry(kernel, _SLOT_ARGTYPES, symbol)(
                kk.consts, p.n, p.N, p.k, p.grouping, mbl, mlv, bl, lv, gt, kk.chunk,
                2 if _narrow(p) else 4, ctypes.byref(out), ctypes.byref(smem),
            )
        build.check(rc, symbol)
        want = smem_bytes(p, gt, kk.chunk, kernel)
        if smem.value != want:
            raise RuntimeError(
                f"{p.name}: {kernel} takes {smem.value} B of shared memory for {gt} gates, "
                f"mb_pbs.smem_bytes says {want}"
            )
        _slots[key] = out.value
    return _slots[key]


def tiled_bsk(bsk_ntt: torch.Tensor, p, chunk: int, narrow: bool) -> torch.Tensor:
    """The BSK layout of the tile body: [n/g, 2^g-1, rows, k+1, NP, N]
    (a grouping-1 BSK [n, rows, k+1, NP, N] is that at g = 1) ->
    [n/g, NP, N/chunk, 2^g-1, rows, k+1, chunk], so that each block (one
    prime) streams one contiguous chunk of its step's slab at a time; as
    i16 when `narrow` (every residue < 2^15), else i32."""
    t = bsk_ntt.reshape(p.n // p.grouping, (1 << p.grouping) - 1, p.gadget_rows, p.k + 1,
                        NUM_PRIMES, p.N // chunk, chunk)
    t = t.permute(0, 4, 5, 1, 2, 3, 6).contiguous()
    return t.to(torch.int16) if narrow else t.to(torch.int32)


@dataclass(frozen=True, eq=False)
class MbKernelKey:
    """The kernels' view of one server key, derived once per key.

    `bsk` is the device key's own NTT-domain BSK in its natural
    [n/g, 2^g-1, rows, k+1, NP, N] order (no copy); the plain versions
    read it. K1, K6, K2 and K3 read `bsk_k1` (`tiled_bsk`), `twf` / `twi`
    (the twiddles and their Shoup companions as pairs [NP, N, 2] in
    register-pass order, `twiddles_by_pass`) and `swizzle`
    (`bank_swizzle`); K4 reads its own BSK and twists
    (`ts_pbs.ts_server_key`); all read the power table (K3 aside) and the
    constants. The Shoup companion of the BSK is dropped (the kernels
    reduce with a Barrett constant per prime)."""

    params: TfheParams
    bsk: torch.Tensor  # i32 bit patterns
    psi: torch.Tensor  # i32 [NP, N] each
    psi_sh: torch.Tensor
    psi_inv: torch.Tensor
    psi_inv_sh: torch.Tensor
    pw: torch.Tensor  # i32 [NP, 2N]
    ef: torch.Tensor  # i32 [N]
    consts: ctypes.Array  # u32 [26]
    twf: torch.Tensor  # i32 [NP, N, 2]
    twi: torch.Tensor
    swizzle: torch.Tensor  # u8 [N]
    chunk: int

    @functools.cached_property
    def bsk_k1(self) -> torch.Tensor:
        """The BSK chunked per step and prime (`tiled_bsk`), i16 where every
        product sum fits u32: a second copy of the BSK on the device, half
        or all of `bsk`'s bytes. Built on first use, so only a key whose
        kernel reads it (K1, K6, K2, K3) holds it."""
        return tiled_bsk(self.bsk, self.params, self.chunk, _narrow(self.params))


_layouts: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def mb_server_key(dsk: pbs.DeviceServerKey) -> MbKernelKey:
    """The kernel layout of `dsk`, built on first use and cached per key."""
    got = _layouts.get(dsk)
    if got is not None:
        return got
    tab = dsk.tab
    dev = dsk.device
    p = dsk.params

    def i32(a):
        return torch.as_tensor(a.astype("int64")).to(torch.int32).to(dev)

    pw, ef = pbs.power_tables(tab.N, str(dev))
    g = tab.garner
    garner = [
        g.inv_p0_mod_p1, g.inv_p0_mod_p1_sh, g.p0_mod_p2, g.p0_mod_p2_sh,
        g.inv_p01_mod_p2, g.inv_p01_mod_p2_sh, g.p0_mod_p3, g.p0_mod_p3_sh,
        g.p01_mod_p3, g.p01_mod_p3_sh, g.inv_p012_mod_p3, g.inv_p012_mod_p3_sh,
        g.prod_mod_q, g.half_p3,
    ]
    vals = (
        [int(x) for x in tab.primes]
        + [int(x) for x in tab.n_inv]
        + [int(x) for x in tab.n_inv_sh]
        + [int(x) for x in garner]
    )

    def pairs(w, w_sh, inverse):
        return i32(np.stack([twiddles_by_pass(w, tab.N, inverse),
                             twiddles_by_pass(w_sh, tab.N, inverse)], axis=-1))

    key = MbKernelKey(
        params=p,
        bsk=dsk.bsk_ntt.contiguous(),
        psi=i32(tab.psi_rev),
        psi_sh=i32(tab.psi_rev_sh),
        psi_inv=i32(tab.psi_inv_rev),
        psi_inv_sh=i32(tab.psi_inv_rev_sh),
        pw=pw.to(torch.int32).contiguous(),
        ef=ef.to(torch.int32).contiguous(),
        consts=(ctypes.c_uint32 * len(vals))(*vals),
        twf=pairs(tab.psi_rev, tab.psi_rev_sh, False),
        twi=pairs(tab.psi_inv_rev, tab.psi_inv_rev_sh, True),
        swizzle=torch.from_numpy(bank_swizzle(tab.N)).to(dev),
        chunk=chunk_freqs(p),
    )
    _layouts[dsk] = key
    return key


def check_inputs(dsk: pbs.DeviceServerKey, lwe_in, testv, what: str) -> None:
    """Raise unless a kernel can take these tensors: everything on one
    CUDA device, int64 words, lwe_in [G, n+1] and testv [1 or G, N]."""
    p = dsk.params
    G = lwe_in.shape[0] if lwe_in.dim() else 0
    if dsk.bsk_ntt.device != lwe_in.device or testv.device != lwe_in.device:
        raise ValueError(
            f"{what}: server key on {dsk.bsk_ntt.device}, inputs on "
            f"{lwe_in.device} / {testv.device}"
        )
    if lwe_in.dtype != torch.int64 or testv.dtype != torch.int64:
        raise ValueError(f"{what}: words are int64 tensors, got {lwe_in.dtype} / {testv.dtype}")
    if lwe_in.dim() != 2 or G == 0 or lwe_in.shape[1] != p.n + 1 or testv.dim() != 2 or (
        testv.shape[0] not in (1, G) or testv.shape[1] != p.N
    ):
        raise ValueError(
            f"{what}: lwe_in {tuple(lwe_in.shape)} / testv "
            f"{tuple(testv.shape)}, want [G, {p.n + 1}] / [1 or G, {p.N}]"
        )


def check_build(p, builds, what: str) -> None:
    """Raise unless `builds` (K1_BUILDS, K2_BUILDS, K6_BUILDS, K4_BUILDS,
    K3_BUILDS) holds p's (grouping, gadget rows): the kernel file has no
    template build for another."""
    if (p.grouping, p.gadget_rows) not in builds:
        raise ValueError(
            f"{p.name}: {what} has no build for grouping {p.grouping} with {p.gadget_rows} gadget rows"
        )


def rotate_tiles(kernel: str, dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor,
                 extra=(), tables=None) -> torch.Tensor:
    """One launch of csrc/<kernel>.cu (K1 blind_rotate_mb, K6
    blind_rotate_ps, K2 blind_rotate_sb, K4 blind_rotate_ts or K3
    blind_rotate_gm: the body of rotate_tiles.cuh with the kernel's word
    source, epilogue, transform and monomial source) on CUDA tensors
    checked by the caller, with the tile plan `plan_for` picks; `extra`:
    the kernel's own tables and constants as (ctypes type, value) pairs,
    passed after the Garner constants; `tables`: (BSK, forward, inverse
    twiddle pairs) in place of `bsk_k1`, `twf`, `twi` (K4's). Returns the
    [G, k+1, N] words."""
    p = dsk.params
    n, N, k = p.n, p.N, p.k
    G = lwe_in.shape[0]
    key = mb_server_key(dsk)
    bsk, twf, twi = tables or (key.bsk_k1, key.twf, key.twi)
    plan = plan_for(dsk, G, kernel)
    acc = to_i32_bits(pbs.initial_acc(p, lwe_in, testv)).contiguous()
    abar = ops.mod_switch(lwe_in[:, :n], N).to(torch.int32).contiguous()
    (mbl, mlv), (bl, lv) = p.component_gadgets[0], p.component_gadgets[-1]
    argtypes = _ARGTYPES[:8] + [t for t, _ in extra] + _ARGTYPES[8:]
    # the C entry launches in the current device's context: make it the
    # inputs' card, which a mesh shard need not be
    with torch.cuda.device(lwe_in.device):
        rc = build.entry(kernel, argtypes)(
            acc.data_ptr(), abar.data_ptr(), bsk.data_ptr(),
            twf.data_ptr(), twi.data_ptr(), key.pw.data_ptr(),
            key.swizzle.data_ptr(), key.consts, *(v for _, v in extra),
            G, n, N, k, p.grouping, mbl, mlv, bl, lv, plan.gt, plan.chunk, bsk.element_size(),
            torch.cuda.current_stream(lwe_in.device).cuda_stream,
        )
    build.check(rc, f"helm_{kernel}")
    return from_i32_bits(acc)


def blind_rotate_mb(
    dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Multi-bit blind rotation [G, n+1] words -> [G, k+1, N] words, at
    any grouping K1 has a build for, 1 included: there the one subset
    polynomial is P_1 = X^a - 1 and the key is `gen_bsk_multibit`'s [n, 1,
    rows, k+1, NP, N] (`gen_bsk`'s [n, rows, k+1, NP, N] holds the same
    GGSW(s_i)). At grouping 1 this is a blind rotation of the same input
    as K2's (`sb_pbs.blind_rotate_sb`, which decomposes the rotated
    difference) with other noise, so other words; `blind_rotation` still
    routes grouping-1 sets to K2, as the reference's `bootstrap_mxu`
    does.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (`blind_rotate_mb.launches` counts the launches, `g1_launches` those
    at grouping 1)."""
    p = dsk.params
    if lwe_in.device.type == "cpu":
        return pbs.blind_rotate_multibit(dsk, lwe_in, testv)
    if lwe_in.device.type != "cuda":
        raise NotImplementedError(f"blind_rotate_mb: no kernel for {lwe_in.device}")
    check_inputs(dsk, lwe_in, testv, "blind_rotate_mb")
    check_build(p, K1_BUILDS, "K1")
    out = rotate_tiles("blind_rotate_mb", dsk, lwe_in, testv)
    blind_rotate_mb.launches += 1
    if p.grouping == 1:
        blind_rotate_mb.g1_launches += 1
    return out


blind_rotate_mb.launches = 0
blind_rotate_mb.g1_launches = 0


#: the multi-bit kernel when HELM_TPU_MB_KERNEL does not name one
#: (ts_pbs.py:73 DEFAULT_MB_KERNEL)
DEFAULT_MB_KERNEL = "fs"
MB_KERNELS = ("fs", "fs16", "ts", "hb", "hb2", "ps")


def mb_kernel() -> str:
    """The multi-bit kernel selection (`helm_tpu/ops/ts_pbs.py:76`
    `mb_kernel`): HELM_TPU_MB_KERNEL when it names a kernel, else "ts"
    under the legacy HELM_TPU_TS_KERNEL=1, else DEFAULT_MB_KERNEL. Read
    at every call, as the reference does."""
    env = os.environ.get("HELM_TPU_MB_KERNEL")
    if env in MB_KERNELS:
        return env
    if os.environ.get("HELM_TPU_TS_KERNEL", "0") == "1":
        return "ts"
    return DEFAULT_MB_KERNEL


def blind_rotation(params):
    """The blind-rotation wrapper `bootstrap` runs for `params`, routed as
    `helm_tpu/ops/mxu_pbs.py:2864-2936` `bootstrap_mxu` routes:
    grouping 1 -> K2 (`sb_pbs.blind_rotate_sb`) whatever the selection;
    otherwise by `mb_kernel()`: "ps" -> K6 (`ps_pbs.blind_rotate_ps`);
    "ts" (also the legacy HELM_TPU_TS_KERNEL=1) -> K4
    (`ts_pbs.blind_rotate_ts`); "fs", "fs16", "hb", "hb2" -> K1
    (`blind_rotate_mb`: their TPU bodies are K1's pallas_call with another
    BSK dtype or layout, the same function)."""
    if params.grouping == 1:
        from .sb_pbs import blind_rotate_sb

        return blind_rotate_sb
    kn = mb_kernel()
    if kn == "ps":
        from .ps_pbs import blind_rotate_ps

        return blind_rotate_ps
    if kn == "ts":
        from .ts_pbs import blind_rotate_ts

        return blind_rotate_ts
    return blind_rotate_mb


def kernel_layouts(dsk: pbs.DeviceServerKey) -> None:
    """Build the key layouts the selected kernel reads (`mb_server_key`'s
    tables for every kernel; its chunked `bsk_k1` for K1, K6 and K2, but
    not under "ts"; K4's `ts_server_key`, with its own chunked BSK in the
    four-step order, under "ts"), so that an engine pays for them once, up
    front."""
    key = mb_server_key(dsk)
    if dsk.params.grouping > 1 and mb_kernel() == "ts":
        from .ts_pbs import ts_server_key

        ts_server_key(dsk)
    else:
        key.bsk_k1  # built here, on first access, and cached


def bootstrap(
    dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """Full PBS [G, n+1] -> [G, n+1]: the blind rotation `blind_rotation`
    picks (its kernel on CUDA, its plain version on the CPU), sample
    extract, int8-limb keyswitch."""
    acc = blind_rotation(dsk.params)(dsk, lwe_in, testv)
    big = ops.sample_extract(acc, dsk.params.k, dsk.params.N)
    return pbs.keyswitch(dsk, big)
