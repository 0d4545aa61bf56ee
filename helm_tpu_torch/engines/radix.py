"""Radix-integer homomorphic ops (arith mode building blocks), on torch words.

Counterpart of `helm_tpu/engines/radix.py` (the reference's radix
operations: src/circuit.rs:1113-1483, src/gates.rs:306-702). Values are
vectors of 2-bit-message / 2-bit-carry blocks: value = sum_i block_i * 4^i,
u8..u128 = 4..64 blocks, each block an LWE ciphertext of n+1 words (int64
in [0, 2^32), `fhe/ntt.py`). Blocks are kept clean (message < 4, no
carries) after every public op.

Every op is a coroutine that yields lists of (pre, test_poly) bootstrap
requests and receives the bootstrapped results; the dataflow scheduler in
`engines/arith.py` merges the requests of all runnable gates into one
`_bootstrap_multi` call per round (one `mb_pbs.bootstrap`: on the card the
multi-bit kernel for ARITH_128_MB2, on the CPU its plain version). The
plain methods on RadixOps drive one coroutine to completion.

Words wrap mod 2^32 in the reference (uint32); here every linear
combination is masked with `M32` before it becomes a ciphertext (the
largest, a compressor chunk of five terms, stays below 2^35). The
reference's `x.at[idx].add(v)` is an in-place add on a fresh tensor.

`RadixOps.mesh`, when set (`ArithEngine.set_sharding`), is a gate mesh
(`parallel/mesh.py`): every merged bootstrap of that engine then goes
through the mesh's exchange (`mesh.bootstrap_sharded`), still one merged
launch in `LAUNCHES` and its real slots in `SLOTS`. The reference keeps the
mesh in the module global `BATCH_SHARD`, which every later engine of the
process inherits; here it belongs to the engine.

Left out as TPU-only mechanics (ROADMAP.md "What the port leaves out"):
the power-of-two bucket padding of each launch (:119-129, which exists to
stop recompiles) and the `HELM_TPU_MAX_G` width cap (:143-162, a
TPU-worker crash clamp). Each slot bootstraps alone, so the output words
are the reference's; `SLOTS` counts real slots, where the reference counts
padded ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fhe import pbs
from ..fhe.ntt import M32, words
from ..parallel import mesh as mesh_mod
from ..params import TfheParams

WIDTH_BLOCKS = {"u8": 4, "u16": 8, "u32": 16, "u64": 32, "u128": 64}

#: bootstrap calls (merged rounds) and bootstrapped slots, this process
LAUNCHES = [0]
SLOTS = [0]


class RadixTestPolys:
    """The radix ops' test polynomials, [1, N] words each on `device`."""

    def __init__(self, params: TfheParams, device):
        half = params.msg_space // 2  # reachable messages (padding bit)
        ms = np.arange(half, dtype=np.uint64)

        def tv(f):
            return words(pbs.lut_test_poly(params, f(ms).astype(np.uint64))[None, :], device)

        self.msg = tv(lambda m: m % 4)
        self.carry = tv(lambda m: m // 4)
        self.mul_lo = tv(lambda m: ((m >> 2) * (m & 3)) % 4)
        self.mul_hi = tv(lambda m: ((m >> 2) * (m & 3)) // 4)
        self.lobit = tv(lambda m: m % 2)
        self.hibit = tv(lambda m: (m % 4) // 2)
        # shr helper: 2 * (x % 2) to splice a low bit into the block above
        self.lobit2 = tv(lambda m: 2 * (m % 2))
        self.half = tv(lambda m: (m % 4) // 2)
        # log-depth carry propagation (Hillis-Steele over carry status):
        # status of a raw block sum s<=7: 2=generate (s>=4), 1=propagate
        # (s==3, carries a carry-in through), 0=kill
        self.status = tv(lambda m: np.where(m >= 4, 2, np.where(m == 3, 1, 0)))
        # combine(newer=idx>>2, older=idx&3): newer==1 ? older : newer
        self.cmb = tv(lambda m: np.where((m >> 2) == 1, m & 3, m >> 2))
        # fused combine-then-carry for the LAST scan round: carry bit of
        # the combined status (status==2 -> 1)
        self.cmbc = tv(lambda m: np.where((m >> 2) == 1, m & 3, m >> 2) // 2)
        # final message from idx = 2*s + carry_in
        self.msgc = tv(lambda m: ((m >> 1) + (m & 1)) % 4)


def _bootstrap_multi(dsk, pres: list, tvs: list, mesh=None) -> list:
    """One bootstrap call for several (pre, testv) groups: the groups'
    pre-images side by side, each slot with its group's test polynomial
    (one [1, N] polynomial when every group shares it); the results split
    back per group. On a gate mesh the call is sharded across it."""
    sizes = [p.shape[0] for p in pres]
    pre = torch.cat(pres) if len(pres) > 1 else pres[0]
    if all(t is tvs[0] for t in tvs):
        tv = tvs[0]
    else:
        tv = torch.cat([t.expand(s, t.shape[-1]) for s, t in zip(sizes, tvs)])
    LAUNCHES[0] += 1
    SLOTS[0] += pre.shape[0]
    out = mesh_mod.bootstrap(mesh, dsk, pre, tv)
    return list(torch.split(out, sizes))


def _run(ops: "RadixOps", gen):
    """Drive one op coroutine to completion, launching every yielded
    request list immediately (the single-op / library-API path)."""
    try:
        reqs = gen.send(None)
        while True:
            outs = _bootstrap_multi(ops.dsk, [r[0] for r in reqs], [r[1] for r in reqs], ops.mesh)
            reqs = gen.send(outs)
    except StopIteration as e:
        return e.value


def trivial_blocks(params: TfheParams, value: int, nb: int, batch: int, device) -> torch.Tensor:
    """Trivial radix encryption [batch, nb, n+1]."""
    out = torch.zeros((batch, nb, params.n + 1), dtype=torch.int64, device=device)
    for i in range(nb):
        out[:, i, params.n] = ((value >> (2 * i)) & 3) * params.delta
    return out


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=like.device)


def _propagate_g(tp: RadixTestPolys, z, with_carry=False):
    """Carry-propagate blocks -> clean blocks (+ carry-out).

    z: [B, nb, n+1]. Invariant at every call site: block sums <= 6 for
    blocks >= 1 and <= 7 at block 0 (carry-in 0 there), so every running
    carry is 0/1. nb >= 8 uses log-depth carry-lookahead (Hillis-Steele
    scan over encrypted generate/propagate status, ceil(log2 nb)+3
    rounds); smaller widths ripple sequentially (nb rounds).
    """
    n1 = z.shape[-1]
    B, nb = z.shape[0], z.shape[1]
    if nb < 8:
        c = _zeros((B, n1), z)
        outs = []
        for i in range(nb):
            t = (z[:, i] + c) & M32
            m, c = yield [(t, tp.msg), (t, tp.carry)]
            outs.append(m)
        res = torch.stack(outs, dim=1)
        return (res, c) if with_carry else res
    flat = z.reshape(B * nb, n1)
    (a,) = yield [(flat, tp.status)]
    a = a.reshape(B, nb, n1)
    o = 1
    while 2 * o < nb:
        # inclusive scan: a[i] <- combine(a[i] over a[i-o])
        pre = (4 * a[:, o:] + a[:, :-o]) & M32
        (upd,) = yield [(pre.reshape(B * (nb - o), n1), tp.cmb)]
        a = torch.cat([a[:, :o], upd.reshape(B, nb - o, n1)], dim=1)
        o *= 2
    # final scan round, fused with carry extraction: positions < o are
    # already final (Hillis-Steele: position i is final once o > i), so
    # this ONE launch maps them through `half` while the rest combine
    # straight to a carry bit via `cmbc` — saving the separate half round
    pre = (4 * a[:, o:] + a[:, :-o]) & M32
    hic, loc = yield [
        (pre.reshape(B * (nb - o), n1), tp.cmbc),
        (a[:, :o].reshape(B * o, n1), tp.half),
    ]
    cs = torch.cat([loc.reshape(B, o, n1), hic.reshape(B, nb - o, n1)], dim=1)
    cin = torch.cat([_zeros((B, 1, n1), z), cs[:, : nb - 1]], dim=1)
    pre = ((2 * z + cin) & M32).reshape(B * nb, n1)
    (m,) = yield [(pre, tp.msgc)]
    res = m.reshape(B, nb, n1)
    return (res, cs[:, nb - 1]) if with_carry else res


def _prop_rounds(nb: int) -> int:
    """Bootstrap rounds _propagate_g takes at width nb."""
    if nb < 8:
        return nb
    o, iters = 1, 0
    while 2 * o < nb:
        o *= 2
        iters += 1
    return 1 + iters + 1 + 1  # status + scan + fused final + msgc


def _sim_compress(cols_w: list[list[int]], limit: int, nb: int) -> int:
    """Round count of _compress_g's loop on weights alone (the chunking
    is deterministic host-side scheduling, so both endgames can be
    costed exactly before spending any bootstraps)."""
    rounds = 0
    cw = [list(ws) for ws in cols_w]
    while any(sum(ws) > limit for ws in cw):
        rounds += 1
        new: list[list[int]] = [[] for _ in range(nb)]
        for c, ws in enumerate(cw):
            if sum(ws) <= limit:
                new[c].extend(ws)
                continue
            k = 0
            while k < len(ws):
                w, cnt = 0, 0
                while k < len(ws) and w + ws[k] <= 5:
                    w += ws[k]
                    k += 1
                    cnt += 1
                new[c].append(1)
                if not (cnt == 1 and w == 1) and c + 1 < nb:
                    new[c + 1].append(1)
        cw = new
    return rounds


def _neg(y, n: int, delta: int, first: bool):
    """The blocks 3 - y (every body + 3 delta), + 1 at block 0 when
    `first`: x + _neg(y) computes x + ~y (+ 1)."""
    neg = (0 - y) & M32
    neg[..., n] = (neg[..., n] + 3 * delta) & M32
    if first:
        neg[:, 0, n] = (neg[:, 0, n] + delta) & M32
    return neg


class RadixOps:
    """Device key + test polys + the radix op suite.

    `*_g` methods are coroutines (yield PBS request lists, receive
    results); the plain methods drive them synchronously. `mesh`: the gate
    mesh every bootstrap is sharded on, or None."""

    def __init__(self, params: TfheParams, dsk, mesh=None):
        self.params = params
        self.dsk = dsk
        self.mesh = mesh
        self.tp = RadixTestPolys(params, dsk.device)

    # -- add / sub -----------------------------------------------------
    def add_g(self, x, y, with_carry: bool = False):
        return _propagate_g(self.tp, (x + y) & M32, with_carry=with_carry)

    def sub_g(self, x, y, with_carry: bool = False):
        """x - y via x + (3-y per block) + 1; carry-out == (x >= y)."""
        p = self.params
        z = (x + _neg(y, p.n, p.delta, True)) & M32
        return _propagate_g(self.tp, z, with_carry=with_carry)

    def add_sub_mixed_g(self, x, y, is_sub):
        """Fused batch of adds and subs: row i computes x-y when is_sub[i]
        (a static python sequence) else x+y. Both ops end in the same
        carry-propagate, so the whole batch shares ONE bootstrap chain."""
        p = self.params
        neg = _neg(y, p.n, p.delta, True)
        sel = torch.tensor(list(is_sub), dtype=torch.bool, device=x.device)[:, None, None]
        return _propagate_g(self.tp, (x + torch.where(sel, neg, y)) & M32)

    def add_scalar_block0_g(self, x, v: int):
        p = self.params
        z = x.clone()
        z[:, 0, p.n] = (z[:, 0, p.n] + v * p.delta) & M32
        return _propagate_g(self.tp, z)

    def ge_g(self, x, y):
        """Carry-only comparison: (x >= y) as one encrypted bit — the
        carry-out of x + ~y + 1 via a log-depth generate/propagate status
        REDUCTION (a full subtraction computes every prefix carry plus a
        final message round just to discard them; the reduction needs
        ceil(log2 nb) combine rounds over a halving batch)."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        n1 = p.n + 1
        z = (x + _neg(y, p.n, p.delta, True)) & M32
        (a,) = yield [(z.reshape(B * nb, n1), self.tp.status)]
        a = a.reshape(B, nb, n1)
        m = nb
        while m > 2:
            h = m // 2
            pre = (4 * a[:, 1 : 2 * h : 2] + a[:, 0 : 2 * h : 2]) & M32
            (cmb,) = yield [(pre.reshape(B * h, n1), self.tp.cmb)]
            cmb = cmb.reshape(B, h, n1)
            a = torch.cat([cmb, a[:, 2 * h :]], dim=1) if m % 2 else cmb
            m = h + m % 2
        if m == 2:  # final combine straight to the carry bit
            pre = ((4 * a[:, 1] + a[:, 0]) & M32).reshape(B, n1)
            (c,) = yield [(pre, self.tp.cmbc)]
        else:
            (c,) = yield [(a[:, 0], self.tp.half)]
        return c

    # -- mul -----------------------------------------------------------
    def mul_g(self, x, y, square: bool = False):
        """Schoolbook + carry-save compression; all rounds fully batched.

        Request preambles are built with one gather + arithmetic op per
        round (index tensors over a term pool) rather than per-(i,j) slice
        ops.

        square=True (y is x): symmetric pairs are bootstrapped ONCE and
        their pool index listed twice in the compression columns —
        ~47% fewer slots in the dominant partial-product round."""
        B, nb = x.shape[0], x.shape[1]
        n1 = self.params.n + 1
        if square:
            pairs = [(i, j) for i in range(nb) for j in range(i, nb) if i + j < nb]
        else:
            pairs = [(i, j) for i in range(nb) for j in range(nb) if i + j < nb]
        hi_pairs = [(i, j) for (i, j) in pairs if i + j + 1 < nb]

        def pair_pre(ps):  # [len(ps)*B, n+1], pair-major
            idx_i = torch.tensor([i for i, _ in ps], device=x.device)
            idx_j = torch.tensor([j for _, j in ps], device=x.device)
            z = (4 * x[:, idx_i] + y[:, idx_j]) & M32  # [B, P, n+1]
            return z.transpose(0, 1).reshape(len(ps) * B, n1)

        if hi_pairs:
            lo, hi = yield [
                (pair_pre(pairs), self.tp.mul_lo),
                (pair_pre(hi_pairs), self.tp.mul_hi),
            ]
        else:
            (lo,) = yield [(pair_pre(pairs), self.tp.mul_lo)]
            hi = lo[:0]
        # term pool [T, B, n+1]; row T is a zero pad for short chunks
        pool = torch.cat(
            [
                lo.reshape(len(pairs), B, n1),
                hi.reshape(len(hi_pairs), B, n1),
                _zeros((1, B, n1), x),
            ]
        )
        zpad = len(pairs) + len(hi_pairs)
        cols: list[list[tuple[int, int]]] = [[] for _ in range(nb)]
        mult = (lambda i, j: 2 if i != j else 1) if square else (lambda i, j: 1)
        for idx, (i, j) in enumerate(pairs):
            cols[i + j].extend([(idx, 1)] * mult(i, j))
        for idx, (i, j) in enumerate(hi_pairs):
            cols[i + j + 1].extend([(len(pairs) + idx, 1)] * mult(i, j))
        return (yield from self._compress_g(pool, cols, zpad, B, n1))

    def _compress_g(self, pool, cols, zpad, B, n1):
        """Carry-save column compression to one CLEAN block per column.

        cols[c] holds (pool_index, weight) entries; weight w means the
        block's value is <= 3*w (clean blocks w=1, doubled blocks w=2).
        Each round greedily packs chunks of total weight <= 5 per column
        (chunk sums <= 15, inside the PBS domain), bootstraps msg+carry
        for every chunk in ONE launch, and feeds carries one column up.

        Endgame: compressing all the way to one entry makes the final
        carries RIPPLE one column per round (~nb rounds); stopping at
        column weight <= 2 (block sums <= 6, the propagate invariant)
        and finishing with ONE log-depth carry propagate is often
        cheaper. Scheduling is host-side and deterministic, so both
        endgames are SIMULATED on the weights and the cheaper one runs."""
        nb = len(cols)
        dev = pool.device

        def colw(terms):
            return sum(w for _, w in terms)

        r1 = _sim_compress([[w for _, w in t] for t in cols], 1, nb)
        r2 = _sim_compress([[w for _, w in t] for t in cols], 2, nb)
        prop_end = r2 + _prop_rounds(nb) < r1
        limit = 2 if prop_end else 1

        while any(colw(terms) > limit for terms in cols):
            chunk_idx, chunk_col = [], []
            new_cols: list[list[tuple[int, int]]] = [[] for _ in range(nb)]
            for c, terms in enumerate(cols):
                if colw(terms) <= limit:
                    new_cols[c].extend(terms)
                    continue
                k = 0
                while k < len(terms):
                    chunk, w = [], 0
                    while k < len(terms) and w + terms[k][1] <= 5:
                        chunk.append(terms[k][0])
                        w += terms[k][1]
                        k += 1
                    if len(chunk) == 1 and w == 1:
                        new_cols[c].append((chunk[0], 1))
                    else:
                        chunk_idx.append(chunk + [zpad] * (5 - len(chunk)))
                        chunk_col.append(c)
            if chunk_idx:
                C = len(chunk_idx)
                sel = torch.tensor(chunk_idx, device=dev)  # [C, 5]
                pre = (pool[sel].sum(dim=1) & M32).reshape(C * B, n1)
                msgs, carries = yield [(pre, self.tp.msg), (pre, self.tp.carry)]
                base = pool.shape[0] - 1  # overwrite the zero pad position
                pool = torch.cat(
                    [
                        pool[:-1],
                        msgs.reshape(C, B, n1),
                        carries.reshape(C, B, n1),
                        torch.zeros((1, B, n1), dtype=torch.int64, device=dev),
                    ]
                )
                zpad = base + 2 * C
                for ci, c in enumerate(chunk_col):
                    new_cols[c].append((base + ci, 1))
                    if c + 1 < nb:
                        new_cols[c + 1].append((base + C + ci, 1))
            cols = new_cols
        if prop_end:
            sel1 = torch.tensor([t[0][0] if t else zpad for t in cols], device=dev)
            sel2 = torch.tensor([t[1][0] if len(t) > 1 else zpad for t in cols], device=dev)
            z = ((pool[sel1] + pool[sel2]) & M32).transpose(0, 1)  # [B, nb, n+1]
            return (yield from _propagate_g(self.tp, z))
        sel = torch.tensor([terms[0][0] if terms else zpad for terms in cols], device=dev)
        return pool[sel].transpose(0, 1)  # [B, nb, n+1]

    def mul_plain_g(self, x, c: int):
        """x * plaintext c via binary expansion feeding the carry-save
        compressor directly: even shifts contribute x's blocks relabeled
        (free), odd shifts contribute DOUBLED blocks (2*ct, linear,
        weight 2 in the compressor) — zero propagates anywhere. Truncates
        mod 2^width like the encrypted schoolbook."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        n1 = p.n + 1
        width = 2 * nb
        c &= (1 << width) - 1
        if c == 0:
            return trivial_blocks(p, 0, nb, B, x.device)
        # pool: x's blocks (idx i), doubled blocks (idx nb+i), zero pad
        xt = x.transpose(0, 1)  # [nb, B, n+1]
        pool = torch.cat([xt, (2 * xt) & M32, _zeros((1, B, n1), x)])
        zpad = 2 * nb
        cols: list[list[tuple[int, int]]] = [[] for _ in range(nb)]
        for k in range(width):
            if not (c >> k) & 1:
                continue
            s, bit = divmod(k, 2)
            for j in range(s, nb):  # term block j = (2x if odd else x)[j-s]
                cols[j].append((nb + (j - s), 2) if bit else ((j - s), 1))
        return (yield from self._compress_g(pool, cols, zpad, B, n1))

    # -- division ------------------------------------------------------
    def div_g(self, x, y):
        """Restoring long division; div-by-zero yields all-ones (like the
        hardware algorithm; documented divergence from Rust's panic)."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        n1 = p.n + 1
        bits = 2 * nb
        # extract all bits of x in one round
        flat = x.reshape(B * nb, n1)
        los, his = yield [(flat, self.tp.lobit), (flat, self.tp.hibit)]
        los = los.reshape(B, nb, n1)
        his = his.reshape(B, nb, n1)
        xbit = [(his[:, k // 2] if k % 2 else los[:, k // 2]) for k in range(bits)]
        # remainder register gets one extra block so 2R+b never truncates
        # before the comparison
        nbe = nb + 1
        y_ext = torch.cat([y, _zeros((B, 1, n1), x)], dim=1)
        r = _zeros((B, nbe, n1), x)
        gy = None  # conditional subtrahend, DEFERRED into the next double
        qbits = [None] * bits
        for k in reversed(range(bits)):
            if gy is None:
                # r = 2r + x_bit_k (values <= 7 before propagate)
                z = (2 * r) & M32
                z[:, 0] = (z[:, 0] + xbit[k]) & M32
            else:
                # fold the pending r -= ge*y into the doubling: z =
                # 2*(r + ~gy + 1) + b, blocks <= 15 (inside the PBS
                # domain) — one msg/carry split brings it back under the
                # propagate invariant, replacing a whole extra propagate
                z = (2 * (r + _neg(gy, p.n, p.delta, True))) & M32
                z[:, 0] = (z[:, 0] + xbit[k]) & M32
                flat = z.reshape(B * nbe, n1)
                m, cr = yield [(flat, self.tp.msg), (flat, self.tp.carry)]
                z = m.reshape(B, nbe, n1).clone()
                z[:, 1:] = (z[:, 1:] + cr.reshape(B, nbe, n1)[:, : nbe - 1]) & M32  # sums <= 6
            r = yield from _propagate_g(self.tp, z)
            # ge = (r >= y), carry-only log-depth comparison
            ge = yield from self.ge_g(r, y_ext)
            # gy = ge*y via bivariate (4*ge + y_i); subtraction deferred
            # (the last iteration's never happens — r is discarded)
            qbits[k] = ge
            if k:
                gy_pre = ((4 * ge[:, None] + y_ext) & M32).transpose(0, 1).reshape(B * nbe, n1)
                (gy,) = yield [(gy_pre, self.tp.mul_lo)]
                gy = gy.reshape(nbe, B, n1).transpose(0, 1)
        # quotient blocks are already clean (two 0/1 bits, <= 3): one
        # batched refresh round, no carry propagation needed
        q = torch.stack(
            [(qbits[2 * i] + 2 * qbits[2 * i + 1]) & M32 for i in range(nb)], dim=1
        )
        (m,) = yield [(q.reshape(B * nb, n1), self.tp.msg)]
        return m.reshape(B, nb, n1)

    def div_plain_g(self, x, d: int):
        """Division by a plaintext divisor via multiply-by-reciprocal
        (Granlund-Montgomery): floor(x/d) == floor(x*M / 2^k) exactly for
        all x < 2^w with l = ceil(log2 d), k = w + l, M = ceil(2^k / d).
        One widened mul_plain + a free right relabel."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        w = 2 * nb
        d &= (1 << w) - 1
        if d == 0:  # all-ones, like the restoring-division path
            return trivial_blocks(p, (1 << w) - 1, nb, B, x.device)
        if d == 1:
            return x
        if d & (d - 1) == 0:
            return (yield from self.shift_plain_g(x, d.bit_length() - 1, False))
        l = (d - 1).bit_length()  # noqa: E741
        k = w + l
        M = ((1 << k) + d - 1) // d
        # widen so x*M (< 2^(w+k)) never truncates, then shift right by k
        nb2 = (w + k + 1) // 2
        xw = torch.cat([x, _zeros((B, nb2 - nb, p.n + 1), x)], dim=1)
        prod = yield from self.mul_plain_g(xw, M)
        q = yield from self.shift_plain_g(prod, k, False)
        return q[:, :nb]

    # -- shifts --------------------------------------------------------
    def _halve_g(self, x):
        """x >> 1 on clean blocks: halves, with each block's low bit
        spliced into the block below (one bootstrap round)."""
        B, nb, n1 = x.shape
        flat = x.reshape(B * nb, n1)
        halves, lob2 = yield [(flat, self.tp.half), (flat, self.tp.lobit2)]
        out = halves.reshape(B, nb, n1).clone()
        out[:, : nb - 1] = (out[:, : nb - 1] + lob2.reshape(B, nb, n1)[:, 1:]) & M32
        return out

    def shift_plain_g(self, x, amount: int, left: bool):
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        width = 2 * nb
        if amount >= width:
            return trivial_blocks(p, 0, nb, B, x.device)
        blocks, bit = divmod(amount, 2)
        zero = _zeros((B, blocks, p.n + 1), x)
        if left:
            if blocks:
                x = torch.cat([zero, x[:, : nb - blocks]], dim=1)
            if bit:
                x = yield from _propagate_g(self.tp, (2 * x) & M32)
        else:
            if blocks:
                x = torch.cat([x[:, blocks:], zero], dim=1)
            if bit:
                x = yield from self._halve_g(x)
        return x

    def shift_plain_many_g(self, x, amounts, left: bool):
        """Batched plain-amount shifts, one per row of x with its own
        amount. Block relabels are free; all rows with an odd amount share
        ONE bootstrap round (a batched 2*x propagate for SHL, one
        halves+lobit2 pair for SHR) instead of one launch per gate."""
        p = self.params
        nb = x.shape[1]
        width = 2 * nb
        rows, odd = [], []
        for i, a in enumerate(amounts):
            if a >= width:
                rows.append(_zeros((nb, p.n + 1), x))
                continue
            blocks, bit = divmod(a, 2)
            xi = x[i]
            if blocks:
                zpad = _zeros((blocks, p.n + 1), x)
                xi = torch.cat([zpad, xi[: nb - blocks]]) if left else torch.cat([xi[blocks:], zpad])
            rows.append(xi)
            if bit:
                odd.append(i)
        base = torch.stack(rows)
        if not odd:
            return base
        sel = torch.tensor(odd, device=x.device)
        sub = base[sel]
        if left:
            upd = yield from _propagate_g(self.tp, (2 * sub) & M32)
        else:
            upd = yield from self._halve_g(sub)
        base[sel] = upd
        return base

    def shift_ct_g(self, x, y, left: bool):
        """Shift by encrypted amount: mux ladder over the amount's bits
        (amounts >= width wrap mod width; documented)."""
        p = self.params
        B, nb = x.shape[0], x.shape[1]
        width = 2 * nb
        flat = y.reshape(B * nb, p.n + 1)
        los, his = yield [(flat, self.tp.lobit), (flat, self.tp.hibit)]
        los = los.reshape(B, nb, p.n + 1)
        his = his.reshape(B, nb, p.n + 1)
        ybits = [
            his[:, k // 2] if k % 2 else los[:, k // 2]
            for k in range(max(1, (width - 1).bit_length()))
        ]
        for k, sel in enumerate(ybits):
            shifted = yield from self.shift_plain_g(x, 1 << k, left)
            x = yield from self._mux_blocks_g(sel, shifted, x)
        return x

    def _mux_blocks_g(self, sel, a, b):
        """per-block sel ? a : b via two bivariate products + linear add.

        One PBS round: sel*a_i and (1-sel)*b_i are fresh bootstraps and
        one of them is an encryption of 0, so the sum's message is the
        selected block (< 4 — no carries, nothing to propagate)."""
        p = self.params
        B, nb = a.shape[0], a.shape[1]
        n1 = p.n + 1
        not_sel = (0 - sel) & M32
        not_sel[:, p.n] = (not_sel[:, p.n] + p.delta) & M32
        pre1 = ((4 * sel[:, None] + a) & M32).transpose(0, 1).reshape(B * nb, n1)
        pre2 = ((4 * not_sel[:, None] + b) & M32).transpose(0, 1).reshape(B * nb, n1)
        t1, t2 = yield [(pre1, self.tp.mul_lo), (pre2, self.tp.mul_lo)]
        return ((t1 + t2) & M32).reshape(nb, B, n1).transpose(0, 1)

    # -- synchronous single-op runners ----------------------------------
    def add(self, x, y, with_carry: bool = False):
        return _run(self, self.add_g(x, y, with_carry=with_carry))

    def sub(self, x, y, with_carry: bool = False):
        return _run(self, self.sub_g(x, y, with_carry=with_carry))

    def add_sub_mixed(self, x, y, is_sub):
        return _run(self, self.add_sub_mixed_g(x, y, is_sub))

    def add_scalar_block0(self, x, v: int):
        return _run(self, self.add_scalar_block0_g(x, v))

    def mul(self, x, y, square: bool = False):
        return _run(self, self.mul_g(x, y, square=square))

    def mul_plain(self, x, c: int):
        return _run(self, self.mul_plain_g(x, c))

    def div(self, x, y):
        return _run(self, self.div_g(x, y))

    def div_plain(self, x, d: int):
        return _run(self, self.div_plain_g(x, d))

    def ge(self, x, y):
        return _run(self, self.ge_g(x, y))

    def shift_plain(self, x, amount: int, left: bool):
        return _run(self, self.shift_plain_g(x, amount, left))

    def shift_plain_many(self, x, amounts, left: bool):
        return _run(self, self.shift_plain_many_g(x, amounts, left))

    def shift_ct(self, x, y, left: bool):
        return _run(self, self.shift_ct_g(x, y, left))

    def _mux_blocks(self, sel, a, b):
        return _run(self, self._mux_blocks_g(sel, a, b))
