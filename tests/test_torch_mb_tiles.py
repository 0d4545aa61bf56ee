"""The host-side plan and layouts of K1, K6, K2, K4 and K3 (one kernel
body, `csrc/rotate_tiles.cuh`), and a plain model of the body's order of
operations, against helm_tpu_torch's plain versions and helm_tpu.

The CUDA kernels (`csrc/blind_rotate_{mb,ps,sb,ts,gm}.cu`) cannot run
here; what they read can:
- `mb_pbs.tile_plan`: every tile fits the shared memory a block may take
  and the tiles cover every gate exactly once, at the sets and widths the
  kernels run (multi-bit sets for K1 and K6, grouping-1 sets for K2, every
  multi-bit set for K4, with the limb matrices it stages, and K3), and
  `cluster_slots` holds it to the kernel's own layout;
- `mb_pbs.tiled_bsk`: the chunked BSK layout inverts to `dsk.bsk_ntt`, at
  grouping 1 too; `kernel_layouts` builds it only for a kernel that reads
  it;
- `mb_pbs.twiddles_by_pass` and `pass_stages`: the register-pass NTTs,
  written here with the kernel's index formulas, equal `ntt.ntt_fwd` /
  `ntt.ntt_inv`;
- `mb_pbs.bank_swizzle`: a permutation of every row, and from N = 256 on
  no register pass or run of 32 consecutive words meets a bank twice;
- `_model`: the body's order of operations in plain torch (tile by tile,
  prime by prime: the decomposition of the word source's words, the pass
  NTTs, the products from the chunked layout in u32 where `fits_u32`
  holds, the inverse passes, the epilogue per coefficient quarter). With
  the bare accumulator and Garner (K1) and with the CRT fold (K6) it
  equals `pbs.blind_rotate_multibit`, `pbs.blind_rotate_prime_split` and
  `pbs_jnp.blind_rotate_multibit`; with the rotated difference at
  grouping 1 (K2) it equals `pbs.blind_rotate` and `pbs_jnp.blind_rotate`;
  with the four-step transform (K4's FourStepTC) it equals
  `pbs.blind_rotate_transposed`, and with the bit-ladder monomials (K3's
  Ladder) `pbs.blind_rotate_ladder`, both `pbs.blind_rotate_multibit` and
  the jnp rotation too, at a g = 2 set, a g = 4 set and N = 2048 (p =
  65537), word for word.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helm_tpu import params as RP
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe import pbs_jnp
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu_torch import params as P
from helm_tpu_torch.fhe import ntt, ops, pbs
from helm_tpu_torch.fhe.modring import get_tables, primes_for
from helm_tpu_torch.fhe.ntt import to_host, words
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.ops import mb_pbs, ts_pbs
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

#: the tiny k=3 grouping-1 set of chip_smoke.py's phase k2
RK3_G1 = dataclasses.replace(RP.TEST_PARAMS_K3, name="test_tiny_k3_g1", grouping=1)
#: a tiny g = 2 set at N = 2048 (PRIMES, with 65537)
N2048 = dataclasses.replace(RP.TEST_PARAMS_MB, name="test_tiny_mb2_n2048", N=2048)
SETS = {
    "k3": (RP.TEST_PARAMS_K3, 51), "mb4": (RP.TEST_PARAMS_MB4, 52),
    "g1": (RP.TEST_PARAMS, 53), "lut": (RP.TEST_PARAMS_LUT, 54), "k3_g1": (RK3_G1, 55),
    "n2048": (N2048, 56),
}

#: the sets K1 and K6 run (phases k1 and k6 of chip_smoke.py), and those K2
#: runs (phase k2)
PLAN_SETS = [
    P.GATES_128_K3, P.LUT_128_K2, P.ARITH_128_MB2, P.TEST_PARAMS_K3, P.TEST_PARAMS_MB4,
    dataclasses.replace(P.TEST_PARAMS_K3, name="test_tiny_k3_n1024", N=1024),
    dataclasses.replace(P.TEST_PARAMS_MB, name="test_tiny_mb2_n2048", N=2048),
    P.GATES_TPU, P.GATES_PARAMS, P.LUT_PARAMS, P.ARITH_PARAMS, P.TEST_PARAMS, P.TEST_PARAMS_LUT,
    dataclasses.replace(P.TEST_PARAMS_K3, name="test_tiny_k3_g1", grouping=1),
]


@pytest.fixture(scope="module")
def keys():
    """(client key, jnp device key, port device key) per set, made once."""
    out = {}
    for name, (p, seed) in SETS.items():
        ck = ref_lwe.keygen(p, seed)
        sk = ref_gen_server_key(ck)
        out[name] = (
            ck,
            pbs_jnp.DeviceServerKey.from_host(sk),
            pbs.DeviceServerKey.from_host(server_key_from_reference(sk), "cpu"),
        )
    return out


def h100_slots(gt):
    """The clusters of K1 an H100 holds at once (`cluster_slots` on the card)."""
    return 30


@pytest.mark.parametrize("p", PLAN_SETS, ids=lambda p: p.name)
@pytest.mark.parametrize("G", [1, 2, 8, 37, 200, 1024])
def test_tile_plan_fits_and_covers(p, G):
    plan = mb_pbs.tile_plan(p, G, h100_slots)
    assert plan.smem <= mb_pbs.SMEM_LIMIT
    assert plan.gt & (plan.gt - 1) == 0 and 1 <= plan.gt <= mb_pbs.MAX_TILE
    covered = np.zeros(G, np.int64)
    for t in range(plan.tiles):
        covered[t * plan.gt : min(G, (t + 1) * plan.gt)] += 1
    assert (covered == 1).all() and (plan.tiles - 1) * plan.gt < G
    # the BSK chunk: whole frequencies, a bulk copy of a multiple of 16
    # bytes, and one product item per thread at most
    words = ((1 << p.grouping) - 1) * p.gadget_rows * (p.k + 1) * plan.chunk
    assert p.N % plan.chunk == 0 and plan.chunk >= 32
    assert words * (2 if plan.narrow else 4) % 16 == 0
    assert (p.k + 1) * plan.chunk <= mb_pbs.THREADS


#: every multi-bit set of params.py, and the tiny ones the card checks
MULTIBIT_SETS = [p for p in vars(P).values() if isinstance(p, P.TfheParams) and p.grouping > 1] + [
    dataclasses.replace(P.TEST_PARAMS_K3, name="test_tiny_k3_n1024", N=1024),
    dataclasses.replace(P.TEST_PARAMS_MB, name="test_tiny_mb2_n2048", N=2048),
]


@pytest.mark.parametrize("kernel", ["blind_rotate_ts", "blind_rotate_gm"])
@pytest.mark.parametrize("p", MULTIBIT_SETS, ids=lambda p: p.name)
@pytest.mark.parametrize("G", [1, 8, 37, 1024])
def test_k4_and_k3_plans_fit_and_cover(kernel, p, G):
    """K4's and K3's tiles fit the shared memory a block may take at every
    multi-bit set and cover every gate once. K4's region (limb planes, and
    the limb matrices it stages) is on top of the body's, and the plan
    stages the most directions that fit: both at N = 512, one or both at
    N = 1024, none at N = 2048; K3's layout is K1's plus the step's
    monomials, [gt, g, N] u16."""
    plan = mb_pbs.tile_plan(p, G, h100_slots, kernel)
    assert plan.smem <= mb_pbs.SMEM_LIMIT and plan.smem == mb_pbs.smem_bytes(p, plan.gt, plan.chunk, kernel)
    assert plan.gt & (plan.gt - 1) == 0 and 1 <= plan.gt <= mb_pbs.MAX_TILE
    covered = np.zeros(G, np.int64)
    for t in range(plan.tiles):
        covered[t * plan.gt : min(G, (t + 1) * plan.gt)] += 1
    assert (covered == 1).all() and (plan.tiles - 1) * plan.gt < G
    k1 = mb_pbs.smem_bytes(p, plan.gt, plan.chunk)
    if kernel == "blind_rotate_gm":
        assert plan.staged == 0 and plan.smem == k1 + plan.gt * p.grouping * p.N * 2
        return
    assert plan.smem == k1 + mb_pbs.tc_bytes(p, plan.gt, plan.staged)
    assert plan.staged == 2 or k1 + mb_pbs.tc_bytes(p, plan.gt, plan.staged + 1) > mb_pbs.SMEM_LIMIT
    if p.N == 512:
        assert plan.staged == 2
    if p.N == 2048:
        assert plan.staged == 0
    if p.N == 1024 and plan.gt == 1:
        assert plan.staged >= 1


@pytest.mark.parametrize("G,gt", [(2, 1), (8, 1), (32, 2), (37, 2), (64, 4), (128, 2), (200, 8), (256, 2), (1024, 8)])
def test_tile_plan_counts_waves(G, gt):
    """With 28 clusters resident at once, GATES_128_K3 takes the tile of
    fewest gate-times: two gates where 32 single-gate tiles would need two
    waves; at G=256 five waves of two-gate tiles (15) beat two of eight-gate
    tiles (18) and tie with three of four-gate tiles."""
    assert mb_pbs.tile_plan(P.GATES_128_K3, G, lambda _: 28).gt == gt


def _untiled(t):
    """The inverse of `mb_pbs.tiled_bsk`, as i32 [n/g, 2^g-1, rows, k+1, NP, N]."""
    g1, np_, nch, nv1, rows, kp1, chunk = t.shape
    return t.to(torch.int32).permute(0, 3, 4, 5, 1, 2, 6).reshape(g1, nv1, rows, kp1, np_, nch * chunk)


@pytest.mark.parametrize("name", ["k3", "mb4", "g1", "lut", "k3_g1"])
def test_tiled_bsk_inverts(keys, name):
    """At grouping 1 the BSK [n, rows, k+1, NP, N] is the multi-bit layout
    at g = 1: one subset per step."""
    _, _, dsk = keys[name]
    key = mb_pbs.mb_server_key(dsk)
    p = dsk.params
    assert key.bsk_k1.dtype == (torch.int16 if mb_pbs._narrow(p) else torch.int32)
    assert key.chunk == mb_pbs.chunk_freqs(p)
    want = dsk.bsk_ntt.reshape((p.n // p.grouping, (1 << p.grouping) - 1) + tuple(dsk.bsk_ntt.shape[-4:]))
    assert torch.equal(_untiled(key.bsk_k1), want.to(torch.int32))


def _pass_ntt(x, tw, p, N, inverse):
    """The register-pass NTT of rows x [.., N] (int64) for one prime p with
    the pass-ordered twiddle pairs tw [N, 2], written with the kernel's
    index formulas (pbs_common.cuh fwd_radix / inv_radix): blocks of 2^R
    words, stage by stage; the inverse without the N^-1 scale."""
    lead = x.shape[:-1]
    s = 0
    for R in mb_pbs.pass_stages(N):
        if inverse:  # x = i0 * (t0 << R) + k * t0 + j
            v = x.reshape(lead + (N >> (s + R), 1 << R, 1 << s))
        else:  # x = i0 * (N >> s) + k * tl + j
            v = x.reshape(lead + (1 << s, 1 << R, N >> (s + R)))
        v = v.clone()
        for r in range(R):
            if inverse:
                dist, h, ni = 1 << r, N >> (s + r + 1), N >> (s + R)
                nq = 1 << (R - 1 - r)
            else:
                dist, h, ni = 1 << (R - 1 - r), 1 << (s + r), 1 << s
                nq = 1 << r
            i0 = torch.arange(v.shape[-3])[:, None]
            q = torch.arange(nq)[None, :]
            w = tw[h + q * ni + i0]  # [i0, q, 2]
            vv = v.reshape(lead + (v.shape[-3], nq, 2, dist, v.shape[-1]))
            a, b = vv[..., 0, :, :], vv[..., 1, :, :]
            wx, ws = w[..., 0, None, None], w[..., 1, None, None]
            if inverse:
                na, nb = ntt.add_mod(a, b, p), ntt.mul_shoup(ntt.sub_mod(a, b, p), wx, ws, p)
            else:
                t = ntt.mul_shoup(b, wx, ws, p)
                na, nb = ntt.add_mod(a, t, p), ntt.sub_mod(a, t, p)
            v = torch.stack([na, nb], dim=-3).reshape(v.shape)
        x = v.reshape(lead + (N,))
        s += R
    return x


@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024, 2048])
def test_pass_ntt_matches_ntt(N):
    tab = get_tables(N)
    rng = np.random.default_rng(N)
    x = np.stack([rng.integers(0, p, size=(3, N)) for p in tab.primes], axis=1)
    x = torch.from_numpy(x.astype(np.int64))  # [3, NP, N]
    twf = torch.from_numpy(np.stack([mb_pbs.twiddles_by_pass(tab.psi_rev, N, False),
                                     mb_pbs.twiddles_by_pass(tab.psi_rev_sh, N, False)], -1).astype(np.int64))
    twi = torch.from_numpy(np.stack([mb_pbs.twiddles_by_pass(tab.psi_inv_rev, N, True),
                                     mb_pbs.twiddles_by_pass(tab.psi_inv_rev_sh, N, True)], -1).astype(np.int64))
    fwd = ntt.ntt_fwd(x, tab)
    for pi, p in enumerate(int(q) for q in tab.primes):
        got = _pass_ntt(x[:, pi], twf[pi], p, N, False)
        assert torch.equal(got, fwd[:, pi]), f"forward passes at N={N}, prime {p}"
        inv = _pass_ntt(fwd[:, pi], twi[pi], p, N, True)
        # ntt_inv scales by N^-1; the kernel does it in Garner
        scaled = ntt.mul_shoup(inv, int(tab.n_inv[pi]), int(tab.n_inv_sh[pi]), p)
        assert torch.equal(scaled, x[:, pi]), f"inverse passes at N={N}, prime {p}"


def _lanes(N):
    """The in-row offsets the 32 lanes of each warp touch at once (N >= 256:
    a warp's lanes stay in one row): every register pass of both directions
    (one word k of each thread's block), and runs of 32 consecutive
    words."""
    logn = N.bit_length() - 1
    tr = np.arange(N // 8)
    out = []
    for inverse in (False, True):
        s = 0
        for R in mb_pbs.pass_stages(N):
            lstr = s if inverse else logn - s - R
            for u in range(8 >> R):
                b = tr + u * (N // 8)
                j, i0 = b & ((1 << lstr) - 1), b >> lstr
                xb = (i0 << (s + R) if inverse else i0 << (logn - s)) + j
                for k in range(1 << R):
                    out.append(xb + (k << lstr))
            s += R
    out.append(np.arange(N))
    return [a.reshape(-1, 32) for a in out]


@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024, 2048])
def test_bank_swizzle_is_conflict_free(N):
    hx = mb_pbs.bank_swizzle(N).astype(np.int64)
    assert hx.shape == (N,) and hx.max() < 32
    phys = np.arange(N) ^ hx
    assert sorted(phys) == list(range(N))  # a permutation of the row
    if N < 256:  # a warp spans several rows: the tiny test sets only
        return
    for lanes in _lanes(N):
        banks = np.sort((lanes ^ hx[lanes]) % 32, axis=1)
        assert (np.diff(banks, axis=1) > 0).all(), f"a bank conflict at N={N}"


def _acc_words(acc, a, N):
    """AccQuarter's words: the bare accumulator [ng, kp1, N]."""
    return acc


def _rotdiff_words(acc, a, N):
    """RotDiffQuarter's words, with the kernel's index formula: word x of
    X^a acc - acc is acc[y] for y = (x - a) mod 2N, negated when y >= N
    (then acc[y - N]), minus acc[x]; a: the gates' mask elements [ng]."""
    y = (torch.arange(N)[None, :] - a[:, None]) & (2 * N - 1)  # [ng, N]
    neg = (y >= N)[:, None, :]
    rot = torch.gather(acc, 2, (y & (N - 1))[:, None, :].expand_as(acc))
    rot = torch.where(neg, (0 - rot) & ntt.M32, rot)
    return (rot - acc) & ntt.M32


def _garner(r4, tab):
    """Garner's epilogue on [.., NP, N/4] scaled residues."""
    return ntt.garner_to_u32(r4, tab)


def _crt_fold(r4, tab):
    """CrtFold's epilogue, in the kernel's arithmetic: the u32 wrapping sum
    of r_i W_i, s = sum_i r_i (W_i / P) in double precision in prime order,
    kq = floor(s + 0.5), sum - kq P mod 2^32."""
    c = ntt.crt_constants(tab.N)
    total = torch.zeros_like(r4[..., 0, :])
    s = torch.zeros(r4[..., 0, :].shape, dtype=torch.float64)
    for i in range(len(c.w_mod)):
        total = (total + r4[..., i, :] * c.w_mod[i]) & ntt.M32
        s = s + r4[..., i, :].to(torch.float64) * c.frac[i]
    kq = torch.floor(s + 0.5).to(torch.int64)
    return (total - kq * c.prod_mod) & ntt.M32


def _radix8(v, tw, p, inverse):
    """The 8-point stages of the four-step transform on axis -2 of v (int64,
    size 8) with the kernel's index formulas: forward as pbs_common.cuh
    fwd_radix<3>(v, stw, 0, 0, p), inverse as inv_radix<3>(v, stw + 8, 0,
    0, 3, p); tw: this prime's stage pairs [16, 2] (forward at 1..7,
    inverse at 9..15)."""
    v = [v[..., k, :] for k in range(8)]
    for r in range(3):
        if inverse:
            dist, h = 1 << r, 4 >> r
            for q in range(4 >> r):
                w = tw[8 + h + q]
                for kk in range(dist):
                    a = q * 2 * dist + kk
                    u, t = v[a], v[a + dist]
                    v[a] = ntt.add_mod(u, t, p)
                    v[a + dist] = ntt.mul_shoup(ntt.sub_mod(u, t, p), w[0], w[1], p)
        else:
            half = 4 >> r
            for q in range(1 << r):
                w = tw[(1 << r) + q]
                for kk in range(half):
                    a = q * 2 * half + kk
                    u, t = v[a], ntt.mul_shoup(v[a + half], w[0], w[1], p)
                    v[a], v[a + half] = ntt.add_mod(u, t, p), ntt.sub_mod(u, t, p)
    return torch.stack(v, dim=-2)


def _tc_product(x, w_win, rc, p, nl):
    """FourStepTC's N2-point product of rows x [.., N2] (residues mod p):
    the data's balanced limbs (nl of them) against the matrix's two window
    limbs w_win [2, N2, N2], limb pair by limb pair (float64 sums of int8
    products: exact) into the shifts acc_s, recombined in the kernel's
    arithmetic: off + sum_s (acc_s + 2^24) rc[s] with off = p 2^31 - 2^24
    sum_s rc[s], below 2^64, mod p."""
    a = ntt.split_limbs(ntt.balanced(x, p), nl)
    acc = [0] * (nl + 1)
    for la in range(nl):
        for lw in range(2):
            w = torch.from_numpy(w_win[lw].astype(np.float64))
            acc[la + lw] = acc[la + lw] + (a[la].to(torch.float64) @ w).to(torch.int64)
    rcs = [int(r) for r in rc[:nl + 1]]
    v = (p << 31) - (sum(rcs) << 24)
    for s, r in enumerate(rcs):
        assert int((acc[s] + (1 << 24)).min()) > 0 and int((acc[s] + (1 << 24)).max()) < 1 << 25
        v = v + (acc[s] + (1 << 24)) * r
    assert int(v.max()) < 1 << 63
    return torch.remainder(v, p)


def _four_step_fwd(f, pi, p, tk, win):
    """FourStepTC's forward transform of rows f [.., N] of prime pi: the
    8-point stages (the body's first register pass), the twist, the
    tensor-core product; out in the four-step frequency order."""
    N = f.shape[-1]
    v = _radix8(f.reshape(f.shape[:-1] + (8, N // 8)), tk.stw[pi].long(), p, False)
    tw = tk.twf[pi].long().reshape(8, N // 8, 2)
    v = ntt.mul_shoup(v, tw[..., 0], tw[..., 1], p)
    return _tc_product(v, win["w2_win"][pi], win["w2_rc"][pi], p, ntt.limb_count(p)).reshape(f.shape)


def _four_step_inv(s, pi, p, tk, win):
    """FourStepTC's inverse of rows s [.., N] (four-step order) of prime pi:
    the tensor-core product, the inverse twist, the inverse 8-point stages;
    natural order out, N^-1 folded into the twist and the matrix."""
    N = s.shape[-1]
    v = _tc_product(s.reshape(s.shape[:-1] + (8, N // 8)), win["w2i_win"][pi], win["w2i_rc"][pi], p,
                    ntt.limb_count(p))
    tw = tk.twi[pi].long().reshape(8, N // 8, 2)
    v = ntt.mul_shoup(v, tw[..., 0], tw[..., 1], p)
    return _radix8(v, tk.stw[pi].long(), p, True).reshape(s.shape)


def _ladder(a, f, pi, p, N):
    """The Ladder source's NTT(X^a)[f] (csrc/rotate_tiles.cuh): the Shoup
    product over the set bits b of a, lowest first, of T[b][f]
    (`pbs.monomial_tables`); a [ng], f [cf] -> [ng, cf]."""
    t, t_sh = (torch.from_numpy(x.astype(np.int64)) for x in pbs.monomial_tables(N))
    m = torch.ones((a.shape[0], f.shape[0]), dtype=torch.int64)
    for b in range(N.bit_length()):
        on = ((a >> b) & 1).bool()[:, None]
        m = torch.where(on, ntt.mul_shoup(m, t[b, pi, f], t_sh[b, pi, f], p), m)
    return m


def _model(dsk, lwe_in, testv, words=_acc_words, fold=_garner, transform="passes", mono="lookup"):
    """The kernel body's order of operations in plain torch: per tile of
    `tile_plan`, per step, per prime (the cluster's blocks) the
    decomposition of the tile's `words` (`_acc_words`: K1, K6, K4, K3;
    `_rotdiff_words`: K2), the forward transform, the products from the
    chunked BSK (sum over rows first, in u32 where fits_u32 holds, then
    the P_v scale where the words are the bare accumulator), the inverse
    transform; then the epilogue `fold` (`_garner`: K1, K2, K4, K3;
    `_crt_fold`: K6) per coefficient quarter. `transform`: "passes" (the
    register-pass NTTs; the epilogue scales by N^-1) or "four_step" (K4's
    FourStepTC: `_four_step_fwd` / `_four_step_inv`, the BSK and the
    monomials in the four-step frequency order); `mono`: "lookup" (the
    power table) or "ladder" (K3's bit ladder, `_ladder`)."""
    p = dsk.params
    key = mb_pbs.mb_server_key(dsk)
    tab = dsk.tab
    N, k, g, n = p.N, p.k, p.grouping, p.n
    kp1, rows, nv1 = k + 1, p.gadget_rows, (1 << g) - 1
    subsets = words is _acc_words
    four = transform == "four_step"
    kernel = "blind_rotate_ts" if four else "blind_rotate_gm" if mono == "ladder" else "blind_rotate_mb"
    G = lwe_in.shape[0]
    plan = mb_pbs.tile_plan(p, G, h100_slots, kernel)
    primes = [int(x) for x in tab.primes]
    narrow = mb_pbs._narrow(p)
    pw, ef = pbs.power_tables(N, "cpu")
    if four:
        tk, win = ts_pbs.ts_server_key(dsk), ntt.window_tables(N)
        chunks, ef = tk.bsk.to(torch.int64), tk.ef4.long()
    else:
        chunks = key.bsk_k1.to(torch.int64)  # [n/g, NP, N/cf, nv1, rows, kp1, cf]
        twf, twi = key.twf.to(torch.int64), key.twi.to(torch.int64)
    cf = key.chunk
    abar = ops.mod_switch(lwe_in[:, :n], N)
    acc_all = pbs.initial_acc(p, lwe_in, testv)
    out = torch.empty_like(acc_all)
    for t in range(plan.tiles):
        g0, g1 = t * plan.gt, min(G, (t + 1) * plan.gt)
        acc = acc_all[g0:g1].clone()  # [ng, kp1, N]
        for j in range(n // g):
            src = words(acc, abar[g0:g1, j], N)
            res = []
            for pi, q in enumerate(primes):
                # decomposition (fhe/ops.py signed_decompose), rows [rows, ng, N]
                f = torch.empty((rows, g1 - g0, N), dtype=torch.int64)
                for c, (bl, lv) in enumerate(p.component_gadgets):
                    row0 = c * p.component_gadgets[0][1]
                    total = bl * lv
                    r = (((src[:, c] >> (32 - total - 1)) + 1) >> 1) & ((1 << total) - 1)
                    for lvl in range(lv - 1, -1, -1):
                        d = r & ((1 << bl) - 1)
                        carry = (d >= (1 << (bl - 1))).to(torch.int64)
                        d = d - carry * (1 << bl)
                        r = (r >> bl) + carry
                        f[row0 + lvl] = torch.remainder(d, q)
                f = _four_step_fwd(f, pi, q, tk, win) if four else _pass_ntt(f, twf[pi], q, N, False)
                s = torch.empty((kp1, g1 - g0, N), dtype=torch.int64)
                e = ef[None, :]
                for ch in range(N // cf):
                    fs = slice(ch * cf, (ch + 1) * cf)
                    b = chunks[j, pi, ch]  # [nv1, rows, kp1, cf]
                    a_i = [abar[g0:g1, j * g + i] for i in range(g)]
                    if mono == "ladder":
                        d = [_ladder(a, torch.arange(N)[fs], pi, q, N) - 1 for a in a_i]
                    else:
                        d = [pw[pi][(a[:, None] * e[:, fs]) % (2 * N)] - 1 for a in a_i]
                    pv = [None]
                    for v in range(1, nv1 + 1):
                        lo = (v & -v).bit_length() - 1
                        pv.append(d[lo] if v == 1 << lo else (pv[v & (v - 1)] * d[lo]) % q)
                    for c in range(kp1):
                        acc_s = 0
                        for v in range(nv1):
                            tv = (f[:, :, fs] * b[v, :, c, None, :]).sum(dim=0)  # [ng, cf]
                            if narrow:
                                assert int(tv.max()) < 1 << 32
                            # K2 (no subsets): one product per row, reduced once
                            acc_s = acc_s + (pv[v + 1] * (tv % q) if subsets else tv)
                        if narrow:
                            assert int(acc_s.max()) < 1 << 32
                        s[c, :, fs] = acc_s % q
                if four:  # N^-1 is in the inverse twist and matrix
                    res.append(_four_step_inv(s, pi, q, tk, win))
                else:
                    s = _pass_ntt(s, twi[pi], q, N, True)
                    res.append(ntt.mul_shoup(s, int(tab.n_inv[pi]), int(tab.n_inv_sh[pi]), q))
            r4 = torch.stack(res, dim=-2)  # [kp1, ng, NP, N]
            for quarter in range(4):  # block `quarter` folds its coefficients
                cs = slice(quarter * N // 4, (quarter + 1) * N // 4)
                folded = fold(r4[..., cs], tab)  # [kp1, ng, N/4]
                acc[:, :, cs] = (acc[:, :, cs] + folded.permute(1, 0, 2)) & ntt.M32
        out[g0:g1] = acc
    return out


def _inputs(ck, G, seed, per_gate):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, G).astype(bool)
    x = ref_lwe.encrypt(ck, ref_lwe.encode_bool(bits))
    if per_gate:
        tv = rng.integers(0, 1 << 32, size=(G, ck.params.N), dtype=np.uint64).astype(np.uint32)
    else:
        tv = pbs_jnp.gates_test_poly(ck.params)
    return x, tv


@pytest.mark.parametrize("name,G,per_gate,jnp_too", [
    ("k3", 5, True, True), ("k3", 37, False, False), ("mb4", 5, False, False),
])
def test_model_matches_plain_and_jnp(keys, name, G, per_gate, jnp_too):
    """The model equals the plain version; and helm_tpu's jnp rotation at
    one shape (test_torch_pbs.py holds the plain version against it at the
    others; each new width would cost the jnp rotation a compilation)."""
    ck, jdsk, tdsk = keys[name]
    x, tv = _inputs(ck, G, 200 + G, per_gate)
    got = _model(tdsk, words(x), words(tv))
    plain = pbs.blind_rotate_multibit(tdsk, words(x), words(tv))
    assert torch.equal(got, plain)
    if jnp_too:
        ref = np.asarray(pbs_jnp.blind_rotate_multibit(jdsk, jnp.asarray(x), jnp.asarray(tv)))
        np.testing.assert_array_equal(to_host(got), ref)


@pytest.mark.parametrize("fold,name,G,per_gate,jnp_too", [
    ("crt", "k3", 5, True, True), ("crt", "mb4", 5, False, True), ("garner", "mb4", 3, True, False),
])
def test_fold_model_matches_prime_split_multibit_and_jnp(keys, fold, name, G, per_gate, jnp_too):
    """K6's order of operations (K1's, with the CRT fold per coefficient
    quarter) equals `pbs.blind_rotate_prime_split`, `pbs.blind_rotate_multibit`
    and helm_tpu's jnp rotation; and with Garner, K1's, at per-gate test
    polynomials at the grouping-4 set."""
    ck, jdsk, tdsk = keys[name]
    x, tv = _inputs(ck, G, 300 + G, per_gate)
    got = _model(tdsk, words(x), words(tv), fold=_crt_fold if fold == "crt" else _garner)
    assert torch.equal(got, pbs.blind_rotate_prime_split(tdsk, words(x), words(tv)))
    assert torch.equal(got, pbs.blind_rotate_multibit(tdsk, words(x), words(tv)))
    if jnp_too:
        ref = np.asarray(pbs_jnp.blind_rotate_multibit(jdsk, jnp.asarray(x), jnp.asarray(tv)))
        np.testing.assert_array_equal(to_host(got), ref)


@pytest.mark.parametrize("name,G,per_gate,jnp_too", [
    ("k3", 5, True, True), ("k3", 37, False, False), ("mb4", 3, True, True), ("n2048", 3, True, False),
])
def test_four_step_model_matches_transposed_multibit_and_jnp(keys, name, G, per_gate, jnp_too):
    """K4's order of operations (the body with FourStepTC: the 8-point
    stages as the first register pass, the twist, the limb products on the
    tensor cores in the four-step frequency order, the four-step chunked
    BSK and ef4 lookups, the products straight into limb planes, the
    inverse product, twist and stages, no N^-1 in Garner) equals
    `pbs.blind_rotate_transposed`, `pbs.blind_rotate_multibit` and
    helm_tpu's jnp rotation; N = 2048 takes p = 65537's scaled two-limb
    matrices."""
    ck, jdsk, tdsk = keys[name]
    x, tv = _inputs(ck, G, 600 + G, per_gate)
    got = _model(tdsk, words(x), words(tv), transform="four_step")
    assert torch.equal(got, pbs.blind_rotate_transposed(tdsk, words(x), words(tv)))
    assert torch.equal(got, pbs.blind_rotate_multibit(tdsk, words(x), words(tv)))
    if jnp_too:
        ref = np.asarray(pbs_jnp.blind_rotate_multibit(jdsk, jnp.asarray(x), jnp.asarray(tv)))
        np.testing.assert_array_equal(to_host(got), ref)


@pytest.mark.parametrize("name,G,per_gate,jnp_too", [
    ("k3", 5, True, True), ("mb4", 3, False, True), ("n2048", 3, True, False),
])
def test_ladder_model_matches_ladder_multibit_and_jnp(keys, name, G, per_gate, jnp_too):
    """K3's order of operations (the body with the Ladder source: NTT(X^a)
    as the Shoup product of T[b] over a's set bits, K1's chunked BSK)
    equals `pbs.blind_rotate_ladder`, `pbs.blind_rotate_multibit` and
    helm_tpu's jnp rotation."""
    ck, jdsk, tdsk = keys[name]
    x, tv = _inputs(ck, G, 700 + G, per_gate)
    got = _model(tdsk, words(x), words(tv), mono="ladder")
    assert torch.equal(got, pbs.blind_rotate_ladder(tdsk, words(x), words(tv)))
    assert torch.equal(got, pbs.blind_rotate_multibit(tdsk, words(x), words(tv)))
    if jnp_too:
        ref = np.asarray(pbs_jnp.blind_rotate_multibit(jdsk, jnp.asarray(x), jnp.asarray(tv)))
        np.testing.assert_array_equal(to_host(got), ref)


@pytest.mark.parametrize("name,G,per_gate,jnp_too", [
    ("g1", 5, False, True), ("g1", 37, True, False), ("lut", 5, True, True), ("k3_g1", 5, False, True),
])
def test_rotdiff_model_matches_blind_rotate_and_jnp(keys, name, G, per_gate, jnp_too):
    """K2's order of operations (the body at grouping 1 decomposing X^a acc -
    acc, one product per gadget row, Garner) equals `pbs.blind_rotate` and
    helm_tpu's jnp single-bit rotation (`pbs_jnp.blind_rotate`), at
    TEST_PARAMS (one tile and several), TEST_PARAMS_LUT with per-gate test
    polynomials and the k=3 grouping-1 set (the jnp rotation at one width
    each: each new width would cost it a compilation); and K1's order of
    operations (the bare accumulator, P_v after the products) computes
    other words there."""
    ck, jdsk, tdsk = keys[name]
    x, tv = _inputs(ck, G, 400 + G, per_gate)
    got = _model(tdsk, words(x), words(tv), words=_rotdiff_words)
    assert torch.equal(got, pbs.blind_rotate(tdsk, words(x), words(tv)))
    if jnp_too:
        ref = np.asarray(pbs_jnp.blind_rotate(jdsk, jnp.asarray(x), jnp.asarray(tv)))
        np.testing.assert_array_equal(to_host(got), ref)
    if name == "g1" and G == 5:
        assert not torch.equal(_model(tdsk, words(x), words(tv)), got)


@pytest.mark.parametrize("name", ["k3", "mb4", "g1"])
@pytest.mark.parametrize("off", [0, 16])
def test_cluster_slots_holds_the_plan_to_the_kernel(keys, monkeypatch, name, off):
    """`cluster_slots` asks the kernel that will launch (K1 for multi-bit
    keys by default, K2 at grouping 1) and passes it the BSK's element size
    (the kernel refuses one that its sums do not call for), and raises
    unless the kernel's shared memory for the tile is `smem_bytes`'s; the
    C entry point is stood in for here, with `off` bytes more than the
    plan."""
    _, _, dsk = keys[name]
    p, key = dsk.params, mb_pbs.mb_server_key(dsk)
    kernel = "blind_rotate_sb" if p.grouping == 1 else "blind_rotate_mb"
    seen = []

    def entry(name_, argtypes, symbol=None):
        assert (name_, symbol) == (kernel, f"helm_{kernel}_clusters")

        def call(*args):
            seen.append(args[11])
            args[12]._obj.value = 30
            args[13]._obj.value = mb_pbs.smem_bytes(p, args[9], args[10], kernel) + off
            return 0

        return call

    monkeypatch.setattr(mb_pbs.build, "entry", entry)
    monkeypatch.setattr(mb_pbs, "_slots", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    if off:
        with pytest.raises(RuntimeError, match="smem_bytes"):
            mb_pbs.cluster_slots(dsk, 1, kernel)
    else:
        assert mb_pbs.cluster_slots(dsk, 1, kernel) == 30
    assert seen == [key.bsk_k1.element_size()] and seen[0] == (2 if mb_pbs._narrow(p) else 4)


@pytest.mark.parametrize("kernel", ["blind_rotate_ts", "blind_rotate_gm"])
def test_cluster_slots_of_k4_and_k3(keys, monkeypatch, kernel):
    """`cluster_slots` asks K4's and K3's own C entries, holds them to
    `smem_bytes` of that kernel (K4's with its limb region, K3's with its
    monomials), and builds no chunked BSK copy to learn the element size."""
    _, _, dsk = keys["k3"]
    dsk = dataclasses.replace(dsk)  # a fresh key: nothing cached
    p, key = dsk.params, mb_pbs.mb_server_key(dsk)
    seen = []

    def entry(name_, argtypes, symbol=None):
        assert (name_, symbol) == (kernel, f"helm_{kernel}_clusters")

        def call(*args):
            seen.append(args[11])
            args[12]._obj.value = 29
            args[13]._obj.value = mb_pbs.smem_bytes(p, args[9], args[10], kernel)
            return 0

        return call

    monkeypatch.setattr(mb_pbs.build, "entry", entry)
    monkeypatch.setattr(mb_pbs, "_slots", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert mb_pbs.cluster_slots(dsk, 2, kernel) == 29
    assert seen == [2] and "bsk_k1" not in vars(key)
    assert mb_pbs.plan_for(dsk, 8, kernel).smem == mb_pbs.smem_bytes(p, 1, key.chunk, kernel)


def test_k1_phases_instruments_the_kernel():
    """tools/k1_phases finds each of its anchors in the kernel once, for K1
    and for K4 (it runs only on the card; this keeps its anchors in step
    with the source)."""
    from helm_tpu_torch.tools import k1_phases

    for kernel in ("mb", "ts"):
        src = k1_phases.instrumented_source(kernel)
        assert all(f"MARK_({i})" in src for i in range(7)) and "helm_k1_clocks" in src
        assert f"helm_blind_rotate_{kernel}_clusters" in src


@pytest.mark.parametrize("single_bit,name", [
    (False, "K1_BUILDS"), (True, "K2_BUILDS"), (False, "K4_BUILDS"), (False, "K3_BUILDS"),
], ids=["K1-K6", "K2", "K4", "K3"])
def test_every_multibit_set_has_a_k1_build(single_bit, name):
    """A build per (grouping, rows): K1 and K6, K4 and K3 for every
    multi-bit set, K2 for every grouping-1 set; and digits |d| <= B/2
    below the smallest prime (the kernels' floor-mod adds p once)."""
    builds = getattr(mb_pbs, name)
    sets = [p for p in vars(P).values() if isinstance(p, P.TfheParams) and (p.grouping == 1) == single_bit]
    assert sets
    for p in sets:
        assert (p.grouping, p.gadget_rows) in builds, p.name
        for bl, _ in p.component_gadgets:
            assert 1 << (bl - 1) < min(primes_for(p.N)), p.name


@pytest.mark.parametrize("builds,what,grouping,rows,change", [
    ("K1_BUILDS", "K6", 3, 4, dict(n=15)),
    ("K1_BUILDS", "K1", 2, 5, dict(pbs_mask_base_log=8, pbs_mask_level=3)),
    ("K2_BUILDS", "K2", 1, 9, dict(k=2, pbs_level=3)),
    ("K4_BUILDS", "K4", 3, 4, dict(n=15)),
    ("K3_BUILDS", "K3", 2, 5, dict(pbs_mask_base_log=8, pbs_mask_level=3)),
])
def test_check_build_refuses_a_shape_without_a_build(builds, what, grouping, rows, change):
    """The wrappers refuse, before any launch, a (grouping, rows) their
    kernel file has no template build for (grouping 3: no set has it)."""
    p = dataclasses.replace(P.TEST_PARAMS_MB, grouping=grouping, **change)
    assert p.gadget_rows == rows
    with pytest.raises(ValueError, match=f"{what} has no build for grouping {grouping} with {rows} gadget rows"):
        mb_pbs.check_build(p, getattr(mb_pbs, builds), what)
    mb_pbs.check_build(P.TEST_PARAMS_K3, mb_pbs.K1_BUILDS, what)


@pytest.mark.parametrize("name,selected,built", [
    ("k3", "ts", False), ("k3", "fs", True), ("k3", "ps", True), ("g1", "ts", True),
])
def test_kernel_layouts_build_the_chunked_bsk_only_for_its_readers(keys, monkeypatch, name, selected, built):
    """`kernel_layouts` builds the chunked BSK (`bsk_k1`) where the
    selection reads it (K1 under fs, K6 under ps, K2 for every grouping-1
    key) and leaves it unbuilt under ts (K4 reads the natural layout)."""
    monkeypatch.setenv("HELM_TPU_MB_KERNEL", selected)
    _, _, dsk = keys[name]
    dsk = dataclasses.replace(dsk)  # a fresh key: nothing cached
    mb_pbs.kernel_layouts(dsk)
    assert ("bsk_k1" in vars(mb_pbs.mb_server_key(dsk))) == built


def test_wrapper_refuses_what_the_kernel_cannot_take(keys):
    """Off the CPU K1 launches its kernel or raises (a meta tensor stands in
    for a device with no kernel), and the plan refuses a set whose one gate
    does not fit a block."""
    _, _, dsk = keys["k3"]
    x = torch.zeros((2, dsk.params.n + 1), dtype=torch.int64, device="meta")
    with pytest.raises(NotImplementedError, match="blind_rotate_mb"):
        mb_pbs.blind_rotate_mb(dsk, x, x)
    big = dataclasses.replace(P.TEST_PARAMS_K3, N=4096)
    with pytest.raises(ValueError, match="shared memory"):
        mb_pbs.tile_plan(big, 8, h100_slots)


def test_kernel_ab_compares_k1_sass(tmp_path, monkeypatch):
    """tools/kernel_ab's `sass` matches K1's instantiations by (grouping,
    rows, narrow) and counts differing instructions, encodings and
    addresses aside (nvcc and cuobjdump are stood in for here)."""
    from helm_tpu_torch.tools import kernel_ab

    def dump(reg):
        f = "\t\tFunction : _ZN12_GLOBAL__N_112rotate_tilesILi2ELi8ELb1ENS_10AccQuarterENS_6GarnerEEEv\n"
        return (f + "        /*0000*/   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */\n"
                f"        /*0010*/   IMAD {reg}, R2, 0x4, R7 ;   /* 0x0000000a00ff017b */\n")

    dumps = {"a": dump("R6"), "b": dump("R6")}

    def run(cmd, **kw):
        if cmd[0].endswith("cuobjdump"):
            return type("R", (), {"stdout": dumps[cmd[-1].rsplit("k1_", 1)[1][0]]})
        return None

    monkeypatch.setattr(kernel_ab.subprocess, "run", run)
    assert kernel_ab.compare_sass("A", "B", str(tmp_path))
    dumps["b"] = dump("R9")
    assert not kernel_ab.compare_sass("A", "B", str(tmp_path))
