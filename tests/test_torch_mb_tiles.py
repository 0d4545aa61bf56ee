"""K1's host-side plan and layouts, and a plain model of its order of
operations, against helm_tpu_torch's plain version and helm_tpu.

The CUDA kernel (`csrc/blind_rotate_mb.cu`) cannot run here; what it
reads can:
- `mb_pbs.tile_plan`: every tile fits the shared memory a block may take
  and the tiles cover every gate exactly once, at the sets and widths the
  kernel runs, and `cluster_slots` holds it to the kernel's own layout;
- `mb_pbs.tiled_bsk`: the chunked BSK layout inverts to `dsk.bsk_ntt`;
- `mb_pbs.twiddles_by_pass` and `pass_stages`: the register-pass NTTs,
  written here with the kernel's index formulas, equal `ntt.ntt_fwd` /
  `ntt.ntt_inv`;
- `mb_pbs.bank_swizzle`: a permutation of every row, and from N = 256 on
  no register pass or run of 32 consecutive words meets a bank twice;
- `_model`: the kernel's order of operations in plain torch (tile by tile,
  prime by prime: the decomposition, the pass NTTs, sum_r F_r BSK_v[r, c]
  before the P_v scale from the chunked layout in u32 where `fits_u32`
  holds, the inverse passes, Garner per coefficient quarter) equals
  `pbs.blind_rotate_multibit` and `pbs_jnp.blind_rotate_multibit` word
  for word.
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
from helm_tpu_torch.ops import mb_pbs

SETS = {"k3": (RP.TEST_PARAMS_K3, 51), "mb4": (RP.TEST_PARAMS_MB4, 52)}

#: the sets K1 runs (phase k1 of chip_smoke.py)
PLAN_SETS = [
    P.GATES_128_K3, P.LUT_128_K2, P.ARITH_128_MB2, P.TEST_PARAMS_K3, P.TEST_PARAMS_MB4,
    dataclasses.replace(P.TEST_PARAMS_K3, name="test_tiny_k3_n1024", N=1024),
    dataclasses.replace(P.TEST_PARAMS_MB, name="test_tiny_mb2_n2048", N=2048),
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


@pytest.mark.parametrize("name", ["k3", "mb4"])
def test_tiled_bsk_inverts(keys, name):
    _, _, dsk = keys[name]
    key = mb_pbs.mb_server_key(dsk)
    p = dsk.params
    assert key.bsk_k1.dtype == (torch.int16 if mb_pbs._narrow(p) else torch.int32)
    assert key.chunk == mb_pbs.chunk_freqs(p)
    assert torch.equal(_untiled(key.bsk_k1), dsk.bsk_ntt.to(torch.int32))


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


def _model(dsk, lwe_in, testv):
    """K1's order of operations in plain torch: per tile of `tile_plan`,
    per group, per prime (the cluster's blocks) the decomposition of the
    tile's accumulators, the forward pass NTTs, the products from the
    chunked BSK (sum over rows first, in u32 where fits_u32 holds, then the
    P_v scale), the inverse passes; then Garner per coefficient quarter."""
    p = dsk.params
    key = mb_pbs.mb_server_key(dsk)
    tab = dsk.tab
    N, k, g, n = p.N, p.k, p.grouping, p.n
    kp1, rows, nv1 = k + 1, p.gadget_rows, (1 << g) - 1
    G = lwe_in.shape[0]
    plan = mb_pbs.tile_plan(p, G, h100_slots)
    primes = [int(x) for x in tab.primes]
    narrow = mb_pbs._narrow(p)
    chunks = key.bsk_k1.to(torch.int64)  # [n/g, NP, N/cf, nv1, rows, kp1, cf]
    cf = key.chunk
    twf, twi = key.twf.to(torch.int64), key.twi.to(torch.int64)
    pw, ef = pbs.power_tables(N, "cpu")
    abar = ops.mod_switch(lwe_in[:, :n], N)
    acc_all = pbs.initial_acc(p, lwe_in, testv)
    out = torch.empty_like(acc_all)
    for t in range(plan.tiles):
        g0, g1 = t * plan.gt, min(G, (t + 1) * plan.gt)
        acc = acc_all[g0:g1].clone()  # [ng, kp1, N]
        for j in range(n // g):
            res = []
            for pi, q in enumerate(primes):
                # decomposition (fhe/ops.py signed_decompose), rows [rows, ng, N]
                f = torch.empty((rows, g1 - g0, N), dtype=torch.int64)
                for c, (bl, lv) in enumerate(p.component_gadgets):
                    row0 = c * p.component_gadgets[0][1]
                    total = bl * lv
                    r = (((acc[:, c] >> (32 - total - 1)) + 1) >> 1) & ((1 << total) - 1)
                    for lvl in range(lv - 1, -1, -1):
                        d = r & ((1 << bl) - 1)
                        carry = (d >= (1 << (bl - 1))).to(torch.int64)
                        d = d - carry * (1 << bl)
                        r = (r >> bl) + carry
                        f[row0 + lvl] = torch.remainder(d, q)
                f = _pass_ntt(f, twf[pi], q, N, False)
                s = torch.empty((kp1, g1 - g0, N), dtype=torch.int64)
                e = ef[None, :]
                for ch in range(N // cf):
                    fs = slice(ch * cf, (ch + 1) * cf)
                    b = chunks[j, pi, ch]  # [nv1, rows, kp1, cf]
                    d = [pw[pi][(abar[g0:g1, j * g + i, None] * e[:, fs]) % (2 * N)] - 1 for i in range(g)]
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
                            acc_s = acc_s + pv[v + 1] * (tv % q)
                        if narrow:
                            assert int(acc_s.max()) < 1 << 32
                        s[c, :, fs] = acc_s % q
                s = _pass_ntt(s, twi[pi], q, N, True)
                res.append(ntt.mul_shoup(s, int(tab.n_inv[pi]), int(tab.n_inv_sh[pi]), q))
            r4 = torch.stack(res, dim=-2)  # [kp1, ng, NP, N]
            for quarter in range(4):  # block `quarter` folds its coefficients
                cs = slice(quarter * N // 4, (quarter + 1) * N // 4)
                folded = ntt.garner_to_u32(r4[..., cs], tab)  # [kp1, ng, N/4]
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


@pytest.mark.parametrize("name", ["k3", "mb4"])
@pytest.mark.parametrize("off", [0, 16])
def test_cluster_slots_holds_the_plan_to_the_kernel(keys, monkeypatch, name, off):
    """`cluster_slots` passes the kernel the BSK's element size (the kernel
    refuses one that its sums do not call for) and raises unless the
    kernel's shared memory for the tile is `smem_bytes`'s; the C entry
    point is stood in for here, with `off` bytes more than the plan."""
    _, _, dsk = keys[name]
    p, key = dsk.params, mb_pbs.mb_server_key(dsk)
    seen = []

    def entry(name_, argtypes, symbol=None):
        assert (name_, symbol) == ("blind_rotate_mb", "helm_blind_rotate_mb_clusters")

        def call(*args):
            seen.append(args[11])
            args[12]._obj.value = 30
            args[13]._obj.value = mb_pbs.smem_bytes(p, args[9], args[10]) + off
            return 0

        return call

    monkeypatch.setattr(mb_pbs.build, "entry", entry)
    monkeypatch.setattr(mb_pbs, "_slots", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    if off:
        with pytest.raises(RuntimeError, match="smem_bytes"):
            mb_pbs.cluster_slots(dsk, 1)
    else:
        assert mb_pbs.cluster_slots(dsk, 1) == 30
    assert seen == [key.bsk_k1.element_size()] and seen[0] == (2 if mb_pbs._narrow(p) else 4)


def test_k1_phases_instruments_the_kernel():
    """tools/k1_phases finds each of its anchors in the kernel once (it
    runs only on the card; this keeps its anchors in step with the source)."""
    from helm_tpu_torch.tools import k1_phases

    src = k1_phases.instrumented_source()
    assert all(f"MARK_({i})" in src for i in range(7)) and "helm_k1_clocks" in src


def test_every_multibit_set_has_a_k1_build():
    """A build per (grouping, rows), and digits |d| <= B/2 below the
    smallest prime (the kernel's floor-mod adds p once)."""
    for p in vars(P).values():
        if isinstance(p, P.TfheParams) and p.grouping > 1:
            assert (p.grouping, p.gadget_rows) in mb_pbs.K1_BUILDS, p.name
            for bl, _ in p.component_gadgets:
                assert 1 << (bl - 1) < min(primes_for(p.N)), p.name


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
