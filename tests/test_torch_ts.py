"""K4's plain version and its four-step transform, against helm_tpu.

- `ntt.mxu_tables` against `helm_tpu/ops/mxu_ntt.py` `mxu_tables`, and
  `ntt.ntt_fwd_four_step` / `ntt_inv_four_step` against `mxu_ntt.fwd_ref` /
  `inv_ref` and against `ntt.ntt_fwd` after `perm_from_std`, for the three
  prime sets.
- The signed 8-bit limb split the tensor-core products take, at +-p//2 of
  every prime and at +-32768 (p = 65537 needs three limbs).
- `pbs.blind_rotate_transposed` against `pbs_jnp.blind_rotate_multibit`,
  word for word, at TEST_PARAMS_K3 (ragged G=11, per-gate test
  polynomials), TEST_PARAMS_MB4 and a tiny N=2048 g=2 set (PRIMES).
- The two-limb window split of the N2-point matrices (`ntt.window_tables`:
  every entry of the scaled matrix in two signed 8-bit limbs, c = 3 for
  p = 65537 and 1 elsewhere), and K4's transforms in the kernel's
  arithmetic (the 8-point stages as a register pass, the twist, the limb
  products recombined with c^-1; `tests/test_torch_mb_tiles.py`
  `_four_step_fwd` / `_four_step_inv`) equal to `ntt_fwd_four_step` /
  `ntt_inv_four_step`.
- `ts_pbs.ts_server_key`: the chunked four-step BSK inverts to a
  permutation of the BSK; the B-fragment packing of the window limbs; the
  transform's constants; the wrapper's dispatch by device.
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
from helm_tpu.ops import mxu_ntt
from helm_tpu_torch import params as P
from helm_tpu_torch.fhe import ntt, pbs
from helm_tpu_torch.fhe.modring import PRIMES, PRIMES_512, PRIMES_1024, get_tables
from helm_tpu_torch.fhe.ntt import to_host, words
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.ops import mb_pbs, ts_pbs
from test_torch_mb_tiles import _four_step_fwd, _four_step_inv, _untiled
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

#: each prime set with a ring size that uses it
PRIME_SETS = {"PRIMES_512": (PRIMES_512, 512), "PRIMES_1024": (PRIMES_1024, 1024), "PRIMES": (PRIMES, 2048)}
N2048 = dataclasses.replace(RP.TEST_PARAMS_MB, name="test_tiny_mb2_n2048", N=2048)
SETS = {"k3": (RP.TEST_PARAMS_K3, 51), "mb4": (RP.TEST_PARAMS_MB4, 52), "n2048": (N2048, 53)}


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


@pytest.mark.parametrize("name", sorted(PRIME_SETS))
def test_four_step_tables_equal_the_reference(name):
    primes, N = PRIME_SETS[name]
    mine, ref = ntt.mxu_tables(N), mxu_ntt.mxu_tables(N)
    assert tuple(mine["primes"]) == primes
    for f in ("perm_from_std", "stage_tw", "stage_tw_sh", "istage_tw", "istage_tw_sh",
              "tw", "tw_sh", "twi", "twi_sh"):
        np.testing.assert_array_equal(mine[f], ref[f], err_msg=f)
    for f in ("w2", "w2i"):
        limbs = mine[f + "_limbs"].astype(np.int64)
        value = sum(limbs[:, i] * 256**i for i in range(ntt.MAX_LIMBS))
        ref_limbs = ref[f + "_limbs"].astype(np.int64)  # int16 pairs
        ref_value = ref_limbs[:, 0] + 256 * ref_limbs[:, 1]
        for pi, p in enumerate(primes):
            np.testing.assert_array_equal(value[pi] % p, ref_value[pi] % p, err_msg=f)
            np.testing.assert_array_equal(mine[f][pi], ref_value[pi] % p, err_msg=f)
            assert not limbs[pi, ntt.limb_count(p):].any()


@pytest.mark.parametrize("name", sorted(PRIME_SETS))
def test_four_step_transforms_equal_the_reference(name):
    primes, N = PRIME_SETS[name]
    tab = get_tables(N)
    rng = np.random.default_rng(N)
    x = np.stack([rng.integers(0, p, size=(3, N)) for p in primes], axis=1)  # [3, NP, N]
    # the boundary residues of the balanced split: 0, p//2, p//2 + 1, p - 1
    for pi, p in enumerate(primes):
        x[0, pi, :4] = (0, p // 2, p // 2 + 1, p - 1)
    xt = torch.from_numpy(x.astype(np.int64))
    fwd = ntt.ntt_fwd_four_step(xt, N).numpy()
    ref = np.stack([mxu_ntt.fwd_ref(x[:, pi].astype(np.uint32), pi, N) for pi in range(4)], axis=1)
    np.testing.assert_array_equal(fwd, ref)
    perm = ntt.mxu_tables(N)["perm_from_std"]
    np.testing.assert_array_equal(fwd, ntt.ntt_fwd(xt, tab).numpy()[..., perm])
    inv = ntt.ntt_inv_four_step(torch.from_numpy(fwd), N).numpy()
    ref_inv = np.stack([mxu_ntt.inv_ref(fwd[:, pi].astype(np.uint32), pi, N) for pi in range(4)], axis=1)
    np.testing.assert_array_equal(inv, ref_inv)
    np.testing.assert_array_equal(inv, x)


@pytest.mark.parametrize("name", sorted(PRIME_SETS))
def test_limb_split_holds_every_balanced_residue(name):
    """limb_count(p) signed 8-bit limbs hold [-(p//2), p//2] exactly, the
    ends included; two limbs cannot hold 32768, so p = 65537 takes three."""
    primes, _ = PRIME_SETS[name]
    for p in primes:
        nl = ntt.limb_count(p)
        b = torch.arange(-(p // 2), p // 2 + 1, dtype=torch.int64)
        assert torch.equal(ntt.balanced(torch.remainder(b, p), p), b)
        limbs = ntt.split_limbs(b, nl)
        assert all(int(x.min()) >= -128 and int(x.max()) <= 127 for x in limbs)
        assert torch.equal(sum(x * 256**i for i, x in enumerate(limbs)), b)
        assert nl == (3 if p == 65537 else 2)
    edge = torch.tensor([32768, -32768, 32639, -32896], dtype=torch.int64)
    three = ntt.split_limbs(edge, 3)
    assert torch.equal(sum(x * 256**i for i, x in enumerate(three)), edge)
    two = ntt.split_limbs(edge, 2)
    held = sum(x * 256**i for i, x in enumerate(two))
    assert held.tolist() == [-32768, -32768, 32639, -32896]  # 32768 is out of two limbs' reach


def _ctxts(ck, G, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, G).astype(bool)
    x = ref_lwe.encrypt(ck, ref_lwe.encode_bool(bits))
    tv = rng.integers(0, 1 << 32, size=(G, ck.params.N), dtype=np.uint64).astype(np.uint32)
    return x, tv


@pytest.mark.parametrize("name,G", [("k3", 11), ("mb4", 3), ("n2048", 4)])
def test_blind_rotate_transposed_matches_multibit(keys, name, G):
    ck, jdsk, tdsk = keys[name]
    x, tv = _ctxts(ck, G, 400 + G)
    ref = np.asarray(pbs_jnp.blind_rotate_multibit(jdsk, jnp.asarray(x), jnp.asarray(tv)))
    got = to_host(pbs.blind_rotate_transposed(tdsk, words(x), words(tv)))
    np.testing.assert_array_equal(got, ref)
    # K4's wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(to_host(ts_pbs.blind_rotate_ts(tdsk, words(x), words(tv))), ref)


def test_ts_server_key_is_a_permutation_of_the_bsk(keys):
    """K4's BSK is K1's chunked layout (`mb_pbs.tiled_bsk`: i16 where the
    sums fit u32) of the BSK in the four-step frequency order: untiled, each
    (group, subset, row, component, prime) slab is a permutation of the
    BSK's; at a g = 2 set (u16), a g = 4 set and N = 2048."""
    for name in ("k3", "mb4", "n2048"):
        _, _, tdsk = keys[name]
        p = tdsk.params
        key = ts_pbs.ts_server_key(tdsk)
        assert ts_pbs.ts_server_key(tdsk) is key  # cached per key
        nv1 = (1 << p.grouping) - 1
        bsk = tdsk.bsk_ntt  # [n/g, 2^g-1, rows, k+1, NP, N]
        chunk = mb_pbs.chunk_freqs(p)
        assert tuple(key.bsk.shape) == (p.n // p.grouping, 4, p.N // chunk, nv1, p.gadget_rows, p.k + 1, chunk)
        assert key.bsk.dtype == (torch.int16 if mb_pbs._narrow(p) else torch.int32) and key.bsk.is_contiguous()
        perm = torch.from_numpy(ntt.mxu_tables(p.N)["perm_from_std"])
        flat = _untiled(key.bsk)
        assert torch.equal(flat, bsk[..., perm].to(torch.int32))
        j, pi, v, r, c = 3, 3, nv1 - 1, 2, 1
        assert sorted(flat[j, v, r, c, pi].tolist()) == sorted(bsk[j, v, r, c, pi].tolist())
        _, ef = pbs.power_tables(p.N, "cpu")
        assert torch.equal(key.ef4.long(), ef[perm])


@pytest.mark.parametrize("N", [64, 512, 2048])
def test_b_fragments_follow_the_mma_layout(N):
    """Unpacking the B fragments by the PTX ISA's m16n8k32 layout (lane
    (g, t) holds column 8 nt + g, rows 32 kk + 4t + (0..3) and + 16)
    gives back the two window limbs of the matrices, zero-padded to a
    multiple of 32 rows; and those are what K4's key holds."""
    t = ntt.window_tables(N)
    frag = ts_pbs.b_fragments(t["w2_win"])
    N2 = N // ntt.N1
    Kp = -(-N2 // 32) * 32
    assert frag.shape == (4, 2, Kp // 32, N2 // 8, 32, 8)
    assert np.array_equal(ts_pbs.transform_tables(N, "cpu")["bfwd"].numpy(), frag)
    back = np.zeros((4, 2, Kp, N2), np.int8)
    for lane in range(32):
        g, tq = lane >> 2, lane & 3
        for j in range(8):
            k = np.arange(Kp // 32)[:, None] * 32 + tq * 4 + (j & 3) + 16 * (j >= 4)
            n = np.arange(N2 // 8)[None, :] * 8 + g
            back[:, :, k, n] = frag[:, :, :, :, lane, j]
    np.testing.assert_array_equal(back[:, :, :N2], t["w2_win"])
    assert not back[:, :, N2:].any()


def test_transform_tables_constants():
    """ts_consts per prime: the data's limbs, then 256^s c^-1 mod p of the
    forward and of the inverse matrix (c = 3 at 65537); the stage pairs
    are the standard transform's first three stages; the twists are
    mxu_tables' as (w, w_sh) pairs."""
    tables = ts_pbs.transform_tables(2048, "cpu")
    vals = tables["ts_consts"].long().numpy()
    assert vals.shape == (4, 9)
    t, tab = ntt.mxu_tables(2048), get_tables(2048)
    assert vals[:, 0].tolist() == [2, 2, 2, 3]
    assert tables["scale"] == ((1, 1), (1, 1), (1, 1), (3, 3))
    inv3 = pow(3, -1, 65537)
    assert vals[3, 1:5].tolist() == [pow(256, s, 65537) * inv3 % 65537 for s in range(4)]
    assert vals[0, 5:].tolist() == [pow(256, s, PRIMES[0]) for s in range(4)]
    stw = tables["stw"].long().numpy()
    assert (stw[:, 1:8, 0] == tab.psi_rev[:, 1:8]).all()
    assert (stw[:, 9:, 1] == tab.psi_inv_rev_sh[:, 1:8]).all()
    assert not stw[:, [0, 8]].any()
    twf = tables["twf"].long().numpy()
    assert (twf[..., 0] == t["tw"].reshape(4, -1)).all() and (twf[..., 1] == t["tw_sh"].reshape(4, -1)).all()


@pytest.mark.parametrize("N", [64, 512, 1024, 2048])
def test_window_split_takes_every_scaled_entry_in_two_limbs(N):
    """Two signed 8-bit limbs hold [-32896, 32639]: every residue of a
    prime below 65536 has a representative there, and of 65537 all but
    32640, which both of its matrices contain; scaled by c = 3 they have no
    such entry, and each matrix's two window limbs give back c w mod p."""
    t, w = ntt.mxu_tables(N), ntt.window_tables(N)
    for pi, p in enumerate(t["primes"]):
        for name in ("w2", "w2i"):
            c = int(w[name + "_scale"][pi])
            assert c == (3 if p == 65537 else 1)
            limbs = w[name + "_win"][pi].astype(np.int64)
            assert limbs.shape == (2, N // 8, N // 8)
            value = limbs[0] + 256 * limbs[1]
            assert value.min() >= ntt.WINDOW[0] and value.max() <= ntt.WINDOW[1]
            np.testing.assert_array_equal(value % p, t[name][pi] * c % p)
            if p == 65537:
                assert (t[name][pi] == 32640).any()  # no two-limb form unscaled
                with pytest.raises(AssertionError, match="no two-limb"):
                    ntt.window(t[name][pi], p)
    assert ntt.matrix_scale(np.array([32640]), 65537) == 2
    assert ntt.matrix_scale(np.array([32640, 16320]), 65537) == 3


@pytest.mark.parametrize("N", [64, 512, 1024, 2048])
def test_kernel_four_step_equals_the_plain_transforms(N):
    """K4's transforms in the kernel's order and arithmetic (the body's
    first register pass as the 8-point stages, the twist, the data's
    balanced limbs against the matrices' window limbs, recombined with
    256^s c^-1; the inverse twist and stages) equal ntt_fwd_four_step and
    ntt_inv_four_step, boundary residues of the balanced split included."""
    primes = ntt.mxu_tables(N)["primes"]
    rng = np.random.default_rng(N + 1)
    x = np.stack([rng.integers(0, p, size=(3, N)) for p in primes], axis=1)  # [3, NP, N]
    for pi, p in enumerate(primes):
        x[0, pi, :4] = (0, p // 2, p // 2 + 1, p - 1)
    xt = torch.from_numpy(x.astype(np.int64))
    key = ts_pbs.transform_tables(N, "cpu")
    tk = type("T", (), {k: key[k] for k in ("twf", "twi", "stw")})
    win = ntt.window_tables(N)
    fwd = torch.stack([_four_step_fwd(xt[:, pi], pi, p, tk, win) for pi, p in enumerate(primes)], dim=1)
    assert torch.equal(fwd, ntt.ntt_fwd_four_step(xt, N))
    inv = torch.stack([_four_step_inv(fwd[:, pi], pi, p, tk, win) for pi, p in enumerate(primes)], dim=1)
    assert torch.equal(inv, ntt.ntt_inv_four_step(fwd, N)) and torch.equal(inv, xt)


def test_off_the_cpu_k4_launches_or_raises(keys):
    """Off the CPU the K4 wrapper launches its kernel or raises (a meta
    tensor stands in for a device with no kernel); grouping-1 keys are
    refused on any device."""
    _, _, tdsk = keys["k3"]
    x = torch.zeros((2, tdsk.params.n + 1), dtype=torch.int64, device="meta")
    with pytest.raises(NotImplementedError, match="blind_rotate_ts"):
        ts_pbs.blind_rotate_ts(tdsk, x, x)
    with pytest.raises(NotImplementedError, match="four_step_kernel"):
        ts_pbs.four_step_kernel(tdsk, x)
    g1 = dataclasses.replace(tdsk, params=P.TEST_PARAMS)
    with pytest.raises(ValueError, match="grouping 1"):
        ts_pbs.blind_rotate_ts(g1, x, x)
