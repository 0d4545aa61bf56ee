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
- `ts_pbs.ts_server_key` as a permutation of the BSK, the B-fragment
  packing of the limb matrices, and the wrapper's dispatch by device.
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
from helm_tpu_torch.ops import ts_pbs

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
    _, _, tdsk = keys["n2048"]
    p = tdsk.params
    key = ts_pbs.ts_server_key(tdsk)
    assert ts_pbs.ts_server_key(tdsk) is key  # cached per key
    nv1 = (1 << p.grouping) - 1
    bsk = tdsk.bsk_ntt  # [n/g, 2^g-1, rows, k+1, NP, N]
    assert tuple(key.bsk.shape) == (p.n // p.grouping, 4, nv1, p.gadget_rows, p.k + 1, p.N)
    assert key.bsk.is_contiguous()
    perm = torch.from_numpy(ntt.mxu_tables(p.N)["perm_from_std"])
    j, pi, v, r, c = 3, 3, 1, 2, 1
    assert torch.equal(key.bsk[j, pi, v, r, c], bsk[j, v, r, c, pi][perm])
    assert sorted(key.bsk[j, pi, v, r, c].tolist()) == sorted(bsk[j, v, r, c, pi].tolist())
    _, ef = pbs.power_tables(p.N, "cpu")
    assert torch.equal(key.ef4.long(), ef[perm])


@pytest.mark.parametrize("N", [64, 512, 2048])
def test_b_fragments_follow_the_mma_layout(N):
    """Unpacking the B fragments by the PTX ISA's m16n8k32 layout (lane
    (g, t) holds column 8 nt + g, rows 32 kk + 4t + (0..3) and + 16)
    gives back the limb matrices, zero-padded to a multiple of 32 rows."""
    t = ntt.mxu_tables(N)
    frag = ts_pbs.b_fragments(t["w2_limbs"])
    N2 = N // ntt.N1
    Kp = -(-N2 // 32) * 32
    assert frag.shape == (4, ntt.MAX_LIMBS, Kp // 32, N2 // 8, 32, 8)
    back = np.zeros((4, ntt.MAX_LIMBS, Kp, N2), np.int8)
    for lane in range(32):
        g, tq = lane >> 2, lane & 3
        for j in range(8):
            k = np.arange(Kp // 32)[:, None] * 32 + tq * 4 + (j & 3) + 16 * (j >= 4)
            n = np.arange(N2 // 8)[None, :] * 8 + g
            back[:, :, k, n] = frag[:, :, :, :, lane, j]
    np.testing.assert_array_equal(back[:, :, :N2], t["w2_limbs"])
    assert not back[:, :, N2:].any()


def test_transform_tables_constants():
    tables = ts_pbs.transform_tables(2048, "cpu")
    vals = list(tables["ts_consts"])
    t = ntt.mxu_tables(2048)
    blk = 4 * 3 * 8
    assert vals[:blk] == t["stage_tw"].ravel().tolist()
    assert vals[3 * blk:4 * blk] == t["istage_tw_sh"].ravel().tolist()
    assert vals[4 * blk:4 * blk + 4] == [2, 2, 2, 3]
    assert vals[4 * blk + 4 + 3 * 5:] == [pow(256, s, 65537) for s in range(5)]


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
