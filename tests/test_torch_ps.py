"""K6's plain version, the CRT fold and the multi-bit kernel selector of
helm_tpu_torch, against helm_tpu.

- `ntt.crt_fold` (the prime-split kernel's CRT partial-sum fold) against
  `helm_tpu.ops.mxu_pbs._crt_fast` (the TPU kernel's float32 fold) and
  against `garner_to_u32`, on the residues of random values inside the
  convolution bound and of +-conv_bound itself, for the three prime sets.
- `pbs.blind_rotate_prime_split` against `pbs.blind_rotate_multibit` and
  `pbs_jnp.blind_rotate_multibit`, word for word, at TEST_PARAMS_K3 and
  TEST_PARAMS_ARITH_MB (the same keys, carried across).
- `mb_pbs.mb_kernel` against `helm_tpu.ops.ts_pbs.mb_kernel` for every
  value of the environment variables, and the routing of `mb_pbs.bootstrap`
  (K1, K6, and K4 under "ts" and the legacy HELM_TPU_TS_KERNEL=1).
- `ps_pbs.crt_args`: the CRT fold's constants as K6's C entry takes them.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helm_tpu import params as RP
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe import pbs_jnp
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu.ops import mxu_pbs, ts_pbs
from helm_tpu_torch import params as P
from helm_tpu_torch.fhe import ntt, pbs
from helm_tpu_torch.fhe.modring import PRIMES, PRIMES_512, PRIMES_1024, get_tables, primes_for
from helm_tpu_torch.fhe.ntt import to_host, words
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.ops import mb_pbs, ps_pbs, sb_pbs
from helm_tpu_torch.ops import ts_pbs as ts_pbs_port
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

#: each prime set with a ring size that uses it
PRIME_SETS = {"PRIMES_512": (PRIMES_512, 512), "PRIMES_1024": (PRIMES_1024, 1024), "PRIMES": (PRIMES, 2048)}
SETS = {"k3": (RP.TEST_PARAMS_K3, 41), "arith_mb2": (RP.TEST_PARAMS_ARITH_MB, 42), "g1": (RP.TEST_PARAMS, 43)}


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


def _bound(primes) -> int:
    """The largest conv_bound of any parameter set whose ring uses `primes`."""
    return max(p.conv_bound() for p in P.ALL_PARAMS.values() if primes_for(p.N) == primes)


def _residues(xs, primes) -> np.ndarray:
    """[NP, M] residues of the signed integers xs."""
    return np.array([[x % p for x in xs] for p in primes], dtype=np.int64)


def _ref_crt_fast(res: np.ndarray, primes) -> np.ndarray:
    """The TPU kernel's fold, with its constants built as
    `blind_rotate_fs_ps` builds them (mxu_pbs.py:2477-2491)."""
    prod = int(np.prod([int(p) for p in primes], dtype=object))
    w_mod, fracs = [], []
    for p in primes:
        m = prod // p
        w = m * pow(m, -1, p)
        w_mod.append(w % (1 << 32))
        fracs.append(np.float32(w / prod))
    out = mxu_pbs._crt_fast(
        [jnp.asarray(r.astype(np.uint32)) for r in res], w_mod, fracs, prod % (1 << 32)
    )
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(PRIME_SETS))
def test_crt_fold_matches_crt_fast_and_garner(name):
    primes, N = PRIME_SETS[name]
    tab = get_tables(N)
    assert tuple(int(p) for p in tab.primes) == primes
    bound = _bound(primes)
    prod = int(np.prod([int(p) for p in primes], dtype=object))
    assert 2 * bound < prod
    rng = np.random.default_rng(len(name))
    xs = [bound, -bound, 0, 1, -1] + [int(v) for v in rng.integers(-bound, bound + 1, 3000, dtype=np.int64)]
    res = _residues(xs, primes)  # [NP, M]: the M samples on the ring axis
    exp = np.array([x % (1 << 32) for x in xs], dtype=np.uint32)
    got = to_host(ntt.crt_fold(torch.from_numpy(res), tab))
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(to_host(ntt.garner_to_u32(torch.from_numpy(res), tab)), exp)
    np.testing.assert_array_equal(_ref_crt_fast(res, primes), exp)


@pytest.mark.parametrize("name", sorted(PRIME_SETS))
def test_crt_constants_are_the_reference_ones(name):
    primes, N = PRIME_SETS[name]
    c = ntt.crt_constants(N)
    prod = int(np.prod([int(p) for p in primes], dtype=object))
    assert c.primes == primes and c.prod_mod == prod % (1 << 32)
    for i, p in enumerate(primes):
        m = prod // p
        w = m * pow(m, -1, p)
        assert c.w_mod[i] == w % (1 << 32)
        assert c.frac[i] == w / prod  # the float64 of the exact ratio


def _ctxts(ck, G, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, G).astype(bool)
    x = ref_lwe.encrypt(ck, ref_lwe.encode_bool(bits))
    tv = rng.integers(0, 1 << 32, size=(G, ck.params.N), dtype=np.uint64).astype(np.uint32)
    return x, tv


@pytest.mark.parametrize("name,G", [("k3", 5), ("arith_mb2", 4)])
def test_blind_rotate_prime_split_matches_multibit(keys, name, G):
    ck, jdsk, tdsk = keys[name]
    x, tv = _ctxts(ck, G, 300 + G)
    ref = np.asarray(pbs_jnp.blind_rotate_multibit(jdsk, jnp.asarray(x), jnp.asarray(tv)))
    got = to_host(pbs.blind_rotate_prime_split(tdsk, words(x), words(tv)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(to_host(pbs.blind_rotate_multibit(tdsk, words(x), words(tv))), ref)
    # K6's wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(to_host(ps_pbs.blind_rotate_ps(tdsk, words(x), words(tv))), ref)


ENVS = [
    {},
    *({"HELM_TPU_MB_KERNEL": k} for k in ("fs", "fs16", "ts", "hb", "hb2", "ps", "bogus")),
    {"HELM_TPU_TS_KERNEL": "1"},
    {"HELM_TPU_TS_KERNEL": "1", "HELM_TPU_MB_KERNEL": "ps"},
    {"HELM_TPU_TS_KERNEL": "0", "HELM_TPU_MB_KERNEL": "bogus"},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "unset")
def test_mb_kernel_matches_the_reference(monkeypatch, env):
    monkeypatch.delenv("HELM_TPU_MB_KERNEL", raising=False)
    monkeypatch.delenv("HELM_TPU_TS_KERNEL", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mb_pbs.mb_kernel() == ts_pbs.mb_kernel()
    assert mb_pbs.DEFAULT_MB_KERNEL == ts_pbs.DEFAULT_MB_KERNEL


ROUTES = [
    ("fs", "blind_rotate_mb"), ("fs16", "blind_rotate_mb"), ("hb", "blind_rotate_mb"),
    ("hb2", "blind_rotate_mb"), ("ps", "blind_rotate_ps"), ("ts", "blind_rotate_ts"),
]


# The ids are kept from before K4 was ported, when "ts" raised ("ts-None").
# That case now checks ts -> K4 (blind_rotate_ts), by name and under the
# legacy HELM_TPU_TS_KERNEL=1, and its bootstrap words.
@pytest.mark.parametrize("kernel,want", ROUTES, ids=[
    "fs-blind_rotate_mb", "fs16-blind_rotate_mb", "hb-blind_rotate_mb", "hb2-blind_rotate_mb",
    "ps-blind_rotate_ps", "ts-None",
])
def test_bootstrap_routing(keys, monkeypatch, kernel, want):
    """Each selection's blind rotation: "ts" is K4 (`ts_pbs.blind_rotate_ts`),
    by name and under the legacy HELM_TPU_TS_KERNEL=1, and its route through
    `mb_pbs.bootstrap` gives the reference's bootstrap words; grouping 1
    takes K2 whatever the selection."""
    monkeypatch.delenv("HELM_TPU_TS_KERNEL", raising=False)
    monkeypatch.setenv("HELM_TPU_MB_KERNEL", kernel)
    ck, jdsk, tdsk = keys["k3"]
    assert mb_pbs.blind_rotation(keys["g1"][2].params) is sb_pbs.blind_rotate_sb
    assert mb_pbs.blind_rotation(tdsk.params).__name__ == want
    if kernel == "ts":
        assert mb_pbs.blind_rotation(tdsk.params) is ts_pbs_port.blind_rotate_ts
        monkeypatch.delenv("HELM_TPU_MB_KERNEL")
        monkeypatch.setenv("HELM_TPU_TS_KERNEL", "1")
        assert mb_pbs.blind_rotation(tdsk.params) is ts_pbs_port.blind_rotate_ts
        x, _ = _ctxts(ck, 3, 9)
        tv = pbs.gates_test_poly(ck.params)
        ref = np.asarray(pbs_jnp.bootstrap(jdsk, jnp.asarray(x), jnp.asarray(tv)))
        np.testing.assert_array_equal(to_host(mb_pbs.bootstrap(tdsk, words(x), words(tv))), ref)


def test_bootstrap_words_under_ps(keys, monkeypatch):
    """K6's route through `mb_pbs.bootstrap` gives the reference's
    bootstrap words (K1's route: tests/test_torch_pbs.py)."""
    monkeypatch.setenv("HELM_TPU_MB_KERNEL", "ps")
    ck, jdsk, tdsk = keys["k3"]
    x, _ = _ctxts(ck, 3, 9)
    tv = pbs.gates_test_poly(ck.params)
    ref = np.asarray(pbs_jnp.bootstrap(jdsk, jnp.asarray(x), jnp.asarray(tv)))
    np.testing.assert_array_equal(to_host(mb_pbs.bootstrap(tdsk, words(x), words(tv))), ref)


@pytest.mark.parametrize("name", sorted(PRIME_SETS))
def test_crt_args_are_the_fold_constants(name):
    """K6 reads K1's key layout; its own arguments are the fold's W_i mod
    2^32 (u32) and W_i / P (f64), after the Garner constants."""
    _, N = PRIME_SETS[name]
    c = ntt.crt_constants(N)
    (tw, w), (tf, f) = ps_pbs.crt_args(N)
    assert tw._type_ is ctypes.c_uint32 and tf._type_ is ctypes.c_double
    assert list(w) == list(c.w_mod) and list(f) == list(c.frac)


def test_off_the_cpu_k6_launches_or_raises(keys):
    """Off the CPU the K6 wrapper launches its kernel or raises (a meta
    tensor stands in for a device with no kernel); grouping-1 keys are
    refused on any device."""
    _, _, tdsk = keys["k3"]
    x = torch.zeros((2, tdsk.params.n + 1), dtype=torch.int64, device="meta")
    with pytest.raises(NotImplementedError, match="blind_rotate_ps"):
        ps_pbs.blind_rotate_ps(tdsk, x, x)
    with pytest.raises(ValueError, match="grouping 1"):
        ps_pbs.blind_rotate_ps(keys["g1"][2], x, x)
