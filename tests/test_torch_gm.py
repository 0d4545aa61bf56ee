"""K3's plain version and the multi-bit sweep of helm_tpu_torch, against
helm_tpu.

- `pbs.monomial_tables` against `pbs_jnp.monomial_tables`, and the bit
  ladder `pbs.monomial_ntt` against the direct lookup NTT(X^a)[f] =
  psi^(a e_f) that K1 uses.
- `pbs.blind_rotate_ladder` against `pbs_jnp.blind_rotate_multibit`, word
  for word, at TEST_PARAMS_K3 (g=2, per-gate test polynomials) and
  TEST_PARAMS_MB4 (g=4).
- `gm_pbs.gm_server_key` (the ladder's tables alone) and the wrapper's
  dispatch by device. The kernel's order of operations with the Ladder
  source is held against `blind_rotate_ladder` in
  `tests/test_torch_mb_tiles.py`.
- `helm_tpu_torch.tools.mb_sweep`: the environment knobs and arguments of
  `tools/mb_sweep.py`, a CPU sweep with its key cache, and the refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helm_tpu import params as RP
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe import pbs_jnp
from helm_tpu.fhe.server_key import gen_server_key as ref_gen_server_key
from helm_tpu_torch.fhe import pbs
from helm_tpu_torch.fhe.ntt import to_host, words
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.ops import gm_pbs, mb_pbs, ps_pbs, ts_pbs
from helm_tpu_torch.tools import mb_sweep
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

SETS = {"k3": (RP.TEST_PARAMS_K3, 61), "mb4": (RP.TEST_PARAMS_MB4, 62)}


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


@pytest.mark.parametrize("N", [64, 512, 2048])
def test_monomial_tables_equal_the_reference(N):
    mine, ref = pbs.monomial_tables(N), pbs_jnp.monomial_tables(N)
    np.testing.assert_array_equal(mine[0], ref[0])
    np.testing.assert_array_equal(mine[1], ref[1])


@pytest.mark.parametrize("N", [64, 2048])
def test_bit_ladder_equals_the_direct_lookup(N):
    a = torch.tensor([0, 1, 2, N - 1, N, N + 1, 2 * N - 1, 777 % (2 * N)])
    pw, ef = pbs.power_tables(N, "cpu")
    direct = pw[:, (a[:, None] * ef[None, :]) & (2 * N - 1)].permute(1, 0, 2)
    assert torch.equal(pbs.monomial_ntt(a, N), direct)


def _ctxts(ck, G, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, G).astype(bool)
    x = ref_lwe.encrypt(ck, ref_lwe.encode_bool(bits))
    tv = rng.integers(0, 1 << 32, size=(G, ck.params.N), dtype=np.uint64).astype(np.uint32)
    return x, tv


@pytest.mark.parametrize("name,G", [("k3", 6), ("mb4", 3)])
def test_blind_rotate_ladder_matches_multibit(keys, name, G):
    ck, jdsk, tdsk = keys[name]
    x, tv = _ctxts(ck, G, 500 + G)
    ref = np.asarray(pbs_jnp.blind_rotate_multibit(jdsk, jnp.asarray(x), jnp.asarray(tv)))
    got = to_host(pbs.blind_rotate_ladder(tdsk, words(x), words(tv)))
    np.testing.assert_array_equal(got, ref)
    # K3's wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(to_host(gm_pbs.blind_rotate_gm(tdsk, words(x), words(tv))), ref)


def test_gm_server_key(keys):
    """K3's key holds the ladder's tables and nothing BSK-sized: it reads
    K1's chunked BSK (`mb_server_key(dsk).bsk_k1`), and the TPU kernel's
    Shoup companion of the BSK is gone."""
    _, _, tdsk = keys["k3"]
    key = gm_pbs.gm_server_key(tdsk)
    assert gm_pbs.gm_server_key(tdsk) is key  # cached per key
    assert sorted(vars(key)) == ["mono", "mono_sh"]
    mono, mono_sh = pbs.monomial_tables(tdsk.params.N)
    assert torch.equal(key.mono.long(), torch.from_numpy(mono.astype(np.int64)))
    assert torch.equal(key.mono_sh.long(), torch.from_numpy(mono_sh.astype(np.int64)))


def test_off_the_cpu_k3_launches_or_raises(keys):
    """Off the CPU the K3 wrapper launches its kernel or raises (a meta
    tensor stands in for a device with no kernel); grouping-1 keys are
    refused on any device."""
    import dataclasses

    from helm_tpu_torch import params as P

    _, _, tdsk = keys["k3"]
    x = torch.zeros((2, tdsk.params.n + 1), dtype=torch.int64, device="meta")
    with pytest.raises(NotImplementedError, match="blind_rotate_gm"):
        gm_pbs.blind_rotate_gm(tdsk, x, x)
    with pytest.raises(ValueError, match="grouping 1"):
        gm_pbs.blind_rotate_gm(dataclasses.replace(tdsk, params=P.TEST_PARAMS), x, x)


@pytest.mark.parametrize("layout,want", [
    ("fs", mb_pbs.blind_rotate_mb), ("fs16", mb_pbs.blind_rotate_mb), ("hb", mb_pbs.blind_rotate_mb),
    ("hb2", mb_pbs.blind_rotate_mb), ("ps", ps_pbs.blind_rotate_ps), ("ts", ts_pbs.blind_rotate_ts),
    ("gm", gm_pbs.blind_rotate_gm),
])
def test_mb_sweep_layouts(layout, want):
    assert mb_sweep.rotation(layout) is want


def test_mb_sweep_runs_on_the_cpu_with_its_key_cache(tmp_path, capsys, monkeypatch):
    """The default LAYOUT is gm (K3), GTS values are printed and ignored,
    keys are cached in the npz format and loaded on the second run; the
    rotations agree with K1's plain version."""
    env = {"PSET": "TEST_PARAMS_MB", "G": "3", "GTS": "8,16"}
    monkeypatch.setattr(mb_sweep, "ITERS", 1)
    argv = ["--device", "cpu", "--keys", str(tmp_path)]
    assert mb_sweep.main(argv, env) == 0
    assert sorted(f.name for f in tmp_path.iterdir()) == ["ck_test_tiny_mb2.npz", "sk_test_tiny_mb2.npz"]
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "gm gt=8 (ignored", "gm gt=16 (ignored",
    ]
    assert all(" rot/s (first call " in ln for ln in lines)
    assert mb_sweep.main(argv, {**env, "LAYOUT": "ts", "GTS": "4"}) == 0
    assert capsys.readouterr().out.startswith("ts gt=4 ")
    from helm_tpu_torch.fhe.keys import load_client_key, load_server_key

    ck = load_client_key(str(tmp_path / "ck_test_tiny_mb2.npz"))
    dsk = pbs.DeviceServerKey.from_host(load_server_key(str(tmp_path / "sk_test_tiny_mb2.npz")), "cpu")
    x, tv = mb_sweep.inputs(ck, 3, "cpu")
    assert torch.equal(gm_pbs.blind_rotate_gm(dsk, x, tv), pbs.blind_rotate_multibit(dsk, x, tv))


@pytest.mark.parametrize("env,what", [
    ({"ABLATES": ":noladder"}, "What the port leaves out"),
    ({"PSET": "NO_SUCH_SET"}, "names no parameter set"),
    ({"PSET": "TEST_PARAMS_MB", "LAYOUT": "mxu"}, "LAYOUT='mxu'"),
])
def test_mb_sweep_refusals(tmp_path, env, what):
    with pytest.raises(SystemExit, match=what):
        mb_sweep.main(["--device", "cpu", "--keys", str(tmp_path)], env)
    assert not list(tmp_path.iterdir())  # refused before keygen


def test_mb_sweep_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mb_sweep.main(["--keys", str(tmp_path)], {"PSET": "TEST_PARAMS_MB"})
