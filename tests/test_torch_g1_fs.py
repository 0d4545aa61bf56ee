"""K1 at grouping 1 and the port of `tools/g1_fs_test.py`, on the CPU.

K1's CUDA kernel (`csrc/blind_rotate_mb.cu`, builds (1, 4), (1, 6),
(1, 8)) cannot run here; its plain version and what the kernel reads can:
- the port's `gen_bsk_multibit` at g = 1 equals the reference's for the
  same seed, and holds the same GGSW(s_i) as the single-bit `gen_bsk`;
- `mb_pbs.blind_rotate_mb` on the CPU at the tiny k=3 set at g = 1 (8
  gadget rows) and at TEST_PARAMS (4 rows), G = 8, equals the reference's
  `jax.jit(pbs_jnp.blind_rotate_multibit)` word for word (the reference's
  own tool showed that `blind_rotate_fs_mb(interpret=True)` equals that
  function at this set; its 53-s interpret-mode compile is not run here);
- the tool's CPU path decrypts the AND table; production routing still
  sends grouping 1 to K2; K1's shared memory counts the power table at
  g = 1 and K2's does not; K6, K4 and K3 still refuse grouping 1, and a
  CUDA-less device makes K1 raise at g = 1, never fall back.
"""

import contextlib
import dataclasses
import io
import re

import jax
import numpy as np
import pytest
import torch

from helm_tpu import params as RP
from helm_tpu.fhe import lwe as ref_lwe
from helm_tpu.fhe import pbs_jnp
from helm_tpu.fhe import server_key as ref_server_key
from helm_tpu_torch import params as P
from helm_tpu_torch.fhe import lwe, pbs, server_key
from helm_tpu_torch.fhe.ntt import to_host, words
from helm_tpu_torch.fhe.server_key import server_key_from_reference
from helm_tpu_torch.ops import build, mb_pbs, sb_pbs
from helm_tpu_torch.tools import g1_fs_test
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

#: the reference's g1_fs_test set on the CPU, and TEST_PARAMS (already g = 1)
RK3_G1 = dataclasses.replace(RP.TEST_PARAMS_K3, name="test_tiny_k3_g1", grouping=1)
SETS = {"k3_g1": (RK3_G1, 61), "test_params": (RP.TEST_PARAMS, 62)}


@pytest.fixture(scope="module")
def keys():
    """(reference client key, jnp device key, port device key) per set, on
    the reference's gen_bsk_multibit key at g = 1, made once."""
    out = {}
    for name, (p, seed) in SETS.items():
        ck = ref_lwe.keygen(p, seed)
        bsk, sh = ref_server_key.gen_bsk_multibit(ck)
        sk = ref_server_key.ServerKey(p, bsk, sh, ref_server_key.gen_ksk(ck))
        out[name] = (ck, pbs_jnp.DeviceServerKey.from_host(sk),
                     pbs.DeviceServerKey.from_host(server_key_from_reference(sk), "cpu"))
    return out


def test_gen_bsk_multibit_at_g1_equals_reference():
    """The port's grouped key at g = 1 from the same seed: the reference's
    [n, 1, rows, k+1, NP, N] words and Shoup companions, and the words of
    the single-bit gen_bsk, reshaped."""
    p = g1_fs_test.g1_params(cpu=True)
    assert p == P.from_reference(RK3_G1)
    ref = ref_server_key.gen_bsk_multibit(ref_lwe.keygen(RK3_G1, 5))
    got = server_key.gen_bsk_multibit(lwe.keygen(p, 5), device="cpu")
    single = server_key.gen_bsk(lwe.keygen(p, 5), device="cpu")
    for a, b, c in zip(got, ref, single):
        assert a.shape == b.shape == (p.n, 1, p.gadget_rows, p.k + 1, 4, p.N)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a.reshape(c.shape), c)


@pytest.mark.parametrize("name", list(SETS))
def test_k1_at_g1_equals_jnp_multibit(keys, name):
    """K1's wrapper on the CPU at grouping 1 (its plain version) equals the
    reference's jnp multi-bit rotation word for word, G = 8."""
    ck, jdsk, tdsk = keys[name]
    p = tdsk.params
    assert p.grouping == 1 and (1, p.gadget_rows) in mb_pbs.K1_BUILDS
    rng = np.random.default_rng(7)
    lin = rng.integers(0, 1 << 32, size=(8, p.n + 1), dtype=np.uint64).astype(np.uint32)
    tv = pbs.gates_test_poly(p)
    want = np.asarray(jax.jit(pbs_jnp.blind_rotate_multibit)(jdsk, lin, tv))
    got = mb_pbs.blind_rotate_mb(tdsk, words(lin, "cpu"), words(tv, "cpu"))
    np.testing.assert_array_equal(to_host(got), want)
    # the single-bit key's layout (gen_bsk) gives the same words
    flat = dataclasses.replace(tdsk, bsk_ntt=tdsk.bsk_ntt[:, 0], bsk_ntt_sh=tdsk.bsk_ntt_sh[:, 0])
    assert torch.equal(mb_pbs.blind_rotate_mb(flat, words(lin, "cpu"), words(tv, "cpu")), got)


def test_tool_cpu_path_decrypts_the_and_table():
    """`python -m helm_tpu_torch.tools.g1_fs_test --device cpu`: the
    reference's INTERP=1 lines, the AND table decrypted."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert g1_fs_test.main(["--device", "cpu"], env={}) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == "params: test_tiny_k3_g1 n=16 k=3 N=64 l=2 g=1"
    assert re.fullmatch(r"keygen [\d.]+s", lines[1]) and re.fullmatch(r"compile\+first [\d.]+s", lines[2])
    assert lines[3:] == ["decrypt-verified ok"]


def test_tool_refuses_a_wrong_rotation():
    """The tool's check fails on words that do not decrypt to the table."""
    p = g1_fs_test.g1_params(cpu=True)
    ck = lwe.keygen(p, 7)
    with pytest.raises(AssertionError, match="rotation WRONG"):
        g1_fs_test.check_ands(ck, torch.zeros((8, p.k + 1, p.N), dtype=torch.int64), "g=1 fs")


def test_production_routing_sends_g1_to_k2():
    """`blind_rotation` (the bootstrap's choice) still takes K2 at grouping 1,
    whatever HELM_TPU_MB_KERNEL says, as the reference's bootstrap_mxu."""
    for p in (P.TEST_PARAMS, P.GATES_TPU, g1_fs_test.g1_params(cpu=False)):
        assert mb_pbs.blind_rotation(p) is sb_pbs.blind_rotate_sb
    assert mb_pbs.blind_rotation(P.GATES_128_K3) is mb_pbs.blind_rotate_mb


@pytest.mark.parametrize("p", [P.TEST_PARAMS, P.GATES_TPU, g1_fs_test.g1_params(cpu=False)],
                         ids=lambda p: p.name)
def test_shared_memory_counts_the_power_table_for_k1_only(p):
    """At g = 1 K1's word source scales by P_1, so its layout stages the
    power table [2N] u32 (csrc/rotate_tiles.cuh SmemLayout on Src::kSubsets);
    K2's does not. tile_plan sizes each kernel by its own layout."""
    chunk = mb_pbs.chunk_freqs(p)
    for gt in (1, 2, 4, 8):
        k1 = mb_pbs.smem_bytes(p, gt, chunk, "blind_rotate_mb")
        assert k1 - mb_pbs.smem_bytes(p, gt, chunk, "blind_rotate_sb") == 2 * p.N * 4
    for kernel in ("blind_rotate_mb", "blind_rotate_sb"):
        plan = mb_pbs.tile_plan(p, 1024, lambda gt: 30, kernel)
        assert plan.smem == mb_pbs.smem_bytes(p, plan.gt, chunk, kernel) <= mb_pbs.SMEM_LIMIT


@pytest.mark.parametrize("builds,what", [("K6_BUILDS", "K6"), ("K4_BUILDS", "K4"), ("K3_BUILDS", "K3")])
def test_check_build_refuses_g1_for_k6_k4_k3(builds, what):
    """K1 has grouping-1 builds; K6, K4 and K3 keep theirs, all multi-bit."""
    for rows, base in ((4, P.TEST_PARAMS), (8, g1_fs_test.g1_params(cpu=False))):
        assert base.gadget_rows == rows
        mb_pbs.check_build(base, mb_pbs.K1_BUILDS, "K1")
        with pytest.raises(ValueError, match=f"{what} has no build for grouping 1 with {rows} gadget rows"):
            mb_pbs.check_build(base, getattr(mb_pbs, builds), what)
    assert getattr(mb_pbs, builds) == mb_pbs.K1_BUILDS - {(1, 4), (1, 6), (1, 8)}


@pytest.mark.parametrize("source,builds", [("blind_rotate_mb", "K1_BUILDS"), ("blind_rotate_ps", "K6_BUILDS")])
def test_build_sets_are_the_files_select_kernel(source, builds):
    """The (grouping, rows) a kernel file's select_kernel builds are the
    build set its wrapper checks."""
    text = (build.CSRC / f"{source}.cu").read_text()
    found = {(int(g), int(r)) for g, r in re.findall(r"S\.g == (\d) && S\.rows == (\d+)", text)}
    assert found == getattr(mb_pbs, builds)


def test_k1_at_g1_off_the_cpu_launches_or_raises(keys):
    """Off the CPU K1 takes a grouping-1 key to its kernel or raises (a
    meta tensor stands in for a device with no kernel): no fallback."""
    _, _, tdsk = keys["k3_g1"]
    x = torch.zeros((2, tdsk.params.n + 1), dtype=torch.int64, device="meta")
    with pytest.raises(NotImplementedError, match="blind_rotate_mb"):
        mb_pbs.blind_rotate_mb(tdsk, x, x)
