"""The plain versions of K7-K10 (helm_tpu_torch/ops/probes.py) against the
JAX package's Pallas probes in interpret mode, and the four probe tools
on the CPU.

The same inputs, made with numpy from the probes' own seeds, go through
the reference's kernel under `pl.pallas_call(interpret=True)` and through
the port's wrapper on CPU tensors (its plain version). Tolerance 0
everywhere: every operand is an integer, every multiply and add rounds
once in the same order on both sides, and in K10's C every partial sum
of the bf16 products stays below 2^24 (|limb| <= 164, 512 terms). The
accumulators of K8/K9 pass 2^24 and round, in the same order on both
sides, so their words agree too. The reference's tools are loaded from
their paths (tools/ is not a package); K10 runs at the loaded module's
STEPS set to 2, K8/K9 at 2 steps. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py phase `probes`.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from helm_tpu.ops.mxu_pbs import _expand8
from helm_tpu_torch.ops import probes
from helm_tpu_torch.tools import expand8_probe, liveset_harness, ptw_probe, splat_repro

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: many small plain-version ops run slower on a
    pool of threads beside the other test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_splat():
    return _tool("mosaic_splat_repro")


@pytest.fixture(scope="module")
def ref_liveset():
    return _tool("liveset_harness")


@pytest.fixture(scope="module")
def ref_ptw():
    mod = _tool("ptw_probe")
    mod.STEPS = STEPS  # its kernels end at program_id == STEPS - 1
    return mod


def _cols(steps, seed=7):
    rng = np.random.default_rng(seed)
    return rng, rng.integers(-16384, 16384, (steps, 64, 96)).astype(np.float32)


def test_expand8_equals_reference_and_tile():
    x, e8 = expand8_probe.inputs()

    def kernel(x_ref, e_ref, o_ref):
        o_ref[...] = _expand8(x_ref[...], e_ref[:, :128])

    ref = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((6144, 128), jnp.uint32), interpret=True,
    )(jnp.asarray(x), jnp.asarray(e8)))
    got = probes.expand8(torch.from_numpy(x.astype(np.int32)), torch.from_numpy(np.ascontiguousarray(e8[:, :128])))
    assert got.dtype == torch.int32 and got.shape == (6144, 128)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)
    np.testing.assert_array_equal(ref, np.tile(x, (1, 16)))


def test_expand8_general_weights_in_order():
    """A non-one-hot e8: the plain version sums over j in order, in f32."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 16, (5, 8)).astype(np.int32)
    e8 = rng.integers(-3, 4, (8, 16)).astype(np.float32)
    got = probes.expand8(torch.from_numpy(x), torch.from_numpy(e8)).numpy()
    lo, hi = (x & 255).astype(np.int64), (x >> 8).astype(np.int64)
    np.testing.assert_array_equal(got, lo @ e8.astype(np.int64) + ((hi @ e8.astype(np.int64)) << 8))


@pytest.mark.parametrize("variant", probes.SPLAT_VARIANTS)
def test_splat_equals_reference(ref_splat, variant):
    _, cols = _cols(STEPS)
    rows = np.random.default_rng(8).integers(-128, 129, (2, 64, 512)).astype(np.float32)
    c = cols.astype(np.int16) if variant == "i16" else cols
    ref = np.asarray(ref_splat.run(jnp.asarray(c), jnp.asarray(rows), variant, STEPS, True))
    got = probes.splat(torch.from_numpy(c), torch.from_numpy(rows), variant)
    assert got.shape == (1, 64, 512)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("variant", probes.LIVESET_VARIANTS)
@pytest.mark.parametrize("R,A", [(1, 1), (2, 4), (8, 12)])
def test_liveset_equals_reference(ref_liveset, R, A, variant):
    rng, cols = _cols(STEPS)
    rows = rng.integers(-128, 129, (2 * R, 64, 512)).astype(np.float32)
    ref = np.asarray(ref_liveset.run(jnp.asarray(cols), jnp.asarray(rows), R, A, 512, STEPS, True, variant))
    got = probes.liveset(torch.from_numpy(cols), torch.from_numpy(rows), A, variant)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_splat_is_liveset_at_one_pair():
    _, cols = _cols(3)
    rows = torch.from_numpy(np.random.default_rng(5).integers(-128, 129, (2, 64, 512)).astype(np.float32))
    cols = torch.from_numpy(cols)
    assert torch.equal(probes.splat(cols, rows, "splat"), probes.liveset(cols, rows, 1, "splat"))
    assert torch.equal(probes.splat(cols, rows, "impl"), probes.splat(cols.to(torch.int16), rows, "i16"))


def _ref_ptw(mod, pattern, inputs):
    kern, out_shape = {
        "A": (mod.kernel_A, (64, 512)), "NOB": (mod.kernel_NOB, (64, 512)),
        "B": (functools.partial(mod._kernel_T, L=64), (512, 64)),
        "B2": (functools.partial(mod._kernel_T, L=128), (512, 128)),
        "C": (mod.kernel_C, (512, 512)),
    }[pattern]
    return np.asarray(pl.pallas_call(
        kern, grid=(mod.STEPS,), interpret=True,
        in_specs=[pl.BlockSpec(x.shape, lambda j, _nd=len(x.shape): (0,) * _nd, memory_space=pltpu.VMEM)
                  for x in inputs],
        out_specs=pl.BlockSpec(out_shape, lambda j: (0,) * len(out_shape), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        scratch_shapes=[pltpu.VMEM(out_shape, jnp.float32)],
    )(*[jnp.asarray(x) for x in inputs]))


@pytest.mark.parametrize("pattern", probes.PTW_PATTERNS)
def test_ptw_equals_reference(ref_ptw, pattern):
    inputs = ptw_probe.inputs(probes.PTW_PATTERNS)[pattern]
    ref = _ref_ptw(ref_ptw, pattern, inputs)
    got = probes.ptw(pattern, [torch.from_numpy(a) for a in inputs], STEPS, ref_ptw.UNITS)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ptw_inputs_follow_the_reference_draws(ref_ptw):
    """The tool draws the reference's inputs, in its order (B2's slab
    only when B2 runs)."""
    P = ref_ptw.P
    rng = np.random.default_rng(0)
    slab = rng.integers(-P // 2, P // 2, (64, 96)).astype(np.float32)
    w0 = rng.integers(-128, 129, (512, 64)).astype(np.float32)
    got = ptw_probe.inputs(["A", "C"])
    np.testing.assert_array_equal(got["A"][0], slab)
    np.testing.assert_array_equal(got["B"][0], slab.T)
    np.testing.assert_array_equal(got["C"][0], w0)
    assert "B2" not in got


def test_wrappers_refuse_other_devices_and_shapes():
    x = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="no kernel for meta"):
        probes.expand8(x, torch.zeros((8, 16), device="meta"))
    with pytest.raises(ValueError, match=r"x \[R, 8\]"):
        probes.expand8(torch.zeros((4, 7), dtype=torch.int32), torch.zeros((8, 16)))
    with pytest.raises(ValueError, match="variant"):
        probes.splat(torch.zeros((1, 64, 96)), torch.zeros((2, 64, 8)), "red")
    with pytest.raises(ValueError, match="pattern"):
        probes.ptw("D", [torch.zeros((64, 96))], 1)


def test_probe_tools_on_the_cpu(capsys):
    assert expand8_probe.main(["--device", "cpu"], {}) == 0
    assert splat_repro.main(["--device", "cpu"], {"STEPS": "2"}) == 0
    assert liveset_harness.main(["--device", "cpu"], {"STEPS": "2", "RS": "1,2", "AS": "1,4",
                                                      "VARIANTS": "splat,red"}) == 0
    assert ptw_probe.main(["--device", "cpu", "A", "B2"], {"STEPS": "1"}) == 0
    out = capsys.readouterr().out
    assert "match: True" in out
    for v in probes.SPLAT_VARIANTS:
        assert f"{v:7s}:" in out
    assert "splat vs scalar:" in out
    assert out.count(" M terms/s") == 4 + 2 * 2 * 2
    assert "ns/unit" in out and "{'A': " in out
    # a CPU run names no device metric
    assert "not measured (cpu)" in out and "H100 bound" not in out
    with pytest.raises(SystemExit, match="unknown patterns"):
        ptw_probe.main(["--device", "cpu", "Z"], {})
