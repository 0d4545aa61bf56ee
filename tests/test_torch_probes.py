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
against these plain versions on the card by chip_smoke.py phase `probes`;
here, the host's models of them are: C's work items and scratch, its
swizzled limb layout against the reference's limbs, the exactness of its
f32 sums in any order, and K7's thread-to-column map.
"""

import functools
import importlib.util
import os
import re

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
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2


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


# -- K10's C on wgmma: the host's view of the kernel (csrc/probe_ptw.cu ptw_c) --


def ptw_c_plan(G, units, blocks):
    """C's work items as csrc/probe_ptw.cu ptw_c deals them: item i is
    (group vc, column block cb, pass p) with p = i % npass, cb = i / npass %
    ncb, vc = i / npass / ncb, and block b takes items b, b + blocks, ...;
    each item is (vc, cb, p, first column, columns, units): a pass takes
    two units (the last one of an odd count, one), and the last column
    block of a G that PTW_C_COLS does not divide is narrower."""
    ncb, npass = -(-G // probes.PTW_C_COLS), -(-units // 2)
    items = []
    for i in range(probes.NVC * ncb * npass):
        p, cb, vc = i % npass, i // npass % ncb, i // npass // ncb
        col0 = cb * probes.PTW_C_COLS
        items.append((vc, cb, p, col0, min(probes.PTW_C_COLS, G - col0), min(2, units - 2 * p)))
    return [items[b::blocks] for b in range(blocks)]


@pytest.mark.parametrize("G,units,blocks", [(512, 2, 132), (8, 2, 132), (520, 3, 7), (1024, 1, 132)])
def test_ptw_c_plan_takes_each_item_once(G, units, blocks):
    """Every (group, column block, pass) is one item of exactly one block;
    the column blocks tile [0, G), the last one narrower and its missing
    columns masked; the passes take every unit once."""
    plan = ptw_c_plan(G, units, blocks)
    assert len(plan) == blocks
    items = [it for b in plan for it in b]
    keys = [(vc, cb, p) for vc, cb, p, *_ in items]
    assert len(keys) == len(set(keys)) == probes.NVC * -(-G // 48) * -(-units // 2)
    for vc in range(probes.NVC):
        cols = sorted((c0, w) for v, _, p, c0, w, _ in items if v == vc and p == 0)
        assert cols[0][0] == 0 and all(a + wa == b for (a, wa), (b, _) in zip(cols, cols[1:]))
        assert cols[-1][0] + cols[-1][1] == G and all(0 < w <= probes.PTW_C_COLS for _, w in cols)
        assert all(w == probes.PTW_C_COLS for _, w in cols[:-1])
        assert sum(nu for v, cb, _, _, _, nu in items if v == vc and cb == 0) == units
    # block b's items are b, b + blocks, ...: at G = 512 on 132 SMs, one each
    if (G, units, blocks) == (512, 2, 132):
        assert all(len(b) == 1 for b in plan)


def test_ptw_c_scratch_sizes():
    limbs, sums, barrier = probes.ptw_c_scratch_bytes(512)
    assert probes.PTW_C_LIMB_BYTES == 12 * 3 * 512 * 64 * 2 == 2_359_296
    assert limbs == 2 * probes.PTW_C_LIMB_BYTES and sums == 3 * 64 * 512 * 4 and barrier == 256
    assert probes.ptw_c_scratch_bytes(8) == (limbs, 3 * 64 * 8 * 4, 256)
    # the sums and the counter start on 16-byte boundaries (the bulk adds' rows)
    assert limbs % 16 == 0 and (limbs + sums) % 16 == 0


def test_ptw_c_limb_layout_unpermutes_to_the_reference(ref_ptw):
    """The swizzled limb buffer holds every word of the reference's s00,
    m1 and s11 once: un-permuting it gives them back, and each 128-byte
    row of a 1024-byte tile of 8 rows holds its 16-byte chunks q at q ^
    (row % 8)."""
    w0, w1, bcol = ptw_probe.inputs(["C"])["C"]
    off = probes.ptw_c_limb_offsets()
    assert off.shape == (12, 3, 512, 64)
    flat = off.reshape(-1)
    assert bool((flat % 2 == 0).all()) and torch.equal(torch.sort(flat).values, torch.arange(0, probes.PTW_C_LIMB_BYTES, 2))
    # chunk q of row m of a tile: 8 consecutive contraction rows, at q ^ (m % 8)
    k = torch.arange(0, 64, 8)
    for m in (0, 5, 13):
        pos = (off[0, 0, k, m] % 1024 - (m % 8) * 128) // 16
        assert pos.tolist() == [q ^ (m % 8) for q in range(8)]
    image = probes.ptw_c_limb_image(probes.ptw_c_limbs(*(torch.from_numpy(a) for a in (w0, w1, bcol))))
    words = image.view(torch.int16)[flat // 2].view(torch.bfloat16).reshape(12, 3, 512, 64).float().numpy()
    for vc in (0, 7, 11):
        b = bcol[:, vc : vc + 1]
        s00, s01 = (np.asarray(v) for v in ref_ptw._split256(ref_ptw._redfbt(jnp.asarray(w0 * b))))
        s10, s11 = (np.asarray(v) for v in ref_ptw._split256(ref_ptw._redfbt(jnp.asarray(w1 * b))))
        np.testing.assert_array_equal(words[vc, 0], s00)
        np.testing.assert_array_equal(words[vc, 1], s01 + s10)
        np.testing.assert_array_equal(words[vc, 2], s11)


def test_ptw_c_exact_in_any_order_of_summation():
    """C's exactness argument on the probe's inputs: every limb is an
    integer of at most 8 bits (|m1| <= 164), every partial sum of a
    product stays below 2^24, and taking the six products in float32 over
    shuffled 16-row slices (the tensor cores' k16 steps, in any order),
    summed in shuffled order, gives ptw_plain's words."""
    w0, w1, bcol = (torch.from_numpy(a) for a in ptw_probe.inputs(["C"])["C"])
    limbs = probes.ptw_c_limbs(w0, w1, bcol).float()
    assert float(limbs[:, [0, 2]].abs().max()) <= 128 and float(limbs[:, 1].abs().max()) <= 164
    t = torch.arange(-9216, 9217, dtype=torch.float32)  # every balanced residue
    x0, x1 = probes._split256(t)
    assert float(x0.abs().max()) <= 128 and float(x1.abs().max()) <= 36
    # the largest |partial sum| any order can reach: sum_k |limb| |x|
    worst = {"lo": limbs[:, 0].abs().sum(1) * 128, "mid": limbs[:, 1].abs().sum(1) * 128 + limbs[:, 0].abs().sum(1) * 36,
             "hi2": limbs[:, 1].abs().sum(1) * 36 + limbs[:, 2].abs().sum(1) * 128, "hi3": limbs[:, 2].abs().sum(1) * 36}
    assert max(float(v.max()) for v in worst.values()) < 2**24
    rng = np.random.default_rng(12)
    acc = torch.zeros((512, 512))
    peak = 0.0
    for _ in range(STEPS):
        xs = probes._split256(probes._redfbt(acc + 1.0))
        parts = []
        for _u in range(2):
            for vc in range(probes.NVC):
                s = {}
                for name, terms in (("lo", [(0, 0)]), ("mid", [(1, 0), (0, 1)]), ("hi2", [(1, 1), (2, 0)]), ("hi3", [(2, 1)])):
                    sl = [(l, xi, k0) for l, xi in terms for k0 in range(0, 512, 16)]
                    total = torch.zeros((64, 512))
                    for i in rng.permutation(len(sl)):
                        l, xi, k0 = sl[i]
                        total = total + limbs[vc, l, k0 : k0 + 16].T @ xs[xi][k0 : k0 + 16]
                        peak = max(peak, float(total.abs().max()))
                    s[name] = total
                r3 = probes._redfbt(s["hi3"])
                r2 = probes._redfbt(s["hi2"] + 256.0 * r3)
                r1 = probes._redfbt(s["mid"] + 256.0 * r2)
                parts.append(probes._redfbt(s["lo"] + 256.0 * r1))
        total = torch.zeros((64, 512))
        for i in rng.permutation(len(parts)):
            total = total + parts[i]
        acc = probes._redfbt(total.repeat(8, 1))
    assert peak < 2**24
    np.testing.assert_array_equal(acc.numpy(), probes.ptw_plain("C", (w0, w1, bcol), STEPS).numpy())


def expand8_geometry():
    """csrc/probe_expand8.cu's warps a block, rows a warp and columns a
    warp, read from its source."""
    with open(os.path.join(REPO, "helm_tpu_torch", "csrc", "probe_expand8.cu")) as f:
        src = f.read()
    return tuple(int(re.search(rf"\b{name} = (\d+)", src).group(1)) for name in ("WPB", "RPW", "TILE"))


def expand8_plan(R, L):
    """K7's launch, modelled: (grid (x, y), and for every (block x, block
    y, warp, lane) that writes, its (rows, first column, columns, 16-byte
    store)). A warp takes RPW consecutive rows, a lane 4 consecutive
    columns of its warp's tile; the last tile's lanes past L write nothing
    or fewer words, and a row that is not 16-byte aligned (L % 4) is
    written word by word."""
    wpb, rpw, tile = expand8_geometry()
    grid = (-(-R // (wpb * rpw)), -(-L // tile))
    cells = []
    for bx in range(grid[0]):
        for by in range(grid[1]):
            for warp in range(wpb):
                r0 = (bx * wpb + warp) * rpw
                rows = range(r0, min(R, r0 + rpw))
                for lane in range(32):
                    l0 = by * tile + 4 * lane
                    if l0 >= L or not rows:
                        continue
                    nl = min(4, L - l0)
                    cells.append((bx, by, warp, lane, rows, l0, nl, nl == 4 and L % 4 == 0))
    return grid, cells


@pytest.mark.parametrize("R,L", [(6144, 128), (37, 100), (21, 130), (9, 36), (5, 18)])
def test_expand8_plan_writes_each_word_once(R, L):
    """K7's thread-to-column map at the kernel's geometry (4 warps a block,
    2 rows a warp, a tile of 128 columns): a lane 4 consecutive columns
    (one 16-byte store where the row is 16-byte aligned), every word of
    [R, L] written exactly once."""
    assert expand8_geometry() == (4, 2, 128)
    grid, cells = expand8_plan(R, L)
    assert grid == (-(-R // 8), -(-L // 128))
    hits = np.zeros((R, L), np.int32)
    for bx, by, warp, lane, rows, l0, nl, vec in cells:
        assert l0 == by * 128 + 4 * lane and 1 <= nl <= 4 and vec == (nl == 4 and L % 4 == 0)
        for r in rows:
            hits[r, l0 : l0 + nl] += 1
    assert (hits == 1).all()
    if (R, L) == (6144, 128):
        assert grid[0] >= 2 * 132 and all(vec for *_, vec in cells)


# -- the kernels' exact FP32-rate rounding, tied to the probes' data ----------
#
# csrc/probe_splat.cu (K8/K9's `red`) takes floor(y) as RD(y + 1.5 2^23) -
# 1.5 2^23, exact for |y| < 2^22; csrc/probe_ptw.cu (K10's A, NOB, B, B2
# and C) reduces mod P and splits by magic-number rounding (redfbt_c,
# redmod_c: integers below 2^24; split_c: below 2^23). The tests below check
# that the plain versions feed their floors only values of that domain, on
# the probes' own inputs and seeds, and check each identity over the domain
# in numpy (float32 operations round to nearest, as the kernels' _rn ones).

MAGIC = np.float32(1.5 * 2**23)


def _add_rd(y, m):
    """float32 y + m rounded toward -inf (__fadd_rd), for |y| <= |m|: the
    sum in float64 with its exact error (fast two-sum), then the nearest
    float32 stepped down where it lies above the exact sum."""
    y64, m64 = y.astype(np.float64), np.float64(m)
    s = y64 + m64
    e = y64 - (s - m64)
    f = s.astype(np.float32)
    return np.where(f.astype(np.float64) - s > e, np.nextafter(f, np.float32(-np.inf)), f)


def _floor_rd(y):
    """csrc/probe_splat.cu reduce16381's floor."""
    return _add_rd(y, MAGIC) - MAGIC


def _rint(x):
    return (x + MAGIC) - MAGIC  # float32, round to nearest even


def _redmod_c(t):
    q = _rint(t * np.float32(1.0 / probes.PTW_P))
    return (t.astype(np.float64) - q.astype(np.float64) * probes.PTW_P).astype(np.float32)  # fmaf: one rounding


def _redfbt_c(t):
    t = _redmod_c(t)
    hp, p = np.float32(9216.0), np.float32(probes.PTW_P)
    t = np.where(t > hp, t - p, t)
    return np.where(t < -hp, t + p, t)


def _split_c(t):
    hi = _rint(t * np.float32(1 / 256) + np.float32(1 / 512))
    return (t.astype(np.float64) - 256.0 * hi.astype(np.float64)).astype(np.float32), hi


def test_splat_ring_depth_is_the_kernels():
    with open(os.path.join(REPO, "helm_tpu_torch", "csrc", "probe_splat.cu")) as f:
        src = f.read()
    cps, stages = (int(re.search(rf"\b{name} = (\d+);", src).group(1)) for name in ("CPS", "STAGES"))
    assert (probes.SPLAT_STAGE, probes.SPLAT_RING) == (cps, stages * cps)


@pytest.mark.parametrize("R,A", [(1, 1), (8, 12)])
def test_liveset_red_floors_stay_in_the_round_down_domain(monkeypatch, R, A):
    """liveset_harness's inputs (seed 7: its 256 steps of columns, then the
    rows of R = 1, 2, 4, 8 in turn), its first 8 steps: every value `red`
    passes to floor is finite and below 2^22 in magnitude."""
    rng = np.random.default_rng(7)
    cols = rng.integers(-16384, 16384, (256, 64, 96)).astype(np.float32)
    rows = {r: rng.integers(-128, 129, (2 * r, 64, 512)).astype(np.float32) for r in probes.LIVESET_RS}
    seen = []
    floor = torch.floor

    def recording_floor(y):
        seen.append(float(y.abs().max()))
        assert bool(torch.isfinite(y).all())
        return floor(y)

    monkeypatch.setattr(torch, "floor", recording_floor)
    probes.liveset_plain(torch.from_numpy(cols[:8]), torch.from_numpy(rows[R]), A, "red")
    assert len(seen) == 8 * 96 // 8 * 2 and max(seen) < 2**22


@pytest.mark.parametrize("pattern", ["A", "NOB", "B", "B2"])
def test_ptw_reductions_see_only_exact_integers(monkeypatch, pattern):
    """ptw_probe's inputs (seed 0), 3 steps: every value that A, NOB, B and
    B2's plain version reduces mod P is an integer below 2^24 in magnitude
    (the domain of the kernel's redfbt_c and redmod_c), every value it
    splits one below 2^23 (split_c's)."""
    data = {k: [torch.from_numpy(a) for a in v] for k, v in ptw_probe.inputs(["B2"]).items()}
    seen = {"_redfbt": [], "_split256": []}

    def recorder(name):
        fn = getattr(probes, name)

        def wrapped(t):
            assert bool((t == torch.round(t)).all()), f"{name} of a value that is not an integer"
            seen[name].append(float(t.abs().max()))
            return fn(t)
        return wrapped

    for name in seen:
        monkeypatch.setattr(probes, name, recorder(name))
    probes.ptw_plain(pattern, data[pattern], 3)
    # a step: base and acc, and per unit 8 rows and 12 groups' three; the
    # first t of a step is added unreduced
    assert len(seen["_redfbt"]) == 3 * (2 + 2 * (8 + 3 * 12) - 1) and len(seen["_split256"]) == 3 * 2 * 8
    assert max(seen["_redfbt"]) < 2**24 and max(seen["_split256"]) < 2**23


def test_round_down_floor_is_exact_below_2_22():
    """floor(y) = RD(y + 1.5 2^23) - 1.5 2^23 for float32 |y| < 2^22: on
    uniform values, on every sampled integer and its float32 neighbours,
    and on tiny values of both signs."""
    rng = np.random.default_rng(22)
    k = rng.integers(-(2**22) + 1, 2**22, 1_000_000).astype(np.float32)
    ys = [rng.uniform(-(2**22), 2**22, 1_000_000).astype(np.float32), k,
          np.nextafter(k, np.float32(np.inf)), np.nextafter(k, np.float32(-np.inf)),
          (rng.standard_normal(500_000) * 10.0 ** rng.uniform(-30, 0, 500_000)).astype(np.float32),
          np.float32([2**22 - 0.5, -(2**22) + 0.5, 0.0, -0.0, 0.5, -0.5])]
    y = np.concatenate(ys)
    assert np.abs(y).max() < 2**22
    np.testing.assert_array_equal(_floor_rd(y), np.floor(y))


def test_magic_reductions_equal_the_plain_version_below_2_24():
    """redfbt_c gives the plain version's words (probes._redfbt) for
    integers below 2^24, split_c probes._split256's below 2^23: every
    integer up to 2^16, 3M uniform ones, and the folds' and the split's
    edges (P k + 9216, +9217, 256 k + 128 and their neighbours); redmod_c
    is congruent mod P and at most (P + 1) / 2 in magnitude."""
    rng = np.random.default_rng(24)
    P = int(probes.PTW_P)
    kp = rng.integers(-(2**24) // P, 2**24 // P, 200_000)
    k256 = rng.integers(-(2**16) + 1, 2**16 - 1, 200_000)
    edges = [P * kp + d for d in (-9217, -9216, 9216, 9217)] + [256 * k256 + d for d in (-129, -128, -127, 127, 128, 129)]
    t = np.concatenate([np.arange(-(2**16), 2**16 + 1), rng.integers(-(2**24) + 1, 2**24, 3_000_000), *edges])
    t = t[np.abs(t) < 2**24].astype(np.float32)
    np.testing.assert_array_equal(_redfbt_c(t), probes._redfbt(torch.from_numpy(t)).numpy())
    r = _redmod_c(t).astype(np.int64)
    assert np.abs(r).max() <= (P + 1) // 2 and ((t.astype(np.int64) - r) % P == 0).all()
    t = t[np.abs(t) < 2**23]
    lo, hi = _split_c(t)
    plo, phi = probes._split256(torch.from_numpy(t))
    np.testing.assert_array_equal(lo, plo.numpy())
    np.testing.assert_array_equal(hi, phi.numpy())


def test_int16_halves_convert_exactly():
    """csrc/probe_splat.cu lo16 / hi16 on every int16 in either half of a
    word: 2^23 + (v + 2^15) and 1.5 2^23 + v built in the float's bits,
    less the offset, is v; lo16's bits are its LOP3 (truth table 0x9A on
    w, 0xFFFF0000, 0x4B008000), whatever the other half holds."""
    v = np.arange(-(2**15), 2**15, dtype=np.int64)
    w = (v & 0xFFFF) | (np.random.default_rng(16).permutation(v) & 0xFFFF) << 16
    bits = np.zeros_like(w)
    for i in range(32):  # lop3: bit i of the result is bit 4 a + 2 b + c of the table
        a, b, c = (w >> i) & 1, (0xFFFF0000 >> i) & 1, (0x4B008000 >> i) & 1
        bits |= ((0x9A >> (4 * a + 2 * b + c)) & 1) << i
    np.testing.assert_array_equal(bits, (v ^ 0x8000) & 0xFFFF | 0x4B000000)
    lo = bits.astype(np.uint32).view(np.float32) - np.float32(8421376.0)
    hi = (v + 0x4B400000).astype(np.uint32).view(np.float32) - MAGIC
    np.testing.assert_array_equal(lo, v.astype(np.float32))
    np.testing.assert_array_equal(hi, v.astype(np.float32))
