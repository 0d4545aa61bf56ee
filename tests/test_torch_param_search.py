"""The port of `tools/param_search.py` on the CPU, against the reference's
own script loaded by path.

The bars, the loops and the pick are the reference's: on a narrow range
of LWE dimensions (every N, k and g, n = 700-712) the port's `min_sigma`
and its candidates before the pick (name, failure bits, both sigmas, in
the loop's order) equal those the reference's `main` builds. The cost is
a model of K1 on the card: its units a step and gate are the work
chip_smoke.py `int_ops` counts, at g = 1, 2 and 4; `fit` recovers known
coefficients from k1_phases-shaped results; the table has the
reference's columns and `k1`.
"""

import builtins
import contextlib
import dataclasses
import importlib.util
import io
import os
import sys

import pytest

from helm_tpu_torch import params as P
from helm_tpu_torch.ops import mb_pbs
from helm_tpu_torch.tools import param_search as ps
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LO, N_HI = 700, 713


@pytest.fixture(scope="module")
def ref():
    """The reference's tools/param_search.py as a module."""
    spec = importlib.util.spec_from_file_location("ref_param_search", os.path.join(REPO, "tools", "param_search.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_candidates(ref):
    """The sets the reference's `main` appends to its candidates (each one
    passes through its `cost`), its LWE dimensions narrowed to N_LO..N_HI
    (its loop's `range(576, 900, step)`; every other range as it is)."""

    def narrow_range(*args):
        if args[:2] == (576, 900):
            return builtins.range(N_LO, N_HI, *args[2:])
        return builtins.range(*args)

    seen = []
    cost = ref.cost

    def recording_cost(p):
        seen.append(p)
        return cost(p)

    ref.range, ref.cost = narrow_range, recording_cost
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            ref.main()
    finally:
        del ref.range
        ref.cost = cost
    return seen


@pytest.mark.parametrize("dim", [512, 701, 702, 712, 1024, 1536, 2048])
def test_min_sigma_equals_reference(ref, dim):
    assert ps.min_sigma(dim) == ref.min_sigma(dim)


def test_candidates_before_the_pick_equal_reference(ref_candidates):
    mine = ps.candidates(n_lo=N_LO, n_hi=N_HI)
    assert len(mine) == len(ref_candidates) > 0
    for (f, p), r in zip(mine, ref_candidates):
        assert p.name == r.name
        assert f == r.pbs_failure_log2(linear_growth=8.0) <= ps.FAIL_BITS
        assert (p.lwe_noise_std, p.glwe_noise_std) == (r.lwe_noise_std, r.glwe_noise_std)
        assert dataclasses.asdict(p) == dataclasses.asdict(P.from_reference(r))


@pytest.mark.parametrize("p", [P.GATES_128_K3, dataclasses.replace(P.GATES_128_K3, name="gates_128_k3_g1", grouping=1),
                               P.GATES_TPU_MB4, P.LUT_128_MB2], ids=lambda p: f"{p.name}-g{p.grouping}")
def test_units_are_chip_smoke_int_ops_per_step(p):
    """Butterflies and multiply-adds a step and gate, weighted as
    chip_smoke.py weighs them, are its int_ops for K1 (P_v counted at
    every grouping, g = 1 too); K2's count leaves the subset products out."""
    sys.path.insert(0, REPO)
    import chip_smoke

    ub, um, ur = ps.units(p)
    steps = p.n // p.grouping
    assert chip_smoke.int_ops(p, 3, "blind_rotate_mb") == 3 * steps * (
        chip_smoke.OPS_PER_BUTTERFLY * ub + chip_smoke.OPS_PER_MULADD * um)
    assert ur == (p.k + 1) * p.N
    if p.grouping == 1:
        subsets = (p.k + 1) * ps.NP * p.N
        assert chip_smoke.int_ops(p, 3, "blind_rotate_sb") == 3 * steps * (
            chip_smoke.OPS_PER_BUTTERFLY * ub + chip_smoke.OPS_PER_MULADD * (um - subsets))


def test_table_has_the_reference_columns_and_k1():
    rows = ps.pick(ps.candidates(n_lo=N_LO, n_hi=N_HI))
    lines = ps.table(rows).splitlines()
    assert lines[0].split() == ["name", "cost_x", "pred_bs/s", "fail2^", "lwe_sig", "glwe_sig", "k1"]
    assert len(lines) - 1 == len(rows) == len({(p.N, p.k, p.grouping) for _, _, p in rows})
    for line, (c, f, p) in zip(lines[1:], rows):
        cells = line.split()
        assert cells[0] == p.name and cells[-1] == ("yes" if ps.has_build(p) else "no")
        assert float(cells[1]) == pytest.approx(c / ps.cost(P.GATES_128_K3), abs=0.005)
        assert float(cells[3]) == pytest.approx(f, abs=0.05)
    # cheapest first; the reference's 10-row sets (k=4, l=2) have no K1 build
    assert [c for c, _, _ in rows] == sorted(c for c, _, _ in rows)
    assert not ps.has_build(next(p for _, _, p in rows if p.k == 4))


def _phases(p, G, gt, coef):
    """A k1_phases RESULT dict whose clocks the model `coef` gives exactly."""
    ub, um, ur = (gt * u for u in ps.units(p))
    a, b32, b64, c = coef
    b = b32 if mb_pbs._narrow(p) else b64
    clocks = {"decompose+pass1": a * ub / 4, "fwd passes": a * ub / 2, "inv passes": a * ub / 4,
              "products": b * um, "cluster sync 1": c * ur / 3, "garner": c * ur / 3, "cluster sync 2": c * ur / 3}
    return {"tool": "k1_phases", "kernel": "mb", "set": p.name, "grouping": p.grouping, "G": G, "gt": gt,
            "ms": 1.0, "groups": p.n // p.grouping, "clocks": clocks}


def test_fit_recovers_the_coefficients():
    """Least squares over the widest width of each set and grouping, the
    multiply-adds apart for the narrow build (GATES_128_K3) and the wide
    one (LUT_128_K2, ARITH_128_MB2); a narrower width of a set is left
    out, and a fit with no wide width raises."""
    coef = (0.25, 0.5, 1.25, 2.0)
    assert mb_pbs._narrow(P.GATES_128_K3) and not mb_pbs._narrow(P.LUT_128_K2)
    g1 = dataclasses.replace(P.GATES_128_K3, name="gates_128_k3_g1", grouping=1)
    results = [_phases(P.GATES_128_K3, 1024, 4, coef), _phases(g1, 1024, 4, coef),
               _phases(P.LUT_128_K2, 256, 2, coef), _phases(P.ARITH_128_MB2, 1024, 1, coef),
               _phases(P.ARITH_128_MB2, 8, 8, (9.0, 9.0, 9.0, 9.0)), {"tool": "family_bench"}]
    out = ps.fit(results)
    assert out["coef"] == pytest.approx(coef)
    assert len(out["rows"]) == 12
    assert all(r["model"] == pytest.approx(r["measured"]) for r in out["rows"])
    assert {r["kind"] for r in out["rows"]} == set(ps.KINDS)
    with pytest.raises(ValueError, match="muladd u64"):
        ps.fit(results[:2])


def test_the_recorded_model_is_normalised_to_its_measurement():
    assert min(ps.A_BFLY, ps.B_MULADD_U32, ps.B_MULADD_U64, ps.C_REST, ps.MEAS) > 0
    assert ps.predicted(P.GATES_128_K3) == pytest.approx(ps.MEAS)
    g1 = dataclasses.replace(P.GATES_128_K3, grouping=1)
    assert ps.predicted(g1) < ps.MEAS  # twice the steps
    assert ps.has_build(g1) and (1, 8) in mb_pbs.K1_BUILDS
