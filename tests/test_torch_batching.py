"""helm_tpu_torch.batching, the H100 serving cost model, on the CPU.

The launch plan is a pure function of (set, level widths, batch, clusters
a wave), so the model runs here at GATES_128_K3 on c880-like's level
widths with a stated slot count (30 clusters a wave, what the card holds
for K1 at GATES_128_K3; the card's own count comes from
`mb_pbs.cluster_slots`). The reference's contracts hold: fill in (0, 1],
the 2%-tie-prefers-larger rule, `check_batch`'s None at fill >= 0.75 and
its warning naming the suggested batch otherwise, and the CPU branch's
fill 1.0 and choice of max_batch.
"""

from types import SimpleNamespace

import pytest
import torch

from helm_tpu_torch import batching
from helm_tpu_torch import params as P
from helm_tpu_torch.circuit.graph import Circuit
from helm_tpu_torch.circuit.plan import binarize, build_plan
from helm_tpu_torch.circuit.verilog import read_verilog_file
from helm_tpu_torch.engines.boolean import BooleanEngine
from helm_tpu_torch.ops import mb_pbs
from _port_threads import compute_share  # noqa: F401,E402 (autouse)

SLOTS = 30


@pytest.fixture(scope="module")
def c880_plan():
    nl = read_verilog_file("benchmarks/netlists/c880-like.v")
    gates = binarize(nl.gates)
    c = Circuit(gates, nl.inputs, nl.outputs, nl.dff_outputs)
    c.sort_circuit()
    c.compute_levels()
    return build_plan(c, set(nl.wire_set) | {g.output for g in gates}, P.GATES_128_K3, "gates")


@pytest.fixture
def card_engine(c880_plan, monkeypatch):
    """c880-like's plan at GATES_128_K3 as a compiled engine on the card
    would hold it, with the card's clusters a wave stated (SLOTS)."""
    monkeypatch.setattr(mb_pbs, "cluster_slots", lambda dsk, gt, kernel="blind_rotate_mb": SLOTS)
    return SimpleNamespace(params=P.GATES_128_K3, device=torch.device("cuda"), plan=c880_plan, dsk=None)


def test_level_widths_are_the_plans(card_engine):
    widths = batching.level_widths(card_engine)
    assert len(widths) == 24
    assert {w for w, _ in widths} == {8, 16, 32}
    assert all(0 < r <= w for w, r in widths)


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 8, 12, 16])
def test_plan_is_the_tile_plan_and_fill_in_unit_interval(card_engine, batch):
    widths = batching.level_widths(card_engine)
    launches = batching.launch_plan(P.GATES_128_K3, widths, batch, SLOTS)
    assert launches == batching.engine_launches(card_engine, batch)
    for (w, r), x in zip(widths, launches):
        plan = mb_pbs.tile_plan(P.GATES_128_K3, batch * w, lambda gt: SLOTS)
        assert (x.gates, x.real, x.gt) == (batch * w, batch * r, plan.gt)
        assert x.waves == -(-plan.tiles // SLOTS) and x.slots == SLOTS
        assert x.gate_times == x.waves * (x.gt + 1)
        assert x.real <= x.gates <= x.positions == x.waves * SLOTS * x.gt
    cost, fill = batching.predicted_cost_per_vector(card_engine, batch)
    assert 0 < fill <= 1
    assert cost == pytest.approx(sum(
        x.gate_times + batching.KS_GATE_TIMES * x.gates + batching.LEVEL_GATE_TIMES for x in launches
    ) / batch)


def test_one_vector_plan_at_c880_widths(card_engine):
    """Batch 1: a 32-slot level takes 16 tiles of 2 gates in one wave (3
    gate-times, against 2 waves x 2 of 1-gate tiles); 16 and 8 slots one
    wave of 1-gate tiles (2 gate-times)."""
    launches = batching.engine_launches(card_engine, 1)
    by_width = {x.gates: (x.gt, x.waves, x.gate_times) for x in launches}
    assert by_width == {32: (2, 1, 3), 16: (1, 1, 2), 8: (1, 1, 2)}


@pytest.mark.parametrize("widths,batch", [
    ([(30, 30), (60, 60)], 1),
    ([(15, 15), (30, 30), (60, 60)], 2),
    ([(120, 120)], 2),
])
def test_fill_is_one_where_widths_fill_whole_waves(widths, batch):
    launches = batching.launch_plan(P.GATES_128_K3, widths, batch, SLOTS)
    assert batching.plan_cost(launches, batch)[1] == 1.0


def test_fill_counts_padding_and_idle_slots():
    # 20 real of 32 launched gates, in one wave of 16 two-gate tiles: 32
    # of the wave's 60 positions are launched
    launches = batching.launch_plan(P.GATES_128_K3, [(32, 20)], 1, SLOTS)
    assert batching.plan_cost(launches, 1)[1] == pytest.approx(20 / 60)


def _fake_costs(monkeypatch, table):
    monkeypatch.setattr(batching, "predicted_cost_per_vector", lambda engine, b: table[b])


@pytest.mark.parametrize("costs,best", [
    ({1: 10.0, 2: 5.0, 3: 5.09, 4: 5.2}, 3),  # 5.09 within 2% of 5.0: the larger wins
    ({1: 10.0, 2: 5.0, 3: 5.2, 4: 6.0}, 2),   # nothing within 2%
    ({1: 4.0, 2: 4.0, 3: 4.0, 4: 4.0}, 4),    # all tied
])
def test_two_percent_tie_prefers_the_larger_batch(monkeypatch, costs, best):
    _fake_costs(monkeypatch, {b: (c, 0.5) for b, c in costs.items()})
    got, table = batching.suggest_batch(object(), max_batch=4)
    assert got == best
    assert [t["batch"] for t in table] == [1, 2, 3, 4]


def test_check_batch_warns_below_the_threshold_only(monkeypatch):
    _fake_costs(monkeypatch, {1: (10.0, 0.2), 2: (6.0, 0.5), 3: (5.0, 0.75), 4: (5.5, 0.9)})
    assert batching.check_batch(object(), 3, max_batch=4) is None
    assert batching.check_batch(object(), 4, max_batch=4) is None
    warn = batching.check_batch(object(), 1, max_batch=4)
    assert "batch 1 fills" in warn and "20%" in warn and "suggestion: batch 3 (75% fill)" in warn


def test_check_batch_on_the_c880_plan(card_engine):
    """One c880-like vector fills the card's clusters to well under 75%;
    the warning names the model's batch."""
    best, table = batching.suggest_batch(card_engine, 16)
    warn = batching.check_batch(card_engine, 1)
    assert warn is not None and f"suggestion: batch {best} " in warn
    fill = {t["batch"]: t["fill"] for t in table}
    assert fill[1] < batching.UNDERFILL_WARN
    assert min(t["cost_per_vector"] for t in table) < table[0]["cost_per_vector"]


def test_cpu_engine_fill_one_and_max_batch():
    """On the CPU there are no tiles: cost is the slots a vector, fill 1.0,
    every batch ties and the largest is picked (the reference's non-mxu
    branch)."""
    eng = BooleanEngine(mode="gates", params=P.TEST_PARAMS, seed=3, device="cpu")
    eng.compile(read_verilog_file("benchmarks/netlists/2-bit-adder.v"))
    slots = sum(lp.slot_in.shape[0] for lp in eng.plan.levels)
    assert batching.predicted_cost_per_vector(eng, 5) == (float(slots), 1.0)
    best, table = batching.suggest_batch(eng, 7)
    assert best == 7 and {t["fill"] for t in table} == {1.0}
    assert batching.check_batch(eng, 1) is None


def test_calibrate_recovers_the_constants(card_engine):
    gate_s, ks, level = 1.5e-3, 0.002, 0.4
    launches = {B: batching.engine_launches(card_engine, B) for B in (1, 2, 4, 8, 12, 16)}
    measured = {B: gate_s * batching.plan_cost(xs, B, ks, level)[0] for B, xs in launches.items()}
    got = batching.calibrate(launches, measured)
    assert got == pytest.approx((gate_s, ks, level), rel=1e-6)


@pytest.mark.parametrize("env,kernel", [
    (None, "blind_rotate_mb"),
    ("ps", "blind_rotate_ps"),
    ("ts", "blind_rotate_ts"),
    ("hb2", "blind_rotate_mb"),
])
def test_engine_launches_follow_the_route(card_engine, monkeypatch, env, kernel):
    """The launches are planned for the kernel HELM_TPU_MB_KERNEL routes
    to, with that kernel's clusters a wave and shared memory (K4's tiles
    hold its limb planes too)."""
    if env is None:
        monkeypatch.delenv("HELM_TPU_MB_KERNEL", raising=False)
    else:
        monkeypatch.setenv("HELM_TPU_MB_KERNEL", env)
    asked = set()

    def slots(dsk, gt, k="blind_rotate_mb"):
        asked.add(k)
        return SLOTS

    monkeypatch.setattr(mb_pbs, "cluster_slots", slots)
    widths = batching.level_widths(card_engine)
    assert batching.engine_launches(card_engine, 16) == batching.launch_plan(
        P.GATES_128_K3, widths, 16, SLOTS, kernel
    )
    assert asked == {kernel}
