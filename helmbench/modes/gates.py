"""Gates mode: `helm_tpu_torch.engines.boolean.BooleanEngine(mode="gates")`,
one bootstrap a two-input gate; inputs are bits, outputs bits."""

from __future__ import annotations

import numpy as np

from .. import reference


def make_engine(cfg, params, keys, device):
    from helm_tpu_torch.circuit.verilog import read_verilog_file
    from helm_tpu_torch.engines.boolean import BooleanEngine

    engine = BooleanEngine(mode="gates", params=params, keys=keys, device=device)
    engine.compile(read_verilog_file(cfg["netlist_path"]))
    return engine


def draw_inputs(rng, nl, count: int, cfg) -> np.ndarray:
    return rng.integers(0, 2, size=(count, len(nl.inputs))).astype(bool)


def encrypt(engine, nl, inputs: np.ndarray):
    """The input ciphertexts [count, inputs, n+1] on the engine's device,
    by the program's client encryption under its client key."""
    from helm_tpu_torch.fhe import lwe
    from helm_tpu_torch.fhe.ntt import words

    cts = lwe.encrypt_many(engine.client_key, lwe.encode_bool(inputs).reshape(-1))
    return words(cts.reshape(inputs.shape + (-1,)), engine.device)


class Layout:
    """Where a request's input ciphertexts go in the engine's wire table,
    and where its outputs are read."""

    def __init__(self, engine, nl, batch: int):
        import torch

        idx = engine.plan.wire_index
        self.batch = batch
        self.inputs = torch.tensor([idx[w] for w in nl.inputs], device=engine.device)
        self.outputs = torch.tensor([idx[w] for w in nl.outputs], device=engine.device)
        # trivial encryptions of false on every wire; the inputs are overwritten
        self.template = engine.encrypt_inputs({} if batch == 1 else [{}] * batch)

    def fill(self, pool, rows):
        """The wire table of the request that carries pool rows `rows`."""
        wires = self.template.clone()
        if self.batch == 1:
            wires[self.inputs] = pool[rows[0]]
        else:
            wires[:, self.inputs] = pool[rows]
        return wires

    def outputs_to_host(self, wires) -> np.ndarray:
        """The output ciphertexts [batch, outputs, n+1] as host u32 words."""
        out = wires[..., self.outputs, :].cpu().numpy()
        return out.reshape(self.batch, -1, out.shape[-1]).astype(np.uint32)


def expected(cfg, nl, inputs: np.ndarray) -> np.ndarray:
    return reference.evaluate_gates(nl, inputs)


def judge(cfg, expected_out, cts, key) -> reference.Judgement:
    return reference.judge_gates(expected_out, cts, key)


def counters(engine) -> dict:
    """The program's counts: blind-rotation launches of the engine's route
    (graph replays included)."""
    from helm_tpu_torch.ops import mb_pbs

    return {"launches": mb_pbs.blind_rotation(engine.params).launches}


def counts(engine, part) -> dict:
    """The counters' change over a stretch of the window, with `launches`
    and `bootstraps`: the plan's real slots of every vector slot evaluated."""
    delta = {k: part.after[k] - part.before[k] for k in part.after}
    real = sum(lp.real_slots for lp in engine.plan.levels)
    return {**delta, "bootstraps": part.slots * real}


def warmup_calls(engine) -> int:
    """A fused engine runs its first call eagerly and captures its graph
    there; the second call is its first replay, as every call of the
    window is. An eager engine needs one call."""
    return 2 if engine.fused and engine.device.type == "cuda" else 1


def batch_fill(engine, batch: int):
    """The batch layer's fill of the card's cluster slots at `batch`."""
    from helm_tpu_torch import batching

    return batching.predicted_cost_per_vector(engine, batch)[1]


def auto_batch(engine, max_batch: int) -> int:
    from helm_tpu_torch import batching

    return batching.suggest_batch(engine, max_batch)[0]
