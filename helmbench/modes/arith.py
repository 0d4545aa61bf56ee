"""Arith mode: `helm_tpu_torch.engines.arith.ArithEngine`, radix integers
of 2-bit blocks; inputs and outputs are unsigned words."""

from __future__ import annotations

import numpy as np

from .. import reference


def make_engine(cfg, params, keys, device):
    from helm_tpu_torch.circuit.verilog import read_verilog_file
    from helm_tpu_torch.engines.arith import ArithEngine

    engine = ArithEngine(cfg["ptxt_type"], params=params, keys=keys, device=device)
    engine.compile(read_verilog_file(cfg["netlist_path"], True))
    return engine


def draw_inputs(rng, nl, count: int, cfg) -> np.ndarray:
    """Words drawn uniformly over the configuration's word width."""
    bits = cfg["circuit"]["word_bits"]
    return rng.integers(0, 1 << bits, size=(count, len(nl.inputs)), dtype=np.uint64)


def _blocks(engine, values: np.ndarray) -> np.ndarray:
    bits = engine.params.message_bits
    shifts = (bits * np.arange(engine.nb)).astype(np.uint64)
    return (values[..., None] >> shifts) & np.uint64((1 << bits) - 1)


def encrypt(engine, nl, inputs: np.ndarray):
    """The input ciphertexts [count, inputs, blocks, n+1] on the engine's
    device, by the program's client encryption under its client key."""
    from helm_tpu_torch.fhe import lwe
    from helm_tpu_torch.fhe.ntt import words

    msgs = lwe.encode_msg(engine.params, _blocks(engine, inputs))
    cts = lwe.encrypt_many(engine.client_key, msgs.reshape(-1))
    return words(cts.reshape(msgs.shape + (-1,)), engine.device)


class Layout:
    """Where a request's input ciphertexts go in the engine's wire table
    [wires, batch, blocks, n+1], and where its outputs are read."""

    def __init__(self, engine, nl, batch: int):
        import torch

        idx = engine.wire_index
        self.batch = batch
        self.inputs = torch.tensor([idx[w] for w in nl.inputs], device=engine.device)
        self.outputs = torch.tensor([idx[w] for w in nl.outputs], device=engine.device)
        # encryptions of 0 on every input, trivial zeros elsewhere; the
        # inputs are overwritten
        self.template = engine.encrypt_inputs([{}] * batch)

    def fill(self, pool, rows):
        wires = self.template.clone()
        wires[self.inputs] = pool[rows].transpose(0, 1)
        return wires

    def outputs_to_host(self, wires) -> np.ndarray:
        """The output ciphertexts [batch, outputs, blocks, n+1] as host u32
        words."""
        out = wires[self.outputs].transpose(0, 1).cpu().numpy()
        return out.astype(np.uint32)


def expected(cfg, nl, inputs: np.ndarray) -> np.ndarray:
    return reference.evaluate_arith(nl, inputs, cfg["circuit"]["word_bits"])


def judge(cfg, expected_out, cts, key) -> reference.Judgement:
    p = cfg["params"]
    return reference.judge_arith(expected_out, cts, key, p["msg_space_log"], p["message_bits"])


def counters(engine) -> dict:
    """The program's counts: blind-rotation launches of the engine's route,
    and the radix layer's merged rounds and real slots."""
    from helm_tpu_torch.engines import radix
    from helm_tpu_torch.ops import mb_pbs

    return {
        "launches": mb_pbs.blind_rotation(engine.params).launches,
        "rounds": radix.LAUNCHES[0],
        "slots": radix.SLOTS[0],
    }


def counts(engine, part) -> dict:
    """The counters' change over a stretch of the window, with `launches`
    and `bootstraps`: the radix layer's real slots."""
    delta = {k: part.after[k] - part.before[k] for k in part.after}
    return {**delta, "bootstraps": delta["slots"]}


def warmup_calls(engine) -> int:
    """The arith engine runs eagerly: one call warms every shape."""
    return 1


def batch_fill(engine, batch: int):
    """The batch layer has no model of the arith engine's rounds."""
    return None

