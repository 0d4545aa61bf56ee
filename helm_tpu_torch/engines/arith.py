"""Arithmetic-mode engine: radix integers over behavioral netlists, on a
torch device.

Counterpart of `helm_tpu/engines/arith.py` (the reference's ArithCircuit,
src/circuit.rs:1113-1483): wires carry encrypted u8..u128 radix integers
(`engines/radix.py`); gates are add/sub/mult/div/shl/shr/copy with
ciphertext (x) ciphertext and ciphertext (x) plaintext variants
(numeric-literal wire names are plaintext operands). Combinational only,
like the reference (src/bin/helm.rs:33-36).

Evaluation is the reference's dataflow scheduler: every gate is a radix-op
coroutine that becomes runnable when its input wires are ready, and each
round merges the pending bootstrap requests of all runnable gates into one
`radix._bootstrap_multi` call (one `mb_pbs.bootstrap`: on the card the
multi-bit kernel K1, or K6 under HELM_TPU_MB_KERNEL=ps; on the CPU the
plain versions). The wire table is [W, V, nb, n+1] words on the engine's
device; V > 1 evaluates V input vectors together.

Positional note: the reference always computes `ct OP pt` regardless of
the literal's position (circuit.rs:1337-1361); we evaluate positionally
(`5 - x` means 5-x) by trivially encrypting the literal, which matches the
plaintext oracle.

`set_sharding` shards every merged bootstrap of this engine across a gate
mesh (`parallel/mesh.py`); the mesh is the engine's (`ops.mesh`), where the
reference sets the module global `radix.BATCH_SHARD`.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..circuit.gates import GateType
from ..circuit.graph import Circuit, _is_numeric
from ..circuit.verilog import Netlist
from ..fhe import lwe, pbs
from ..fhe.ntt import to_host, words
from ..fhe.server_key import gen_server_key
from ..ops import mb_pbs
from ..parallel import mesh as mesh_mod
from ..params import DEFAULT_ARITH, TfheParams, warn_if_weak
from . import radix
from .radix import WIDTH_BLOCKS, RadixOps, trivial_blocks


class ArithEngine:
    def __init__(
        self,
        ptxt_type: str,
        params: TfheParams | None = None,
        seed=None,
        keys=None,
        device="cuda",
    ):
        if ptxt_type not in WIDTH_BLOCKS:
            raise ValueError(f"unknown arithmetic type {ptxt_type!r} ({', '.join(WIDTH_BLOCKS)})")
        self.ptxt_type = ptxt_type
        self.nb = WIDTH_BLOCKS[ptxt_type]
        self.width = 2 * self.nb
        self.device = torch.device(device)
        self.params = params or DEFAULT_ARITH
        warn_if_weak(self.params)
        if keys is not None:  # preloaded (client, server) keys (fhe/keys.py)
            self.client_key, sk = keys
            assert self.client_key.params.name == self.params.name
        else:
            self.client_key = lwe.keygen(self.params, seed)
            sk = gen_server_key(self.client_key, self.device)
        self.dsk = pbs.DeviceServerKey.from_host(sk, self.device)
        if self.device.type == "cuda":
            mb_pbs.kernel_layouts(self.dsk)  # the kernels' key layouts, once, up front
        self.ops = RadixOps(self.params, self.dsk)

    def set_sharding(self, batch_shard, repl_shard) -> None:
        """Shard every radix PBS batch of this engine across the mesh
        (`parallel/mesh.py`), and replicate the keys to the mesh's devices.
        The wire table is always replicated, so `repl_shard` asks for
        nothing more."""
        self.ops.mesh = batch_shard.mesh
        mesh_mod.key_replicas(self.dsk, batch_shard.mesh)

    def compile(self, netlist: Netlist) -> None:
        circuit = Circuit(netlist.gates, netlist.inputs, netlist.outputs, netlist.dff_outputs)
        circuit.sort_circuit()
        circuit.compute_levels()
        wires = sorted(set(netlist.wire_set) | set(netlist.inputs) | set(netlist.dff_outputs))
        self.wire_index = {w: i for i, w in enumerate(wires)}
        self.circuit = circuit
        self.netlist = netlist

    # -- client role ---------------------------------------------------
    def _encrypt_value(self, value: int) -> np.ndarray:
        blocks = [(value >> (2 * i)) & 3 for i in range(self.nb)]
        return lwe.encrypt(self.client_key, lwe.encode_msg(self.params, np.array(blocks)))

    def encrypt_inputs(self, input_wire_map: dict | list) -> torch.Tensor:
        """Wire table [W, V, nb, n+1]; V > 1 = a list of input maps
        evaluated together (every merged round is V x wider)."""
        p = self.params
        self._batched = isinstance(input_wire_map, list)
        maps = input_wire_map if self._batched else [input_wire_map]
        W, V = len(self.wire_index), len(maps)
        wires = np.zeros((W, V, self.nb, p.n + 1), dtype=np.uint32)
        dff = set(self.netlist.dff_outputs)
        # gather every (wire, vector) message, then ONE encryption call
        slots, vals = [], []
        for vi, m in enumerate(maps):
            dummy = not m or "dummy" in m
            for w in self.circuit.input_wires:
                if w in dff:
                    continue
                if dummy:
                    val = 0
                elif w not in m:
                    raise KeyError(f'Input wire "{w}" not found in input wires!')
                else:
                    val = int(m[w])
                slots.append((self.wire_index[w], vi))
                vals.append(val)
            for w in dff:
                slots.append((self.wire_index[w], vi))
                vals.append(0)
        if slots:
            blocks = np.array([[(v >> (2 * i)) & 3 for i in range(self.nb)] for v in vals])
            cts = lwe.encrypt_many(self.client_key, lwe.encode_msg(p, blocks))  # [S, nb, n+1]
            for k, (wi, vi) in enumerate(slots):
                wires[wi, vi] = cts[k]
        return words(wires, self.device)

    # -- evaluation ----------------------------------------------------
    def evaluate(self, wires: torch.Tensor, verbose: bool = False) -> torch.Tensor:
        """Dataflow evaluation: each scheduler round merges the pending PBS
        requests of ALL runnable gates — independent gates of any type at
        any circuit level — into ONE bootstrap call, so the number of calls
        is the critical-path depth in bootstrap rounds."""
        V = wires.shape[1]
        vals: dict[str, torch.Tensor] = {}
        for w in set(self.circuit.input_wires) | set(self.netlist.dff_outputs):
            vals[w] = wires[self.wire_index[w]]

        gates = [g for _, gs in self.circuit.levels for g in gs]
        waiters: dict[str, list[int]] = {}
        nwait = []
        for gi, g in enumerate(gates):
            deps = {w for w in g.inputs if not _is_numeric(w) and w not in vals}
            nwait.append(len(deps))
            for w in deps:
                waiters.setdefault(w, []).append(gi)

        ready = deque(gi for gi, c in enumerate(nwait) if c == 0)
        running: list = []  # (gate_idx, coroutine)
        pending: list = []  # request list per running coroutine
        computed: list[str] = []

        def finish(gi: int, result) -> None:
            out = gates[gi].output
            vals[out] = result
            computed.append(out)
            for wi in waiters.get(out, ()):
                nwait[wi] -= 1
                if nwait[wi] == 0:
                    ready.append(wi)

        rounds = 0
        while ready or running:
            while ready:  # activate (cascades through bootstrap-free gates)
                gi = ready.popleft()
                gen, imm = self._gate_gen(gates[gi], vals, V)
                if gen is None:
                    finish(gi, imm)
                    continue
                try:
                    reqs = gen.send(None)
                except StopIteration as e:
                    finish(gi, e.value)
                    continue
                running.append((gi, gen))
                pending.append(reqs)
            if not running:
                break
            pres = [r[0] for reqs in pending for r in reqs]
            tvs = [r[1] for reqs in pending for r in reqs]
            outs = radix._bootstrap_multi(self.dsk, pres, tvs, self.ops.mesh)
            rounds += 1
            if verbose:
                print(
                    f"  round {rounds}: {len(running)} gates in flight, "
                    f"{sum(p.shape[0] for p in pres)} PBS slots"
                )
            still_running, still_pending, off = [], [], 0
            for (gi, gen), reqs in zip(running, pending):
                res = outs[off : off + len(reqs)]
                off += len(reqs)
                try:
                    nxt = gen.send(res)
                except StopIteration as e:
                    finish(gi, e.value)
                    continue
                still_running.append((gi, gen))
                still_pending.append(nxt)
            running, pending = still_running, still_pending
        if len(computed) != len(gates):
            missing = {g.output for g in gates} - set(computed)
            raise RuntimeError(f"unresolved gates (cycle?): {sorted(missing)}")
        if verbose:
            print(
                f"  {len(gates)} gates in {rounds} merged PBS rounds "
                f"(totals this process: {radix.LAUNCHES[0]} launches, "
                f"{radix.SLOTS[0]} slots)"
            )
        if not computed:
            return wires
        dst = torch.tensor([self.wire_index[w] for w in computed], device=wires.device)
        out = wires.clone()
        out[dst] = torch.stack([vals[w] for w in computed])
        return out

    def _gate_gen(self, g, vals: dict, V: int):
        """Coroutine (or immediate value) computing one gate. Returns
        (generator, None) or (None, result) for bootstrap-free gates."""
        ops = self.ops
        t = g.type

        def opnd(name: str):
            if _is_numeric(name):
                return trivial_blocks(self.params, int(name), self.nb, V, self.device)
            return vals[name]

        if t == GateType.COPY:
            return None, opnd(g.inputs[0])
        if t == GateType.MULT:
            # ct (x) pt multiplies (numeric literal on either side — mult
            # commutes) take the cheap binary-expansion path; power-of-two
            # constants are pure block relabels with no bootstraps at all
            p0, p1 = _is_numeric(g.inputs[0]), _is_numeric(g.inputs[1])
            if p0 != p1:
                c = int(g.inputs[0] if p0 else g.inputs[1])
                return ops.mul_plain_g(opnd(g.inputs[1 if p0 else 0]), c), None
            if not p0 and g.inputs[0] == g.inputs[1]:  # squaring: symmetric
                xx = opnd(g.inputs[0])
                return ops.mul_g(xx, xx, square=True), None
            return ops.mul_g(opnd(g.inputs[0]), opnd(g.inputs[1])), None
        if t in (GateType.SHL, GateType.SHR):
            left = t == GateType.SHL
            if _is_numeric(g.inputs[1]):  # plain amount: cheap relabel path
                return ops.shift_plain_g(opnd(g.inputs[0]), int(g.inputs[1]), left), None
            return ops.shift_ct_g(opnd(g.inputs[0]), opnd(g.inputs[1]), left), None
        if t == GateType.ADD:
            return ops.add_g(opnd(g.inputs[0]), opnd(g.inputs[1])), None
        if t == GateType.SUB:
            return ops.sub_g(opnd(g.inputs[0]), opnd(g.inputs[1])), None
        if t == GateType.DIV:
            if _is_numeric(g.inputs[1]):  # plain divisor: mul-by-reciprocal
                return ops.div_plain_g(opnd(g.inputs[0]), int(g.inputs[1])), None
            return ops.div_g(opnd(g.inputs[0]), opnd(g.inputs[1])), None
        raise ValueError(f"unsupported arith gate {t}")

    # -- decryption ----------------------------------------------------
    def _decrypt_value(self, ct_blocks: np.ndarray) -> int:
        ph = lwe.decrypt_phase(self.client_key, ct_blocks)
        msgs = lwe.decode_msg(self.params, ph) % 4
        return int(sum(int(m) << (2 * i) for i, m in enumerate(msgs)))

    def _per_vector(self, wires: torch.Tensor, names) -> dict | list:
        host = to_host(wires)
        outs = [
            {w: self._decrypt_value(host[self.wire_index[w], vi]) for w in names}
            for vi in range(host.shape[1])
        ]
        return outs if getattr(self, "_batched", host.shape[1] > 1) else outs[0]

    def decrypt_outputs(self, wires: torch.Tensor) -> dict | list:
        """dict when encrypt_inputs got a single map; list of dicts (one
        per vector, length preserved even at 1) when it got a list."""
        return self._per_vector(wires, self.circuit.output_wires)

    def decrypt_all_wires(self, wires: torch.Tensor) -> dict | list:
        return self._per_vector(wires, self.wire_index)
