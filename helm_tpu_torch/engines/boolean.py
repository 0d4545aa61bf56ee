"""Boolean engines, gates mode and LUT mode, on a torch device.

Counterpart of `helm_tpu/engines/boolean.py`. The wire map is a word
tensor [W, n+1] (or [B, W, n+1] for a batch of B input vectors) on the
engine's device; every level of the level plan (`circuit/plan.py`
`build_plan`) runs as: gather the slot inputs, per-slot linear
combination, ONE batched bootstrap over all slots (`ops.mb_pbs.bootstrap`:
on the card the multi-bit kernel K1, or K6 under HELM_TPU_MB_KERNEL=ps,
for grouping > 1 and the single-bit kernel K2 for grouping 1, on the CPU
their plain torch versions),
scatter, MUX pairs, linear ops. In LUT mode each slot bootstraps with its
own test polynomial (`testv_bank[testv_sel]`, tiled across a batch of
input vectors) and wires carry messages m * delta instead of +-q/8.
Sequential circuits loop `evaluate` per cycle; the READY protocol latches
outputs obliviously (`evaluate_ready`).

Levels run as a Python loop. The wire tensor is cloned once per
`evaluate` call and then updated in place level by level (the reference
donates its buffer instead). Fused level evaluation (`fuse_levels`, the
reference's `lax.scan` over all levels, `_scan_eval_step`) is a CUDA
graph here: on the card a fused engine runs the loop once eagerly, captures
it into one `torch.cuda.CUDAGraph` per batch shape and blind-rotation
route, and replays that graph on every later call. A graph records
launches of any width, so each level keeps its own slot count: the
reference pads every level to one width so that one compiled executable
serves the scan (`_stack_levels`), and each slot bootstraps alone, so the
padding changes no word of a real wire. On the CPU fusing changes
nothing: the loop runs eagerly on the plain versions.

Gate sharding (`set_sharding`, `parallel/mesh.py`): every PBS batch goes
through the mesh's exchange (`mesh.bootstrap_sharded`), the slots of each
level padded to a power of two of at least the mesh size, as in the
reference. A fused engine on a mesh captures the exchange too: the shard
streams fork from and join the capture stream, and an NCCL all-gather is
captured with them; a mesh over several cards of one process, or a gloo
process group, raises at capture (`mesh.check_capturable`).

The reference's TPU-only mechanics are left out: executable caching and
AOT (`cached_jit`), the scan's chunking and crash clamps
(`_max_chunk_levels`, the adaptive segments) and the interpret switch.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from ..circuit.graph import Circuit
from ..circuit.plan import Q8, CircuitPlan, binarize, build_plan, decompose_wide_luts
from ..circuit.verilog import Netlist
from ..fhe import lwe, pbs
from ..fhe.ntt import M32, to_host, words
from ..fhe.server_key import gen_server_key
from ..ops import mb_pbs
from ..parallel import mesh as mesh_mod
from ..params import DEFAULT_GATES, DEFAULT_LUT, Q, TfheParams, warn_if_weak

_PLAN_FIELDS = (
    "slot_in", "slot_coef", "slot_off", "slot_dst",
    "mux_pairs", "mux_dst", "lin_src", "lin_coef", "lin_off", "lin_dst",
)


def _lin_ops(wires, lp):
    """wires[.., lin_dst] = coef * wires[.., lin_src] + off (in place)."""
    n = wires.shape[-1] - 1
    lv = wires[..., lp["lin_src"], :] * lp["lin_coef"][:, None]
    lv[..., n] += lp["lin_off"]
    wires[..., lp["lin_dst"], :] = lv & M32


def _level_step(dsk, wires, lp, testv, mesh=None):
    """One PBS level (boolean.py:33 `_level_body`), updating `wires` in place.
    testv: [1, N] (gates) or one test polynomial per slot [S, N] (LUT);
    mesh: the gate mesh the bootstrap batch is sharded on, or None."""
    n = dsk.params.n
    ins = wires[..., lp["slot_in"], :]  # [.., S, 3, n+1]
    pre = (ins * lp["slot_coef"][..., None]).sum(dim=-2)
    pre[..., n] += lp["slot_off"]
    pre = pre & M32
    lead = pre.shape[:-2]
    pre = pre.reshape(-1, n + 1)
    if testv.shape[0] not in (1, pre.shape[0]):  # a batch: per-slot polys repeat
        testv = testv.repeat(pre.shape[0] // testv.shape[0], 1)
    outs = mesh_mod.bootstrap(mesh, dsk, pre, testv)
    outs = outs.reshape(lead + (-1, n + 1))
    wires[..., lp["slot_dst"], :] = outs
    mval = outs[..., lp["mux_pairs"][:, 0], :] + outs[..., lp["mux_pairs"][:, 1], :]
    mval[..., n] += Q8
    wires[..., lp["mux_dst"], :] = mval & M32
    _lin_ops(wires, lp)


def _ready_step_gates(dsk, ready, new, valid, testv, mesh=None):
    """valid <- mux(READY, new, valid), batched as one bootstrap launch
    (boolean.py:212). ready: [.., n+1]; new/valid: [.., n_out, n+1]."""
    n = dsk.params.n
    off = (-Q8) % Q
    pre1 = ready[..., None, :] + new
    pre1[..., n] += off
    pre2 = valid - ready[..., None, :]
    pre2[..., n] += off
    both = torch.cat([pre1, pre2], dim=-2) & M32
    outs = mesh_mod.bootstrap(mesh, dsk, both.reshape(-1, n + 1), testv).reshape(both.shape)
    k = new.shape[-2]
    res = outs[..., :k, :] + outs[..., k:, :]
    res[..., n] += Q8
    return res & M32


def _ready_step_lut(dsk, ready, new, valid, testv_and, delta, mesh=None):
    """valid <- new*READY + valid*(1-READY) (boolean.py:229), batched as
    one bootstrap launch. ready: [.., n+1]; new/valid: [.., n_out, n+1]."""
    n = dsk.params.n
    not_ready = (0 - ready) & M32
    not_ready[..., n] += delta
    pre1 = 2 * new + ready[..., None, :]
    pre2 = 2 * valid + not_ready[..., None, :]
    both = torch.cat([pre1, pre2], dim=-2) & M32
    outs = mesh_mod.bootstrap(mesh, dsk, both.reshape(-1, n + 1), testv_and).reshape(both.shape)
    k = new.shape[-2]
    return (outs[..., :k, :] + outs[..., k:, :]) & M32


@dataclass
class _LevelGraph:
    """One captured level program: `graph` reads and writes the static
    wire buffer `wires`, and launches the blind-rotation wrapper `rotation`'s
    kernel `launches` times a replay; on a mesh, `shard_launches[s]` of them
    on shard s, and `gathers` all-gathers."""

    graph: "torch.cuda.CUDAGraph"
    wires: torch.Tensor
    rotation: Callable
    launches: int
    mesh: mesh_mod.GateMesh | None = None
    shard_launches: tuple = ()
    gathers: int = 0

    def count_replay(self) -> None:
        """Add one replay's launches (and gathers) to the counters."""
        self.rotation.launches += self.launches
        if self.mesh is not None:
            for s, c in enumerate(self.shard_launches):
                self.mesh.launches[s] += c
            self.mesh.gathers += self.gathers


def _scan_eval_step(run, wires: torch.Tensor, rotation, mesh=None) -> tuple[torch.Tensor, _LevelGraph]:
    """Fused level evaluation on the card: the counterpart of
    `helm_tpu/engines/boolean.py:124` `_scan_eval_step` (and, over
    several cycles, of `_scan_eval_cycles` :166), with a CUDA graph in
    place of `lax.scan`.

    `run(w)` is the level program: it updates the wire tensor `w` in place.
    It first runs eagerly on a copy of `wires` on a side stream: that run's
    words are returned, and it fills the lazy caches a capture may not
    (the kernels' `dlopen`, `mb_pbs.cluster_slots`' occupancy query, the
    key layouts `mb_server_key` / `ts_server_key`, whose pageable
    host-to-device copies are illegal while capturing). Then `run` is
    captured on the same stream over a static wire buffer of `wires`'
    shape. Every kernel argument is baked into the graph: the key's tables
    and the plan's index tensors, which the engine holds, and the
    constants each launch reads on the host (`MbKernelKey.consts`, K6's CRT
    constants), which never change for a key. The capture launches
    nothing, so the launches `rotation` counted while capturing are taken
    back and kept as the graph's `launches`, counted at each replay (and so
    are a mesh's shard launches and all-gathers). A capture that fails
    raises."""
    dev = wires.device
    main = torch.cuda.current_stream(dev)
    out = wires.clone()
    static = torch.empty_like(wires)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)  # after the clone: the side stream reads `out`
    with torch.cuda.stream(side):
        run(out)
    main.wait_stream(side)
    before = rotation.launches
    shards = list(mesh.launches) if mesh is not None else []
    gathers = mesh.gathers if mesh is not None else 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        run(static)
    entry = _LevelGraph(graph, static, rotation, rotation.launches - before)
    rotation.launches = before
    if mesh is not None:
        entry.mesh = mesh
        entry.shard_launches = tuple(c - b for c, b in zip(mesh.launches, shards))
        entry.gathers = mesh.gathers - gathers
        mesh.launches[:], mesh.gathers = shards, gathers
    return out, entry


class BooleanEngine:
    """Gates- or LUT-mode encrypted circuit evaluator on a torch device.

    fuse_levels: True or False forces fused level evaluation (one CUDA
    graph replay a call on the card) on or off; None decides at
    `compile()` by the reference's rule (`fused` holds the decision)."""

    def __init__(
        self,
        mode: str = "gates",
        params: TfheParams | None = None,
        seed=None,
        keys=None,
        device="cuda",
        fuse_levels: bool | None = None,
    ):
        if mode not in ("gates", "lut"):
            raise ValueError(f"unknown mode {mode!r} (gates or lut)")
        self.fuse_levels = fuse_levels
        self.fused = False
        self.replays = 0  # graph replays of fused evaluation, over the engine's life
        self._graphs: dict = {}
        self.mesh: mesh_mod.GateMesh | None = None  # set_sharding
        self._min_slots = 1
        self.mode = mode
        self.device = torch.device(device)
        self.params = params or (DEFAULT_GATES if mode == "gates" else DEFAULT_LUT)
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
        self.plan: CircuitPlan | None = None
        self._testv_gates = words(pbs.gates_test_poly(self.params), self.device)
        if mode == "lut":
            half = self.params.msg_space // 2
            and_tab = np.array([((m >> 1) & 1) & (m & 1) for m in range(half)], np.uint64)
            self._testv_and = words(pbs.lut_test_poly(self.params, and_tab)[None, :], self.device)

    def set_sharding(self, batch_shard, repl_shard) -> None:
        """Enable gate sharding (before compile; `parallel/mesh.py`): every
        PBS batch is split across `batch_shard.mesh`, each level padded to a
        power of two of at least the mesh size; the keys are replicated to
        the mesh's devices here, once. The wires are always replicated (every
        process holds them whole), so `repl_shard` asks for nothing more."""
        if self.plan is not None:
            raise RuntimeError("set_sharding must be called before compile()")
        self.mesh = batch_shard.mesh
        self._min_slots = self.mesh.size
        mesh_mod.key_replicas(self.dsk, self.mesh)

    # -- compilation ---------------------------------------------------
    def compile(self, netlist: Netlist) -> None:
        gates = binarize(netlist.gates)
        if self.mode == "lut":
            gates = decompose_wide_luts(gates)
        circuit = Circuit(gates, netlist.inputs, netlist.outputs, netlist.dff_outputs)
        circuit.sort_circuit()
        circuit.compute_levels()
        # binarize / decompose_wide_luts introduce fresh intermediate wires
        wire_set = set(netlist.wire_set) | {g.output for g in gates}
        self.plan = build_plan(
            circuit, wire_set, self.params, self.mode,
            lut_test_poly_fn=lambda tab: pbs.lut_test_poly(self.params, tab),
            min_slots=self._min_slots,
        )
        dev = self.device

        def t(a):
            a = np.asarray(a)
            # index arrays stay int64; u32 offsets become words
            return torch.from_numpy(a.astype(np.int64)).to(dev)

        self._dev_levels = [
            {f: t(getattr(lp, f)) for f in _PLAN_FIELDS} for lp in self.plan.levels
        ]
        if self.mode == "lut":  # each PBS level's per-slot test polynomials
            bank = words(self.plan.testv_bank, dev) if self.plan.testv_bank is not None else None
            for d, lp in zip(self._dev_levels, self.plan.levels):
                d["testv"] = bank[t(lp.testv_sel)] if lp.num_slots else None
        fuse = self.fuse_levels
        if fuse is None:
            # the reference's auto-rule (boolean.py:354-366), so that the
            # same circuits fuse in both packages: many levels, a narrow
            # widest level and bounded pad waste (the reference pads every
            # level to the widest; the graph does not, but the rule stays)
            lps = self.plan.levels
            S = max(max(lp.slot_in.shape[0] for lp in lps), 1)
            real = max(sum(lp.slot_in.shape[0] for lp in lps), 1)
            fuse = 8 <= len(lps) and S <= 256 and S * len(lps) <= 3 * real
        self.fused = bool(fuse)
        self._graphs = {}  # the graphs read the old plan's tensors

    # -- client role ---------------------------------------------------
    def _encode(self, v) -> np.ndarray:
        if self.mode == "gates":
            return lwe.encode_bool(bool(v))
        return lwe.encode_msg(self.params, int(bool(v)))

    def _decode(self, phase):
        if self.mode == "gates":
            return bool(lwe.decode_bool(phase))
        return int(lwe.decode_msg(self.params, phase))

    def _encrypt_host(self, input_wire_map: dict) -> np.ndarray:
        p = self.params
        wires = np.zeros((self.plan.num_wires, p.n + 1), dtype=np.uint32)
        wires[:, p.n] = self._encode(False)  # trivial encryptions of false / 0
        dummy = not input_wire_map or "dummy" in input_wire_map
        dff = set(self.plan.dff_outputs)
        for w in self.plan.input_wires:
            if w in dff:
                continue
            if dummy:
                val = False
            elif w not in input_wire_map:
                raise KeyError(f'Input wire "{w}" not found in input wires!')
            else:
                val = input_wire_map[w]
            wires[self.plan.wire_index[w]] = lwe.encrypt(self.client_key, self._encode(val))
        for w in self.plan.dff_outputs:
            wires[self.plan.wire_index[w]] = lwe.encrypt(self.client_key, self._encode(False))
        return wires

    def _encrypt_host_batched(self, maps: list) -> np.ndarray:
        """All B maps' input bits in one encryption call (lwe.encrypt_many)."""
        p = self.params
        B, W = len(maps), self.plan.num_wires
        arr = np.zeros((B, W, p.n + 1), dtype=np.uint32)
        arr[:, :, p.n] = self._encode(False)
        dff = set(self.plan.dff_outputs)
        idxs, mus = [], []
        for m in maps:
            dummy = not m or "dummy" in m
            for w in self.plan.input_wires:
                if w in dff:
                    continue
                if dummy:
                    val = False
                elif w not in m:
                    raise KeyError(f'Input wire "{w}" not found in input wires!')
                else:
                    val = m[w]
                idxs.append(self.plan.wire_index[w])
                mus.append(self._encode(val))
            for w in self.plan.dff_outputs:
                idxs.append(self.plan.wire_index[w])
                mus.append(self._encode(False))
        if not idxs:
            return arr
        cts = lwe.encrypt_many(self.client_key, np.asarray(mus))
        per = len(idxs) // B
        for bi in range(B):
            sl = slice(bi * per, (bi + 1) * per)
            arr[bi, np.asarray(idxs[sl])] = cts[sl]
        return arr

    def encrypt_inputs(self, input_wire_map) -> torch.Tensor:
        """Encrypt one input map to [W, n+1], or a list of maps to the
        batched shape [B, W, n+1] (every level then bootstraps B*S slots)."""
        assert self.plan is not None
        if isinstance(input_wire_map, (list, tuple)):
            arr = self._encrypt_host_batched(list(input_wire_map))
        else:
            arr = self._encrypt_host(input_wire_map)
        return words(arr, self.device)

    # -- evaluation ----------------------------------------------------
    def _run_levels(self, wires: torch.Tensor, cycles: int = 1, verbose: bool = False) -> None:
        """`cycles` passes of the level program, updating `wires` in place."""
        total = len(self._dev_levels)
        for _ in range(cycles):
            for i, lp in enumerate(self._dev_levels):
                if lp["slot_in"].shape[0] == 0:
                    _lin_ops(wires, lp)
                else:
                    testv = lp["testv"] if self.mode == "lut" else self._testv_gates
                    _level_step(self.dsk, wires, lp, testv, self.mesh)
                if verbose:
                    ns = self.plan.levels[i].num_slots
                    print(
                        f"  Evaluated gates in level [{i + 1}/{total}]"
                        f" ({ns} PBS slots in one launch)"
                    )

    def _graph_eval(self, wires: torch.Tensor, cycles: int, verbose: bool) -> torch.Tensor:
        """`cycles` passes of the level program on the card as one graph
        replay (`_scan_eval_step`). The graphs are cached by the wires'
        shape (the batch), the cycles and the blind-rotation route
        (`mb_pbs.blind_rotation`, which follows HELM_TPU_MB_KERNEL at every
        call); the first call for a key runs eagerly and captures. Each
        graph, with its memory pool, is kept until the next `compile`."""
        rotation = mb_pbs.blind_rotation(self.params)
        key = (tuple(wires.shape), cycles, rotation)
        total = len(self._dev_levels)
        what = f"all {total} levels" + (f" x {cycles} cycles" if cycles > 1 else "")
        entry = self._graphs.get(key)
        if entry is None:
            if self.mesh is not None:
                mesh_mod.check_capturable(self.mesh, wires.device)
            out, self._graphs[key] = _scan_eval_step(
                lambda w: self._run_levels(w, cycles), wires, rotation, self.mesh
            )
            if verbose:
                g = self._graphs[key].gathers
                print(f"  Evaluated {what} eagerly, then captured them in 1 CUDA graph"
                      + (f" (with its {g} all-gathers)" if g else ""))
            return out
        entry.wires.copy_(wires)
        entry.graph.replay()
        entry.count_replay()
        self.replays += 1
        if verbose:
            print(f"  Evaluated {what} in 1 graph replay")
        return entry.wires.clone()  # the next replay overwrites the static buffer

    def evaluate(self, wires: torch.Tensor, verbose: bool = False) -> torch.Tensor:
        assert self.plan is not None
        if self.fused and wires.device.type == "cuda":
            return self._graph_eval(wires, 1, verbose)
        wires = wires.clone()
        t0 = time.perf_counter()
        self._run_levels(wires, 1, verbose)
        if verbose:
            print(f"  {len(self._dev_levels)} levels enqueued in {time.perf_counter() - t0:.3f} s")
        return wires

    def evaluate_cycles(self, wires: torch.Tensor, cycles: int) -> torch.Tensor:
        """`cycles` sequential cycles. On the card all of them are one graph
        replay (`_scan_eval_step` over cycles x levels), whatever
        `fuse_levels` says, as the reference's `evaluate_cycles` scans them
        in one dispatch (boolean.py:734); the words are those of `cycles`
        `evaluate` calls, since the state advances through the wires (DFF
        copies are plan levels). A circuit with the READY protocol, and
        every circuit on the CPU, loops `evaluate`."""
        assert self.plan is not None
        if wires.device.type == "cuda" and not self.has_ready():
            return self._graph_eval(wires, cycles, False)
        for _ in range(cycles):
            wires = self.evaluate(wires)
        return wires

    # -- READY protocol ------------------------------------------------
    def has_ready(self) -> bool:
        return self.plan is not None and "READY" in self.plan.wire_index

    def init_ready(self, batch: int | None = None) -> torch.Tensor:
        """Trivial false / 0 latches for the output wires."""
        p = self.params
        n_out = len(self.plan.output_wires)
        shape = (n_out, p.n + 1) if batch is None else (batch, n_out, p.n + 1)
        valid = np.zeros(shape, dtype=np.uint32)
        valid[..., p.n] = self._encode(False)
        return words(valid, self.device)

    def evaluate_ready(self, wires: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        idx = torch.tensor(
            [self.plan.wire_index[w] for w in self.plan.output_wires],
            dtype=torch.int64, device=self.device,
        )
        ready = wires[..., self.plan.wire_index["READY"], :]
        new = wires[..., idx, :]
        if self.mode == "gates":
            return _ready_step_gates(self.dsk, ready, new, valid, self._testv_gates, self.mesh)
        return _ready_step_lut(
            self.dsk, ready, new, valid, self._testv_and, self.params.delta, self.mesh
        )

    # -- decryption ----------------------------------------------------
    def decrypt_outputs(self, wires: torch.Tensor, from_valid: bool = False):
        host = to_host(wires)
        if host.ndim == 3:  # batched: one dict per input vector
            return [self._decrypt_outputs_one(h, from_valid) for h in host]
        return self._decrypt_outputs_one(host, from_valid)

    def _decrypt_outputs_one(self, host: np.ndarray, from_valid: bool) -> dict:
        out = {}
        for i, w in enumerate(self.plan.output_wires):
            row = host[i] if from_valid else host[self.plan.wire_index[w]]
            out[w] = self._decode(lwe.decrypt_phase(self.client_key, row))
        return out

    def decrypt_all_wires(self, wires: torch.Tensor):
        """Every wire, not just the outputs."""
        host = to_host(wires)
        if host.ndim == 3:
            return [self._decrypt_all_one(h) for h in host]
        return self._decrypt_all_one(host)

    def _decrypt_all_one(self, host: np.ndarray) -> dict:
        return {
            w: self._decode(lwe.decrypt_phase(self.client_key, host[i]))
            for w, i in self.plan.wire_index.items()
        }
