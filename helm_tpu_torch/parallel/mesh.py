"""Multi-device gate sharding.

Counterpart of `helm_tpu/parallel/mesh.py`. The scaling axis is the PBS
batch, as in the reference: the slots of every level (and of every merged
radix round) are split across a 1-D mesh of shards, the keys are
replicated, and the wires stay replicated. Where the reference lets XLA
partition the batch (a sharding constraint, or `shard_map` around its
kernels), the port runs the exchange itself, `bootstrap_sharded`:

1. pad the batch of R slots to a multiple of the mesh size (zero rows);
2. each shard this process owns bootstraps its contiguous block
   (`mb_pbs.bootstrap`: its kernel on a card, the plain version on the CPU)
   on its device, with that device's replica of the server key
   (`key_replicas`) and, on a card, on its own CUDA stream, forked from
   and joined to the caller's stream by events, so that shards on one card
   can overlap;
3. the blocks come back to the wires' device in shard order and, under a
   process group, one all-gather concatenates every process's blocks.

Each slot bootstraps alone, so a sharded evaluation gives the unsharded
words on every real wire (padding slots and the plan's trash wire aside).

Meshes:
- `make_gate_mesh(n, device="cuda")`: the first n cards of this process,
  raising when fewer exist; on "cpu" n virtual shards, run one after
  another (the counterpart of XLA's
  `--xla_force_host_platform_device_count`); after
  `distributed.init_multihost`, one shard per process.
- `GateMesh([torch.device("cuda:0")] * 4)`, built by hand: several shards on
  one card, each on its own stream. Only `make_gate_mesh` refuses repeated
  devices.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..fhe import pbs
from ..fhe.ntt import to_host
from ..ops import mb_pbs


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class GateMesh:
    """A 1-D mesh of shards: `devices` in global shard order (across
    processes), and the process group when there is one. Each process owns
    a contiguous block of `size // world` shards, `local`.

    `launches[s]` counts the blind-rotation kernel launches of shard s (the
    route wrapper's count, so 0 on the CPU) and `gathers` the all-gathers,
    over the mesh's life."""

    def __init__(self, devices, group=None):
        self.devices = [_device(d) for d in devices]
        self.group = group
        if group is None:
            self.world, self.rank = 1, 0
        else:
            self.world = torch.distributed.get_world_size(group)
            self.rank = torch.distributed.get_rank(group)
        if not self.devices or len(self.devices) % self.world:
            raise ValueError(f"{len(self.devices)} shards do not split over {self.world} processes")
        per = len(self.devices) // self.world
        self.local = range(self.rank * per, (self.rank + 1) * per)
        self.launches = [0] * len(self.devices)
        self.gathers = 0
        self._streams: dict[int, torch.cuda.Stream] = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_devices(self) -> list[torch.device]:
        """The distinct devices of this process's shards, in shard order."""
        return list(dict.fromkeys(self.devices[s] for s in self.local))

    def stream(self, s: int) -> "torch.cuda.Stream":
        """Shard s's CUDA stream, made on first use."""
        if s not in self._streams:
            self._streams[s] = torch.cuda.Stream(self.devices[s])
        return self._streams[s]

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        where = "" if self.group is None else f", {self.world} processes ({self.backend()})"
        return f"GateMesh('gates': {self.size} shards [{devs}]{where})"

    def backend(self) -> str | None:
        return None if self.group is None else str(torch.distributed.get_backend(self.group))


def make_gate_mesh(n_devices: int | None = None, device="cuda") -> GateMesh:
    """A mesh over the first n distinct devices of type `device` (all of
    them by default); on "cpu", n virtual shards (1 by default). Under a
    process group (`distributed.init_multihost`), one shard per process,
    each on its process's current card (or the CPU), gathered from every
    rank: n must then be the world size."""
    kind = torch.device(device).type
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        n = n_devices or world
        if n != world:
            raise ValueError(
                f"requested {n} shards under a process group of {world}: the port runs one "
                "process per shard, so --mesh must equal the number of processes"
            )
        mine = str(_device(kind))  # init_multihost made this rank's card current
        devs = [None] * world
        dist.all_gather_object(devs, mine)
        return GateMesh(devs, dist.group.WORLD)
    if kind == "cpu":
        return GateMesh([torch.device("cpu")] * (n_devices or 1))
    if kind != "cuda":
        raise ValueError(f"make_gate_mesh: no mesh of {device!r} devices")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or count
    if count < n or n == 0:
        raise ValueError(f"requested {n} devices, only {count} available")
    return GateMesh([torch.device("cuda", i) for i in range(n)])


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading (slot) axis of a PBS batch split across `mesh`
    (the reference's `NamedSharding(mesh, P("gates"))`)."""

    mesh: GateMesh


@dataclasses.dataclass(frozen=True)
class Replicated:
    """A whole tensor on every shard (`NamedSharding(mesh, P())`)."""

    mesh: GateMesh


def batch_sharding(mesh: GateMesh) -> BatchSharding:
    """PBS batches: shard the leading (gate/slot) axis, replicate the rest."""
    return BatchSharding(mesh)


def replicated(mesh: GateMesh) -> Replicated:
    return Replicated(mesh)


def shard_engine(engine, n_devices: int | None = None, device=None) -> GateMesh:
    """Turn on gate sharding for a Boolean/Arith engine, on a mesh of
    `device`s (default: the engine's device type)."""
    mesh = make_gate_mesh(n_devices, device or engine.device.type)
    engine.set_sharding(batch_sharding(mesh), replicated(mesh))
    return mesh


def gather_host(wires: torch.Tensor, repl_shard=None) -> np.ndarray:
    """The wires on the host. They are replicated on every process (each
    process holds the whole wire tensor), so no gather from other ranks is
    needed."""
    return to_host(wires)


_replicas: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def key_replicas(dsk: pbs.DeviceServerKey, mesh: GateMesh) -> dict:
    """dsk on each distinct device of this process's shards: dsk itself on
    its own device (whose owner builds its layouts), else a copy of its
    tensors there, with the kernels' key layouts built up front on a card
    (`mb_pbs.kernel_layouts`). Made once per key and device."""
    have = _replicas.setdefault(dsk, {})  # the copies only: a value holding dsk would keep it alive
    home = dsk.bsk_ntt.device
    out = {}
    for dev in mesh.local_devices():
        if dev == home:
            out[dev] = dsk
            continue
        if dev not in have:
            rep = dataclasses.replace(
                dsk, device=dev, bsk_ntt=dsk.bsk_ntt.to(dev),
                bsk_ntt_sh=dsk.bsk_ntt_sh.to(dev), ksk_limbs=dsk.ksk_limbs.to(dev),
            )
            if dev.type == "cuda":
                mb_pbs.kernel_layouts(rep)
            have[dev] = rep
        out[dev] = have[dev]
    return out


def check_capturable(mesh: GateMesh, home: torch.device) -> None:
    """Raise unless a CUDA graph captured on `home` can hold `mesh`'s
    exchange: every local shard on `home` (the shard streams fork from and
    join the capture stream) and, under a process group, NCCL (its
    all-gather is captured; gloo's goes through the host)."""
    devs = mesh.local_devices()
    if devs != [home]:
        raise NotImplementedError(
            f"fused evaluation on a mesh whose shards lie on {[str(d) for d in devs]} with the "
            f"wires on {home}: a graph is captured on one card (use fuse_levels=False)"
        )
    if mesh.group is not None and mesh.backend() != "nccl":
        raise NotImplementedError(
            f"fused evaluation under a {mesh.backend()} process group: its all-gather goes "
            "through the host and cannot be captured (use fuse_levels=False, or NCCL)"
        )


def _all_gather(mesh: GateMesh, block: torch.Tensor) -> torch.Tensor:
    """Every process's block, concatenated in rank order."""
    dist = torch.distributed
    if mesh.backend() == "nccl":
        out = block.new_empty((mesh.world * block.shape[0],) + tuple(block.shape[1:]))
        dist.all_gather_into_tensor(out, block, group=mesh.group)
        return out
    host = block.cpu()
    parts = [torch.empty_like(host) for _ in range(mesh.world)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.cat(parts).to(block.device)


def bootstrap_sharded(
    mesh: GateMesh, dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor, testv: torch.Tensor
) -> torch.Tensor:
    """`mb_pbs.bootstrap` of a replicated [R, n+1] batch on `mesh`: the
    exchange of the module docstring. testv is [1, N] (replicated) or one
    polynomial per slot, [R, N] (sharded with the batch). Returns the
    [R, n+1] words on lwe_in's device, on every process."""
    R, width = lwe_in.shape
    per = -(-R // mesh.size)
    pad = per * mesh.size - R
    per_slot = testv.shape[0] == R and R > 1
    if pad:
        lwe_in = torch.cat([lwe_in, lwe_in.new_zeros((pad, width))])
        if per_slot:
            testv = torch.cat([testv, testv[-1:].expand(pad, -1)])
    keys = key_replicas(dsk, mesh)
    rotation = mb_pbs.blind_rotation(dsk.params)
    home = lwe_in.device
    block = lwe_in.new_empty((per * len(mesh.local), width))

    def shard(j: int, s: int) -> None:
        dev = mesh.devices[s]
        rows = slice(s * per, (s + 1) * per)
        x = lwe_in[rows].to(dev)
        tv = (testv[rows] if per_slot else testv).to(dev)
        before = rotation.launches
        out = mb_pbs.bootstrap(keys[dev], x, tv)
        mesh.launches[s] += rotation.launches - before
        block[j * per:(j + 1) * per].copy_(out)

    if home.type == "cuda":
        main = torch.cuda.current_stream(home)
        for j, s in enumerate(mesh.local):
            stream = mesh.stream(s)
            stream.wait_stream(main)  # fork: after the pre-images are written
            with torch.cuda.device(mesh.devices[s]), torch.cuda.stream(stream):
                shard(j, s)
        for s in mesh.local:
            main.wait_stream(mesh.stream(s))  # join: before the block is read
    else:
        for j, s in enumerate(mesh.local):
            shard(j, s)
    if mesh.group is not None:
        block = _all_gather(mesh, block)
        mesh.gathers += 1
    return block[:R]


def bootstrap(mesh: GateMesh | None, dsk: pbs.DeviceServerKey, lwe_in: torch.Tensor,
              testv: torch.Tensor) -> torch.Tensor:
    """One PBS batch: `mb_pbs.bootstrap`, or on a mesh `bootstrap_sharded`."""
    if mesh is None:
        return mb_pbs.bootstrap(dsk, lwe_in, testv)
    return bootstrap_sharded(mesh, dsk, lwe_in, testv)
