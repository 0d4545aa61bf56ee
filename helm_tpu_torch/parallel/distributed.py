"""Multi-process runs over `torch.distributed`.

Counterpart of `helm_tpu/parallel/distributed.py`. The reference runs one
JAX process per host (`jax.distributed.initialize`), and its mesh spans
every device of every host. The port runs one process per card, which is
PyTorch's idiom: `num_processes` counts cards (or CPU processes), a rank
takes the card of its place among the ranks of its host, and a mesh under
`init_multihost` has one shard per process, so `--mesh N` with
`--multihost` must equal the world size. The group runs NCCL unless ranks
of one host share a card.

Usage (per process):

    from helm_tpu_torch.parallel import distributed, mesh
    dev = distributed.init_multihost("10.0.0.1:8476", num_processes=4, process_id=RANK)
    engine = BooleanEngine(..., device=dev)
    m = mesh.make_gate_mesh()             # one shard per process
    engine.set_sharding(mesh.batch_sharding(m), mesh.replicated(m))

or through the CLI: `--multihost coordinator:port,num_processes,process_id`
with `--mesh N` (N = num_processes).

Every process encrypts the same inputs under the same keys and seed, so the
wires are replicated and each process decrypts its own copy; the only
collective is the all-gather of each sharded bootstrap batch
(`mesh.bootstrap_sharded`).
"""

from __future__ import annotations

import socket
from datetime import timedelta

import torch

#: seconds a rendezvous or a collective may wait before it fails: a peer
#: that never comes raises instead of hanging the run
TIMEOUT_S = 90


def host_layout(hosts: list[str], rank: int) -> tuple[int, int]:
    """(local rank, local world size) of `rank` among the ranks whose host
    name is its own; `hosts[r]` is rank r's host."""
    local = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return local.index(rank), len(local)


def choose_backend(kind: str, local_world: int, cards: int) -> str:
    """NCCL when every rank of this host has a card of its own, else gloo
    (NCCL refuses two ranks on one device; gloo gathers through the host);
    gloo on the CPU."""
    if kind == "cpu":
        return "gloo"
    return "nccl" if local_world <= cards else "gloo"


def init_multihost(
    coordinator: str, num_processes: int, process_id: int, device="cuda"
) -> torch.device:
    """Join the process group and return this process's device.

    coordinator: "host:port" of process 0 (it serves the rendezvous store).
    Every rank first posts its host name to the store; a rank's place among
    the ranks of its host, its local rank, picks its card,
    `cuda:(local rank % device_count)` (made current), and the backend is
    `choose_backend` of the ranks on this host against its cards. On the
    CPU the backend is gloo. Call once per process, before keygen."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"init_multihost: no backend for {dev}")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda" and cards == 0:
        raise RuntimeError("init_multihost: no CUDA device is available (device='cpu' runs gloo)")
    host, sep, port = coordinator.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"init_multihost: coordinator {coordinator!r} is not host:port")
    timeout = timedelta(seconds=TIMEOUT_S)
    store = torch.distributed.TCPStore(
        host, int(port), num_processes, process_id == 0, timeout=timeout
    )
    store.set(f"helm_host/{process_id}", socket.gethostname())
    hosts = [store.get(f"helm_host/{r}").decode() for r in range(num_processes)]
    local_rank, local_world = host_layout(hosts, process_id)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        choose_backend(dev.type, local_world, cards),
        store=store,
        world_size=num_processes,
        rank=process_id,
        timeout=timeout,
    )
    return dev


def parse_multihost_flag(spec: str) -> tuple[str, int, int]:
    """Parse the CLI's `--multihost coordinator:port,nprocs,pid` value."""
    parts = spec.split(",")
    if len(parts) != 3:
        raise ValueError(
            "--multihost expects coordinator:port,num_processes,process_id"
        )
    return parts[0], int(parts[1]), int(parts[2])
