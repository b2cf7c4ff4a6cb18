"""Multi-process wiring: ``torch.distributed`` from flags or environment.

Port of ``gstpu/parallel/multihost.py``.  One process is one rank.

- ``init_distributed`` starts the default process group from its
  arguments, else from ``GSTPU_COORDINATOR`` / ``GSTPU_NUM_PROCESSES`` /
  ``GSTPU_PROCESS_ID``; with neither it does nothing, so call sites can
  call it unconditionally.  Before the group starts, every rank publishes
  its host's name and CUDA card count through the rendezvous store
  (``host_table``), and every rank takes the backend and its card from that
  one table: ``nccl`` when every rank has a card of its own (no host runs
  more ranks than it has cards), ``gloo`` when ranks share a card or run on
  the CPU (``choose_backend``).  A rank's card is its index among its
  host's ranks, modulo the host's cards (``local_index``), so the ranks of
  a host need not be numbered contiguously.  NCCL refuses two ranks on one
  device; under gloo the collectives of CUDA tensors go through host memory
  (``parallel/collectives.py``).
- ``shard_rows`` replaces ``put_global``: every rank holds the same full
  array and keeps its slice of axis 0 over the mesh's model axis.
"""

from __future__ import annotations

import datetime
import json
import os
import socket

import torch
import torch.distributed as dist

# How long a rank waits for the others in the rendezvous and in any
# collective before it raises (a rank that died leaves the rest waiting).
TIMEOUT = datetime.timedelta(minutes=10)


def distributed_config(coordinator: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None):
    """``(coordinator, num_processes, process_id)`` from the arguments,
    else from the GSTPU_* environment variables; None without a
    coordinator."""
    coordinator = coordinator or os.environ.get("GSTPU_COORDINATOR")
    if coordinator is None:
        return None
    num_processes = int(num_processes
                        or os.environ.get("GSTPU_NUM_PROCESSES", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("GSTPU_PROCESS_ID", "0"))
    return coordinator, num_processes, process_id


def host_table(store, rank: int, world: int, host: str,
               cards: int) -> list[tuple[str, int]]:
    """Every rank's (host name, CUDA cards it may use), by rank: this rank
    publishes its own through the rendezvous ``store`` and waits for the
    rest."""
    store.set(f"gstpu/host/{rank}", json.dumps([host, cards]))
    keys = [f"gstpu/host/{r}" for r in range(world)]
    store.wait(keys, TIMEOUT)
    return [tuple(json.loads(store.get(k))) for k in keys]


def choose_backend(hosts: list[tuple[str, int]]) -> str:
    """``nccl`` when every rank has a card of its own: every rank sees a
    card and no host runs more ranks than it has cards; else ``gloo``
    (ranks that share a card, or ranks on the CPU).  ``hosts`` is
    ``host_table``'s."""
    for name, cards in hosts:
        ranks_here = sum(1 for h, _ in hosts if h == name)
        if cards == 0 or ranks_here > cards:
            return "gloo"
    return "nccl"


def local_index(hosts: list[tuple[str, int]], rank: int) -> int:
    """This rank's index among the ranks on its host, in rank order."""
    return sum(1 for h, _ in hosts[:rank] if h == hosts[rank][0])


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device=None) -> str | None:
    """Initialize the default process group if a coordinator is given.

    ``coordinator`` is ``host:port`` (a TCP rendezvous on process 0) or an
    init-method URL such as ``file:///path``.  Returns the backend's name,
    or None when running as one process.  On CUDA the rank's card
    ``cuda:{local_index % cards}`` becomes the current device, unless
    ``device`` is the CPU.
    """
    config = distributed_config(coordinator, num_processes, process_id)
    if config is None:
        return None
    coordinator, num_processes, process_id = config
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    store, _, _ = next(dist.rendezvous(url, process_id, num_processes,
                                       timeout=TIMEOUT))
    on_cpu = device is not None and torch.device(device).type == "cpu"
    cards = (torch.cuda.device_count()
             if torch.cuda.is_available() and not on_cpu else 0)
    hosts = host_table(store, process_id, num_processes, socket.gethostname(),
                       cards)
    backend = choose_backend(hosts)
    if cards:
        torch.cuda.set_device(local_index(hosts, process_id) % cards)
    # the group's keys live under a prefix of their own, as
    # init_process_group puts them when it makes the store itself
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg",
                                                            store),
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return backend


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's slice of axis 0 of ``x`` over the mesh's model axis (a
    copy); the length must divide evenly."""
    size, index = mesh.model.size, mesh.model.index
    if x.shape[0] % size:
        raise ValueError(f"{x.shape[0]} rows do not split over {size} ranks")
    n = x.shape[0] // size
    return x[index * n:(index + 1) * n].clone()
