"""Ranks for the site-sharded sweep over ``torch.distributed`` (port of
``hmsc_tpu/utils/mesh.py``'s ``make_mesh``).

The JAX package lays a device mesh over one program; here a mesh is one
process a rank, SPMD, talking through ``torch.distributed``.  Start the
ranks with ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) and call
:func:`make_mesh` in each, or from one Python process with
:func:`spawn_ranks`, which starts ``m`` processes with the ``spawn`` start
method and the process group already made.

The backend is chosen, never guessed: ``nccl`` where each rank has a card
of its own, ``gloo`` on the CPU.  Ranks that share one card must ask for
``backend="gloo"`` themselves: gloo stages every collective through host
memory, so such a run checks correctness and says nothing about scaling
across cards.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import traceback
from typing import Any

import torch

__all__ = ["Mesh", "make_mesh", "spawn_ranks"]

# how long make_mesh's process group waits in a collective before it raises
_GROUP_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one sharded run, as seen by this rank: ``site_shards``
    ranks on the site axis (``species_shards`` on the species axis; only 1
    is ported), this process's ``rank``, the ``backend``, the ``device``
    this rank samples on and the process ``group`` (None: the default
    one)."""
    site_shards: int = 1
    species_shards: int = 1
    rank: int = 0
    backend: str | None = None
    device: Any = None
    group: Any = None


def _env_int(name: str, default=None):
    v = os.environ.get(name)
    return default if v is None else int(v)


def make_mesh(site_shards: int = 1, species_shards: int = 1,
              backend: str | None = None, device=None) -> Mesh:
    """This rank's :class:`Mesh` for ``sample_mcmc(mesh=...)``.

    The process group is the one already made (``spawn_ranks``, or a
    caller's ``init_process_group``); else it is made from the
    environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``).  Its size must be ``site_shards x
    species_shards``.  ``device`` defaults to the card when there is one:
    rank ``LOCAL_RANK`` takes card ``LOCAL_RANK % device_count``.
    ``backend=None`` takes ``nccl`` when each rank on the host has a card
    of its own and ``gloo`` on the CPU; ranks that share a card raise
    unless the caller passes ``backend="gloo"``."""
    site_shards, species_shards = int(site_shards), int(species_shards)
    if site_shards < 1 or species_shards < 1:
        raise ValueError(f"site_shards={site_shards} and species_shards="
                         f"{species_shards} must be >= 1")
    world = site_shards * species_shards
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if world == 1:
        return Mesh(1, 1, 0, backend, device)
    import torch.distributed as dist
    local = _env_int("LOCAL_RANK", _env_int("RANK", 0))
    local_size = _env_int("LOCAL_WORLD_SIZE", world)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is available; "
                               "pass device='cpu'")
        own = count >= local_size
        if backend is None:
            if not own:
                raise ValueError(
                    f"make_mesh: {local_size} ranks share {count} card(s); "
                    "NCCL needs a card a rank.  Pass backend='gloo' to run "
                    "them on the shared card (a correctness run: gloo "
                    "stages every collective through host memory)")
            backend = "nccl"
        elif backend == "nccl" and not own:
            raise ValueError(f"make_mesh: backend='nccl' with {local_size} "
                             f"ranks on {count} card(s); NCCL needs a card "
                             "a rank (pass backend='gloo')")
        device = torch.device("cuda", local % count)
    elif backend is None:
        backend = "gloo"
    elif backend != "gloo":
        raise ValueError(f"make_mesh: backend={backend!r} on the CPU; only "
                         "gloo runs there")
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = _env_int("RANK"), _env_int("WORLD_SIZE")
        if rank is None or size is None:
            raise RuntimeError(
                "make_mesh: no process group and no RANK / WORLD_SIZE in "
                "the environment: start the ranks with torchrun or "
                "hmsc_tpu_torch.utils.mesh.spawn_ranks")
    if size != world:
        raise ValueError(f"make_mesh: site_shards x species_shards = "
                         f"{world} but the process group has {size} ranks")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"make_mesh: the process group runs "
                             f"{dist.get_backend()!r}, not {backend!r}")
    else:
        dist.init_process_group(backend, rank=rank, world_size=size,
                                timeout=_GROUP_TIMEOUT)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(site_shards, species_shards, rank, backend, device)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _rank_main(rank, m, backend, device, port, timeout_s, fn, args, queue):
    """A spawned rank: the process group, then ``fn(rank, *args)``; its
    result (or the traceback) goes back through ``queue``."""
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(m),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(m),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=m, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:                    # noqa: BLE001 - reported back
        queue.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, m: int, backend: str = "gloo", device="cpu",
                args: tuple = (), timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``m`` new processes (the ``spawn`` start
    method), one a rank, each with the process group made on
    ``tcp://localhost`` with ``backend``; returns their results in rank
    order.  ``fn`` must be a module-level function (the children import
    its module, nothing else of the caller's).  Each rank's collectives
    time out after ``timeout_s``; a rank that raises makes this raise with
    its traceback, and every process started here is ended before it
    returns."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, m, backend, str(device), port, timeout_s,
                               fn, tuple(args), q), daemon=True)
             for r in range(m)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        while len(results) + len(errors) < m:
            try:
                rank, ok, out = q.get(timeout=timeout_s + 60)
            except queue_mod.Empty:
                errors.append(f"no result within {timeout_s + 60:.0f} s")
                break
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        q.close()
    if errors:
        raise RuntimeError("spawn_ranks: " + "\n".join(errors))
    return [results[r] for r in range(m)]
