"""The ranks of a mesh on one host, started together.

``spawn(fn, world, args)`` runs ``fn(*args)`` in ``world`` new processes
(the ``spawn`` start method: each imports ``fn`` afresh), rank ``r`` on
``devices[r]``, joined by one process group on a free localhost port:
NCCL where every rank has a card of its own, gloo where ranks share one or
run on the CPU.  It waits for every rank; a rank that raises raises here,
with its traceback, and the others are stopped.  The stage entry points
start their ranks through it when ``tpu.mesh`` asks for more than one
(:func:`run_entry`); under torchrun or ``tpu.multihost`` (a SLURM or an
Open MPI start among them) they join the ranks that started them instead.
Each rank it starts has its ``LOCAL_RANK`` set, as a launcher's has.
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vidtome_torch.parallel.distributed import launched
from vidtome_torch.parallel.mesh import default_devices, mesh_size


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_for(devices) -> str:
    """NCCL where every rank has a card of its own, else gloo (the CPU, or
    ranks that share a card: NCCL refuses two ranks on one device)."""
    devices = [torch.device(d) for d in devices]
    cards = all(d.type == "cuda" for d in devices)
    return "nccl" if cards and len(set(devices)) == len(devices) else "gloo"


def rank_devices(n: int, kind: str = "cuda") -> list[torch.device]:
    """Devices for ``n`` ranks: the CPU for each (``kind`` "cpu"), else a
    card each where ``n`` are visible, else card 0 for all (shared over
    gloo: one card can still run a mesh, at host-memory collectives)."""
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def _rank_main(rank: int, fn, world: int, init_method: str, backend: str,
               devices: list[str], timeout_s: float | None, args) -> None:
    # the ranks' local rank, as a launcher sets it: a SLURM_LOCALID or
    # OMPI_COMM_WORLD_LOCAL_RANK inherited from a cluster start would give
    # every rank the same card (distributed.local_card)
    os.environ["LOCAL_RANK"] = str(rank)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # ranks on the CPU share its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kw)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), devices=None,
          timeout: float | None = None,
          collective_timeout: float | None = None) -> None:
    """Run ``fn(*args)`` in ``world`` ranks (see the module docstring);
    ``devices`` one a rank (default: the visible cards, else the CPU).
    ``timeout`` bounds the wait (the ranks are killed, then TimeoutError),
    ``collective_timeout`` every collective of the process group."""
    devices = [str(d) for d in (default_devices(world) if devices is None
                                else devices)][:world]
    if len(devices) < world:
        raise ValueError(f"need {world} devices for {world} ranks, have "
                         f"{len(devices)}")
    backend = backend_for(devices)
    init_method = f"tcp://localhost:{free_port()}"
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, init_method, backend, devices,
                          collective_timeout, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=None if deadline is None
                       else max(0.0, deadline - time.monotonic())):
        if deadline is not None and time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{world} ranks of {fn.__qualname__} did not "
                               f"finish within {timeout} s")


def run_entry(fn, tpu_cfg, args: tuple = (), device=None,
              timeout: float | None = None) -> None:
    """A stage entry point: ``fn(*args)`` here, or in the ranks of
    ``tpu.mesh`` when it asks for more than one and no process group or
    launcher holds this process (rank r on card r, or on the CPU when
    ``device`` is the CPU); ``timeout`` seconds bound the ranks' run and
    each of their collectives (:func:`spawn`)."""
    n = mesh_size(tpu_cfg)
    multihost = bool((tpu_cfg or {}).get("multihost"))
    if n == 1 or dist.is_initialized() or launched() or multihost:
        fn(*args)
        return
    devices = None
    if device is not None and torch.device(device).type != "cuda":
        devices = [device] * n
    print(f"[INFO] starting {n} ranks for tpu.mesh "
          f"{dict(tpu_cfg['mesh'])}")
    spawn(fn, n, args, devices, timeout=timeout, collective_timeout=timeout)
