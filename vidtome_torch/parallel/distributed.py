"""The process group of a mesh that spans hosts, or that a launcher started.

Counterpart of ``vidtome_tpu/parallel/distributed.py``.  JAX's
multi-process runtime (``jax.distributed.initialize``) makes one program
see the devices of every host; the port's ranks are processes, one a card,
joined by ``torch.distributed.init_process_group`` (NCCL on the cards,
gloo on the CPU).

Config surface (the JAX package's keys):

  tpu:
    multihost: true            # join (or start) the process group
    coordinator: "host0:1234"  # init_method tcp://host0:1234
    num_processes: 4           # world_size
    process_id: 0              # rank

Without the three manual keys a launcher's environment applies
(torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
``LOCAL_RANK`` picks the card).  An implicit call (no keys, not forced)
does nothing unless those markers are set; ``multihost: true`` that cannot
initialise raises, as JAX's ``force`` does.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

# what torchrun (and torch.distributed.launch) set in every rank
LAUNCHER_MARKERS = ("RANK", "WORLD_SIZE")


def launched() -> bool:
    """Whether a launcher started this process as one rank of several."""
    return all(m in os.environ for m in LAUNCHER_MARKERS)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         force: bool = False) -> bool:
    """Idempotent ``init_process_group``: True when the process group is
    (now) initialised, False when an implicit call found nothing to join.
    The three manual arguments go together (``coordinator_address``
    "host:port" or an init-method URL); without them a launcher's
    environment is read (``env://``); ``force`` (``tpu.multihost: true``)
    raises where neither says where the ranks are."""
    if dist.is_initialized():
        return True
    manual = (coordinator_address, num_processes, process_id)
    if not force and all(v is None for v in manual) and not launched():
        return False
    if any(v is not None for v in manual):
        if any(v is None for v in manual):
            raise ValueError("tpu.coordinator, tpu.num_processes and "
                             "tpu.process_id go together")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    elif launched():
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        raise RuntimeError(
            "tpu.multihost: true, but neither tpu.coordinator / "
            "num_processes / process_id nor a launcher's RANK / WORLD_SIZE "
            "say where the ranks are")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    print(f"[INFO] multi-host torch.distributed initialized: process "
          f"{rank}/{world}, backend {backend}")
    return True


def initialize_from_config(tpu_cfg: Any) -> bool:
    """Wire ``tpu.multihost`` (+ the optional manual coordinator fields);
    without it, join a launcher's ranks where there are any."""
    if not tpu_cfg or not tpu_cfg.get("multihost"):
        return initialize_multihost()
    np_ = tpu_cfg.get("num_processes")
    pid = tpu_cfg.get("process_id")
    return initialize_multihost(
        coordinator_address=tpu_cfg.get("coordinator"),
        num_processes=int(np_) if np_ is not None else None,
        process_id=int(pid) if pid is not None else None,
        force=True)
