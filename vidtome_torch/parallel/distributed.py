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

``multihost: true`` fills what the keys leave unset as
``jax.distributed.initialize`` does (:func:`resolve_process_group`), each
value from the first of: the key; ``JAX_COORDINATOR_ADDRESS`` (the
coordinator); torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT``; an Open MPI start (``OMPI_MCA_orte_hnp_uri``); a SLURM
start (``SLURM_JOB_ID``, ``SLURM_STEP_NODELIST``, ``SLURM_NTASKS``,
``SLURM_PROCID``, ``SLURM_LOCALID``).  torchrun comes before the clusters
because ``srun torchrun`` sets both.  jax's Kubernetes detector (it needs
the ``kubernetes`` package) and its Cloud TPU detectors have no
counterpart.  A value still unset raises ``ValueError``; nothing found at
all raises ``RuntimeError``: nothing falls back to one process.  An
implicit call (no keys, not forced) joins torchrun's ranks only, and does
nothing without them.

A rank's card is its start's local rank (:func:`local_rank`), else its
rank modulo the visible cards (:func:`local_card`); ``make_mesh`` uses the
same rule.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

# what torchrun (and torch.distributed.launch) set in every rank
LAUNCHER_MARKERS = ("RANK", "WORLD_SIZE")
OMPI_URI = "OMPI_MCA_orte_hnp_uri"
SLURM_VARS = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
              "SLURM_PROCID", "SLURM_LOCALID")
# each cluster's world size and rank
CLUSTER_RANKS = {"ompi": ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),
                 "slurm": ("SLURM_NTASKS", "SLURM_PROCID")}
# a cluster's coordinator port: jobid-derived, in [65535 - 2**12 + 1, 65535]
CLUSTER_PORT_BASE = 65536 - 2 ** 12


def launched(environ: Mapping[str, str] | None = None) -> bool:
    """Whether a launcher started this process as one rank of several."""
    env = os.environ if environ is None else environ
    return all(m in env for m in LAUNCHER_MARKERS)


def cluster(environ: Mapping[str, str] | None = None) -> str | None:
    """The cluster start jax would detect: "ompi", "slurm" (Open MPI first,
    as jax registers them) or None."""
    env = os.environ if environ is None else environ
    if OMPI_URI in env:
        return "ompi"
    if all(v in env for v in SLURM_VARS):
        return "slurm"
    return None


def ompi_coordinator(uri: str, port: str | None = None) -> str:
    """"ip:port" of an Open MPI launcher URI ("<jobid>.<n>;tcp://ip,..:p" or
    "tcp6://[ip,..]:p"): its first IP, on ``port`` or one derived from the
    job id (jax ``ompi_cluster.py``)."""
    if not port:
        port = str(int(uri.split(".", 1)[0]) // 2 ** 12 % 2 ** 12
                   + CLUSTER_PORT_BASE)
    m = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if m is None:
        raise RuntimeError(f"no launcher IP in {OMPI_URI}={uri!r}")
    return f"{m.group(1) or m.group(2)}:{port}"


def slurm_coordinator(node_list: str, job_id: str,
                      port: str | None = None) -> str:
    """"host:port" of the first host of a SLURM node list ("node001",
    "node001,host2", "node[001-015],host2", "node[001,007-015],host2"), on
    ``port`` or one derived from the job id (jax ``slurm_cluster.py``)."""
    port = port or str(int(job_id) % 2 ** 12 + CLUSTER_PORT_BASE)
    m = re.match(r"([^,\[]*)(?:\[([^,\-\]]*))?", node_list)
    return f"{m.group(1)}{m.group(2) or ''}:{port}"


def local_rank(environ: Mapping[str, str] | None = None) -> int | None:
    """This rank's index among its host's ranks, as its start gives it:
    torchrun's ``LOCAL_RANK``, ``JAX_LOCAL_DEVICE_IDS`` (one id: the port
    runs one process a card), Open MPI's ``OMPI_COMM_WORLD_LOCAL_RANK``,
    SLURM's ``SLURM_LOCALID`` (each cluster's only where jax would detect
    it); None where none applies."""
    env = os.environ if environ is None else environ
    if env.get("LOCAL_RANK"):
        return int(env["LOCAL_RANK"])
    if env.get("JAX_LOCAL_DEVICE_IDS"):
        ids = [int(i) for i in env["JAX_LOCAL_DEVICE_IDS"].split(",")]
        if len(ids) != 1:
            raise ValueError(f"JAX_LOCAL_DEVICE_IDS={ids}: the port runs one "
                             f"process a card, so it names one id")
        return ids[0]
    kind = cluster(env)
    if kind == "ompi":
        return int(env["OMPI_COMM_WORLD_LOCAL_RANK"])
    if kind == "slurm":
        return int(env["SLURM_LOCALID"])
    return None


def local_card(rank: int, world: int, cards: int,
               environ: Mapping[str, str] | None = None) -> int:
    """The card of rank ``rank`` of ``world`` on a host with ``cards``
    visible: its :func:`local_rank`, else ``rank % cards``.  Raises where
    that card is not on this host."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not one of {world}")
    local = local_rank(environ)
    card = rank % cards if local is None and cards else local
    if card is None or not 0 <= card < cards:
        raise ValueError(f"rank {rank} of {world} would take card {card}, but "
                         f"{cards} cards are visible on this host (check "
                         f"CUDA_VISIBLE_DEVICES against the start's local "
                         f"rank)")
    return card


class Start(NamedTuple):
    """Where this process's ranks meet: ``coordinator`` ("host:port", an
    init-method URL, or "env://" for torchrun's variables), the world size,
    this rank, its start's :func:`local_rank` and where each of the first
    three came from ("keys", "env", "torchrun", "ompi", "slurm")."""

    coordinator: str
    world: int
    rank: int
    local: int | None
    sources: dict

    @property
    def init_method(self) -> str:
        if "://" in self.coordinator:
            return self.coordinator
        host, port = self.coordinator.rsplit(":", 1)
        if ":" in host and not host.startswith("["):  # an IPv6 address
            host = f"[{host}]"
        return f"tcp://{host}:{port}"

    def origin(self) -> str:
        """The sources, e.g. "slurm" or "keys (coordinator), slurm (world,
        rank)"."""
        by: dict = {}
        for value, source in self.sources.items():
            by.setdefault(source, []).append(value)
        if len(by) == 1:
            return next(iter(by))
        return ", ".join(f"{s} ({', '.join(v)})" for s, v in by.items())


def resolve_process_group(coordinator: Optional[str] = None,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None,
                          environ: Mapping[str, str] | None = None) -> Start:
    """The :class:`Start` of ``tpu.multihost: true``: each value the keys
    leave unset from ``JAX_COORDINATOR_ADDRESS`` (the coordinator),
    torchrun's variables, then the cluster jax detects (Open MPI, else
    SLURM; ``JAX_COORDINATOR_PORT`` the port of its coordinator).  Raises
    ``RuntimeError`` where nothing says where the ranks are and
    ``ValueError`` naming a value still unset."""
    env = os.environ if environ is None else environ
    values = {"coordinator": coordinator, "world": num_processes,
              "rank": process_id}
    sources = {k: "keys" for k, v in values.items() if v is not None}

    def fill(source: str, **got) -> None:
        for k, v in got.items():
            if values[k] is None and v is not None:
                values[k], sources[k] = v, source

    fill("env", coordinator=env.get("JAX_COORDINATOR_ADDRESS") or None)
    if launched(env):
        fill("torchrun", coordinator="env://", world=int(env["WORLD_SIZE"]),
             rank=int(env["RANK"]))
    kind = cluster(env)
    if kind is not None and None in values.values():
        port = env.get("JAX_COORDINATOR_PORT") or None
        if values["coordinator"] is None:
            fill(kind, coordinator=ompi_coordinator(env[OMPI_URI], port)
                 if kind == "ompi" else slurm_coordinator(
                     env["SLURM_STEP_NODELIST"], env["SLURM_JOB_ID"], port))
        for k, var in zip(("world", "rank"), CLUSTER_RANKS[kind]):
            if values[k] is None:
                fill(kind, **{k: int(env[var])})
    if not sources:
        raise RuntimeError(
            "tpu.multihost: true, but neither tpu.coordinator / "
            "num_processes / process_id, JAX_COORDINATOR_ADDRESS, a "
            "launcher's RANK / WORLD_SIZE, an Open MPI nor a SLURM start "
            "say where the ranks are")
    unset = {"coordinator": "the coordinator (tpu.coordinator, "
                            "JAX_COORDINATOR_ADDRESS)",
             "world": "the number of processes (tpu.num_processes)",
             "rank": "the process id (tpu.process_id)"}
    for k, what in unset.items():
        if values[k] is None:
            raise ValueError(f"tpu.multihost: {what} is unset, and no "
                             f"launcher or cluster start gives it")
    return Start(str(values["coordinator"]), int(values["world"]),
                 int(values["rank"]), local_rank(env), sources)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         force: bool = False) -> bool:
    """Idempotent ``init_process_group``: True when the process group is
    (now) initialised, False when an implicit call found nothing to join.
    ``force`` (``tpu.multihost: true``) resolves the start from the
    arguments ("host:port" or an init-method URL, the world size, the
    rank) and the environment (:func:`resolve_process_group`); an implicit
    call joins torchrun's ranks only."""
    if dist.is_initialized():
        return True
    manual = (coordinator_address, num_processes, process_id)
    env = None
    if not force and all(v is None for v in manual):
        if not launched():
            return False
        env = {k: os.environ[k] for k in (*LAUNCHER_MARKERS, "LOCAL_RANK")
               if k in os.environ}  # torchrun's ranks only
    start = resolve_process_group(*manual, environ=env)
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    where = ""
    if backend == "nccl":
        card = local_card(start.rank, start.world, torch.cuda.device_count())
        torch.cuda.set_device(card)
        where = f", card {card}"
    dist.init_process_group(backend, init_method=start.init_method,
                            world_size=start.world, rank=start.rank)
    print(f"[INFO] multi-host torch.distributed initialized: process "
          f"{start.rank}/{start.world}, backend {backend}{where}, from "
          f"{start.origin()}")
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
