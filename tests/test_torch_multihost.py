"""``tpu.multihost``'s start in the port against ``jax.distributed``'s.

The JAX package hands the keys it has (``tpu.coordinator`` /
``num_processes`` / ``process_id``, ``None`` for the rest) to
``jax.distributed.initialize``, which fills the rest from
``JAX_COORDINATOR_ADDRESS`` / ``JAX_LOCAL_DEVICE_IDS`` and then from the
cluster it detects (Open MPI, then SLURM).  The port's
``resolve_process_group`` must reach the same coordinator, world, rank and
local device as jax's detection in every row of ``JAX_ROWS``; torchrun's
variables come first; a rank's card is one rule (``local_card``) for
``initialize_multihost`` and ``make_mesh``; and the CLI started on two
gloo ranks by a SLURM or an Open MPI environment writes the frames of the
same config started by torchrun's variables, bit for bit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from jax._src.clusters import ClusterEnv

from tests.helpers import make_tiny_video
from tests.torch_ranks import local_rank_rank
from vidtome_torch import testing
from vidtome_torch.io.video import load_video
from vidtome_torch.parallel import distributed as pd
from vidtome_torch.parallel import launch
from vidtome_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
# every variable parallel/distributed.py reads to find a start
START_VARS = (*pd.LAUNCHER_MARKERS, "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "JAX_COORDINATOR_ADDRESS",
              "JAX_COORDINATOR_PORT", "JAX_LOCAL_DEVICE_IDS", pd.OMPI_URI,
              "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_LOCAL_RANK", *pd.SLURM_VARS)
# what jax's Kubernetes and Cloud TPU detectors read
OTHER_CLUSTERS = ("KUBERNETES_SERVICE_HOST", "TPU_WORKER_HOSTNAMES",
                  "TPU_PROCESS_ADDRESSES", "MEGASCALE_COORDINATOR_ADDRESS",
                  "TPU_WORKER_ID", "TPU_SKIP_MDS_QUERY")
CLI_TIMEOUT = 300  # seconds for one start's two ranks
SIZE, N_FRAMES, STEPS = 64, 4, 2

SLURM = {"SLURM_JOB_ID": "1234567", "SLURM_NTASKS": "8",
         "SLURM_PROCID": "5", "SLURM_LOCALID": "1"}
OMPI = {"OMPI_COMM_WORLD_SIZE": "16", "OMPI_COMM_WORLD_RANK": "9",
        "OMPI_COMM_WORLD_LOCAL_RANK": "2"}
URI = "OMPI_MCA_orte_hnp_uri"
TCP = "1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911"
TCP6 = ("1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,"
        "2620:10d:c083:150e::3000:2]:43370")


def slurm(nodes: str, **more) -> dict:
    return {**SLURM, "SLURM_STEP_NODELIST": nodes, **more}


def ompi(uri: str, **more) -> dict:
    return {**OMPI, URI: uri, **more}


# (keys: coordinator, num_processes, process_id; environment)
JAX_ROWS = {
    "slurm one node": ((None, None, None), slurm("node001")),
    "slurm two hosts": ((None, None, None), slurm("node001,host2")),
    "slurm range": ((None, None, None), slurm("node[001-015],host2")),
    "slurm list and range": ((None, None, None),
                             slurm("node[001,007-015],host2")),
    "ompi tcp": ((None, None, None), ompi(TCP)),
    "ompi tcp6": ((None, None, None), ompi(TCP6)),
    "slurm JAX_COORDINATOR_PORT": ((None, None, None), slurm(
        "node001", JAX_COORDINATOR_PORT="12345")),
    "ompi JAX_COORDINATOR_PORT": ((None, None, None), ompi(
        TCP, JAX_COORDINATOR_PORT="12346")),
    "JAX_COORDINATOR_ADDRESS over slurm": ((None, None, None), slurm(
        "node001", JAX_COORDINATOR_ADDRESS="head0:999")),
    "only tpu.coordinator": (("host0:1234", None, None), slurm("node001")),
    "coordinator and world keys": (("host0:1234", 2, None), ompi(TCP)),
    "every key, slurm's local id": (("host0:1234", 8, 3), slurm("node001")),
    "ompi and slurm together": ((None, None, None), {
        **slurm("node001"), **ompi(TCP)}),
    "JAX_LOCAL_DEVICE_IDS": ((None, None, None), slurm(
        "node001", JAX_LOCAL_DEVICE_IDS="3")),
    "JAX_COORDINATOR_ADDRESS and keys": ((None, 4, 0), {
        "JAX_COORDINATOR_ADDRESS": "head0:999"}),
}


@pytest.fixture
def env(monkeypatch):
    """No start's variable and no other cluster's marker in the
    environment; returns a setter of variables."""
    for k in (*START_VARS, *OTHER_CLUSTERS):
        monkeypatch.delenv(k, raising=False)

    def put(values: dict) -> None:
        for k, v in values.items():
            monkeypatch.setenv(k, str(v))
    return put


def jax_detects(coordinator, num_processes, process_id):
    """What ``jax.distributed.initialize`` (jax/_src/distributed.py) passes
    on after its own detection: the environment's coordinator and local
    ids, then the cluster's for what is still unset."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    ids = os.environ.get("JAX_LOCAL_DEVICE_IDS")
    ids = [int(i) for i in ids.split(",")] if ids else None
    return tuple(ClusterEnv.auto_detect_unset_distributed_params(
        coordinator, num_processes, process_id, ids, None, 300))


@pytest.mark.parametrize("row", list(JAX_ROWS), ids=list(JAX_ROWS))
def test_resolver_matches_jax_detection(env, row):
    keys, values = JAX_ROWS[row]
    env(values)
    want = jax_detects(*keys)
    start = pd.resolve_process_group(*keys)
    local = None if start.local is None else [start.local]
    assert (start.coordinator, start.world, start.rank, local) == want
    assert None not in want[:3]


def test_ompi_wins_over_slurm_and_derives_ports(env, monkeypatch):
    """The derived ports, and the sources named on the start line."""
    env({**slurm("node[001,007-015],host2"), **ompi(TCP)})
    start = pd.resolve_process_group()
    port = 1531576320 // 4096 % 4096 + 61440
    assert start.coordinator == f"10.96.0.1:{port}"
    assert start.init_method == f"tcp://10.96.0.1:{port}"
    assert (start.world, start.rank, start.local) == (16, 9, 2)
    assert start.origin() == "ompi"
    env({URI: TCP6})
    assert pd.resolve_process_group().init_method.startswith(
        "tcp://[fe80::b9b:ac5d:9cf0:b858]:")
    monkeypatch.delenv(URI)
    start = pd.resolve_process_group("host0:1234")
    assert start.coordinator == "host0:1234"
    assert start.origin() == "keys (coordinator), slurm (world, rank)"
    assert pd.slurm_coordinator("node[001,007-015],host2", "4097") == \
        "node001:61441"


def test_torchrun_comes_before_slurm(env):
    """``srun torchrun`` sets both: torchrun's variables win, the
    coordinator its ``MASTER_ADDR`` / ``MASTER_PORT`` (env://)."""
    env({**slurm("node001"), "RANK": 3, "WORLD_SIZE": 4, "LOCAL_RANK": 3,
         "MASTER_ADDR": "node001", "MASTER_PORT": 29500})
    start = pd.resolve_process_group()
    assert (start.init_method, start.world, start.rank, start.local) == (
        "env://", 4, 3, 3)
    assert start.origin() == "torchrun"


def test_nothing_found_and_unset_values_raise(env):
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="say where the ranks are"):
        pd.resolve_process_group()
    with pytest.raises(RuntimeError, match="say where the ranks are"):
        pd.initialize_from_config({"multihost": True})
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="number of processes"):
        pd.resolve_process_group("host0:1234")
    with pytest.raises(ValueError, match="process id"):
        pd.resolve_process_group("host0:1234", 2)
    with pytest.raises(ValueError, match="coordinator"):
        pd.resolve_process_group(None, 2, 0)
    env({"JAX_LOCAL_DEVICE_IDS": "0,1", "JAX_COORDINATOR_ADDRESS": "h:1"})
    with pytest.raises(ValueError, match="one process a card"):
        pd.resolve_process_group(None, 2, 0)
    # an implicit call joins torchrun's ranks only
    env(slurm("node001"))
    assert pd.initialize_multihost() is False
    assert not dist.is_initialized()


# (rank, world, environment, visible cards, the card or the error)
CARD_ROWS = {
    "manual keys, rank 5 of 8 on 4 cards": (5, 8, {}, 4, 1),
    "one rank, one card": (0, 1, {}, 1, 0),
    "torchrun": (6, 8, {"LOCAL_RANK": "2"}, 4, 2),
    "JAX_LOCAL_DEVICE_IDS": (5, 8, {"JAX_LOCAL_DEVICE_IDS": "3"}, 4, 3),
    "ompi": (9, 16, ompi(TCP), 4, 2),
    "slurm": (5, 8, slurm("node001"), 4, 1),
    "SLURM_LOCALID outside a SLURM start": (6, 8, {"SLURM_LOCALID": "0"}, 4,
                                            2),
    "ompi before slurm": (5, 8, {**slurm("node001"), **ompi(TCP)}, 4, 2),
    "LOCAL_RANK before slurm": (5, 8, {**slurm("node001"),
                                       "LOCAL_RANK": "0"}, 4, 0),
    "JAX_LOCAL_DEVICE_IDS before ompi": (
        9, 16, ompi(TCP, JAX_LOCAL_DEVICE_IDS="1"), 4, 1),
    "a local rank past the cards": (4, 8, {"LOCAL_RANK": "4"}, 4,
                                    "would take card 4"),
    "several JAX_LOCAL_DEVICE_IDS": (0, 2, {"JAX_LOCAL_DEVICE_IDS": "0,1"},
                                     4, "one process a card"),
    "a rank outside the world": (8, 8, {}, 4, "not one of 8"),
    "no card": (0, 1, {}, 0, "0 cards are visible"),
}


@pytest.mark.parametrize("row", list(CARD_ROWS), ids=list(CARD_ROWS))
def test_card_of_a_rank(row):
    rank, world, environ, cards, want = CARD_ROWS[row]
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            pd.local_card(rank, world, cards, environ)
    else:
        assert pd.local_card(rank, world, cards, environ) == want


@pytest.mark.parametrize("start", ["keys", "torchrun", "ompi", "slurm"])
def test_mesh_and_process_group_take_one_card(env, monkeypatch, start):
    """``initialize_multihost`` and ``make_mesh`` (no ``devices``) put rank
    5 of 8 on the same card of a 4-card host, whatever started it; the
    mesh no longer refuses a global rank past the host's cards.  The card
    calls and the process group are recorded, not made."""
    import torch.distributed as dist

    env({"torchrun": {"RANK": 5, "WORLD_SIZE": 8, "LOCAL_RANK": 1,
                      "MASTER_ADDR": "h", "MASTER_PORT": 1},
         "ompi": ompi(TCP, OMPI_COMM_WORLD_SIZE=8, OMPI_COMM_WORLD_RANK=5,
                      OMPI_COMM_WORLD_LOCAL_RANK=1),
         "slurm": slurm("node001"), "keys": {}}[start])
    cards, groups = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: cards.append(torch.device("cuda", d)
                                               if isinstance(d, int) else d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: groups.append((a, kw)))
    keys = ("h:1", 8, 5) if start == "keys" else (None, None, None)
    assert pd.initialize_multihost(*keys, force=True) is True
    assert groups[0][0] == ("nccl",)
    assert groups[0][1]["world_size"] == 8 and groups[0][1]["rank"] == 5
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 5)
    monkeypatch.setattr(dist, "new_group", lambda ranks: tuple(ranks))
    mesh = make_mesh(2, 4)
    assert mesh.device == torch.device("cuda", 1)
    assert cards == [torch.device("cuda", 1)] * 2
    assert mesh.groups["model"] == (4, 5, 6, 7)


@pytest.mark.parametrize("start", ["slurm", "ompi"])
def test_a_cluster_start_never_spawns_ranks(env, monkeypatch, start):
    """``run_entry`` under ``multihost`` runs the stage in this process (the
    cluster started the ranks); without it a mesh still starts its own, as
    before."""
    env(testing.start_env(start, 2, 0, pd.CLUSTER_PORT_BASE))
    spawned, ran = [], []
    monkeypatch.setattr(launch, "spawn", lambda *a, **kw: spawned.append(a))
    launch.run_entry(ran.append, {"mesh": {"data": 2}, "multihost": True},
                     ("stage",), "cpu")
    assert ran == ["stage"] and spawned == []
    launch.run_entry(ran.append, {"mesh": {"data": 2}}, ("stage",), "cpu")
    assert ran == ["stage"] and len(spawned) == 1


def test_spawned_ranks_set_their_local_rank(env, tmp_path):
    """Ranks that ``spawn`` starts inside a cluster's task (which set
    SLURM_LOCALID 0 for the task) each take their own local rank."""
    env(testing.start_env("slurm", 1, 0, pd.CLUSTER_PORT_BASE))
    launch.spawn(local_rank_rank, 2, (str(tmp_path),), ["cpu", "cpu"],
                 timeout=120, collective_timeout=120)
    for rank in range(2):
        assert (tmp_path / f"{rank}.txt").read_text() == str(rank)


RANK_CODE = """
import sys
import torch
torch.set_num_threads(2)
from vidtome_torch import cli
cli.main(sys.argv[1:], device="cpu")
"""


def _config(root: Path, video: str, name: str) -> list[str]:
    """The tiny stack's edit (random weights, seeded alike in every rank;
    merging on) on two ranks of ``tpu.multihost``, its files under
    ``root/name``."""
    work = root / name
    cfg = {
        "sd_version": "tiny", "input_path": video, "work_dir": str(work),
        "height": SIZE, "width": SIZE, "seed": 123,
        "float_precision": "fp32",
        "inversion": {
            "save_path": str(work / "latents"), "prompt": "a gradient",
            "steps": STEPS, "save_steps": STEPS, "batch_size": 4,
            "n_frames": N_FRAMES, "force": False, "recon": False},
        "generation": {
            "guidance_scale": 7.5, "n_timesteps": STEPS,
            "prompt": {"edit": "a gradient, oil painting"},
            "latents_path": str(work / "latents"),
            "output_path": str(work / "out"), "chunk_size": 4,
            "local_merge_ratio": 0.9, "merge_global": True,
            "save_frame": True, "frame_range": [N_FRAMES]},
        "tpu": {"mesh": {"data": 2}, "multihost": True}}
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return ["--config", str(path)]


def _start(kind: str, argv: list[str], logs: Path) -> list[str]:
    """``cli.main`` in two processes of ``kind``'s simulated start; their
    logs, after both exited 0 within CLI_TIMEOUT."""
    port = (launch.free_port() if kind == "torchrun"
            else testing.cluster_ports()[0])
    base = {k: v for k, v in os.environ.items() if k not in START_VARS}
    procs = []
    for rank in range(2):
        with open(logs / f"{kind}.{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_CODE, *argv], cwd=ROOT,
                env={**base, **testing.start_env(kind, 2, rank, port)},
                stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=CLI_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = [(logs / f"{kind}.{r}.log").read_text() for r in range(2)]
    for p, text in zip(procs, out):
        assert p.returncode == 0, text[-4000:]
    return out


def test_cli_under_slurm_and_ompi_matches_torchrun(tmp_path):
    """Two gloo ranks of ``python -m vidtome_torch.cli``'s ``main`` at
    {data: 2}, started by a SLURM and by an Open MPI environment: each rank
    prints its start line, rank 0 writes the frames and latents of the
    start by torchrun's variables, bit for bit."""
    video = make_tiny_video(str(tmp_path / "video"), n_frames=N_FRAMES,
                            size=SIZE)
    frames, latents = {}, {}
    for kind in ("torchrun", "slurm", "ompi"):
        logs = tmp_path / "logs"
        logs.mkdir(exist_ok=True)
        out = _start(kind, _config(tmp_path, video, kind), logs)
        for rank, text in enumerate(out):
            assert (f"torch.distributed initialized: process {rank}/2, "
                    f"backend gloo, from {kind}") in text, text[-2000:]
            assert (f"device mesh: {{'data': 2, 'model': 1}} (rank {rank}"
                    in text)
        work = tmp_path / kind
        frames[kind] = load_video(str(work / "out" / "edit" / "frames"),
                                  SIZE, SIZE)
        latents[kind] = {p.name: np.load(p) for p in
                         (work / "latents").rglob("noisy_latents_*.npy")}
    assert frames["torchrun"].shape == (N_FRAMES, SIZE, SIZE, 3)
    assert latents["torchrun"]
    for kind in ("slurm", "ompi"):
        assert np.array_equal(frames[kind], frames["torchrun"]), kind
        assert sorted(latents[kind]) == sorted(latents["torchrun"])
        for name, want in latents["torchrun"].items():
            assert np.array_equal(latents[kind][name], want), (kind, name)
