"""The tiny model bundle of tests and dry runs (counterpart of
``vidtome_tpu/testing.py``).

The same module classes and pipeline code paths as the full SD bundles,
shrunk: ``TINY_UNET``, ``TINY_TEXT``, a VAE of (8, 8, 8, 8) channels with
one layer a block, and ``HashTokenizer(1000, 16)``, with random weights
drawn from seeds 0 (UNet), 1 (VAE) and 2 (text encoder), as the JAX
package's tiny bundle draws them.  Also the environment of a simulated
SLURM, Open MPI or torchrun start (:func:`start_env`)."""

from __future__ import annotations

import os
import socket

import torch

from vidtome_torch.models.registry import ModelBundle, init_model
from vidtome_torch.parallel.distributed import CLUSTER_PORT_BASE, OMPI_URI


def make_tiny_bundle(dtype: torch.dtype | None = None,
                     device: str | torch.device = "cpu") -> ModelBundle:
    """The tiny stack on ``device`` in ``dtype`` (default fp32), under the
    JAX tiny bundle's model key."""
    dtype = dtype or torch.float32
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the port's weights are fp32 or bf16, not {dtype}")
    bundle = init_model("tiny", weight_dtype=(
        "bf16" if dtype == torch.bfloat16 else "fp32"), device=device)
    bundle.model_key = "tiny-test-model"
    return bundle


def cluster_ports(n: int = 1) -> list[int]:
    """``n`` TCP ports that nothing listens on now, in the range SLURM's
    and Open MPI's job ids map their coordinator to
    (``distributed.CLUSTER_PORT_BASE`` and up): the ports of simulated
    cluster starts (:func:`start_env`)."""
    first = os.getpid() % 2 ** 12  # concurrent callers start apart
    ports = []
    for i in range(2 ** 12):
        port = CLUSTER_PORT_BASE + (first + i) % 2 ** 12
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("", port))
            except OSError:
                continue
        ports.append(port)
        if len(ports) == n:
            return ports
    raise RuntimeError(f"no {n} free ports in the cluster range")


def start_env(kind: str, world: int, rank: int, port: int) -> dict:
    """The variables that ``kind``'s start sets in rank ``rank`` of
    ``world`` ranks on this one host, its coordinator on localhost:``port``
    (one of :func:`cluster_ports` for the clusters, which derive it from their
    job ids): "slurm" (``srun``), "ompi" (``mpirun``) or "torchrun"."""
    job = port - CLUSTER_PORT_BASE
    if kind == "slurm":
        return {"SLURM_JOB_ID": str(job), "SLURM_STEP_NODELIST": "localhost",
                "SLURM_NTASKS": str(world), "SLURM_PROCID": str(rank),
                "SLURM_LOCALID": str(rank)}
    if kind == "ompi":
        return {OMPI_URI: f"{job * 2 ** 12}.0;tcp://127.0.0.1:{port}",
                "OMPI_COMM_WORLD_SIZE": str(world),
                "OMPI_COMM_WORLD_RANK": str(rank),
                "OMPI_COMM_WORLD_LOCAL_RANK": str(rank)}
    if kind == "torchrun":
        return {"RANK": str(rank), "WORLD_SIZE": str(world),
                "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(port)}
    raise ValueError(f"unknown start {kind!r}")

