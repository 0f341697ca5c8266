"""End-to-end CLI of the port: invert, then generate, on a CUDA device.

    python -m vidtome_torch.cli --config configs/demo.yaml

Takes the same YAML as ``python -m vidtome_tpu.cli``, read by the port's
own config loader (``vidtome_torch.config``), with the port's own video and
artifact I/O (``vidtome_torch.io``).  A ControlNet control (for example
``configs/demo-canny.yaml``) loads the ControlNet named by
``generation.control`` from the top-level ``controlnet_root`` (random,
warned, without one), and generation reads the clip's frames to make their
control images, cached under ``<work_dir>/<control>_image/``.  On
SD2-depth (``sd_version: depth``, for example ``configs/flamingo.yaml``)
both stages read the clip's depth latents through ``<work_dir>/depth/``;
``generation.use_lora`` merges ``generation.lora.path`` into the model when
the generation stage is built (``configs/breakdance.yaml``).  ``sd_version:
xl`` runs SDXL (its latents under ``<save_path>/stable-diffusion-xl-base-1.0``),
and ``generation.refiner`` (for example ``{sd_version: xl-refiner,
denoising_start: 0.8}``) hands the last steps of every edit to the SDXL
refiner.  The inversion writes the per-frame prompts beside the latents
(``inversion_prompts.txt``).

Each stage also runs alone, through the same preamble
(:func:`setup_from_argv`), as in the JAX package:

    python -m vidtome_torch.pipeline.inverter  --config configs/demo.yaml
    python -m vidtome_torch.pipeline.generator --config configs/demo.yaml

the generation from the latents a prior inversion cached.  The ``tpu``
section: ``profile_dir`` traces the inversion stage and the denoising
loop (``torch.profiler``, ``Inverter.__call__`` and
``Generator.ddim_sample``, a file each); ``mesh`` (``{data: D, model: M}``) runs both
stages on D x M ranks, one process a card (``parallel/``): an entry point
starts the ranks itself (``parallel/launch.run_entry``) unless torchrun
or ``multihost`` (``coordinator`` / ``num_processes`` / ``process_id``,
each unset one from torchrun, an Open MPI or a SLURM start:
``parallel/distributed.py``) started them; rank 0 alone writes the
latents, the prompt file, the frames and the video.
``use_pallas_attention`` selects nothing (the card always runs the port's
kernels).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from vidtome_torch.config import load_config, save_config
from vidtome_torch.io import artifacts
from vidtome_torch.io.video import load_video, save_frames, save_video
from vidtome_torch.logging_utils import get_logger, timed
from vidtome_torch.models.registry import init_model
from vidtome_torch.parallel.distributed import initialize_from_config
from vidtome_torch.parallel.launch import run_entry
from vidtome_torch.parallel.mesh import mesh_from_config, shard_bundle
from vidtome_torch.pipeline.common import get_frame_ids, stage_depth
from vidtome_torch.pipeline.generator import Generator
from vidtome_torch.pipeline.inverter import Inverter
from vidtome_torch.utils import seed_everything


def writes(bundle) -> bool:
    """Whether this process writes the stages' files: rank 0 of the
    bundle's mesh, or the only process."""
    return bundle.mesh is None or bundle.mesh.rank == 0


def setup_from_argv(argv=None, device=None):
    """The stages' shared preamble (JAX ``cli.py:18-49``): the config of
    ``--config``; the process group of ``tpu.multihost`` (or of a
    launcher) and the mesh of ``tpu.mesh`` over it, this rank's device
    then the mesh's; the model bundle of ``sd_version`` / ``model_key`` /
    ``generation.control`` / ``float_precision`` / ``controlnet_root`` on
    ``device`` (the card unless the caller passes another), sharded on the
    mesh; ``config["model_key"]`` set to the bundle's and the host RNGs
    seeded.  Returns (config, bundle); ``bundle.mesh`` is the mesh."""
    config = load_config(argv, print_config=not dist.is_initialized()
                         or dist.get_rank() == 0)
    tpu = config.get("tpu", None)
    # the process group first: the mesh is built over its ranks
    initialize_from_config(tpu)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("vidtome_torch runs on a CUDA device; none "
                             "found")
        device = "cuda"
    mesh = mesh_from_config(tpu, device)
    if mesh is not None:
        device = mesh.device
        print(f"[INFO] device mesh: {mesh.shape} (rank {mesh.rank}: data "
              f"{mesh.data_rank}, model {mesh.model_rank}, on {device})")
    with timed("model load"):
        bundle = init_model(
            sd_version=str(config.get("sd_version", "1.5")),
            model_key=config.get("model_key", None),
            weight_dtype=str(config.get("float_precision", "bf16")),
            device=device, seed=int(config.get("seed", 123)),
            control=str(config["generation"].get("control", "none")),
            controlnet_root=config.get("controlnet_root", None))
    if mesh is not None:
        shard_bundle(bundle, mesh)
    config["model_key"] = bundle.model_key
    seed_everything(int(config.get("seed", 123)))
    return config, bundle


def run_inversion(config, bundle):
    inv_cfg = config["inversion"]
    inverter = Inverter(bundle, config)
    save_dir = artifacts.get_latents_dir(inv_cfg["save_path"], bundle.model_key)
    os.makedirs(save_dir, exist_ok=True)
    ts = [int(inverter.scheduler.timesteps[0])]
    if inverter.save_intermediate:
        ts += sorted(inverter.timesteps_to_save)
    if (artifacts.check_latents_exist(save_dir, ts)
            and not inv_cfg.get("force", False)):
        print(f"[INFO] inverted latents exist at: {save_dir}. Skip inversion!")
        return None
    frames = load_video(config["input_path"], int(config["height"]),
                        int(config["width"]))
    if inverter.n_frames is not None:
        frames = frames[: int(inverter.n_frames)]

    writer = writes(bundle)

    def save_latent(t, x):
        if writer:
            artifacts.save_latent(save_dir, t, x.float().cpu().numpy())

    if writer:  # the per-frame prompts beside the latents (JAX
        # inverter.py:432-436)
        with open(os.path.join(save_dir, "inversion_prompts.txt"), "w") as f:
            f.write("\n".join(inverter.prompts(len(frames))))
    inverted, recon = inverter(frames, save_latent)
    if writer:
        path = artifacts.save_latent(save_dir, ts[0],
                                     inverted.float().cpu().numpy())
        print(f"[INFO] inverted latent saved to: {path}")
        save_config(config, save_dir, inv=True)
        if recon is not None:
            save_frames(recon.cpu().numpy(),
                        os.path.join(save_dir, "recon_frames"))
    if bundle.mesh is not None:  # the other ranks read what rank 0 wrote
        bundle.mesh.barrier()
    return inverted


def run_generation(config, bundle):
    gene = config["generation"]
    generator = Generator(bundle, config)
    frame_ids = get_frame_ids(gene.get("frame_range", None),
                              gene.get("frame_ids", None))
    latents_dir = artifacts.get_latents_dir(gene["latents_path"],
                                            bundle.model_key)
    # PnP reads the inversion latents of every generation timestep (JAX
    # generator.py:966-971, :1010-1019)
    ts = [int(t) for t in generator.scheduler.timesteps]
    if not generator.use_pnp:
        ts = ts[:1]
    if not artifacts.check_latents_exist(latents_dir, ts):
        raise FileNotFoundError(
            f"Required latents not found at {latents_dir}. Note: PnP needs "
            f"inversion latents saved at every generation timestep "
            f"(inversion.save_intermediate).")
    table = torch.from_numpy(np.stack([
        artifacts.load_latent(latents_dir, t, frame_ids=frame_ids)
        for t in ts]))
    control = depth = None
    if generator.use_controlnet or generator.use_depth:
        frames = load_video(config["input_path"], int(config["height"]),
                            int(config["width"]), frame_ids=frame_ids)
        if generator.use_controlnet:
            control = generator.load_control(frames, frame_ids,
                                             config["work_dir"])
        if generator.use_depth:
            depth = stage_depth(generator.bundle, frames, frame_ids,
                                config["work_dir"])
    outputs = generator(table[0],
                        src_table=table if generator.use_pnp else None,
                        control=control, depth=depth)
    for name, frames in outputs.items() if writes(bundle) else ():
        out_dir = os.path.join(gene["output_path"], name)
        save_config(config, out_dir, gene=True)
        save_video(frames.cpu().numpy(), out_dir,
                   save_frame=bool(gene.get("save_frame", False)))
    return outputs


def run_both(config, bundle):
    """Both stages, each timed, and their wall time."""
    t0 = time.perf_counter()
    with timed("inversion"):
        run_inversion(config, bundle)
    with timed("generation"):
        run_generation(config, bundle)
    name = "cpu"
    if bundle.device.type == "cuda":
        torch.cuda.synchronize(bundle.device)
        name = torch.cuda.get_device_name(bundle.device)
    get_logger().info("wall time %.3f s on %s", time.perf_counter() - t0,
                      name)


def run_stage(stage, argv=None, device=None):
    """``stage(config, bundle)`` after :func:`setup_from_argv`, in this
    process (one rank of a mesh, or the only one)."""
    config, bundle = setup_from_argv(argv, device=device)
    stage(config, bundle)


def entry(stage, argv=None, device=None, timeout: float | None = None):
    """An entry point's body: :func:`run_stage` of ``stage`` on the ranks of
    ``tpu.mesh`` when it spans several (started here unless a launcher or
    ``multihost`` started them; ``timeout`` seconds bound their run and
    each of their collectives), else in this process."""
    tpu = load_config(argv, print_config=False).get("tpu", None)
    run_entry(run_stage, tpu, (stage, argv, device), device, timeout)


def main(argv=None, device=None, timeout: float | None = None):
    """``python -m vidtome_torch.cli --config x.yaml``: both stages
    (:func:`entry`)."""
    entry(run_both, argv, device, timeout)


if __name__ == "__main__":
    main()
