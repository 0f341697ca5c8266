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
the generation stage is built (``configs/breakdance.yaml``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from vidtome_torch.config import load_config, save_config
from vidtome_torch.io import artifacts
from vidtome_torch.io.video import load_video, save_frames, save_video
from vidtome_torch.models.registry import init_model
from vidtome_torch.pipeline.common import get_frame_ids, stage_depth
from vidtome_torch.pipeline.generator import Generator
from vidtome_torch.pipeline.inverter import Inverter


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

    def save_latent(t, x):
        artifacts.save_latent(save_dir, t, x.float().cpu().numpy())

    inverted, recon = inverter(frames, save_latent)
    path = artifacts.save_latent(save_dir, ts[0],
                                 inverted.float().cpu().numpy())
    print(f"[INFO] inverted latent saved to: {path}")
    save_config(config, save_dir, inv=True)
    if recon is not None:
        save_frames(recon.cpu().numpy(), os.path.join(save_dir, "recon_frames"))
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
    for name, frames in outputs.items():
        out_dir = os.path.join(gene["output_path"], name)
        save_config(config, out_dir, gene=True)
        save_video(frames.cpu().numpy(), out_dir,
                   save_frame=bool(gene.get("save_frame", False)))
    return outputs


def main(argv=None):
    config = load_config(argv)
    if not torch.cuda.is_available():
        raise SystemExit("vidtome_torch.cli runs on a CUDA device; none found")
    t0 = time.perf_counter()
    bundle = init_model(sd_version=str(config.get("sd_version", "1.5")),
                        model_key=config.get("model_key", None),
                        weight_dtype=str(config.get("float_precision", "bf16")),
                        device="cuda", seed=int(config.get("seed", 123)),
                        control=str(config["generation"].get("control",
                                                             "none")),
                        controlnet_root=config.get("controlnet_root", None))
    config["model_key"] = bundle.model_key
    run_inversion(config, bundle)
    run_generation(config, bundle)
    torch.cuda.synchronize()
    print(f"[INFO] wall time {time.perf_counter() - t0:.3f} s on "
          f"{torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
