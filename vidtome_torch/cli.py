"""End-to-end CLI of the port: invert, then generate, on a CUDA device.

    python -m vidtome_torch.cli --config configs/demo.yaml

Takes the same YAML as ``python -m vidtome_tpu.cli``.  The config loader and
the video / latent-cache I/O are the JAX package's JAX-free modules
(``vidtome_tpu.config``, ``vidtome_tpu.io``), imported here only: the rest
of the port imports nothing from ``vidtome_tpu``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from vidtome_torch.models.registry import init_model
from vidtome_torch.pipeline.common import get_frame_ids


def run_inversion(config, bundle):
    from vidtome_tpu.config import save_config
    from vidtome_tpu.io import artifacts
    from vidtome_tpu.io.video import load_video, save_frames

    from vidtome_torch.pipeline.inverter import Inverter

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
    from vidtome_tpu.config import save_config
    from vidtome_tpu.io import artifacts
    from vidtome_tpu.io.video import save_video

    from vidtome_torch.pipeline.generator import Generator

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
    outputs = generator(table[0],
                        src_table=table if generator.use_pnp else None)
    for name, frames in outputs.items():
        out_dir = os.path.join(gene["output_path"], name)
        save_config(config, out_dir, gene=True)
        save_video(frames.cpu().numpy(), out_dir,
                   save_frame=bool(gene.get("save_frame", False)))
    return outputs


def main(argv=None):
    from vidtome_tpu.config import load_config

    config = load_config(argv)
    if not torch.cuda.is_available():
        raise SystemExit("vidtome_torch.cli runs on a CUDA device; none found")
    t0 = time.perf_counter()
    bundle = init_model(sd_version=str(config.get("sd_version", "1.5")),
                        model_key=config.get("model_key", None),
                        weight_dtype=str(config.get("float_precision", "bf16")),
                        device="cuda", seed=int(config.get("seed", 123)))
    config["model_key"] = bundle.model_key
    run_inversion(config, bundle)
    run_generation(config, bundle)
    torch.cuda.synchronize()
    print(f"[INFO] wall time {time.perf_counter() - t0:.3f} s on "
          f"{torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
