"""DDIM inversion stage: source frames -> noisy latents.

Counterpart of the exact path of ``vidtome_tpu/pipeline/inverter.py``
(``_run`` / ``ddim_inversion``): VAE-encode the clip, walk the DDIM
schedule upward predicting noise with the UNet (no merging: merging applies
during generation only), frames in fixed micro-batches.  No step caches and
no control.  File I/O (loading the video, saving latents) is the caller's:
``cli.py`` does it for the command line.
"""

from __future__ import annotations

from typing import Callable

import torch

from vidtome_torch.core.scheduler import (DDIMScheduler, ddim_inverse_step,
                                          ddim_step)
from vidtome_torch.models.registry import ModelBundle
from vidtome_torch.pipeline.common import (TextEncoder, VAECoder,
                                           reject_unported, resolve_precision)


def _pad_frames(a: torch.Tensor, n_target: int) -> torch.Tensor:
    pad = n_target - a.shape[0]
    return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) if pad > 0 else a


class Inverter:
    def __init__(self, bundle: ModelBundle, config):
        inv = config["inversion"]
        reject_unported("inversion", inv, config)
        self.bundle = bundle
        self.steps = int(inv["steps"])
        self.save_steps = int(inv.get("save_steps", self.steps))
        self.save_intermediate = bool(inv.get("save_intermediate", False))
        self.batch_size = int(inv.get("batch_size", 8))
        self.n_frames = inv.get("n_frames", None)
        self.recon = bool(inv.get("recon", False))
        self.prompt = inv["prompt"]
        resolve_precision(config, inv, bundle)
        self.scheduler = DDIMScheduler.create(self.steps)
        self.timesteps_to_save = set(
            int(t) for t in DDIMScheduler.create(self.save_steps).timesteps)
        self.text = TextEncoder(bundle)
        self.vae = VAECoder(bundle, batch_size=self.batch_size)

    @torch.inference_mode()
    def _run(self, latents: torch.Tensor, conds: torch.Tensor,
             inversion: bool, on_step: Callable | None = None) -> torch.Tensor:
        """One UNet call per micro-batch of frames and timestep, then the
        DDIM (inverse) update of all frames (reference invert.py:122-131)."""
        n, bs = latents.shape[0], self.batch_size
        n_p = -(-n // bs) * bs
        x = _pad_frames(latents, n_p).clone()
        conds = _pad_frames(conds, n_p)
        sch = self.scheduler
        ts = sch.timesteps[::-1] if inversion else sch.timesteps
        unet = self.bundle.unet
        for i in range(sch.num_steps):
            t = int(ts[i])
            eps = torch.cat([unet(x[b:b + bs], t, conds[b:b + bs])
                             for b in range(0, n_p, bs)])
            if inversion:
                x = ddim_inverse_step(x, eps, *sch.inversion_alpha_pair(i))
            else:
                x = ddim_step(x, eps, *sch.sample_alpha_pair(i))
            x = x.to(latents.dtype)
            if on_step is not None:
                on_step(i, x[:n])
        return x[:n]

    def ddim_inversion(self, latents: torch.Tensor, conds: torch.Tensor,
                       save_latent: Callable | None = None) -> torch.Tensor:
        """Invert clean latents [T, h, w, 4] to the noisiest timestep.
        ``save_latent(t, latents)``, if given, receives the intermediates at
        the save timesteps (with ``save_intermediate``)."""
        ts_up = self.scheduler.timesteps[::-1]

        def hook(i, x):
            t = int(ts_up[i])
            if (save_latent is not None and self.save_intermediate
                    and t in self.timesteps_to_save):
                save_latent(t, x)

        return self._run(latents, conds, inversion=True, on_step=hook)

    def ddim_sample(self, latents: torch.Tensor,
                    conds: torch.Tensor) -> torch.Tensor:
        """Reconstruct clean latents from inverted ones (fidelity check)."""
        return self._run(latents, conds, inversion=False)

    def encode(self, frames) -> tuple[torch.Tensor, torch.Tensor]:
        """Frames [T, H, W, 3] in [0, 1] -> (clean latents, per-frame
        prompt contexts)."""
        prompts = ([self.prompt] * len(frames) if isinstance(self.prompt, str)
                   else list(self.prompt))
        return self.vae.encode(frames), self.text(prompts)

    def __call__(self, frames, save_latent: Callable | None = None):
        """Invert ``frames``; returns (inverted latents, reconstructed
        frames or None)."""
        latents, conds = self.encode(frames)
        inverted = self.ddim_inversion(latents, conds, save_latent)
        recon = None
        if self.recon:
            recon = self.vae.decode(self.ddim_sample(inverted, conds))
        return inverted, recon
