"""DDIM inversion stage: source frames -> noisy latents.

Counterpart of ``vidtome_tpu/pipeline/inverter.py`` (``_run`` /
``ddim_inversion``): VAE-encode the clip, walk the DDIM schedule upward
predicting noise with the UNet (no merging: merging applies during
generation only), frames in fixed micro-batches.  No ControlNet.  With
``save_intermediate`` the latents of every save timestep are kept: in
memory (``Inverter.saved``, the source table PnP generation reads) and
through the caller's ``save_latent`` hook (``cli.py`` writes them to disk).

Two of the generator's serving caches apply (inversion has one lane, so no
CFG cache): the deep-feature cache (``cache_interval`` /
``cache_schedule``) and the eps skip (``eps_interval`` / ``eps_schedule`` /
``eps_extrapolate``).  DIRECTION NOTE: schedule specs are read in
INVERSION step order, which walks the noise schedule upward, so "full:K"
front-loads refreshes at the LOW-noise end; ``cache_reverse: true`` flips
both masks so "full:K" refreshes the high-noise end instead.
"""

from __future__ import annotations

import collections
from typing import Callable

import torch

from vidtome_torch.core.scheduler import (DDIMScheduler, ddim_inverse_step,
                                          ddim_step)
from vidtome_torch.models.registry import ModelBundle
from vidtome_torch.pipeline.common import (TextEncoder, VAECoder,
                                           reject_unported, resolve_precision)
from vidtome_torch.pipeline.generator import (EpsHistory,
                                              parse_eps_extrapolate,
                                              parse_resnet_mode,
                                              parse_sublayer_mode,
                                              refresh_mask)


def _pad_frames(a: torch.Tensor, n_target: int) -> torch.Tensor:
    pad = n_target - a.shape[0]
    return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) if pad > 0 else a


class Inverter:
    def __init__(self, bundle: ModelBundle, config):
        inv = config["inversion"]
        self.sublayer_mode = parse_sublayer_mode(inv, config)
        reject_unported("inversion", inv, config)
        self.cache_interval = int(inv.get("cache_interval", 0) or 0)
        self.cache_schedule = inv.get("cache_schedule") or None
        self.cache_reverse = bool(inv.get("cache_reverse", False))
        self.cache_on = bool(self.cache_interval or self.cache_schedule)
        self.eps_interval = int(inv.get("eps_interval", 0) or 0)
        self.eps_schedule = inv.get("eps_schedule") or None
        self.eps_on = bool(self.eps_interval or self.eps_schedule)
        self.eps_extrapolate = parse_eps_extrapolate(inv)
        self.resnet_mode = parse_resnet_mode(inv, config)
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
        # UNet calls of the last run by kind ("full", "shallow") and the
        # steps that ran none ("eps_skip")
        self.unet_calls: collections.Counter = collections.Counter()
        # timestep -> latents [T, h, w, 4] of the last inversion, at the
        # save timesteps (with save_intermediate)
        self.saved: dict[int, torch.Tensor] = {}

    def step_masks(self, inversion: bool):
        """(deep-cache refresh mask or None, eps-run mask or None) over the
        steps in run order; refresh steps of the deep cache that fall on
        eps-skip steps run the UNet."""
        n = self.scheduler.num_steps
        flip = self.cache_reverse and inversion
        mask = eps_mask = None
        if self.cache_on:
            mask = refresh_mask(self.cache_schedule, self.cache_interval or 1,
                                n)
            if flip:
                mask = mask[::-1]
            if not mask[0]:
                # a shallow first step would read an empty deep cache
                raise ValueError("inversion cache schedule must refresh on "
                                 "its first step (after cache_reverse): the "
                                 "deep cache starts empty")
        if self.eps_on:
            eps_mask = refresh_mask(self.eps_schedule,
                                    self.eps_interval or 1, n)
            if flip:
                eps_mask = eps_mask[::-1]
            if mask is not None:
                forced = int((mask & ~eps_mask).sum())
                if forced:
                    print(f"[WARNING] {forced} deep-cache refresh steps "
                          "fall on eps-skip steps; running the UNet there "
                          "(eps-run mask auto-aligned upward).")
                    eps_mask = eps_mask | mask
            if not eps_mask[0]:
                raise ValueError("inversion eps schedule must run the "
                                 "first step: the eps cache starts empty")
        return mask, eps_mask

    @torch.inference_mode()
    def _run(self, latents: torch.Tensor, conds: torch.Tensor,
             inversion: bool, on_step: Callable | None = None) -> torch.Tensor:
        """One UNet call per micro-batch of frames and timestep, then the
        DDIM (inverse) update of all frames (reference invert.py:122-131);
        eps-skip steps run only the update on the predicted eps."""
        n, bs = latents.shape[0], self.batch_size
        n_p = -(-n // bs) * bs
        x = _pad_frames(latents, n_p).clone()
        conds = _pad_frames(conds, n_p)
        sch = self.scheduler
        ts = sch.timesteps[::-1] if inversion else sch.timesteps
        unet = self.bundle.unet
        mask, eps_mask = self.step_masks(inversion)
        deep = None
        if mask is not None:
            ch = unet.config.block_out_channels[1]
            deep = x.new_zeros(x.shape[:3] + (ch,))
        history = EpsHistory(self.eps_extrapolate)
        calls = self.unet_calls = collections.Counter()
        update = ddim_inverse_step if inversion else ddim_step
        alphas = sch.inversion_alpha_pair if inversion else sch.sample_alpha_pair
        for i in range(sch.num_steps):
            if eps_mask is not None and not eps_mask[i]:
                calls["eps_skip"] += 1
                eps = history.predict(i)
            else:
                t = int(ts[i])
                mode = "off" if mask is None else (
                    "full" if mask[i] else "shallow")
                parts = []
                for b in range(0, n_p, bs):
                    out = unet(x[b:b + bs], t, conds[b:b + bs],
                               cache_mode=mode,
                               deep_cache=(deep[b:b + bs]
                                           if mode == "shallow" else None),
                               resnet_mode=self.resnet_mode,
                               sublayer_mode=self.sublayer_mode)
                    calls["shallow" if mode == "shallow" else "full"] += 1
                    if mode == "full":
                        out, deep[b:b + bs] = out
                    parts.append(out)
                eps = torch.cat(parts)
                if self.eps_on:
                    history.push(eps.float(), i)
            x = update(x, eps, *alphas(i)).to(latents.dtype)
            if on_step is not None:
                on_step(i, x[:n])
        return x[:n]

    def ddim_inversion(self, latents: torch.Tensor, conds: torch.Tensor,
                       save_latent: Callable | None = None) -> torch.Tensor:
        """Invert clean latents [T, h, w, 4] to the noisiest timestep.
        With ``save_intermediate``, the latents at the save timesteps are
        kept in :attr:`saved` and handed to ``save_latent(t, latents)`` if
        given (JAX ``inverter.py:384-392``)."""
        ts_up = self.scheduler.timesteps[::-1]
        self.saved = {}

        def hook(i, x):
            t = int(ts_up[i])
            if self.save_intermediate and t in self.timesteps_to_save:
                self.saved[t] = x.clone()
                if save_latent is not None:
                    save_latent(t, x)

        return self._run(latents, conds, inversion=True, on_step=hook)

    def source_table(self, timesteps) -> torch.Tensor:
        """PnP's source latents [len(timesteps), T, h, w, 4] from the last
        inversion's saved intermediates (JAX ``generator.py:1010-1019``)."""
        missing = [int(t) for t in timesteps if int(t) not in self.saved]
        if missing:
            raise ValueError(f"no inversion latents at timesteps {missing}: "
                             "PnP needs inversion.save_intermediate with "
                             "every generation timestep saved")
        return torch.stack([self.saved[int(t)] for t in timesteps])

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
