"""DDIM inversion stage: source frames -> noisy latents.

Counterpart of ``vidtome_tpu/pipeline/inverter.py`` (``_run`` /
``ddim_inversion``): VAE-encode the clip, walk the DDIM schedule upward
predicting noise with the UNet (no merging: merging applies during
generation only), frames in fixed micro-batches.  With
``inversion.control`` naming a ControlNet (JAX ``inverter.py:130-146``,
``:186-194``), the bundle's ControlNet runs before every UNet call on the
same micro-batch, fed the control images of its frames (computed from the
frames, padded as the latents are), and its residuals go into the UNet.  On
SD2-depth (``sd_version: depth``, JAX ``inverter.py:186-187``, ``:427-430``)
the frames' depth latents (``common.stage_depth``, through the depth
cache under ``work_dir``) are concatenated as a fifth channel before every
UNet call, full and shallow.  With
``save_intermediate`` the latents of every save timestep are kept: in
memory (``Inverter.saved``, the source table PnP generation reads) and
through the caller's ``save_latent`` hook (``cli.py`` writes them to disk).
On the SDXL base (``sd_version: xl``, JAX ``inverter.py:169-186``) every
UNet call takes the frames' pooled prompt embeds and the time ids
[h, w, 0, 0, h, w] of the configured size.  The JAX inverter cannot invert
with a refiner as the primary model (it keys on ``is_xl``, so the
refiner's (context, pooled) reaches its UNet as the context), and the
port refuses one.

Two of the generator's serving caches apply (inversion has one lane, so no
CFG cache): the deep-feature cache (``cache_interval`` /
``cache_schedule``) and the eps skip (``eps_interval`` / ``eps_schedule`` /
``eps_extrapolate``).  DIRECTION NOTE: schedule specs are read in
INVERSION step order, which walks the noise schedule upward, so "full:K"
front-loads refreshes at the LOW-noise end; ``cache_reverse: true`` flips
both masks so "full:K" refreshes the high-noise end instead.

A mesh (``mesh=``, else the bundle's; JAX ``inverter.py:38-42``,
``:147-150``): the bundle is sharded on it once, and under its data axis
each micro-batch's UNet (and ControlNet) call runs this rank's rows; the
eps and the deep features are all-gathered, so the deep cache stays whole
on every rank.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable

import numpy as np
import torch

from vidtome_torch.control.preprocess import control_preprocess
from vidtome_torch.core.scheduler import (DDIMScheduler, ddim_inverse_step,
                                          ddim_step)
from vidtome_torch.logging_utils import profile_trace, span
from vidtome_torch.models.registry import ModelBundle
from vidtome_torch.pipeline.common import (TextEncoder, VAECoder,
                                           parse_quant, reject_unported,
                                           resolve_precision,
                                           stage_controlnet,
                                           stage_controlnet_table,
                                           stage_depth, stage_quant_table)
from vidtome_torch.parallel.mesh import shard_bundle
from vidtome_torch.pipeline.generator import (EpsHistory, call_rows,
                                              parse_eps_extrapolate,
                                              parse_resnet_mode,
                                              parse_sublayer_mode,
                                              refresh_mask)


def _pad_frames(a: torch.Tensor, n_target: int) -> torch.Tensor:
    pad = n_target - a.shape[0]
    return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) if pad > 0 else a


class Inverter:
    def __init__(self, bundle: ModelBundle, config, mesh=None):
        inv = config["inversion"]
        if bundle.is_refiner:
            raise ValueError(
                f"sd_version {bundle.sd_version!r} cannot invert: the "
                f"refiner is a second generation stage (generation.refiner "
                f"on an sd_version: xl base); the JAX inverter cannot run "
                f"it either")
        self.sublayer_mode = parse_sublayer_mode(inv, config)
        reject_unported("inversion", inv, config)
        # the reference reads use_blip (invert.py:60) but never acts on it
        if inv.get("use_blip", False):
            print("[WARNING] use_blip is accepted for config compatibility "
                  "but not implemented (the reference never implements it "
                  "either); supply inversion.prompt directly")
        self.control = str(inv.get("control", "none"))
        self.control_scale = float(inv.get("control_scale", 1.0))
        self.use_controlnet = stage_controlnet(self.control, bundle,
                                               "inversion")
        self.cache_interval = int(inv.get("cache_interval", 0) or 0)
        self.cache_schedule = inv.get("cache_schedule") or None
        self.cache_reverse = bool(inv.get("cache_reverse", False))
        self.cache_on = bool(self.cache_interval or self.cache_schedule)
        self.eps_interval = int(inv.get("eps_interval", 0) or 0)
        self.eps_schedule = inv.get("eps_schedule") or None
        self.eps_on = bool(self.eps_interval or self.eps_schedule)
        self.eps_extrapolate = parse_eps_extrapolate(inv)
        self.resnet_mode = parse_resnet_mode(inv, config)
        self.quant = parse_quant(inv, config)
        self.bundle = bundle
        self.steps = int(inv["steps"])
        self.save_steps = int(inv.get("save_steps", self.steps))
        self.save_intermediate = bool(inv.get("save_intermediate", False))
        self.batch_size = int(inv.get("batch_size", 8))
        self.n_frames = inv.get("n_frames", None)
        self.recon = bool(inv.get("recon", False))
        self.prompt = inv["prompt"]
        self.work_dir = config.get("work_dir")
        self.profile_dir = (config.get("tpu", None) or {}).get("profile_dir")
        # SDXL's time ids: original and target size (height, width), no crop
        self.time_ids = None
        if bundle.is_xl:
            h, w = float(config["height"]), float(config["width"])
            self.time_ids = [h, w, 0.0, 0.0, h, w]
        resolve_precision(config, inv, bundle)
        self.mesh = mesh if mesh is not None else bundle.mesh
        if self.mesh is not None:  # before the int8 table
            shard_bundle(bundle, self.mesh)
        # int8 (W8A8) serving: the stage's int8 table, passed per UNet call
        self.qt = stage_quant_table(self.quant, bundle, "inversion")
        self.cn_qt = (stage_controlnet_table(self.quant, bundle, "inversion")
                      if self.use_controlnet else None)
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

    def control_images(self, frames) -> torch.Tensor | None:
        """The control images of ``frames`` [T, H, W, 3] in [0, 1] for a
        ControlNet stage (JAX ``inverter.py:438-441``: preprocessed, not
        cached), on the bundle's device and dtype; None without one."""
        if not self.use_controlnet:
            return None
        if isinstance(frames, torch.Tensor):
            frames = frames.float().cpu().numpy()
        images = control_preprocess(np.asarray(frames), self.control,
                                    device=self.bundle.device)
        return torch.from_numpy(np.asarray(images, np.float32)).to(
            self.bundle.device, self.bundle.dtype)

    @torch.inference_mode()
    def _run(self, latents: torch.Tensor, conds, inversion: bool,
             on_step: Callable | None = None,
             control: torch.Tensor | None = None,
             depth: torch.Tensor | None = None) -> torch.Tensor:
        """One UNet call (after the ControlNet's, with ``control``) per
        micro-batch of frames and timestep, then the DDIM (inverse) update
        of all frames (reference invert.py:122-131); eps-skip steps run
        only the update on the predicted eps.  On SD2-depth both networks
        take the micro-batch with its ``depth`` latents as a fifth
        channel.  ``conds`` is the per-frame contexts, on SDXL (contexts,
        pooled embeds)."""
        pooled = None
        if self.time_ids is not None:
            conds, pooled = conds
        n, bs = latents.shape[0], self.batch_size
        if self.use_controlnet and (control is None or control.shape[0] != n):
            raise ValueError(f"inversion.control {self.control!r} needs the "
                             f"control images of the {n} frames")
        if self.bundle.use_depth and (depth is None or depth.shape[0] != n):
            raise ValueError(f"sd_version depth needs the depth latents of "
                             f"the {n} frames")
        n_p = -(-n // bs) * bs
        x = _pad_frames(latents, n_p).clone()
        conds = _pad_frames(conds, n_p)
        xl = {}
        if pooled is not None:
            xl = dict(add_text_embeds=_pad_frames(pooled, n_p),
                      add_time_ids=torch.tensor(
                          [self.time_ids], device=x.device).expand(n_p, -1))
        if control is not None:
            control = _pad_frames(control, n_p)
        if depth is not None:
            depth = _pad_frames(depth, n_p)
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
            with span("invert_step", lambda: f"step={i}"):
                if eps_mask is not None and not eps_mask[i]:
                    calls["eps_skip"] += 1
                    eps = history.predict(i)
                else:
                    t = int(ts[i])
                    mode = "off" if mask is None else (
                        "full" if mask[i] else "shallow")
                    parts = []
                    for b in range(0, n_p, bs):
                        x_in = x[b:b + bs]
                        if depth is not None:
                            x_in = torch.cat(
                                [x_in, depth[b:b + bs].to(x.dtype)], -1)
                        # under the data axis this rank's rows of the
                        # batch
                        rows = call_rows(self.mesh, x_in.shape[0])
                        own = (lambda a: a) if rows is None else rows.take
                        residuals = {}
                        if self.use_controlnet:
                            down, mid = self.bundle.controlnet(
                                own(x_in), t, own(conds[b:b + bs]),
                                own(control[b:b + bs]),
                                conditioning_scale=self.control_scale,
                                qt=self.cn_qt)
                            residuals = dict(down_residuals=down,
                                             mid_residual=mid)
                        out = unet(own(x_in), t, own(conds[b:b + bs]),
                                   cache_mode=mode,
                                   deep_cache=(own(deep[b:b + bs])
                                               if mode == "shallow"
                                               else None),
                                   resnet_mode=self.resnet_mode,
                                   sublayer_mode=self.sublayer_mode,
                                   qt=self.qt, **residuals,
                                   **{k: own(v[b:b + bs])
                                      for k, v in xl.items()},
                                   rows=rows)
                        if rows is not None:  # every rank: the batch's
                            out = (tuple(map(rows.gather, out))
                                   if mode == "full" else rows.gather(out))
                        calls["shallow" if mode == "shallow"
                              else "full"] += 1
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
                       save_latent: Callable | None = None,
                       control: torch.Tensor | None = None,
                       depth: torch.Tensor | None = None) -> torch.Tensor:
        """Invert clean latents [T, h, w, 4] to the noisiest timestep.
        With ``save_intermediate``, the latents at the save timesteps are
        kept in :attr:`saved` and handed to ``save_latent(t, latents)`` if
        given (JAX ``inverter.py:384-392``).  A ControlNet stage takes the
        frames' ``control`` images (:meth:`control_images`), SD2-depth their
        ``depth`` latents (``common.stage_depth``)."""
        ts_up = self.scheduler.timesteps[::-1]
        self.saved = {}

        def hook(i, x):
            t = int(ts_up[i])
            if self.save_intermediate and t in self.timesteps_to_save:
                self.saved[t] = x.clone()
                if save_latent is not None:
                    save_latent(t, x)

        return self._run(latents, conds, inversion=True, on_step=hook,
                         control=control, depth=depth)

    def source_table(self, timesteps) -> torch.Tensor:
        """PnP's source latents [len(timesteps), T, h, w, 4] from the last
        inversion's saved intermediates (JAX ``generator.py:1010-1019``)."""
        missing = [int(t) for t in timesteps if int(t) not in self.saved]
        if missing:
            raise ValueError(f"no inversion latents at timesteps {missing}: "
                             "PnP needs inversion.save_intermediate with "
                             "every generation timestep saved")
        return torch.stack([self.saved[int(t)] for t in timesteps])

    def ddim_sample(self, latents: torch.Tensor, conds: torch.Tensor,
                    control: torch.Tensor | None = None,
                    depth: torch.Tensor | None = None) -> torch.Tensor:
        """Reconstruct clean latents from inverted ones (fidelity check)."""
        return self._run(latents, conds, inversion=False, control=control,
                         depth=depth)

    def prompts(self, n: int) -> list[str]:
        """The per-frame prompts of an n-frame clip: a string prompt
        repeated, a list as given (JAX ``inverter.py:432-433``)."""
        return ([self.prompt] * n if isinstance(self.prompt, str)
                else list(self.prompt))

    def encode(self, frames):
        """Frames [T, H, W, 3] in [0, 1] -> (clean latents, per-frame
        prompt contexts; on SDXL (contexts, pooled embeds))."""
        return self.vae.encode(frames), self.text(self.prompts(len(frames)))

    def __call__(self, frames, save_latent: Callable | None = None):
        """Invert ``frames``; returns (inverted latents, reconstructed
        frames or None).  With ``tpu.profile_dir`` the whole stage runs
        under ``torch.profiler`` (``logging_utils.profile_trace``: a
        Chrome trace ``invert_<pid>_<ns>.json`` in that directory)."""
        trace = (profile_trace(self.profile_dir, self.bundle.device,
                               "invert")
                 if self.profile_dir else contextlib.nullcontext())
        with trace, span("invert", lambda: f"frames={len(frames)}"):
            latents, conds = self.encode(frames)
            control = self.control_images(frames)
            depth = (stage_depth(self.bundle, frames, range(len(frames)),
                                 self.work_dir)
                     if self.bundle.use_depth else None)
            inverted = self.ddim_inversion(latents, conds, save_latent,
                                           control, depth)
            recon = None
            if self.recon:
                recon = self.vae.decode(self.ddim_sample(inverted, conds,
                                                         control, depth))
            return inverted, recon


def main(argv=None, device=None, timeout: float | None = None):
    """The inversion stage alone (JAX ``inverter.py:458-468``):

        python -m vidtome_torch.pipeline.inverter --config configs/demo.yaml

    (the latents and ``inversion_prompts.txt`` under
    ``inversion.save_path``), on the ranks of ``tpu.mesh`` when it spans
    several (``cli.entry``)."""
    from vidtome_torch.cli import entry, run_inversion

    entry(run_inversion, argv, device, timeout)


if __name__ == "__main__":
    main()
