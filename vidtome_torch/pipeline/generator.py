"""Generation stage: chunked CFG denoising with token merging.

Counterpart of ``vidtome_tpu/pipeline/generator.py``.  Per timestep, the
frames are cut into chunks of ``chunk_size`` (the rotate-mode schedule of
``core/chunk.py``); each chunk runs [uncond; cond] lanes through the merging
UNet, the first chunk initialising every block's global token bank and the
rest merging against it and replacing it; the CFG combine is fp32; the DDIM
update follows.  The JAX package's jit / fori_loop / scan / lax.cond
structure is a plain Python loop here.

The serving caches (``configs/serve.yaml``; each is off unless its
interval or schedule is set, see :func:`refresh_mask`):

  * deep-feature cache ``cache_interval`` / ``cache_schedule``: refresh
    steps run the full UNet and keep the input of its last up block per
    lane and frame; the steps between run only the level-0 path around it;
  * CFG delta cache ``cfg_interval`` / ``cfg_schedule``: refresh steps keep
    the guidance delta (cond - uncond) per frame; the steps between drop the
    uncond lane from the batch and apply eps = cond + (gs - 1) * delta;
  * eps skip ``eps_interval`` / ``eps_schedule``: the steps between run no
    UNet at all, only the DDIM update on the last guidance-combined eps,
    extrapolated from the last refreshes with ``eps_extrapolate`` 1
    (linear) or 2 (quadratic) by :func:`extrap_weights`.

PnP (``control: pnp``, JAX ``generator.py:152-161``, ``:504-519``): a third
lane leads the batch, the source, fed at every step from the inversion's
latents at that timestep (``src_table``) under an empty prompt; while
``step < pnp_attn_steps`` the injected self-attentions take the source's q
and k, while ``step < pnp_conv_steps`` up block 1's resnet 1 takes its conv
features.  Merging aligns its matchings over the three lanes.  CFG-skip
steps keep the source lane and drop only the uncond one.

ControlNet (``control`` a key of ``CONTROLNET_DICT``, JAX
``generator.py:530-538``): before every UNet call the bundle's ControlNet
runs on the same input, timestep and lane contexts, with the control
images of the chunk's frames tiled over the lanes that run, and its
residuals, scaled by ``control_scale``, go into the UNet.  It runs unmerged
and on shallow steps too; eps-skip steps run neither network.  The control
images come from :meth:`Generator.load_control` (the png cache under
``work_dir``).

SD2-depth (``sd_version: depth``, JAX ``generator.py:526-528``): the
chunk's frames' depth latents (``common.stage_depth``, through the
depth cache under ``work_dir``) are tiled over the lanes that run (the PnP
source lane included, the uncond lane not on CFG-skip steps) and
concatenated as a fifth channel after the lanes are built; a ControlNet
takes that input too.

LoRA (``use_lora: true``, JAX ``generator.py:301-307``): the adapter named
by ``generation.lora`` is merged into the bundle's UNet and text encoder
when the Generator is built (``models/lora.py``), before the stage's int8
table and its text encoder, once per bundle (``ModelBundle.lora``: a
second Generator with the same adapter merges nothing, one with another
adapter raises).  The inversion never reads it.

Randomness: the chunk schedule comes from ``np.random.default_rng(seed)`` as
in the JAX package; the merge draws (dst frame per local round, global
coin) come from a :class:`~vidtome_torch.models.tome.DrawSource`, by default
filled from ``torch.Generator().manual_seed(seed)``.  Both are rebuilt for
every prompt, so every edit sees the same schedule and draws.
"""

from __future__ import annotations

import collections
import functools
import sys

import numpy as np
import torch

from vidtome_torch.control.preprocess import control_preprocess
from vidtome_torch.core import chunk as chunking
from vidtome_torch.core.scheduler import DDIMScheduler, ddim_step
from vidtome_torch.io import artifacts
from vidtome_torch.models.layers import RESNET_MODES, SUBLAYER_MODES
from vidtome_torch.models.lora import apply_lora_bundle
from vidtome_torch.models.registry import ModelBundle
from vidtome_torch.models.tome import DrawSource, ToMeConfig
from vidtome_torch.pipeline.common import (TextEncoder, VAECoder,
                                           parse_quant, reject_unported,
                                           resolve_precision,
                                           stage_controlnet,
                                           stage_controlnet_table,
                                           stage_quant_table)


def refresh_mask(spec: str | None, interval: int, num_steps: int,
                 start: int = 0, kind: str = "cache") -> np.ndarray:
    """Boolean refresh mask [num_steps] for a step cache.

    ``spec`` (wins over ``interval``) is a comma-separated list of
    segments consumed in order from ``start``:

      * ``full:K``    -- K consecutive refresh (full) steps;
      * ``shallow:K`` -- K consecutive cached (shallow) steps;
      * ``every:NxK`` -- every-Nth refresh for the next K steps;
      * ``uniform:N`` -- every-Nth refresh for the remaining steps (must be
                         the last segment).

    Without a spec, ``interval`` gives the uniform every-Nth pattern.
    Steps past the listed segments refresh; entries before ``start`` are
    marked full.  The first step must refresh (the cache starts empty)."""
    mask = np.ones(num_steps, bool)
    i = start
    if spec:
        segments = [s.strip() for s in str(spec).split(",") if s.strip()]
        for seg_no, seg in enumerate(segments):
            seg_kind, _, arg = seg.partition(":")
            if seg_kind not in ("full", "shallow", "uniform",
                                "every") or not arg:
                raise ValueError(f"bad cache schedule segment {seg!r} "
                                 f"in {spec!r}")
            if seg_kind == "every":
                n_s, _, span_s = arg.partition("x")
                if not n_s or not span_s:
                    raise ValueError(f"'every' segment needs NxK (every-"
                                     f"Nth for K steps): {seg!r}")
                n, span = int(n_s), int(span_s)
                if n < 1 or span < 1:
                    raise ValueError(f"every:NxK needs N,K >= 1: {seg!r}")
                stop = min(i + span, num_steps)
                for j in range(i, stop):
                    mask[j] = (j - i) % n == 0
                i = stop
                continue
            n = int(arg)
            if seg_kind == "uniform":
                if seg_no != len(segments) - 1:
                    raise ValueError(
                        f"'uniform' must be the last segment: {spec!r}")
                if n < 1:
                    raise ValueError(f"uniform interval must be >=1: "
                                     f"{spec!r}")
                for j in range(i, num_steps):
                    mask[j] = (j - i) % n == 0
                i = num_steps
            else:
                stop = min(i + n, num_steps)
                mask[i:stop] = seg_kind == "full"
                i = stop
        mask[i:] = True
    elif interval:
        for j in range(start, num_steps):
            mask[j] = (j - start) % interval == 0
    if start < num_steps and not mask[start]:
        what = ("eps schedule must run the UNet on its first step"
                if kind == "eps"
                else f"{kind} schedule must refresh on its first step")
        raise ValueError(f"{what} (step {start}, spec {spec!r}): "
                         "the cache starts empty")
    return mask


def extrap_weights(t: float, s2: float, s1: float, s0: float,
                   order: int) -> tuple[float, float, float]:
    """Combination weights (w2, w1, w0) for an eps-skip prediction at step
    ``t`` from the last refreshes at steps s2 (newest), s1, s0:
    eps_hat = w2*eps2 + w1*eps1 + w0*eps0.  Order reduces while the history
    is short (aliased or missing nodes): 0 or one refresh -> plain reuse;
    two -> linear; three (order 2) -> quadratic Lagrange.  The one
    predictor of both stages (the JAX generator's in-graph Newton form
    computes the same polynomial)."""
    if order < 1 or s1 < 0 or s1 == s2:
        return 1.0, 0.0, 0.0
    if order < 2 or s0 < 0 or s0 == s1:
        f = (t - s2) / (s2 - s1)
        return 1.0 + f, -f, 0.0
    w0 = (t - s1) * (t - s2) / ((s0 - s1) * (s0 - s2))
    w1 = (t - s0) * (t - s2) / ((s1 - s0) * (s1 - s2))
    w2 = (t - s0) * (t - s1) / ((s2 - s0) * (s2 - s1))
    return w2, w1, w0


class EpsHistory:
    """The eps-skip predictor's state: the eps of the last three UNet steps
    (fp32) and their step indices, newest first.  Until the second and
    third refreshes the older slots alias the newest, so the prediction
    reduces to reuse / linear, as in both JAX stages."""

    def __init__(self, order: int):
        self.order = order
        self.eps: list[torch.Tensor] = []
        self.steps: list[int] = []

    def push(self, eps: torch.Tensor, step: int) -> None:
        if not self.eps:
            self.eps, self.steps = [eps] * 3, [step] * 3
        else:
            self.eps = [eps] + self.eps[:2]
            self.steps = [step] + self.steps[:2]

    def predict(self, step: int) -> torch.Tensor:
        w = extrap_weights(step, *self.steps, self.order)
        out = w[0] * self.eps[0]
        for wi, e in zip(w[1:], self.eps[1:]):
            if wi:
                out = out + wi * e
        return out


def parse_eps_extrapolate(cfg) -> int:
    order = int(cfg.get("eps_extrapolate", 0) or 0)
    if order not in (0, 1, 2):
        raise ValueError("eps_extrapolate must be false/true/1/2 "
                         f"(got {order!r})")
    return order


def parse_resnet_mode(stage_cfg, config) -> str:
    mode = str(stage_cfg.get("resnet_mode", config.get("resnet_mode", "off"))
               or "off")
    if mode not in RESNET_MODES:
        raise ValueError(f"resnet_mode must be one of {RESNET_MODES}, got "
                         f"{mode!r}")
    return mode


def parse_sublayer_mode(stage_cfg, config) -> str:
    mode = str(stage_cfg.get("sublayer_mode",
                             config.get("sublayer_mode", "off")) or "off")
    if mode not in SUBLAYER_MODES:
        raise ValueError(f"sublayer_mode must be one of {SUBLAYER_MODES}, "
                         f"got {mode!r}")
    if mode == "fused" and parse_quant(stage_cfg, config) == "int8":
        raise ValueError("sublayer_mode: fused requires bf16 attention "
                         "projections (quant: none) -- the int8 policy "
                         "strips their kernels")
    return mode


class Generator:
    def __init__(self, bundle: ModelBundle, config):
        gene = config["generation"]
        self.use_pnp = use_pnp = gene.get("control", "none") == "pnp"
        # lane-major [source,] uncond, cond
        self.num_lanes = 3 if use_pnp else 2
        self.cache_interval = int(gene.get("cache_interval", 0) or 0)
        self.cache_schedule = gene.get("cache_schedule") or None
        self.cfg_interval = int(gene.get("cfg_interval", 0) or 0)
        self.cfg_schedule = gene.get("cfg_schedule") or None
        self.eps_interval = int(gene.get("eps_interval", 0) or 0)
        self.eps_schedule = gene.get("eps_schedule") or None
        self.eps_extrapolate = parse_eps_extrapolate(gene)
        self.cache_on = bool(self.cache_interval or self.cache_schedule)
        self.cfg_on = bool(self.cfg_interval or self.cfg_schedule)
        self.eps_on = bool(self.eps_interval or self.eps_schedule)
        if self.eps_on and use_pnp:
            raise ValueError(
                "eps_interval/eps_schedule cannot be combined with "
                "control: pnp -- skipped steps run no UNet, dropping that "
                "timestep's PnP injections.")
        if self.cache_on and use_pnp:
            raise ValueError(
                "cache_interval/cache_schedule cannot be combined with "
                "control: pnp -- cached (shallow) steps skip the up-block-1 "
                "feature injections.  Use cfg_interval/cfg_schedule or "
                "disable the deep-feature cache.")
        self.sublayer_mode = parse_sublayer_mode(gene, config)
        reject_unported("generation", gene, config)
        self.control = str(gene.get("control", "none"))
        self.control_scale = float(gene.get("control_scale", 1.0))
        self.use_controlnet = stage_controlnet(self.control, bundle,
                                               "generation")
        self.resnet_mode = parse_resnet_mode(gene, config)
        self.quant = parse_quant(gene, config)
        self.bundle = bundle
        self.seed = int(config.get("seed", 123))
        self.n_timesteps = int(gene["n_timesteps"])
        self.guidance_scale = float(gene["guidance_scale"])
        self.negative_prompt = gene.get("negative_prompt", "")
        prompt = gene["prompt"]
        self.prompt = dict(prompt) if not isinstance(prompt, str) else {
            "edit": prompt}
        self.chunk_size = int(gene.get("chunk_size", 4))
        self.chunk_ord, self.perm_div = chunking.parse_chunk_ord(
            str(gene.get("chunk_ord", "mix-4")))
        self.merge_global = bool(gene.get("merge_global", False))
        self.tome = ToMeConfig(
            frames=self.chunk_size,
            local_merge_ratio=float(gene.get("local_merge_ratio", 0.9)),
            merge_global=self.merge_global,
            global_merge_ratio=float(gene.get("global_merge_ratio", 0.8)),
            global_rand=float(gene.get("global_rand", 0.5)),
            max_downsample=int(gene.get("max_downsample", 2)),
            target_stride=int(gene.get("target_stride", 4)),
            align_batch=use_pnp or bool(gene.get("align_batch", False)),
            share_match=bool(gene.get("share_match", True)),
            len_quantum=gene.get("len_quantum", 1024))
        self.use_depth = bundle.use_depth
        resolve_precision(config, gene, bundle)
        if bool(gene.get("use_lora", False)):
            # merged before the int8 table is quantized and before the text
            # encoder runs, so that both see the adapted weights
            apply_lora_bundle(bundle, gene.get("lora", {}) or {})
        # int8 (W8A8) serving: the stage's int8 table, passed per UNet call
        self.qt = stage_quant_table(self.quant, bundle, "generation")
        self.cn_qt = (stage_controlnet_table(self.quant, bundle, "generation")
                      if self.use_controlnet else None)
        self.scheduler = DDIMScheduler.create(self.n_timesteps)
        # steps with source attention / conv injection (JAX
        # generator.py:295-299); 0 without PnP
        self.pnp_attn_steps = self.pnp_conv_steps = 0
        if use_pnp:
            self.pnp_attn_steps = int(
                self.n_timesteps * float(gene.get("pnp_attn_t", 0.5)))
            self.pnp_conv_steps = int(
                self.n_timesteps * float(gene.get("pnp_f_t", 0.8)))
        self.text = TextEncoder(bundle)
        self.vae = VAECoder(bundle, batch_size=int(gene.get("batch_size", 8)))
        # UNet calls of the last ddim_sample by kind: "full" (the whole
        # UNet, cache off or refresh), "shallow" (level-0 path around the
        # deep cache), "cfg_skip" (uncond lane dropped) and "eps_skip"
        # (steps that ran no UNet)
        self.unet_calls: collections.Counter = collections.Counter()
        self._eps_align_warned = False

    def configure_frames(self, n: int) -> None:
        """Set n_frames / n_padded / pad_src for an n-frame clip."""
        self.n_frames = n
        self.n_padded, self.pad_src = chunking.pad_to_chunks(n, self.chunk_size)

    def fidx_table(self) -> np.ndarray:
        """[steps, chunks, chunk_size, 2] chunk schedule of one sampling."""
        return chunking.build_fidx_table(
            self.n_padded, self.chunk_size, np.random.default_rng(self.seed),
            self.scheduler.num_steps, chunk_ord=self.chunk_ord,
            perm_div=self.perm_div, merge_global=self.merge_global)

    def draw_source(self, n_chunks: int) -> DrawSource:
        return DrawSource.from_generator(
            self.tome, self.scheduler.num_steps, n_chunks,
            torch.Generator().manual_seed(self.seed))

    def mode_masks(self, start: int = 0) -> np.ndarray | None:
        """[num_steps, 3] bool refresh table (column 0: deep-feature cache,
        column 1: CFG delta cache, column 2: run the UNet at all), or None
        when all three caches are off.  Refresh steps of an active deep or
        CFG cache that fall on eps-skip steps run the UNet; deep refreshes
        that fall on CFG-skip steps also refresh the CFG delta (the uncond
        lane's deep slice refreshes only on steps that run that lane)."""
        if not (self.cache_on or self.cfg_on or self.eps_on):
            return None
        n = self.scheduler.num_steps
        deep = refresh_mask(self.cache_schedule, self.cache_interval or 1,
                            n, start, kind="cache")
        cfgm = refresh_mask(self.cfg_schedule, self.cfg_interval or 1,
                            n, start, kind="cfg")
        epsm = refresh_mask(self.eps_schedule, self.eps_interval or 1,
                            n, start, kind="eps")
        if self.eps_on:
            align = np.zeros(n, bool)
            if self.cache_on:
                align |= deep
            if self.cfg_on:
                align |= cfgm
            forced = int((align[start:] & ~epsm[start:]).sum())
            if forced:
                if not self._eps_align_warned:
                    print(f"[WARNING] {forced} deep/CFG cache refresh steps "
                          "fall on eps-skip steps; those steps now run the "
                          "UNet (eps-run mask auto-aligned upward).",
                          file=sys.stderr)
                    self._eps_align_warned = True
                epsm = epsm | align
        if self.cache_on and self.cfg_on:
            misaligned = int((deep[start:] & ~cfgm[start:]).sum())
            if misaligned:
                print(f"[WARNING] {misaligned} deep-cache refresh steps fall "
                      "on CFG-skip steps (stale uncond deep slice). "
                      "Auto-aligning: those steps now also refresh the CFG "
                      "delta cache.")
                cfgm = cfgm | deep
        return np.stack([deep, cfgm, epsm], axis=1)

    def load_control(self, frames, frame_ids: list[int],
                     work_dir: str) -> torch.Tensor:
        """The control images of ``frames`` [T, H, W, 3] in [0, 1] through
        the png cache ``<work_dir>/<control>_image/<frame:04>.png`` (JAX
        ``generator.py:957-964``), on the bundle's device and dtype."""
        images = artifacts.load_or_compute_control(
            work_dir, self.control, np.asarray(frames), frame_ids,
            functools.partial(control_preprocess, control_type=self.control,
                              device=self.bundle.device))
        return torch.from_numpy(np.asarray(images, np.float32)).to(
            self.bundle.device, self.bundle.dtype)

    def context(self, prompt: str) -> torch.Tensor:
        """The lane contexts of one edit: [uncond; cond], with the empty
        source prompt first under PnP."""
        return self.text.embed_cfg(prompt, self.negative_prompt,
                                   pnp=self.use_pnp)

    @torch.inference_mode()
    def ddim_sample(self, x: torch.Tensor, context: torch.Tensor,
                    fidx_table: np.ndarray | None = None,
                    draws: DrawSource | None = None,
                    src_table: torch.Tensor | None = None,
                    control: torch.Tensor | None = None,
                    depth: torch.Tensor | None = None) -> torch.Tensor:
        """Denoise padded latents x [n_padded, h, w, 4] under the lane
        contexts (:meth:`context`).  PnP needs ``src_table``
        [steps, n_padded, h, w, 4], the inversion's latents at each
        generation timestep; a ControlNet ``control``, the padded control
        images [n_padded, 8h, 8w, 3]; SD2-depth ``depth``, the padded depth
        latents [n_padded, h, w, 1]."""
        sch = self.scheduler
        if self.use_pnp and (src_table is None
                             or src_table.shape[0] != sch.num_steps):
            raise ValueError(f"PnP needs src_table [{sch.num_steps}, "
                             f"n_padded, h, w, 4]")
        if self.use_controlnet and (control is None
                                    or control.shape[0] != x.shape[0]):
            raise ValueError(f"control {self.control!r} needs the padded "
                             f"control images [{x.shape[0]}, H, W, 3]")
        if self.use_depth and (depth is None or depth.shape[0] != x.shape[0]):
            raise ValueError(f"sd_version depth needs the padded depth "
                             f"latents [{x.shape[0]}, h, w, 1]")
        if context.shape[0] != self.num_lanes:
            raise ValueError(f"expected {self.num_lanes} lane contexts, got "
                             f"{context.shape[0]}")
        if fidx_table is None:
            fidx_table = self.fidx_table()
        n_chunks, F = fidx_table.shape[1], fidx_table.shape[2]
        if draws is None:
            draws = self.draw_source(n_chunks)
        unet = self.bundle.unet
        gs = self.guidance_scale
        fidx_all = torch.as_tensor(fidx_table, dtype=torch.long,
                                   device=x.device)
        modes = self.mode_masks()
        deep = ucond = None
        L = self.num_lanes
        if self.cache_on:  # [lanes, Fpad, h, w, C1]
            ch = unet.config.block_out_channels[1]
            deep = x.new_zeros((L,) + x.shape[:3] + (ch,))
        if self.cfg_on:  # the guidance delta, [Fpad, h, w, 4] fp32
            ucond = torch.zeros(x.shape[:3] + (4,), dtype=torch.float32,
                                device=x.device)
        history = EpsHistory(self.eps_extrapolate)
        calls = self.unet_calls = collections.Counter()
        for i in range(sch.num_steps):
            if modes is not None and not modes[i, 2]:
                # eps skip: no UNet, the DDIM update on the predicted eps
                calls["eps_skip"] += 1
                x = ddim_step(x, history.predict(i),
                              *sch.sample_alpha_pair(i)).to(x.dtype)
                continue
            t = int(sch.timesteps[i])
            cache_mode = "off"
            if self.cache_on:
                cache_mode = "full" if modes[i, 0] else "shallow"
            cfg_skip = self.cfg_on and not modes[i, 1]
            # lane-major [[source*F;] uncond*F; cond*F]; a CFG skip drops
            # the uncond lane (row L - 2)
            lanes = [r for r in range(L) if not (cfg_skip and r == L - 2)]
            ctx = context[lanes].repeat_interleave(F, dim=0)
            pnp = {}
            if self.use_pnp:
                pnp = dict(attn_inject=i < self.pnp_attn_steps,
                           conv_inject=i < self.pnp_conv_steps)
            eps = torch.zeros_like(x)
            banks: dict = {}
            for c in range(n_chunks):
                if self.merge_global:
                    mode = "init" if c == 0 else "merge"
                else:
                    mode = "off"
                call = draws.call(self.tome, i, c, mode, banks)
                gather, scatter = fidx_all[i, c, :, 0], fidx_all[i, c, :, 1]
                x_chunk = x[gather]
                deep_in = None
                if cache_mode == "shallow":
                    # frame gather first: the small result takes the lanes
                    deep_in = deep[:, gather][lanes].flatten(0, 1)
                x_lanes = [x_chunk] * (len(lanes) - self.use_pnp)
                if self.use_pnp:
                    x_lanes.insert(0, src_table[i][gather].to(x.dtype))
                x_in = torch.cat(x_lanes)
                if self.use_depth:
                    x_in = torch.cat([x_in, depth[gather].repeat(
                        len(lanes), 1, 1, 1).to(x_in.dtype)], -1)
                residuals = {}
                if self.use_controlnet:
                    down, mid = self.bundle.controlnet(
                        x_in, t, ctx, control[gather].repeat(len(lanes), 1,
                                                             1, 1),
                        conditioning_scale=self.control_scale, qt=self.cn_qt)
                    residuals = dict(down_residuals=down, mid_residual=mid)
                out = unet(x_in, t, ctx, tome_call=call,
                           cache_mode=cache_mode, deep_cache=deep_in,
                           resnet_mode=self.resnet_mode,
                           sublayer_mode=self.sublayer_mode,
                           num_lanes=len(lanes), qt=self.qt, **pnp,
                           **residuals)
                calls["shallow" if cache_mode == "shallow" else "full"] += 1
                if cfg_skip:
                    calls["cfg_skip"] += 1
                if cache_mode == "full":
                    out, d = out
                    d = d.unflatten(0, (len(lanes), F))
                    for li, lane in enumerate(lanes):
                        deep[lane, scatter] = d[li]
                eps_c = out[-F:].float()
                if cfg_skip:
                    e = eps_c + (gs - 1.0) * ucond[gather]
                else:
                    # CFG combine in fp32, cast before the difference
                    eps_u = out[-2 * F:-F].float()
                    delta = eps_c - eps_u
                    if self.cfg_on:
                        ucond[scatter] = delta
                    e = eps_u + gs * delta
                eps[scatter] = e.to(eps.dtype)
            if self.eps_on:
                history.push(eps.float(), i)
            x = ddim_step(x, eps, *sch.sample_alpha_pair(i)).to(x.dtype)
        return x

    def __call__(self, init_latents: torch.Tensor,
                 src_table: torch.Tensor | None = None,
                 control: torch.Tensor | None = None,
                 depth: torch.Tensor | None = None
                 ) -> dict[str, torch.Tensor]:
        """Edit every prompt from the inverted latents [n, h, w, 4] (and,
        for PnP, the inversion latents at every generation timestep,
        [steps, n, h, w, 4]; for a ControlNet, the control images
        [n, H, W, 3] of :meth:`load_control`; on SD2-depth, the depth
        latents [n, h, w, 1] of ``common.stage_depth``); returns {edit name:
        frames [n, H, W, 3] in [0, 1]}."""
        self.configure_frames(init_latents.shape[0])
        dev = self.bundle.device
        pad = torch.as_tensor(self.pad_src, device=dev)
        x0 = init_latents.to(dev, self.bundle.dtype)[pad]
        if src_table is not None:
            src_table = src_table.to(dev, self.bundle.dtype)[:, pad]
        if control is not None:
            control = control.to(dev, self.bundle.dtype)[pad]
        if depth is not None:
            depth = depth.to(dev, torch.float32)[pad]
        outputs = {}
        for name, prompt in self.prompt.items():
            print(f"[INFO] current prompt: {prompt}")
            clean = self.ddim_sample(x0, self.context(prompt),
                                     src_table=src_table, control=control,
                                     depth=depth)
            outputs[name] = self.vae.decode(clean[:self.n_frames])
        return outputs
