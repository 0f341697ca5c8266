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

SDXL (``sd_version: xl``, JAX ``generator.py:404-437``, ``:465-525``,
``:1040-1082``): the lane contexts come with each lane's pooled embed and
time ids [h, w, 0, 0, h, w], repeated per frame as the contexts are; a
``refiner`` sub-config builds a second Generator on an ``xl-refiner``
bundle (random weights, seed 0, without its ``model_key``) from a copy of
the whole config with ``control: none`` and no refiner of its own (JAX
``generator.py:430-433``): ``quant``, ``resnet_mode``, ``sublayer_mode``
and ``use_lora`` carry over, so the refiner builds its own int8 table and
is offered the base's LoRA, while PnP stays with the base.
:meth:`Generator.sample` runs the base for the first ``denoising_start``
share of the steps and the refiner for the rest, from the same chunk
schedule and draws at the same global step indices (its step caches
rebuilt from its first step, :meth:`Generator.mode_masks`); the refiner's
5 time ids carry the aesthetic score, the negative one on every lane but
the cond lane.

LoRA (``use_lora: true``, JAX ``generator.py:301-307``): the adapter named
by ``generation.lora`` is merged into the bundle's UNet and text encoders
when the Generator is built (``models/lora.py``), before the stage's int8
table and its text encoder, once per bundle (``ModelBundle.lora``: a
second Generator with the same adapter merges nothing, one with another
adapter raises).  The inversion never reads it.

Chunk boundaries (``chunk_boundaries``, read lower-cased, JAX
``generator.py:168-180``): ``rotate`` (the default) keeps every chunk
``chunk_size`` real or padded frames and rotates the boundaries each step;
``ragged`` gives the first chunk a random length and never wraps
(``core/chunk.ragged_fidx``): a short chunk repeats its last frame and
writes those slots to a waste slot past the real frames, so the padded
latents hold at least one slot more than the frames (:meth:`configure_frames`)
and a step may run more chunks than ``n_padded / chunk_size``.

Batched chunks (``chunk_batch``, JAX ``generator.py:618-640``): after the
first chunk's UNet call of a step, chunks 2..K run as one UNet call of
``lanes * (K - 1) * chunk_size`` rows, lane-major, then chunk, then frame,
so local merging still joins each chunk's frames.  Every batched chunk
merges against the first chunk's bank (each lane's bank repeated per chunk
with ``repeat_interleave``, as ``jnp.repeat``), and they share the draws of
``DrawSource`` column 1; the batched call's banks are dropped.  It cannot
be combined with ragged boundaries (ValueError, as in JAX): one batched
scatter cannot order the waste slot's writes.

LDM-variant merging (``merge_crossattn`` / ``merge_ff``, bench.py's
``--ldm``): cross-attention and / or the feed-forward of every merging block
run on the locally merged tokens too (``models/layers.TransformerBlock``).

Randomness: the chunk schedule comes from ``np.random.default_rng(seed)`` as
in the JAX package; the merge draws (dst frame per local round, global
coin) come from a :class:`~vidtome_torch.models.tome.DrawSource`, by default
filled from ``torch.Generator().manual_seed(seed)``.  Both are rebuilt for
every prompt, so every edit sees the same schedule and draws.

A mesh (``mesh=``, else the bundle's, ``parallel/mesh.py``; JAX
``generator.py:379-387``): the bundle is sharded on it once (the TP rules
on the model axis) and every rank runs this loop on the same replicated
latents, schedule and draws.  Under the data axis each UNet (and
ControlNet) call runs this rank's rows of the call
(``parallel/mesh.Rows``), and its eps and deep features are all-gathered,
so every rank holds the caches whole: the chunk schedule puts other frames
in a rank's rows at every step.  The refiner's Generator gets the mesh
too.
"""

from __future__ import annotations

import collections
import copy
import functools
import sys

import numpy as np
import torch

from vidtome_torch.control.preprocess import control_preprocess
from vidtome_torch.core import chunk as chunking
from vidtome_torch.core.scheduler import DDIMScheduler, ddim_step
from vidtome_torch.io import artifacts
from vidtome_torch.logging_utils import profile_trace, span
from vidtome_torch.models.layers import RESNET_MODES, SUBLAYER_MODES
from vidtome_torch.models.lora import apply_lora_bundle
from vidtome_torch.models.registry import ModelBundle, init_model
from vidtome_torch.models.tome import DrawSource, ToMeConfig
from vidtome_torch.parallel.mesh import Rows, shard_bundle
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


def stage_tome(gene, use_pnp: bool) -> ToMeConfig:
    """The merging configuration of a generation stage's keys (JAX
    ``generator.py:199-224``); PnP aligns the matchings over its lanes."""
    return ToMeConfig(
        frames=int(gene.get("chunk_size", 4)),
        local_merge_ratio=float(gene.get("local_merge_ratio", 0.9)),
        merge_global=bool(gene.get("merge_global", False)),
        global_merge_ratio=float(gene.get("global_merge_ratio", 0.8)),
        global_rand=float(gene.get("global_rand", 0.5)),
        max_downsample=int(gene.get("max_downsample", 2)),
        target_stride=int(gene.get("target_stride", 4)),
        align_batch=use_pnp or bool(gene.get("align_batch", False)),
        share_match=bool(gene.get("share_match", True)),
        len_quantum=gene.get("len_quantum", 1024),
        merge_crossattn=bool(gene.get("merge_crossattn", False)),
        merge_ff=bool(gene.get("merge_ff", False)))


def call_rows(mesh, n: int) -> Rows | None:
    """This rank's rows of a UNet call of ``n`` rows on ``mesh``'s data
    axis (None without one)."""
    return Rows(mesh, n) if mesh is not None and mesh.data > 1 else None


class Generator:
    def __init__(self, bundle: ModelBundle, config, mesh=None):
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
        self.gene = gene
        # the size the SDXL family's time ids carry (JAX generator.py:1049)
        self.size = ((float(config["height"]), float(config["width"]))
                     if bundle.needs_pooled else None)
        self.seed = int(config.get("seed", 123))
        self.profile_dir = (config.get("tpu", None) or {}).get("profile_dir")
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
        boundaries = str(gene.get("chunk_boundaries", "rotate")).lower()
        if boundaries not in ("rotate", "ragged"):
            raise ValueError(f"chunk_boundaries must be rotate|ragged, got "
                             f"{boundaries!r}")
        self.ragged = boundaries == "ragged"
        self.chunk_batch = bool(gene.get("chunk_batch", False))
        if self.chunk_batch and self.ragged:
            raise ValueError(
                "generation.chunk_batch requires chunk_boundaries: rotate "
                "-- ragged mode routes duplicate scatter slots through the "
                "waste slot sequentially, which a single batched scatter "
                "cannot order.")
        self.tome = stage_tome(gene, use_pnp)
        self.use_depth = bundle.use_depth
        resolve_precision(config, gene, bundle)
        if bool(gene.get("use_lora", False)):
            # merged before the int8 table is quantized and before the text
            # encoder runs, so that both see the adapted weights
            apply_lora_bundle(bundle, gene.get("lora", {}) or {})
        self.mesh = mesh if mesh is not None else bundle.mesh
        if self.mesh is not None:  # after the LoRA, before the int8 table
            shard_bundle(bundle, self.mesh)
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
        # under ToMeConfig.collect_stats: the merge statistics of the last
        # step's UNet calls, by chunk position (ToMeCall.stats)
        self.tome_stats: dict = {}
        # the step caches at the end of the last ddim_sample: "deep"
        # [lanes, Fpad, h, w, C1] and "ucond" [Fpad, h, w, 4] (None where off)
        self.caches: dict = {}
        self._eps_align_warned = False
        self.refiner = None
        ref = gene.get("refiner", None)
        if ref and not bundle.is_refiner:
            if not bundle.is_xl:
                # the refiner denoises in the SDXL VAE's latent space
                raise ValueError(f"generation.refiner requires an SDXL base "
                                 f"(sd_version: xl); got sd_version="
                                 f"{bundle.sd_version!r}")
            ref_bundle = init_model(
                sd_version=ref.get("sd_version", "xl-refiner"),
                model_key=ref.get("model_key"),
                weight_dtype=("bf16" if bundle.dtype == torch.bfloat16
                              else "fp32"), device=bundle.device)
            ref_cfg = copy.deepcopy(config)
            ref_cfg["generation"]["control"] = "none"
            ref_cfg["generation"]["refiner"] = None
            self.refiner = Generator(ref_bundle, ref_cfg, mesh=self.mesh)
            self.refiner_start = float(ref.get("denoising_start", 0.8))
            self.aesthetic = (float(ref.get("negative_aesthetic_score", 2.5)),
                              float(ref.get("aesthetic_score", 6.0)))

    def configure_frames(self, n: int) -> None:
        """Set n_frames / n_padded / pad_src for an n-frame clip.  Ragged
        boundaries need a slot past the real frames for the duplicate
        writes: a clip that fills its chunks gets one more chunk of padding
        (JAX ``generator.py:928-938``)."""
        self.n_frames = n
        self.n_padded, self.pad_src = chunking.pad_to_chunks(n, self.chunk_size)
        if self.ragged and self.n_padded == n:
            self.n_padded += self.chunk_size
            self.pad_src = np.minimum(np.arange(self.n_padded), n - 1)

    def fidx_table(self) -> np.ndarray:
        """[steps, K, chunk_size, 2] chunk schedule of one sampling (K from
        the boundaries: ``n_padded / chunk_size`` rotated, more when
        ragged)."""
        return chunking.build_fidx_table(
            self.n_padded, self.chunk_size, np.random.default_rng(self.seed),
            self.scheduler.num_steps, chunk_ord=self.chunk_ord,
            perm_div=self.perm_div, merge_global=self.merge_global,
            ragged=self.ragged, n_frames=self.n_frames)

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

    def context(self, prompt: str, aesthetic: tuple | None = None):
        """The lane contexts of one edit: [uncond; cond], with the empty
        source prompt first under PnP.  The SDXL family's are (contexts,
        pooled embeds, time ids) (JAX ``generator.py:1040-1065``): the
        base's time ids [h, w, 0, 0, h, w] on every lane, the refiner's
        [h, w, 0, 0, score], the (negative, positive) ``aesthetic`` scores
        (else the configured ones) the negative on every lane but the
        last."""
        context = self.text.embed_cfg(prompt, self.negative_prompt,
                                      pnp=self.use_pnp)
        if self.size is None:
            return context
        ctx, pooled = context
        h, w = self.size
        if self.bundle.unet.config.addition_num_time_ids == 5:
            ref_cfg = self.gene.get("refiner", None) or {}
            neg, pos = aesthetic or (
                float(ref_cfg.get("negative_aesthetic_score", 2.5)),
                float(ref_cfg.get("aesthetic_score", 6.0)))
            ids = [[h, w, 0.0, 0.0, neg]] * (ctx.shape[0] - 1) + [
                [h, w, 0.0, 0.0, pos]]
        else:
            ids = [[h, w, 0.0, 0.0, h, w]] * ctx.shape[0]
        return ctx, pooled, torch.tensor(ids, device=ctx.device)

    def ddim_sample(self, *args, **kwargs) -> torch.Tensor:
        """:meth:`_ddim_sample`, under ``torch.profiler`` when the config
        sets ``tpu.profile_dir`` (JAX ``generator.py:975-986``): a Chrome
        trace of the loop in that directory (``logging_utils.profile_trace``;
        an SDXL refiner stage writes its own beside the base's)."""
        if not self.profile_dir:
            return self._ddim_sample(*args, **kwargs)
        with profile_trace(self.profile_dir, self.bundle.device,
                           "ddim_sample"):
            return self._ddim_sample(*args, **kwargs)

    @torch.inference_mode()
    def _ddim_sample(self, x: torch.Tensor, context,
                     fidx_table: np.ndarray | None = None,
                     draws: DrawSource | None = None,
                     src_table: torch.Tensor | None = None,
                     control: torch.Tensor | None = None,
                     depth: torch.Tensor | None = None, start: int = 0,
                     stop: int | None = None) -> torch.Tensor:
        """Denoise padded latents x [n_padded, h, w, 4] under the lane
        contexts (:meth:`context`) over steps ``start``..``stop`` of the
        schedule (all by default).  PnP needs ``src_table``
        [steps, n_padded, h, w, 4], the inversion's latents at each
        generation timestep; a ControlNet ``control``, the padded control
        images [n_padded, 8h, 8w, 3]; SD2-depth ``depth``, the padded depth
        latents [n_padded, h, w, 1].  The chunk schedule, the draws and
        the PnP table are read at the global step index."""
        add = {}
        if self.size is not None:
            if not isinstance(context, tuple):
                raise ValueError("the SDXL family takes (contexts, pooled "
                                 "embeds, time ids): Generator.context")
            context, pooled, time_ids = context
            add = dict(add_text_embeds=pooled, add_time_ids=time_ids)
        sch = self.scheduler
        stop = sch.num_steps if stop is None else stop
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
        n_chunks, cs = fidx_table.shape[1], fidx_table.shape[2]
        if draws is None:
            draws = self.draw_source(n_chunks)
        # the UNet calls of a step: (draw column, chunks it runs); under
        # chunk_batch the first chunk, then chunks 2..K in one call
        groups = [(c, [c]) for c in range(n_chunks)]
        if self.chunk_batch and n_chunks > 1:
            groups = [(0, [0]), (1, list(range(1, n_chunks)))]
        unet = self.bundle.unet
        gs = self.guidance_scale
        fidx_all = torch.as_tensor(fidx_table, dtype=torch.long,
                                   device=x.device)
        modes = self.mode_masks(start)
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
        self.tome_stats = {}
        for i in range(start, stop):
            eps_skip = modes is not None and not modes[i, 2]
            cache_mode = "off"
            if self.cache_on:
                cache_mode = "full" if modes[i, 0] else "shallow"
            cfg_skip = self.cfg_on and not modes[i, 1]
            with span("gen_step", lambda: f"step={i} cache={cache_mode} "
                      f"cfg_skip={cfg_skip} eps_skip={eps_skip}"):
                if eps_skip:
                    # no UNet, the DDIM update on the predicted eps
                    calls["eps_skip"] += 1
                    x = ddim_step(x, history.predict(i),
                                  *sch.sample_alpha_pair(i)).to(x.dtype)
                    continue
                t = int(sch.timesteps[i])
                # lane-major [[source*F;] uncond*F; cond*F]; a CFG skip
                # drops the uncond lane (row L - 2)
                lanes = [r for r in range(L)
                         if not (cfg_skip and r == L - 2)]
                pnp = {}
                if self.use_pnp:
                    pnp = dict(attn_inject=i < self.pnp_attn_steps,
                               conv_inject=i < self.pnp_conv_steps)
                eps = torch.zeros_like(x)
                banks: dict = {}
                lane_ctx = {}  # rows a call -> the lane contexts, per frame
                for c, chunks in groups:
                    if self.merge_global:
                        mode = "init" if c == 0 else "merge"
                    else:
                        mode = "off"
                    if len(chunks) > 1:
                        # every batched chunk merges against its lane's bank
                        # of the first chunk: lane-major rows, so each bank
                        # row is repeated per chunk (jnp.repeat, not a
                        # tiling)
                        banks = {blk: b.repeat_interleave(len(chunks),
                                                          dim=0)
                                 for blk, b in banks.items()}
                    call = draws.call(self.tome, i, c, mode, banks)
                    pairs = fidx_all[i, chunks].flatten(0, 1)
                    gather, scatter = pairs[:, 0], pairs[:, 1]
                    F = len(chunks) * cs
                    if F not in lane_ctx:
                        lane_ctx[F] = (
                            context[lanes].repeat_interleave(F, dim=0),
                            {k: v[lanes].repeat_interleave(F, dim=0)
                             for k, v in add.items()})
                    ctx, add_kw = lane_ctx[F]
                    x_chunk = x[gather]
                    deep_in = None
                    if cache_mode == "shallow":
                        # frame gather first: the small result takes the
                        # lanes
                        deep_in = deep[:, gather][lanes].flatten(0, 1)
                    x_lanes = [x_chunk] * (len(lanes) - self.use_pnp)
                    if self.use_pnp:
                        x_lanes.insert(0,
                                       src_table[i][gather].to(x.dtype))
                    x_in = torch.cat(x_lanes)
                    if self.use_depth:
                        x_in = torch.cat([x_in, depth[gather].repeat(
                            len(lanes), 1, 1, 1).to(x_in.dtype)], -1)
                    # under the data axis this rank's rows of the call
                    rows = call_rows(self.mesh, x_in.shape[0])
                    own = (lambda a: a) if rows is None else rows.take
                    residuals = {}
                    if self.use_controlnet:
                        down, mid = self.bundle.controlnet(
                            own(x_in), t, own(ctx),
                            own(control[gather].repeat(len(lanes), 1, 1, 1)),
                            conditioning_scale=self.control_scale,
                            qt=self.cn_qt)
                        residuals = dict(down_residuals=down,
                                         mid_residual=mid)
                    out = unet(own(x_in), t, own(ctx), tome_call=call,
                               cache_mode=cache_mode,
                               deep_cache=(None if deep_in is None
                                           else own(deep_in)),
                               resnet_mode=self.resnet_mode,
                               sublayer_mode=self.sublayer_mode,
                               num_lanes=len(lanes), qt=self.qt, **pnp,
                               **residuals,
                               **{k: own(v) for k, v in add_kw.items()},
                               rows=rows)
                    if rows is not None:  # every rank: the call's output
                        out = (tuple(map(rows.gather, out))
                               if cache_mode == "full"
                               else rows.gather(out))
                    calls["shallow" if cache_mode == "shallow"
                          else "full"] += 1
                    if self.tome.collect_stats:
                        self.tome_stats[c] = call.stats
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
                x = ddim_step(x, eps,
                              *sch.sample_alpha_pair(i)).to(x.dtype)
        self.caches = {"deep": deep, "ucond": ucond}
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
            clean = self.sample(x0, prompt, src_table=src_table,
                                control=control, depth=depth)
            outputs[name] = self.vae.decode(clean[:self.n_frames])
        return outputs

    def split_step(self) -> int:
        """The first step of the refiner stage (JAX ``generator.py:1071``)."""
        steps = self.scheduler.num_steps
        return max(1, min(int(round(steps * self.refiner_start)), steps - 1))

    def sample(self, x0: torch.Tensor, prompt: str,
               fidx_table: np.ndarray | None = None,
               draws: DrawSource | None = None, **inputs) -> torch.Tensor:
        """Clean latents of one edit from the padded latents ``x0``: the
        whole schedule, or with a refiner the base up to :meth:`split_step`
        and the refiner from there, both from the same chunk schedule and
        draws (JAX ``generator.py:1067-1082``).  ``inputs`` go to the base
        stage's :meth:`ddim_sample`.  A ``vidtome/generate`` span in a
        profiler's trace, named by the edit whose prompt it is."""
        with span("generate", lambda: "prompt=" + next(
                (k for k, v in self.prompt.items() if v == prompt), "")):
            context = self.context(prompt)
            if self.refiner is None:
                return self.ddim_sample(x0, context, fidx_table, draws,
                                        **inputs)
            if fidx_table is None:
                fidx_table = self.fidx_table()
            if draws is None:
                draws = self.draw_source(fidx_table.shape[1])
            split = self.split_step()
            x = self.ddim_sample(x0, context, fidx_table, draws, stop=split,
                                 **inputs)
            r = self.refiner
            r.configure_frames(self.n_frames)
            print(f"[INFO] refiner stage: steps "
                  f"{split}..{r.scheduler.num_steps}")
            return r.ddim_sample(x, r.context(prompt, self.aesthetic),
                                 fidx_table, draws, start=split)


def main(argv=None, device=None, timeout: float | None = None):
    """The generation stage alone (JAX ``generator.py:1112-1121``), from
    the latents a prior inversion cached under ``generation.latents_path``
    (else ``cli.run_generation``'s ``FileNotFoundError``):

        python -m vidtome_torch.pipeline.generator --config configs/demo.yaml

    on the ranks of ``tpu.mesh`` when it spans several (``cli.entry``)."""
    from vidtome_torch.cli import entry, run_generation

    entry(run_generation, argv, device, timeout)


if __name__ == "__main__":
    main()
