"""Generation stage: chunked CFG denoising with token merging.

Counterpart of the exact path of ``vidtome_tpu/pipeline/generator.py``.  Per
timestep, the frames are cut into chunks of ``chunk_size`` (the rotate-mode
schedule of ``core/chunk.py``); each chunk runs [uncond; cond] lanes through
the merging UNet, the first chunk initialising every block's global token
bank and the rest merging against it and replacing it; the CFG combine is
fp32; the DDIM update follows.  The JAX package's jit / fori_loop / scan
structure is a plain Python loop here.

Randomness: the chunk schedule comes from ``np.random.default_rng(seed)`` as
in the JAX package; the merge draws (dst frame per local round, global
coin) come from a :class:`~vidtome_torch.models.tome.DrawSource`, by default
filled from ``torch.Generator().manual_seed(seed)``.  Both are rebuilt for
every prompt, so every edit sees the same schedule and draws.
"""

from __future__ import annotations

import numpy as np
import torch

from vidtome_torch.core import chunk as chunking
from vidtome_torch.core.scheduler import DDIMScheduler, ddim_step
from vidtome_torch.models.registry import ModelBundle
from vidtome_torch.models.tome import DrawSource, ToMeConfig
from vidtome_torch.pipeline.common import (TextEncoder, VAECoder,
                                           reject_unported, resolve_precision)


class Generator:
    def __init__(self, bundle: ModelBundle, config):
        gene = config["generation"]
        reject_unported("generation", gene, config)
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
            align_batch=bool(gene.get("align_batch", False)),
            share_match=bool(gene.get("share_match", True)),
            len_quantum=gene.get("len_quantum", 1024))
        resolve_precision(config, gene, bundle)
        self.scheduler = DDIMScheduler.create(self.n_timesteps)
        self.text = TextEncoder(bundle)
        self.vae = VAECoder(bundle, batch_size=int(gene.get("batch_size", 8)))

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

    @torch.inference_mode()
    def ddim_sample(self, x: torch.Tensor, context: torch.Tensor,
                    fidx_table: np.ndarray | None = None,
                    draws: DrawSource | None = None) -> torch.Tensor:
        """Denoise padded latents x [n_padded, h, w, 4] under the
        [uncond; cond] context [2, S, C]."""
        sch = self.scheduler
        if fidx_table is None:
            fidx_table = self.fidx_table()
        n_chunks, F = fidx_table.shape[1], fidx_table.shape[2]
        if draws is None:
            draws = self.draw_source(n_chunks)
        unet = self.bundle.unet
        gs = self.guidance_scale
        ctx = context.repeat_interleave(F, dim=0)  # lane-major [uncond*F; cond*F]
        fidx_all = torch.as_tensor(fidx_table, dtype=torch.long,
                                   device=x.device)
        for i in range(sch.num_steps):
            t = int(sch.timesteps[i])
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
                eps_all = unet(torch.cat([x_chunk, x_chunk]), t, ctx,
                               tome_call=call)
                eps_u, eps_c = eps_all[:F].float(), eps_all[F:].float()
                # CFG combine in fp32, cast before the difference
                eps[scatter] = (eps_u + gs * (eps_c - eps_u)).to(eps.dtype)
            x = ddim_step(x, eps, *sch.sample_alpha_pair(i)).to(x.dtype)
        return x

    def __call__(self, init_latents: torch.Tensor) -> dict[str, torch.Tensor]:
        """Edit every prompt from the inverted latents [n, h, w, 4]; returns
        {edit name: frames [n, H, W, 3] in [0, 1]}."""
        self.configure_frames(init_latents.shape[0])
        x0 = init_latents.to(self.bundle.device, self.bundle.dtype)[
            torch.as_tensor(self.pad_src, device=self.bundle.device)]
        outputs = {}
        for name, prompt in self.prompt.items():
            print(f"[INFO] current prompt: {prompt}")
            context = self.text.embed_cfg(prompt, self.negative_prompt)
            clean = self.ddim_sample(x0, context)
            outputs[name] = self.vae.decode(clean[:self.n_frames])
        return outputs
