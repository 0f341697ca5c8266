"""The gated-off generation modes as slices, port vs JAX package, on the CPU.

Each slice generates from the same seeded latents on both packages (tiny
SD1.5 bundle, fp32, 64x64 frames, 4 DDIM steps, chunk 4, local and global
merging, the JAX package's merge draws; under ``chunk_batch`` the batched
call takes the draws of chunk position 1, as JAX folds in ``chunk_pos =
1``) and holds the decoded frames against the JAX package's at a 60 dB
bar (above the repo's 35 dB floor, BASELINE.md) that a wrong bank layout
or a wrong waste-slot write would fail:

* ``chunk_batch`` at 12 frames (3 chunks: one call for the first, one for
  chunks 2-3), without and with the serving caches;
* ``chunk_boundaries: ragged`` at 6 and 8 frames (8 frames: 3 chunks, the
  third from the waste slot's padding);
* the LDM variant (``merge_crossattn`` and ``merge_ff``);
* the mean merge mode, which only ``ToMeConfig.merge_mode`` reaches: both
  Generators' configs replaced (the JAX one's UNet and sample block
  rebuilt on it), with the merge statistics collected.

Without merging, ``chunk_batch`` is a pure batching: the batched
generation equals the sequential one to 1e-5 (as
``tests/test_chunk_batch.py:90``).
"""

from __future__ import annotations

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import jax_draw_table, port_bundle_from_jax, psnr, to_np
from vidtome_torch.models.tome import DrawSource
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_tpu.config import Config

torch.set_num_threads(2)

STEPS = 4
PSNR_SLICE = 60.0
PROMPT = "a colorful gradient, oil painting"
CONFIG = {
    "sd_version": "1.5", "height": 64, "width": 64, "seed": 123,
    "work_dir": "unused", "float_precision": "fp32",
    "generation": {
        "control": "none", "guidance_scale": 7.5, "n_timesteps": STEPS,
        "negative_prompt": "blurry", "prompt": {"edit": PROMPT},
        "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
        "merge_global": True, "global_merge_ratio": 0.8, "align_batch": True,
        "share_match": True, "len_quantum": 1024},
}
# steps: 0 full, 1 shallow with the CFG skip, 2 eps skip, 3 full
CACHES = {"cache_schedule": "full:1,shallow:2",
          "cfg_schedule": "full:1,shallow:2",
          "eps_schedule": "full:2,shallow:1", "eps_extrapolate": True}


def config(**gene) -> Config:
    cfg = copy.deepcopy(CONFIG)
    cfg["generation"].update(gene)
    return Config(cfg)


def latents(n: int) -> np.ndarray:
    return np.random.default_rng(n).standard_normal(
        (n, 8, 8, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def bundles():
    from tests.helpers import make_tiny_bundle

    jb = make_tiny_bundle()
    return jb, port_bundle_from_jax(jb)


def jax_frames(jb, cfg, x: np.ndarray, **tome) -> np.ndarray:
    from vidtome_tpu.pipeline.generator import Generator as JGen

    jgen = JGen(jb, cfg)
    if tome:
        jgen.tome = dataclasses.replace(jgen.tome, **tome)
        jgen.unet = jb.make_unet(tome=jgen.tome)
        jgen._sample_block = jgen._build_sample_fn()
    jgen.configure_frames(x.shape[0])
    jgen.depth = jgen.control_images = None
    clean = jgen.ddim_sample(jnp.asarray(x)[jgen.pad_src],
                             jgen._build_context(PROMPT))
    return np.asarray(jgen.vae.decode(clean[:x.shape[0]]), np.float32)


def port_sample(tb, cfg, x: np.ndarray, jax_draws: bool = True, **tome):
    """(clean latents, generator) of the port from latents x [n, h, w, 4];
    ``tome`` replaces fields of the generator's ToMeConfig."""
    gen = TGen(tb, cfg)
    gen.tome = dataclasses.replace(gen.tome, **tome)
    gen.configure_frames(x.shape[0])
    table = gen.fidx_table()
    draws = (DrawSource(jax_draw_table(123, STEPS, table.shape[1], 4, 4))
             if jax_draws else None)
    clean = gen.ddim_sample(torch.from_numpy(x)[torch.as_tensor(gen.pad_src)],
                            gen.context(PROMPT), fidx_table=table,
                            draws=draws)
    return clean[:x.shape[0]], gen


def check_slice(bundles, cfg, n: int, name: str, **tome):
    jb, tb = bundles
    x = latents(n)
    want = jax_frames(jb, cfg, x, **tome)
    clean, gen = port_sample(tb, cfg, x, **tome)
    got = to_np(gen.vae.decode(clean))
    assert got.shape == (n, 64, 64, 3) and np.isfinite(got).all()
    score = psnr(got, want)
    print(f"{name} slice PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_SLICE
    return gen


@pytest.mark.parametrize("caches", [False, True], ids=["plain", "caches"])
def test_chunk_batch_slice_matches_jax(bundles, caches):
    gen = check_slice(bundles, config(chunk_batch=True,
                                      **(CACHES if caches else {})),
                      12, "chunk_batch" + (" + caches" if caches else ""))
    calls = gen.unet_calls
    run = STEPS - calls["eps_skip"]
    # two UNet calls a step that runs one: the first chunk, then 2..3
    assert calls["full"] + calls["shallow"] == 2 * run
    if caches:
        assert calls["shallow"] and calls["cfg_skip"] and calls["eps_skip"]


@pytest.mark.parametrize("n", [6, 8])
def test_ragged_slice_matches_jax(bundles, n):
    gen = check_slice(bundles, config(chunk_boundaries="ragged"), n,
                      f"ragged {n} frames")
    K = 1 + -(-(n - 1) // 4)
    assert gen.n_padded == (8 if n == 6 else 12)
    assert gen.unet_calls["full"] == K * STEPS


def test_ldm_slice_matches_jax(bundles):
    check_slice(bundles, config(merge_crossattn=True, merge_ff=True), 8,
                "LDM")


def test_mean_merge_slice_matches_jax(bundles):
    gen = check_slice(bundles, config(), 8, "mean merge", merge_mode="mean",
                      collect_stats=True)
    stats = gen.tome_stats
    assert sorted(stats) == [0, 1] and all(
        v["merged_len"] < v["seq_len"] for s in stats.values()
        for v in s.values())


def test_unmerged_chunk_batch_equals_sequential(bundles):
    _, tb = bundles
    x = latents(12)
    off = dict(local_merge_ratio=0.0, merge_global=False)
    seq, gen_s = port_sample(tb, config(**off), x, jax_draws=False)
    bat, gen_b = port_sample(tb, config(chunk_batch=True, **off), x,
                             jax_draws=False)
    assert (gen_s.unet_calls["full"], gen_b.unet_calls["full"]) == (
        3 * STEPS, 2 * STEPS)
    scale = float(seq.abs().max())
    assert float((bat - seq).abs().max()) <= 1e-5 * scale
