"""Chunk boundaries and batched chunks on the port vs the JAX package.

* Ragged fidx tables (``chunk_boundaries: ragged``) are byte-equal to
  JAX's ``build_fidx_table(..., ragged=True)`` over clips of 5-33 frames,
  chunks of 2, 4 and 8, every chunk order, global merging on and off, 3
  seeds; rotate-mode tables stay equal too.
* ``configure_frames`` pads as JAX does (a ragged clip that fills its
  chunks gets a chunk more: the waste slot).
* The Generator reads ``chunk_boundaries`` lower-cased and refuses what
  JAX refuses: an unknown value, and ``chunk_batch`` with ragged
  boundaries; every option but ``control`` is ported.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

from vidtome_torch.core import chunk as t_chunk
from vidtome_torch.models.registry import init_model
from vidtome_torch.pipeline import common
from vidtome_torch.pipeline.generator import Generator as TGen
from vidtome_tpu.config import Config
from vidtome_tpu.core import chunk as j_chunk

CONFIG = {
    "sd_version": "1.5", "height": 64, "width": 64, "seed": 123,
    "work_dir": "unused", "float_precision": "fp32",
    "generation": {
        "control": "none", "guidance_scale": 7.5, "n_timesteps": 4,
        "negative_prompt": "blurry", "prompt": {"edit": "a painting"},
        "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
        "merge_global": True, "global_merge_ratio": 0.8},
}


def _config(**gene) -> Config:
    cfg = copy.deepcopy(CONFIG)
    cfg["generation"].update(gene)
    return Config(cfg)


@pytest.mark.parametrize("chunk", [2, 4, 8])
@pytest.mark.parametrize("chunk_ord", ["seq", "rand", "mix-4"])
@pytest.mark.parametrize("merge_global", [True, False])
def test_ragged_tables_match_jax(chunk, chunk_ord, merge_global):
    order, div = t_chunk.parse_chunk_ord(chunk_ord)
    for n_frames in range(5, 34):
        n_padded = -(-n_frames // chunk) * chunk
        for seed in range(3):
            kw = dict(chunk_ord=order, perm_div=div,
                      merge_global=merge_global, ragged=True,
                      n_frames=n_frames)
            want = j_chunk.build_fidx_table(
                n_padded, chunk, np.random.default_rng(seed), 6, **kw)
            got = t_chunk.build_fidx_table(
                n_padded, chunk, np.random.default_rng(seed), 6, **kw)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            K = 1 + -(-(n_frames - 1) // chunk)
            assert got.shape == (6, K, chunk, 2)
            # every real frame gathered and written exactly once a step;
            # only the waste slot takes the duplicate writes
            for step in got:
                writes = np.sort(step[..., 1].reshape(-1))
                real = writes[writes < n_frames]
                np.testing.assert_array_equal(real, np.arange(n_frames))
                assert (writes[writes >= n_frames] == n_frames).all()
                assert step[..., 0].max() < n_frames
    rotate = dict(chunk_ord=order, perm_div=div, merge_global=merge_global)
    np.testing.assert_array_equal(
        t_chunk.build_fidx_table(4 * chunk, chunk, np.random.default_rng(1),
                                 5, **rotate),
        j_chunk.build_fidx_table(4 * chunk, chunk, np.random.default_rng(1),
                                 5, **rotate))


@pytest.fixture(scope="module")
def bundles():
    from tests.helpers import make_tiny_bundle

    return make_tiny_bundle(), init_model("tiny", weight_dtype="fp32",
                                          device="cpu")


@pytest.mark.parametrize("boundaries", ["rotate", "ragged", "Ragged"])
def test_configure_frames_matches_jax(bundles, boundaries):
    from vidtome_tpu.pipeline.generator import Generator as JGen

    jb, tb = bundles
    cfg = _config(chunk_boundaries=boundaries)
    gen, jgen = TGen(tb, cfg), JGen(jb, cfg, use_pallas=False)
    assert gen.ragged == jgen.ragged == (boundaries.lower() == "ragged")
    for n in (5, 6, 8, 10, 12):
        gen.configure_frames(n)
        jgen.configure_frames(n)
        assert gen.n_padded == jgen.n_padded
        np.testing.assert_array_equal(gen.pad_src, jgen.pad_src)
        assert gen.n_padded > n or not gen.ragged
        assert gen.fidx_table().shape[1] == (
            1 + -(-(n - 1) // 4) if gen.ragged else gen.n_padded // 4)


def test_invalid_chunk_modes_raise_like_jax(bundles):
    from vidtome_tpu.pipeline.generator import Generator as JGen

    jb, tb = bundles
    for gene, match in (({"chunk_boundaries": "wrap"}, "rotate|ragged"),
                        ({"chunk_batch": True, "chunk_boundaries": "RAGGED"},
                         "chunk_batch")):
        for build in (lambda c: TGen(tb, c),
                      lambda c: JGen(jb, c, use_pallas=False)):
            with pytest.raises(ValueError, match=match):
                build(_config(**gene))
    gen = TGen(tb, _config(chunk_batch=True, merge_crossattn=True,
                           merge_ff=True, chunk_boundaries="ROTATE"))
    assert gen.chunk_batch and not gen.ragged
    assert gen.tome.merge_crossattn and gen.tome.merge_ff
    assert list(common._UNPORTED) == ["control"]
