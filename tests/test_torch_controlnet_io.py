"""The port's control preprocessors and caches against the JAX package's.

``vidtome_torch.control`` and the cache half of ``vidtome_torch.io.
artifacts`` are copies written in the port of ``vidtome_tpu.control``
(preprocess, depth) and ``vidtome_tpu.io.artifacts``: the same frames give
identical images and byte-identical cache files through both.  Where a
model preprocessor cannot run (openpose without a pose model, a model
variable naming no checkpoint), the port fails as the JAX package does;
``tests/test_torch_control_models.py`` holds the nets themselves.
"""

from __future__ import annotations

import numpy as np
import pytest

from vidtome_torch.control import depth as t_depth
from vidtome_torch.control import preprocess as t_pre
from vidtome_torch.io import artifacts as t_art
from vidtome_tpu.control import depth as j_depth
from vidtome_tpu.control import preprocess as j_pre
from vidtome_tpu.io import artifacts as j_art


def _frames(n: int = 3, size: int = 64) -> np.ndarray:
    """Moving discs on gradients: edges for canny, texture for Sobel."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = []
    for i in range(n):
        disc = ((xx - 0.3 - 0.1 * i) ** 2 + (yy - 0.5) ** 2) < 0.04
        r = np.where(disc, 0.9, 0.5 + 0.4 * np.sin(6 * xx + i))
        g = np.where(disc, 0.1, 0.5 + 0.4 * np.cos(5 * yy))
        out.append(np.stack([r, g, np.full_like(xx, 0.3 + 0.1 * i)], -1))
    return np.stack(out).astype(np.float32)


@pytest.fixture
def no_models(monkeypatch):
    for env in ("VIDTOME_HED_MODEL", "VIDTOME_LINEART_MODEL",
                "VIDTOME_DEPTH_MODEL", "VIDTOME_POSE_MODEL"):
        monkeypatch.delenv(env, raising=False)


@pytest.mark.parametrize("control", ["canny", "tile", "ip2p", "depth",
                                     "softedge", "lineart_anime"])
def test_preprocess_matches_jax(no_models, control):
    frames = _frames()
    got = t_pre.control_preprocess(frames, control)
    want = j_pre.control_preprocess(frames, control)
    assert got.shape == frames.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= 1
    if control == "canny":
        assert got.max() == 1.0  # the discs' edges


def test_tile_resample_rate_matches_jax():
    frames = _frames()
    np.testing.assert_array_equal(
        t_pre.tile_preprocess(frames, resample_rate=0.25),
        j_pre.tile_preprocess(frames, resample_rate=0.25))


def test_preprocess_dict_has_the_same_types():
    assert sorted(t_pre.PREPROCESS_DICT) == sorted(j_pre.PREPROCESS_DICT)
    with pytest.raises(KeyError, match="unknown control type"):
        t_pre.control_preprocess(_frames(1), "sketch")


def test_depth_proxy_and_latents_match_jax(no_models, tmp_path):
    frames = _frames(2, 128)
    np.testing.assert_array_equal(t_depth.compute_depth(frames[0]),
                                  j_depth.compute_depth(frames[0]))
    raw = np.random.default_rng(0).random((40, 56)).astype(np.float32)
    raw[:3, :5] = -1  # the reference's background sentinel
    np.testing.assert_array_equal(
        t_depth.normalize_depth_to_latent(raw.copy(), (16, 16)),
        j_depth.normalize_depth_to_latent(raw.copy(), (16, 16)))
    got = t_depth.prepare_depth_latents(frames, [4, 9], str(tmp_path / "t"))
    want = j_depth.prepare_depth_latents(frames, [4, 9], str(tmp_path / "j"))
    assert got.shape == (2, 16, 16, 1)
    np.testing.assert_array_equal(got, want)


def _same_files(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_control_cache_is_byte_identical(tmp_path):
    frames, ids = _frames(), [3, 7, 12]
    fn = j_pre.canny_preprocess
    got = t_art.load_or_compute_control(str(tmp_path / "t"), "canny", frames,
                                        ids, fn)
    want = j_art.load_or_compute_control(str(tmp_path / "j"), "canny",
                                         frames, ids, fn)
    np.testing.assert_array_equal(got, want)
    assert t_art.control_image_dir("w", "canny") == \
        j_art.control_image_dir("w", "canny")
    names = [f"{i:04}.png" for i in ids]
    _same_files(tmp_path / "t" / "canny_image", tmp_path / "j" / "canny_image",
                names)
    # a second call reads the pngs back, as the JAX package does

    def fail(_):
        raise AssertionError("recomputed")

    again = t_art.load_or_compute_control(str(tmp_path / "t"), "canny",
                                          frames, ids, fail)
    np.testing.assert_array_equal(
        again, j_art.load_or_compute_control(str(tmp_path / "j"), "canny",
                                             frames, ids, fail))


def test_depth_cache_is_byte_identical(tmp_path, no_models):
    frames, ids = _frames(2), [0, 5]
    got = t_art.load_or_compute_depth(str(tmp_path / "t"), frames, ids,
                                      t_depth.compute_depth)
    want = j_art.load_or_compute_depth(str(tmp_path / "j"), frames, ids,
                                       j_depth.compute_depth)
    np.testing.assert_array_equal(got, want)
    _same_files(tmp_path / "t" / "depth", tmp_path / "j" / "depth",
                [f"{i:04}.{ext}" for i in ids for ext in ("npy", "png")])


def test_openpose_is_not_ported(no_models):
    """Without a pose model (no VIDTOME_POSE_MODEL, no controlnet_aux),
    openpose has no preprocessor: both packages raise the same
    RuntimeError, from the preprocessor and at validation."""
    for pre in (t_pre, j_pre):
        with pytest.raises(RuntimeError, match="needs a pose model"):
            pre.control_preprocess(_frames(1), "openpose")
        with pytest.raises(RuntimeError, match="VIDTOME_POSE_MODEL"):
            pre.validate_control_available("openpose")


@pytest.mark.parametrize("control,env", [
    ("softedge", "VIDTOME_HED_MODEL"),
    ("lineart_anime", "VIDTOME_LINEART_MODEL"),
    ("openpose", "VIDTOME_POSE_MODEL")])
def test_model_preprocessors_are_refused(monkeypatch, tmp_path, control,
                                         env):
    """With the model variable set, both packages run the model and never
    the Sobel fallback: a variable naming a directory that holds no
    checkpoint fails in both alike.  Validation passes, as in JAX.  A
    variable naming a path that does not exist fails in the port, from
    the preprocessor and at validation, where the JAX package would fall
    back to another preprocessor."""
    monkeypatch.setenv(env, str(tmp_path))
    for pre in (t_pre, j_pre):
        with pytest.raises(FileNotFoundError, match="no checkpoint file"):
            pre.control_preprocess(_frames(1), control)
        pre.validate_control_available(control)
    t_pre.validate_control_available("canny")
    monkeypatch.setenv(env, str(tmp_path / "missing.pth"))
    with pytest.raises(FileNotFoundError, match=env):
        t_pre.control_preprocess(_frames(1), control)
    with pytest.raises(FileNotFoundError, match=env):
        t_pre.validate_control_available(control)
