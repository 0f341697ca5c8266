"""The port's frame-quality module (``vidtome_torch.eval``) against the JAX
package's (``vidtome_tpu.eval``): PSNR, SSIM, temporal consistency and
``compare`` of two frame directories give the same numbers (to 1e-9), on
clips from ``tests/helpers.make_tiny_video`` and copies of them moved by
seeded numpy noise; identical frames give ``inf`` in both."""

from __future__ import annotations

import json

import numpy as np
import pytest

from tests.helpers import make_tiny_video
from vidtome_torch import eval as t_eval
from vidtome_torch.io.video import load_video, save_frames
from vidtome_tpu import eval as j_eval

SIZE = 64


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two frame dirs: the tiny video, and it plus seeded noise."""
    root = tmp_path_factory.mktemp("clips")
    a = make_tiny_video(str(root / "a"), n_frames=4, size=SIZE)
    frames = load_video(a, SIZE, SIZE)
    noise = np.random.default_rng(0).normal(0, 0.03, frames.shape)
    b = str(root / "b")
    save_frames(np.clip(frames + noise, 0, 1).astype(np.float32), b)
    return a, b


def _frames(path):
    return load_video(path, SIZE, SIZE)


@pytest.mark.parametrize("fn", ["psnr", "ssim"])
@pytest.mark.parametrize("same", [False, True], ids=["noisy", "identical"])
def test_pair_metrics_match_jax(clips, fn, same):
    a = _frames(clips[0])
    b = a if same else _frames(clips[1])
    for i in range(len(a)):
        got = getattr(t_eval, fn)(a[i], b[i])
        want = getattr(j_eval, fn)(a[i], b[i])
        if fn == "psnr" and same:
            assert got == want == float("inf")
        else:
            assert np.isfinite(got)
            assert abs(got - want) <= 1e-9


@pytest.mark.parametrize("which", [0, 1])
def test_temporal_consistency_matches_jax(clips, which):
    frames = _frames(clips[which])
    got = t_eval.temporal_consistency(frames)
    assert np.isfinite(got)
    assert abs(got - j_eval.temporal_consistency(frames)) <= 1e-9
    # one frame: no pair to warp
    assert t_eval.temporal_consistency(frames[:1]) == float("inf")


@pytest.mark.parametrize("same", [False, True], ids=["noisy", "identical"])
def test_compare_and_main_match_jax(clips, capsys, same):
    a, b = clips
    b = a if same else b
    got = t_eval.compare(a, b, SIZE, SIZE)
    want = j_eval.compare(a, b, SIZE, SIZE)
    assert got.keys() == want.keys()
    for k in want:
        if np.isinf(want[k]):
            assert got[k] == want[k]
        else:
            assert abs(got[k] - want[k]) <= 1e-9, k
    assert (got["psnr_mean"] == float("inf")) == same
    t_eval.main(["--a", a, "--b", b, "--height", str(SIZE), "--width",
                 str(SIZE)])
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):]) == json.loads(json.dumps(got))
