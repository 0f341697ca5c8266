"""The port's own config loader and I/O against the JAX package's.

``vidtome_torch.config``, ``vidtome_torch.io.artifacts`` and
``vidtome_torch.io.video`` are copies written in the port of
``vidtome_tpu.config`` and ``vidtome_tpu.io``; the same files must give
equal results through both."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import yaml

from vidtome_torch import config as t_config
from vidtome_torch.io import artifacts as t_art
from vidtome_torch.io import video as t_video
from vidtome_tpu import config as j_config
from vidtome_tpu.io import artifacts as j_art
from vidtome_tpu.io import video as j_video

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


@pytest.fixture
def in_root(monkeypatch):
    monkeypatch.chdir(ROOT)  # base_config paths are relative to the root


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_file_matches_jax(in_root, path):
    rel = str(path.relative_to(ROOT))
    got = t_config.load_config_file(rel)
    want = j_config.load_config_file(rel)
    assert isinstance(got, t_config.Config)
    assert got.to_dict() == want.to_dict()
    assert t_config.load_config_file(rel, resolve=False).to_dict() == \
        j_config.load_config_file(rel, resolve=False).to_dict()


def test_load_config_takes_the_cli_flag(in_root, capsys):
    got = t_config.load_config(["--config", "configs/demo.yaml", "--x", "1"])
    assert "[INFO] loaded config" in capsys.readouterr().out
    want = j_config.load_config(["--config", "configs/demo.yaml"],
                                print_config=False)
    assert got.to_dict() == want.to_dict()
    assert got.generation.prompt == got["generation"]["prompt"]
    with pytest.raises(AttributeError):
        got.no_such_key


def test_interpolation_and_base_chain(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text(yaml.safe_dump({
        "work_dir": "out", "n": 3,
        "generation": {"prompt": "a dog", "output_path": "${work_dir}/gen",
                       "steps": "${n}"}}))
    child = tmp_path / "child.yaml"
    child.write_text(yaml.safe_dump({"base_config": str(base),
                                     "work_dir": "${name}/w", "name": "x"}))
    got = t_config.load_config_file(str(child))
    assert got.to_dict() == j_config.load_config_file(str(child)).to_dict()
    assert got.generation.output_path == "x/w/gen"
    assert got.generation.steps == 3  # a whole reference keeps its type
    assert got.generation.prompt == {"edit": "a dog"}


@pytest.mark.parametrize("gene,inv", [(True, False), (False, True),
                                      (False, False)])
def test_save_config_reads_back(in_root, tmp_path, gene, inv):
    cfg = t_config.load_config_file("configs/serve.yaml")
    t_config.save_config(cfg, str(tmp_path / "t"), gene=gene, inv=inv)
    j_config.save_config(j_config.load_config_file("configs/serve.yaml"),
                         str(tmp_path / "j"), gene=gene, inv=inv)
    got = (tmp_path / "t" / "config.yaml").read_text()
    assert got == (tmp_path / "j" / "config.yaml").read_text()
    back = yaml.safe_load(got)
    want = cfg.to_dict()
    if gene:
        want.pop("inversion")
    if inv:
        want.pop("generation")
    assert back == want


def test_latent_cache_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(6, 8, 8, 4)).astype(np.float32)
    d_t = t_art.get_latents_dir(str(tmp_path / "t"), "models/sd-tiny/")
    d_j = j_art.get_latents_dir(str(tmp_path / "t"), "models/sd-tiny/")
    assert d_t == d_j == str(tmp_path / "t" / "sd-tiny")
    assert t_art.latent_path(d_t, 981) == j_art.latent_path(d_j, 981)
    assert not t_art.check_latents_exist(d_t, [981])
    path = t_art.save_latent(d_t, 981, lat)
    assert path == j_art.latent_path(d_j, 981)
    assert t_art.check_latents_exist(d_t, [981])
    assert j_art.check_latents_exist(d_j, [981])
    assert not t_art.check_latents_exist(d_t, [981, 1])
    # written by one package, read by the other, whole and by frame ids
    np.testing.assert_array_equal(j_art.load_latent(d_j, 981), lat)
    np.testing.assert_array_equal(t_art.load_latent(d_t, 981, [4, 0]),
                                  lat[[4, 0]])
    j_art.save_latent(d_j, 1, lat[:2])
    np.testing.assert_array_equal(t_art.load_latent(d_t, 1), lat[:2])
    with pytest.raises(FileNotFoundError, match="timestep 5"):
        t_art.load_latent(d_t, 5)


def test_load_video_matches_jax():
    path = str(ROOT / "data" / "demo.mp4")
    got = t_video.load_video(path, 64, 64)
    want = j_video.load_video(path, 64, 64)
    assert got.dtype == np.float32 and got.shape[1:] == (64, 64, 3)
    np.testing.assert_array_equal(got, want)
    ids = [0, 3, 5]
    np.testing.assert_array_equal(t_video.load_video(path, 64, 96, ids),
                                  j_video.load_video(path, 64, 96, ids))


def test_frame_folder_and_save_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    frames = rng.random((3, 70, 90, 3)).astype(np.float32)
    t_video.save_frames(frames, str(tmp_path / "frames"))
    got = t_video.load_video(str(tmp_path / "frames"), 64, 64)
    want = j_video.load_video(str(tmp_path / "frames"), 64, 64)
    np.testing.assert_array_equal(got, want)
    out = t_video.save_video(got, str(tmp_path / "vid"), save_frame=True)
    assert out == str(tmp_path / "vid" / "output.mp4")
    assert (tmp_path / "vid" / "frames" / "0002.png").exists()
    with pytest.raises(FileNotFoundError):
        t_video.load_video(str(tmp_path / "empty"), 64, 64)
