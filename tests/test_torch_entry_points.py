"""The port's stage entry points and its ``tpu`` keys against the JAX
package's.

``python -m vidtome_torch.pipeline.inverter`` / ``.generator`` (their
``main``, on the CPU with ``device="cpu"``) from one YAML, with the JAX
tiny bundle's weights carried into the port (``tests/torch_parity``): the
inversion writes the JAX ``Inverter``'s latents (fp32, within 1e-4 of max
|ref|) and its ``inversion_prompts.txt`` byte for byte; the generation,
merging off (the two packages draw merges from different key chains),
gives frames within the repo's 35 dB floor of the JAX generation's, and
without cached latents raises ``cli.run_generation``'s error.  A
``tpu.mesh`` over two devices and ``tpu.multihost`` are refused;
``tpu.profile_dir`` writes a Chrome trace of the denoising loop (JSON,
holding the UNet's ops) and leaves the frames as they were; on the SDXL
two-stage path one for each stage's loop, as the JAX package traces them.
"""

from __future__ import annotations

import copy
import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from tests.helpers import make_tiny_bundle, make_tiny_video
from tests.torch_parity import port_bundle_from_jax, psnr
from vidtome_torch import cli
from vidtome_torch.io.video import load_video
from vidtome_torch.pipeline import generator as t_generator
from vidtome_torch.pipeline import inverter as t_inverter

torch.set_num_threads(2)

N_FRAMES = 4
SIZE = 64
STEPS = 2


def _config(root: str, video: str, name: str) -> dict:
    work = os.path.join(root, name)
    return {
        "sd_version": "1.5", "input_path": video, "work_dir": work,
        "height": SIZE, "width": SIZE, "seed": 123,
        "float_precision": "fp32",
        "inversion": {
            "save_path": os.path.join(work, "latents"),
            "prompt": "a colorful gradient", "steps": STEPS,
            "save_steps": STEPS, "save_intermediate": True, "batch_size": 4,
            "n_frames": N_FRAMES, "force": False, "recon": False,
            "control": "none"},
        "generation": {
            "control": "none", "guidance_scale": 7.5, "n_timesteps": STEPS,
            "negative_prompt": "blurry",
            "prompt": {"edit": "a colorful gradient, oil painting"},
            "latents_path": os.path.join(work, "latents"),
            "output_path": os.path.join(work, "out"), "chunk_size": 4,
            "chunk_ord": "mix-4", "local_merge_ratio": 0.0,
            "merge_global": False, "save_frame": True,
            "frame_range": [N_FRAMES]},
        "tpu": {"mesh": None, "multihost": False,
                "use_pallas_attention": True},
    }


def _write(cfg: dict, path: str) -> list[str]:
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return ["--config", path]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX inversion and generation of the config, and the port bundle
    with the JAX bundle's weights."""
    from vidtome_tpu.config import Config
    from vidtome_tpu.pipeline.generator import Generator as JGen
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    root = str(tmp_path_factory.mktemp("entry"))
    video = make_tiny_video(os.path.join(root, "video"), n_frames=N_FRAMES,
                            size=SIZE)
    jb = make_tiny_bundle()
    cfg = Config(_config(root, video, "jax"))
    JInv(jb, cfg, use_pallas=False)(cfg.input_path, cfg.inversion.save_path)
    JGen(jb, cfg, use_pallas=False)(
        cfg.input_path, cfg.generation.latents_path,
        cfg.generation.output_path, list(range(N_FRAMES)))
    return root, video, port_bundle_from_jax(jb), os.path.join(
        root, "jax", "latents", jb.model_key)


@pytest.fixture
def port_init(monkeypatch, run):
    """The stages' init_model gives the port bundle of the JAX weights."""
    calls = []

    def init_model(**kwargs):
        calls.append(kwargs)
        return run[2]

    monkeypatch.setattr(cli, "init_model", init_model)
    return calls


def test_stage_entry_points_match_jax(run, port_init, tmp_path):
    root, video, tb, jax_dir = run
    cfg = _config(str(tmp_path), video, "port")
    argv = _write(cfg, str(tmp_path / "port.yaml"))
    t_inverter.main(argv, device="cpu")
    assert port_init[0]["device"] == "cpu"
    assert port_init[0]["sd_version"] == "1.5"
    port_dir = os.path.join(cfg["inversion"]["save_path"], tb.model_key)
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(jax_dir, "noisy_latents_*.npy")))
    assert names and names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(port_dir, "noisy_latents_*.npy")))
    for name in names:
        ref = np.load(os.path.join(jax_dir, name))
        got = np.load(os.path.join(port_dir, name))
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), name
    with open(os.path.join(jax_dir, "inversion_prompts.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(port_dir, "inversion_prompts.txt"), "rb") as f:
        assert f.read() == want

    # the generation alone, from the latents the inversion cached
    t_generator.main(argv, device="cpu")
    frames = {}
    for side, work in (("jax", os.path.join(root, "jax")),
                       ("port", os.path.join(str(tmp_path), "port"))):
        frames[side] = load_video(os.path.join(work, "out", "edit",
                                               "frames"), SIZE, SIZE)
    assert frames["port"].shape == (N_FRAMES, SIZE, SIZE, 3)
    assert psnr(frames["port"], frames["jax"]) >= 35.0


def test_generator_without_latents_raises(run, port_init, tmp_path):
    cfg = _config(str(tmp_path), run[1], "empty")
    with pytest.raises(FileNotFoundError, match="Required latents not found"):
        t_generator.main(_write(cfg, str(tmp_path / "c.yaml")), device="cpu")


@pytest.mark.parametrize("tpu", [{"mesh": {"data": 2}}, {"multihost": True},
                                 {"mesh": {"data": 1, "model": 2}}],
                         ids=["data2", "multihost", "model2"])
@pytest.mark.parametrize("entry", ["inverter", "generator", "setup"])
def test_multi_device_tpu_keys_are_refused(run, port_init, tmp_path, tpu,
                                           entry):
    cfg = _config(str(tmp_path), run[1], "mesh")
    cfg["tpu"].update(tpu)
    argv = _write(cfg, str(tmp_path / "c.yaml"))
    fn = {"inverter": t_inverter.main, "generator": t_generator.main,
          "setup": cli.setup_from_argv}[entry]
    with pytest.raises(NotImplementedError, match="parallel/"):
        fn(argv, device="cpu")
    assert port_init == []  # refused before any model is built


def test_setup_needs_a_card_unless_asked(run, port_init, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    argv = _write(_config(str(tmp_path), run[1], "c"),
                  str(tmp_path / "c.yaml"))
    with pytest.raises(SystemExit, match="CUDA"):
        cli.setup_from_argv(argv)
    config, bundle = cli.setup_from_argv(argv, device="cpu")
    assert bundle is run[2] and config["model_key"] == bundle.model_key


def test_profile_dir_writes_a_trace(run, tmp_path, capsys):
    _, video, tb, _ = run
    cfg = cli.load_config(_write(_config(str(tmp_path), video, "prof"),
                                 str(tmp_path / "c.yaml")))
    cfg["model_key"] = tb.model_key
    cli.run_inversion(cfg, tb)
    plain = cli.run_generation(cfg, tb)["edit"]
    traced_cfg = copy.deepcopy(cfg)
    traced_cfg["tpu"]["profile_dir"] = str(tmp_path / "trace")
    traced_cfg["generation"]["output_path"] = str(tmp_path / "out2")
    traced = cli.run_generation(traced_cfg, tb)["edit"]
    assert torch.equal(traced, plain)
    files = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(files) == 1
    assert "profiler trace written to " + files[0] in capsys.readouterr().out
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::conv2d", "aten::linear", "aten::group_norm"} & names
    assert "aten::conv2d" in names and "aten::linear" in names


def test_profile_dir_traces_both_sdxl_stages(tmp_path):
    """On the SDXL two-stage path each stage's ddim_sample is traced, as
    in the JAX package: the base's and the refiner's, two files."""
    from tests.test_torch_checkpoint import _stack
    from vidtome_torch.config import Config

    cfg = Config({
        "sd_version": "xl", "height": 64, "width": 64, "seed": 123,
        "float_precision": "fp32",
        "generation": {
            "control": "none", "guidance_scale": 7.5, "n_timesteps": 2,
            "negative_prompt": "blurry", "prompt": {"edit": "a gradient"},
            "chunk_size": 4, "local_merge_ratio": 0.0,
            "merge_global": False,
            "refiner": {"sd_version": "tiny-refiner",
                        "denoising_start": 0.5}},
        "tpu": {"profile_dir": str(tmp_path / "trace")}})
    gen = t_generator.Generator(_stack("xl"), cfg)
    gen.configure_frames(4)
    out = gen.sample(torch.randn(4, 8, 8, 4), "a gradient")
    assert out.shape == (4, 8, 8, 4) and torch.isfinite(out).all()
    assert len(glob.glob(str(tmp_path / "trace" / "ddim_sample_*.json"))) == 2
