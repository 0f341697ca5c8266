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
``tpu.mesh`` over two ranks runs each stage entry on two gloo ranks (their
outputs held to the one-process run's), ``tpu.multihost`` joins a process
group, and a mesh larger than the ranks is refused; the logger follows a
redirected stdout; ``tpu.profile_dir`` writes a Chrome trace of the denoising loop (JSON,
holding the UNet's ops) and leaves the frames as they were; on the SDXL
two-stage path one for each stage's loop, as the JAX package traces them.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import io
import json
import os

import numpy as np
import pytest
import torch
import yaml

from tests.helpers import make_tiny_bundle, make_tiny_video
from tests.torch_parity import port_bundle_from_jax, psnr
from tests.torch_ranks import setup_rank
from vidtome_torch import cli
from vidtome_torch.io.video import load_video
from vidtome_torch.logging_utils import get_logger
from vidtome_torch.parallel.launch import spawn
from vidtome_torch.parallel.mesh import make_mesh
from vidtome_torch.pipeline import generator as t_generator
from vidtome_torch.pipeline import inverter as t_inverter

torch.set_num_threads(2)

N_FRAMES = 4
SIZE = 64
STEPS = 2
RANKS_TIMEOUT = 120  # seconds for a spawn's ranks and each collective


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


def _tiny_config(root: str, video: str, name: str, latents: str | None = None,
                 tpu: dict | None = None) -> dict:
    """A config of the tiny stack (random weights seeded alike in every
    process) with local and global merging on, so that a data axis splits
    merged calls."""
    cfg = _config(root, video, name)
    cfg["sd_version"] = "tiny"
    cfg["generation"].update(local_merge_ratio=0.9, merge_global=True)
    if latents is not None:
        cfg["generation"]["latents_path"] = latents
    cfg["tpu"].update(tpu or {})
    return cfg


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The tiny config's inversion and generation in this process: the
    video, the latents dir and the frames."""
    root = str(tmp_path_factory.mktemp("one"))
    video = make_tiny_video(os.path.join(root, "video"), n_frames=N_FRAMES,
                            size=SIZE)
    cfg = _tiny_config(root, video, "one")
    argv = _write(cfg, os.path.join(root, "one.yaml"))
    t_inverter.main(argv, device="cpu")
    t_generator.main(argv, device="cpu")
    return video, cfg["inversion"]["save_path"], _frames_of(cfg)


def _frames_of(cfg: dict) -> np.ndarray:
    return load_video(os.path.join(cfg["generation"]["output_path"], "edit",
                                   "frames"), SIZE, SIZE)


def _latents_of(cfg: dict) -> dict:
    d = os.path.join(cfg["inversion"]["save_path"], "tiny-test-model")
    d = d if os.path.isdir(d) else glob.glob(
        os.path.join(cfg["inversion"]["save_path"], "*"))[0]
    return {os.path.basename(p): np.load(p) for p in glob.glob(
        os.path.join(d, "noisy_latents_*.npy"))}


@pytest.fixture
def free_group():
    """A 1-process gloo group's coordinator on a free port, the group
    destroyed after the test."""
    from vidtome_torch.parallel.launch import free_port

    yield f"localhost:{free_port()}"
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("tpu", [{"mesh": {"data": 2}}, {"multihost": True},
                                 {"mesh": {"data": 1, "model": 2}}],
                         ids=["data2", "multihost", "model2"])
@pytest.mark.parametrize("entry", ["inverter", "generator", "setup"])
def test_multi_device_tpu_keys_are_refused(one_process, tmp_path, tpu, entry,
                                           capfd, free_group):
    """What each entry does with the ``tpu`` keys that it refused before
    ``parallel/`` was ported (the test keeps its name): a ``mesh`` of two
    makes the stage entries start two gloo ranks on the CPU, whose rank 0
    writes what the one-process run writes (the inversion's latents within
    1e-5; the frames within test_pipeline_mesh's bars, 2e-3 of mean |diff|
    on the data axis and 0.02 on the model axis), and makes ``setup``, the
    in-rank preamble, build the mesh over the ranks it runs in, each on its
    place; ``multihost: true`` with the manual keys joins a 1-process group
    (tcp on a free port, world size 1, gloo) before the stage runs."""
    video, latents, frames = one_process
    if "multihost" in tpu:
        tpu = {"multihost": True, "coordinator": free_group,
               "num_processes": 1, "process_id": 0}
    cfg = _tiny_config(str(tmp_path), video, "mesh", latents, tpu)
    argv = _write(cfg, str(tmp_path / "c.yaml"))
    if entry == "setup" and "mesh" in tpu:
        out = str(tmp_path / "setup")
        os.makedirs(out)
        spawn(setup_rank, 2, (argv, out), ["cpu", "cpu"],
              timeout=RANKS_TIMEOUT, collective_timeout=RANKS_TIMEOUT)
        data, model = tpu["mesh"].get("data", 1), tpu["mesh"].get("model", 1)
        for rank in range(2):
            got = torch.load(os.path.join(out, f"{rank}.pt"))
            assert got == {"shape": {"data": data, "model": model},
                           "rank": rank, "world": 2, "backend": "gloo",
                           "device": "cpu", "bundle_mesh": True,
                           "heads": 2 // model}
        return
    if entry == "setup":
        config, bundle = cli.setup_from_argv(argv, device="cpu")
        assert torch.distributed.get_world_size() == 1
        assert torch.distributed.get_backend() == "gloo"
        assert bundle.mesh is None and config["sd_version"] == "tiny"
        return
    {"inverter": t_inverter.main, "generator": t_generator.main}[entry](
        argv, device="cpu", timeout=RANKS_TIMEOUT)
    printed = capfd.readouterr().out
    if "mesh" in tpu:
        shape = {"data": tpu["mesh"].get("data", 1),
                 "model": tpu["mesh"].get("model", 1)}
        assert f"starting 2 ranks for tpu.mesh {tpu['mesh']}" in printed
        for rank in range(2):
            assert f"device mesh: {shape} (rank {rank}:" in printed
    else:
        assert "torch.distributed initialized: process 0/1, backend gloo" \
            in printed
    if entry == "inverter":
        got, want = _latents_of(cfg), _latents_of({"inversion": {
            "save_path": latents}})
        assert got and sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-5)
    else:
        bar = 0.02 if tpu.get("mesh", {}).get("model", 1) > 1 else 2e-3
        diff = np.abs(_frames_of(cfg) - frames).mean()
        assert diff < bar, diff


def test_mesh_larger_than_the_ranks_is_refused(one_process, tmp_path):
    """``setup`` in one process with a 2-rank mesh and no process group,
    and a mesh over more devices than there are."""
    cfg = _tiny_config(str(tmp_path), one_process[0], "big", None,
                       {"mesh": {"data": 2}})
    with pytest.raises(ValueError, match="spans 2 ranks; this process "
                                         "group has 1"):
        cli.setup_from_argv(_write(cfg, str(tmp_path / "c.yaml")),
                            device="cpu")
    with pytest.raises(ValueError, match="need 2 devices for mesh"):
        make_mesh(data=1, model=2)


def test_get_logger_follows_stdout(capsys):
    """The logger writes to the stdout of the moment it logs: a line logged
    under another stdout goes there, not to the first one's."""
    log = get_logger()
    log.info("under the first")
    assert "[INFO] under the first" in capsys.readouterr().out
    other = io.StringIO()
    with contextlib.redirect_stdout(other):
        log.info("under the second")
    assert other.getvalue() == "[INFO] under the second\n"
    assert capsys.readouterr().out == ""


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
