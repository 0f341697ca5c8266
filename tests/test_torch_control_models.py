"""The model-backed control preprocessors of the port (HED softedge,
Anime2Sketch lineart, the OpenPose body net) against the JAX package, on
the CPU.

Each net gets one random state dict in its torch checkpoint layout
(He-normal convolutions from a torch seed, zero biases), loaded by the
port's module with ``strict=True`` and by the JAX converter
(``convert_hed_state_dict`` / ``convert_lineart_state_dict`` /
``convert_pose_state_dict``) into the Flax forward.  Held:

* the raw maps, to 1e-5 of their largest magnitude (fp32 on both sides;
  lineart's, through fourteen instance norms, to 1e-4);
* ``hed_edges``: the share of ``safe_step`` pixels that differ at most
  ``SAFE_STEP_SHARE`` (0 in these runs); ``lineart_edges`` to atol 1e-4;
* the pose post-processing, copied as it stands: the same peaks,
  connections, subsets and drawn image as the JAX functions on the same
  maps, and ``pose_images`` through each package's own net.  A random pose
  net's heatmaps place their peaks on no part in particular and its PAFs
  connect none of them, so the net's last heatmap layer gives every part
  the nose channel's weights and its last PAF layer a field pointing down
  and right (:func:`perturb_pose`): the peaks (36-126 a 64x64 frame here)
  then connect into people and the drawing is not black;
* the preprocess dispatch with each model variable set and unset, the
  device the caller names, and openpose's fail-fast at construction.

The three nets at 512x512 against JAX are ``slow``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch import nn

from vidtome_torch.control import edge_hed as t_hed
from vidtome_torch.control import lineart as t_line
from vidtome_torch.control import loading as t_loading
from vidtome_torch.control import pose as t_pose
from vidtome_torch.control import preprocess as t_pre
from vidtome_tpu.control import edge_hed as j_hed
from vidtome_tpu.control import lineart as j_line
from vidtome_tpu.control import pose as j_pose

torch.set_num_threads(2)

MAP_TOL = 1e-5         # relative to the largest |map|: fp32 on both sides
SAFE_STEP_SHARE = 1e-3  # HED: share of safe_step pixels allowed to differ
LINEART_TOL = 1e-4     # lineart maps in [0, 1], absolute
ENV = {"softedge": "VIDTOME_HED_MODEL",
       "lineart_anime": "VIDTOME_LINEART_MODEL",
       "openpose": "VIDTOME_POSE_MODEL"}


def he_init(module: nn.Module, seed: int) -> nn.Module:
    """He-normal weights, zero biases, from a torch seed."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 4:
                p.copy_(torch.randn(p.shape, generator=g)
                        * (2.0 / p[0].numel()) ** 0.5)
            else:
                p.zero_()
    return module


def perturb_pose(model: t_pose.BodyPoseModel, heat_scale: float = 1.0):
    """Every heatmap channel of the last stage takes channel 0's weights
    (times ``heat_scale``); the last PAF layer's weights shrink by 10 and
    its bias is 0.6 everywhere, a field pointing down and right."""
    with torch.no_grad():
        heat, paf = model.Mconv7_stage6_L2, model.Mconv7_stage6_L1
        heat.weight.copy_(heat.weight[:1].expand_as(heat.weight)
                          * heat_scale)
        heat.bias.fill_(0.0)
        paf.weight.mul_(0.1)
        paf.bias.fill_(0.6)
    return model


def hed_state(seed: int = 1) -> dict:
    m = he_init(t_hed.HEDNetwork(), seed)
    with torch.no_grad():
        m.norm.copy_(torch.tensor([104.0, 117.0, 123.0]).reshape(1, 3, 1, 1))
    return m.state_dict()


def lineart_state(seed: int = 2) -> dict:
    return he_init(t_line.UnetGenerator(), seed).state_dict()


def pose_state(seed: int = 3) -> dict:
    return perturb_pose(he_init(t_pose.BodyPoseModel(), seed)).state_dict()


def clip(n: int = 2, size: int = 64) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = []
    for i in range(n):
        ph = i / n
        disc = ((xx - 0.3 - 0.4 * ph) ** 2 + (yy - 0.6) ** 2) < 0.01
        r = np.where(disc, 0.9, 0.5 + 0.4 * np.sin(2 * np.pi * (xx + ph)))
        g = np.where(disc, 0.1, 0.5 + 0.4 * np.cos(2 * np.pi * yy))
        out.append(np.stack([r, g, np.full_like(xx, 0.3 + 0.2 * ph)], -1))
    return np.stack(out).astype(np.float32)


def _np(state: dict) -> dict:
    return {k: v.numpy() for k, v in state.items()}


def _close(got, want, tol=MAP_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err < tol, err


@pytest.fixture
def ckpts(tmp_path):
    paths = {"hed": tmp_path / "ControlNetHED.pth",
             "lineart": tmp_path / "netG.pth",
             "pose": tmp_path / "body_pose_model.pth"}
    torch.save(hed_state(), paths["hed"])
    # Anime2Sketch checkpoints carry a DataParallel "module." prefix
    torch.save({f"module.{k}": v for k, v in lineart_state().items()},
               paths["lineart"])
    torch.save(pose_state(), paths["pose"])
    return {k: str(v) for k, v in paths.items()}


# ----------------------------------------------------------------- HED


def test_hed_net_matches_jax():
    sd = hed_state()
    model = t_hed.load_hed(sd).eval()
    x = clip(2, 48) * 255.0
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    want = j_hed._build_model().apply(
        {"params": j_hed.convert_hed_state_dict(_np(sd))}, x)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g.numpy().transpose(0, 2, 3, 1), w)


@pytest.mark.parametrize("safe", [True, False], ids=["safe", "soft"])
def test_hed_edges_match_jax(ckpts, safe):
    imgs = clip(2, 64)
    got = t_hed.hed_edges(imgs, ckpts["hed"], "cpu", safe=safe)
    want = j_hed.hed_edges(imgs, ckpts["hed"], safe=safe)
    assert got.shape == want.shape == (2, 64, 64, 3)
    if safe:
        share = float((got != want).mean())
        print(f"HED safe_step pixels that differ: {share:.2e}")
        assert share <= SAFE_STEP_SHARE
        assert set(np.unique(got)) <= {0.0, 0.5, 1.0}
        assert len(np.unique(got)) > 1
    else:  # logits of +-100 carry fp32 noise of 1e-5 into the sigmoid
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ------------------------------------------------------------- lineart


def test_lineart_net_matches_jax():
    sd = lineart_state()
    model = t_line.load_lineart(sd).eval()
    x = clip(1, 256) * 2.0 - 1.0
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    want = j_line.unet_generator_apply(j_line.convert_lineart_state_dict(
        _np(sd)), x)
    # fourteen instance norms, down to 2x2 pixels, amplify the fp32 noise
    _close(got.numpy().transpose(0, 2, 3, 1), want, tol=LINEART_TOL)


def test_lineart_edges_match_jax(ckpts):
    imgs = clip(2, 64)[:, :, :48]  # resized to 256x256 for the net
    got = t_line.lineart_edges(imgs, ckpts["lineart"], "cpu")
    want = j_line.lineart_edges(imgs, ckpts["lineart"])
    assert got.shape == want.shape == (2, 64, 48, 3)
    assert got.std() > 0.05
    np.testing.assert_allclose(got, want, atol=LINEART_TOL, rtol=0)


# ---------------------------------------------------------------- pose


def test_pose_net_matches_jax():
    sd = pose_state()
    model = t_pose.load_pose(sd).eval()
    x = clip(1, 32) - 0.5
    with torch.no_grad():
        paf, heat = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    want = j_pose._build_model().apply(
        {"params": j_pose.convert_pose_state_dict(_np(sd))}, x)
    _close(paf.numpy().transpose(0, 2, 3, 1), want[0])
    _close(heat.numpy().transpose(0, 2, 3, 1), want[1])


def test_pose_wrapped_layout_loads():
    sd = pose_state()
    wrapped = {f"model{i % 3}.{k}": v for i, (k, v) in enumerate(sd.items())}
    a, b = t_pose.load_pose(sd), t_pose.load_pose(wrapped)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])


def _post(mod, heat, paf, H):
    peaks = mod.find_peaks(heat)
    conns, special = mod.score_connections(peaks, paf, H)
    cand, subset = mod.assemble_subsets(peaks, conns, special)
    canvas = mod.draw_bodypose(np.zeros((H, heat.shape[1], 3), np.uint8),
                               cand, subset)
    return peaks, conns, special, cand, subset, canvas


def _same_post(got, want, rtol=1e-4):
    """The same peaks (positions and ids), connections, subsets (members
    and counts) and drawn image; the scores to ``rtol`` (fp32 maps)."""
    assert t_pose.pose_difference(got[:5], want[:5], rtol) is None
    np.testing.assert_array_equal(got[5], want[5])


def test_pose_postprocess_is_jax_s():
    """The JAX tests' synthetic person: the copied post-processing gives
    what the JAX functions give (one person, five joints)."""
    from tests.test_pose import _synthetic_person

    heat, paf, _ = _synthetic_person()
    got, want = _post(t_pose, heat, paf, 96), _post(j_pose, heat, paf, 96)
    _same_post(got, want)
    assert len(got[4]) == 1 and got[4][0][-1] == 5 and got[5].sum() > 0


def test_pose_images_match_jax(ckpts):
    """The whole detector through each package's own net: maps, peaks,
    subsets and the drawn images."""
    imgs = clip(2, 64)
    t_fwd = t_pose.pose_forward(ckpts["pose"], "cpu")
    j_fwd, _ = j_pose._get_model(ckpts["pose"])
    people = 0
    for img in imgs:
        bgr = (np.clip(img, 0, 1) * 255).astype(np.uint8)[:, :, ::-1]
        heat_t, paf_t = t_pose.infer_maps(bgr, t_fwd)
        heat_j, paf_j = j_pose.infer_maps(bgr, j_fwd)
        _close(heat_t, heat_j)
        _close(paf_t, paf_j)
        got = _post(t_pose, heat_t, paf_t, 64)
        _same_post(got, _post(j_pose, heat_j, paf_j, 64))
        people += len(got[4])
    assert people > 0
    got = t_pose.pose_images(imgs, ckpts["pose"], "cpu")
    want = j_pose.pose_images(imgs, ckpts["pose"])
    np.testing.assert_array_equal(got, want)
    assert got.shape == imgs.shape and got.max() > 0


# ------------------------------------------------------------- dispatch


@pytest.mark.parametrize("control", list(ENV))
def test_dispatch_with_the_model_set(ckpts, monkeypatch, control):
    net = {"softedge": "hed", "lineart_anime": "lineart",
           "openpose": "pose"}[control]
    monkeypatch.setenv(ENV[control], ckpts[net])
    imgs = clip(1, 64)
    t_pre.validate_control_available(control)  # no raise
    got = t_pre.control_preprocess(imgs, control, device="cpu")
    direct = {"softedge": lambda: t_hed.hed_edges(imgs, ckpts["hed"], "cpu"),
              "lineart_anime": lambda: t_line.lineart_edges(
                  imgs, ckpts["lineart"], "cpu"),
              "openpose": lambda: t_pose.pose_images(imgs, ckpts["pose"],
                                                     "cpu")}[control]()
    np.testing.assert_array_equal(got, direct)
    # no quiet switch to the CPU or to Sobel: the card is asked for and
    # this machine has none
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            t_pre.control_preprocess(imgs, control, device="cuda")


@pytest.mark.parametrize("control", ["softedge", "lineart_anime"])
def test_dispatch_without_the_model_falls_back_warned(monkeypatch, capsys,
                                                      control):
    import vidtome_tpu.control.preprocess as j_pre

    monkeypatch.delenv(ENV[control], raising=False)
    monkeypatch.setattr(t_pre, "_aux_warned", set())
    imgs = clip(1, 64)
    got = t_pre.control_preprocess(imgs, control, device="cpu")
    assert "falls back" in capsys.readouterr().out
    np.testing.assert_array_equal(got, j_pre.control_preprocess(imgs,
                                                                control))


def test_openpose_fails_fast_without_a_model(monkeypatch):
    from vidtome_torch.models.registry import init_model
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    monkeypatch.delenv("VIDTOME_POSE_MODEL", raising=False)
    with pytest.raises(RuntimeError, match="VIDTOME_POSE_MODEL"):
        t_pre.validate_control_available("openpose")
    with pytest.raises(RuntimeError, match="needs a pose model"):
        t_pre.control_preprocess(clip(1, 32), "openpose", device="cpu")
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu",
                        control="openpose")
    cfg = {"seed": 1, "float_precision": "fp32",
           "inversion": {"prompt": "p", "steps": 2, "control": "openpose"},
           "generation": {"prompt": "p", "n_timesteps": 2,
                          "guidance_scale": 7.5, "control": "openpose"}}
    for stage in (Inverter, Generator):
        with pytest.raises(RuntimeError, match="before inversion"):
            stage(bundle, cfg)


def test_pipelines_run_the_nets_on_the_bundle_device(ckpts, monkeypatch,
                                                      tmp_path):
    """Generator.load_control and Inverter.control_images hand the bundle's
    device to the nets (the card in a run; the CPU bundle here)."""
    from vidtome_torch.models.registry import init_model
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    seen = []
    real = t_hed.hed_edges

    def spy(images, path, device, safe=True):
        seen.append(torch.device(device))
        return real(images, path, device, safe=safe)

    monkeypatch.setenv("VIDTOME_HED_MODEL", ckpts["hed"])
    monkeypatch.setattr(t_hed, "hed_edges", spy)
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu",
                        control="softedge")
    cfg = {"seed": 1, "float_precision": "fp32",
           "inversion": {"prompt": "p", "steps": 2, "control": "softedge"},
           "generation": {"prompt": "p", "n_timesteps": 2,
                          "guidance_scale": 7.5, "control": "softedge"}}
    imgs = clip(2, 64)
    Inverter(bundle, cfg).control_images(imgs)
    Generator(bundle, cfg).load_control(imgs, [0, 1], str(tmp_path))
    assert seen == [bundle.device, bundle.device]


def test_exact_fp32_restores_the_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with t_loading.exact_fp32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def test_safetensors_checkpoints_load(tmp_path):
    from vidtome_torch.io.safetensors import save_file

    sd = hed_state()
    save_file(sd, str(tmp_path / "hed.safetensors"))
    for path in (tmp_path / "hed.safetensors", tmp_path):
        got = t_loading.load_state_dict(str(path))
        assert set(got) == set(sd)
        assert all(torch.equal(got[k], v) for k, v in sd.items())


@pytest.mark.slow
def test_full_size_nets_match_jax(ckpts):
    """The three nets at 512x512, the size the pipelines feed them."""
    imgs = clip(2, 512)
    got = t_hed.hed_edges(imgs, ckpts["hed"], "cpu")
    want = j_hed.hed_edges(imgs, ckpts["hed"])
    assert float((got != want).mean()) <= SAFE_STEP_SHARE
    np.testing.assert_allclose(
        t_line.lineart_edges(imgs, ckpts["lineart"], "cpu"),
        j_line.lineart_edges(imgs, ckpts["lineart"]), atol=LINEART_TOL,
        rtol=0)
    np.testing.assert_array_equal(
        t_pose.pose_images(imgs, ckpts["pose"], "cpu"),
        j_pose.pose_images(imgs, ckpts["pose"]))
