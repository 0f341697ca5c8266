"""The port's spans (``logging_utils.span``) on the tiny stack, on the CPU.

With no profiler recording an edit makes no ``record_function`` call.
Under ``torch.profiler`` an inversion and a generation (token merging
with a global bank and batched chunks, a ControlNet; and the step caches
with CFG and eps skips) open every ``vidtome/`` span of the layer table:
every UNet call inside a step, one ``vidtome/unet`` span a call the stages
count, one ``vidtome/gen_step`` a sampling step, merge-plan and
merge-apply spans never one inside the other, and the outputs the same
bits as untraced.  ``tpu.profile_dir`` traces the inversion to
``invert_*.json``.
"""

from __future__ import annotations

import glob
import json

import pytest
import torch

from vidtome_torch.config import Config
from vidtome_torch.models.registry import init_model
from vidtome_torch.pipeline.generator import Generator
from vidtome_torch.pipeline.inverter import Inverter

STEPS = 4
N_FRAMES = 6
SPANS = {"invert", "invert_step", "generate", "gen_step", "unet",
         "controlnet", "text", "vae_encode", "vae_decode", "transformer",
         "attn", "ff", "resnet", "merge_plan", "merge_apply"}
MODES = {
    # merging with a global bank, batched chunks, a ControlNet
    "merge": dict(control="canny", chunk_batch=True, local_merge_ratio=0.9,
                  merge_global=True, global_merge_ratio=0.8),
    # the serving caches: shallow calls, CFG skips, eps skips
    "serve": dict(control="none", cache_interval=2, cfg_interval=2,
                  eps_interval=3, local_merge_ratio=0.9,
                  merge_global=True),
}


def _config(mode: str, **tpu) -> Config:
    return Config({
        "sd_version": "tiny", "height": 64, "width": 64, "seed": 5,
        "float_precision": "fp32",
        "inversion": {"prompt": "a gradient", "steps": STEPS,
                      "save_steps": STEPS, "batch_size": 4,
                      "control": "none", "cache_interval": 2},
        "generation": {"guidance_scale": 7.5, "n_timesteps": STEPS,
                       "negative_prompt": "blurry",
                       "prompt": {"edit": "a painting"}, "chunk_size": 2,
                       "chunk_ord": "mix-4", **MODES[mode]},
        "tpu": tpu})


@pytest.fixture(scope="module")
def bundle():
    torch.manual_seed(0)
    return init_model("tiny", weight_dtype="fp32", device="cpu",
                      control="canny")


def _edit(bundle, mode: str):
    """One edit: the inversion, the generation, the decode; returns the
    frames and the UNet calls both stages counted."""
    cfg = _config(mode)
    inv, gen = Inverter(bundle, cfg), Generator(bundle, cfg)
    g = torch.Generator().manual_seed(1)
    frames = torch.rand(N_FRAMES, 64, 64, 3, generator=g)
    inverted, _ = inv(frames)
    gen.configure_frames(inverted.shape[0])
    pad = torch.as_tensor(gen.pad_src)
    control = None
    if gen.use_controlnet:
        control = torch.rand(len(gen.pad_src), 64, 64, 3, generator=g)
    clean = gen.sample(inverted[pad], "a painting", control=control)
    out = gen.vae.decode(clean[:gen.n_frames])
    return out, inv.unet_calls, gen.unet_calls


def _spans(path: str) -> list[tuple[str, float, float]]:
    """(name, start, end) of every ``vidtome/`` span of a Chrome trace,
    the name without its attributes."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"][len("vidtome/"):].split(" ")[0], e["ts"],
             e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("vidtome/")]


@pytest.fixture(scope="module", params=sorted(MODES))
def traced(request, bundle, tmp_path_factory):
    """An edit untraced, then the same edit under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    mode = request.param
    plain = _edit(bundle, mode)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _edit(bundle, mode)
    path = str(tmp_path_factory.mktemp("spans") / "trace.json")
    prof.export_chrome_trace(path)
    return mode, plain, out, _spans(path)


def _inside(a, b) -> bool:
    return b[1] <= a[1] and a[2] <= b[2]


def test_no_profiler_no_record_function(bundle, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for mode in MODES:
        out, inv_calls, gen_calls = _edit(bundle, mode)
        assert torch.isfinite(out).all() and gen_calls["full"] > 0


def test_every_span_of_the_table(traced):
    mode, _, _, spans = traced
    want = SPANS if mode == "merge" else SPANS - {"controlnet"}
    assert {s[0] for s in spans} == want


def test_traced_outputs_are_the_same_bits(traced):
    _, plain, out, _ = traced
    assert torch.equal(plain[0], out[0])
    assert plain[1] == out[1] and plain[2] == out[2]


def test_unet_calls_lie_in_steps_and_match_the_counters(traced):
    mode, _, (_, inv_calls, gen_calls), spans = traced
    steps = [s for s in spans if s[0] in ("invert_step", "gen_step")]
    unets = [s for s in spans if s[0] == "unet"]
    assert all(any(_inside(u, s) for s in steps) for u in unets)
    counted = sum(c["full"] + c["shallow"] for c in (inv_calls, gen_calls))
    assert len(unets) == counted
    assert sum(s[0] == "gen_step" for s in spans) == STEPS
    assert sum(s[0] == "invert_step" for s in spans) == STEPS
    if mode == "serve":  # the counts cover shallow calls and eps skips
        assert inv_calls["shallow"] and gen_calls["shallow"]
        assert gen_calls["eps_skip"] and gen_calls["cfg_skip"]


def test_merge_plan_and_apply_never_nest(traced):
    _, _, _, spans = traced
    plans = [s for s in spans if s[0] == "merge_plan"]
    applies = [s for s in spans if s[0] == "merge_apply"]
    assert plans and applies
    for p in plans:
        assert not any(_inside(p, a) or _inside(a, p) for a in applies)


def test_profile_dir_traces_the_inversion(bundle, tmp_path, capsys):
    inv = Inverter(bundle, _config("merge", profile_dir=str(tmp_path)))
    inv(torch.rand(N_FRAMES, 64, 64, 3))
    files = glob.glob(str(tmp_path / "*.json"))
    assert [f.split("/")[-1].split("_")[0] for f in files] == ["invert"]
    assert "profiler trace written to " + files[0] in capsys.readouterr().out
    names = {s[0] for s in _spans(files[0])}
    assert {"invert", "invert_step", "unet", "vae_encode", "text"} <= names
