"""The comparison that decides ``correct``, at test size on the CPU.

The harness runs its whole run here (set-up, window, reference check) on
the tiny stack, skipping only its look for a card: in float32 the program
and the reference agree to rounding; in bf16 a sound run passes limits set
three times above its readings, and each fault a cell can have, planted in
the timed path, fails them, as does the control: the program's own int8
path for the UNet, the reference one step lower for the VAE (float8
operands) and the DDIM update (bfloat16).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import run  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

MIXES = ["exact-cb-32f", "pnp-cb-32f"]
NUMBERS = ("enc_err", "inv_eps_err", "inv_step_err", "gen_out_err",
           "gen_step_err", "dec_err")
SEED = 2147483759  # more than 31 bits, as the driver's seeds are


def _run(mix, dtype="bf16", limits=None, control=False, seed=SEED):
    model = tiny.model(linear=mix.startswith("pnp"))
    model["dtype"] = dtype
    limits = limits or {k: {"limit": float("inf")} for k in NUMBERS}
    return run.run_cell(model, tiny.traffic(mix), limits, [], seed, 0.0,
                        False, "cpu", lambda: None, control=control,
                        log=lambda m: None)


def _numbers(res):
    return {k: v["value"] for k, v in res[0]["compared"].items()}


@pytest.mark.parametrize("mix", MIXES)
def test_reference_follows_the_program_in_float32(mix):
    got = _numbers(_run(mix, dtype="fp32"))
    assert max(got.values()) < 1e-4, got


@pytest.fixture(scope="module")
def sound():
    """Each mix's bf16 readings at test size, and limits three times
    above them."""
    out = {}
    for mix in MIXES:
        got = _numbers(_run(mix))
        out[mix] = {k: {"limit": 3.0 * v} for k, v in got.items()}
    return out


@pytest.mark.parametrize("mix", MIXES)
def test_sound_run_passes_on_another_seed(mix, sound):
    res = _run(mix, limits=sound[mix], seed=SEED + 1)[0]
    assert res["correct"], res["compared"]


def _step_unchanged(monkeypatch):
    from vidtome_torch.pipeline import generator

    monkeypatch.setattr(generator, "ddim_step",
                        lambda x, eps, a, b: x.float())


def _half_batch(monkeypatch):
    """The inversion updates only the first half of the frames."""
    from vidtome_torch.pipeline import inverter

    real = inverter.ddim_inverse_step

    def half(x, eps, a, b):
        y = real(x, eps, a, b)
        n = x.shape[0] // 2
        return torch.cat([y[:n], x[n:].float()])

    monkeypatch.setattr(inverter, "ddim_inverse_step", half)


def _answer_altered(monkeypatch):
    """One edited frame altered where the decode produces it."""
    from vidtome_torch.pipeline.common import VAECoder

    real = VAECoder.decode

    def altered(self, latents):
        out = real(self, latents).clone()
        out[0] = 1.0 - out[0]
        return out

    monkeypatch.setattr(VAECoder, "decode", altered)


def _chunk_altered(monkeypatch):
    """One chunk's rows of every generation UNet call altered where the
    UNet produces them."""
    from vidtome_torch.models.unet import UNet2DConditionModel

    real = UNet2DConditionModel.forward

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if kwargs.get("tome_call") is None:  # the inversion's calls
            return out
        out = out.clone()
        out[-4:] = 0.5 * out[-4:]
        return out

    monkeypatch.setattr(UNet2DConditionModel, "forward", altered)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch,
                                   _answer_altered, _chunk_altered],
                         ids=["step_unchanged", "half_batch",
                              "answer_altered", "chunk_altered"])
@pytest.mark.parametrize("mix", MIXES)
def test_planted_fault_is_not_correct(mix, fault, sound, monkeypatch):
    fault(monkeypatch)
    res = _run(mix, limits=sound[mix])[0]
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("mix", MIXES)
def test_control_is_not_correct(mix, sound):
    """The control in the program's place is not correct, and reads above
    the sound limit on every number but ``gen_out_err``: the int8 path on
    ``inv_eps_err``, the reference one step lower on the VAE and step
    numbers.  On the chip, too, the int8 path reads ``gen_out_err`` within
    twice a sound run's (PERF.md), and fails ``inv_eps_err``."""
    res, got = _run(mix, limits=sound[mix], control=True)
    assert not res["correct"], res["compared"]
    for name in NUMBERS:
        if name != "gen_out_err":
            assert got[name] > sound[mix][name]["limit"], (name, got)
