"""The port's inversion writes ``inversion_prompts.txt`` beside the latents
and warns on ``inversion.use_blip``, as the JAX inverter does
(``vidtome_tpu/pipeline/inverter.py:83-88``, ``:432-436``).

``cli.run_inversion`` runs on the port's tiny CPU bundle and the JAX
``Inverter`` on the JAX tiny bundle, from the same config and clip; the
latent directories hold the same kinds of files
(``tests/test_pipeline_e2e.py:80-86``) and the two prompt files are
identical, byte for byte: a string prompt repeated once per frame, a list
written as given.
"""

from __future__ import annotations

import os

import pytest

from tests.helpers import make_tiny_bundle, make_tiny_video
from tests.test_pipeline_e2e import _base_config
from vidtome_torch import cli
from vidtome_torch.models.registry import init_model
from vidtome_torch.pipeline.inverter import Inverter as TInv

N_FRAMES = 6
PROMPTS = {"string": "a colorful gradient",
           "list": [f"a colorful gradient, frame {i}"
                    for i in range(N_FRAMES)]}


def _config(tmp_path, prompt):
    video = make_tiny_video(str(tmp_path / "video"), n_frames=N_FRAMES)
    cfg = _base_config(str(tmp_path), video)
    cfg.inversion.update(prompt=prompt, steps=2, save_steps=2)
    return cfg


@pytest.mark.parametrize("kind", list(PROMPTS))
def test_inversion_prompts_match_jax(tmp_path, kind):
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    cfg = _config(tmp_path, PROMPTS[kind])
    cfg.inversion["save_path"] = str(tmp_path / "jax")
    JInv(make_tiny_bundle(), cfg, use_pallas=False)(
        cfg.input_path, cfg.inversion.save_path)
    cfg.inversion["save_path"] = str(tmp_path / "port")
    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    cli.run_inversion(cfg, bundle)

    jax_dir = tmp_path / "jax" / "tiny-test-model"
    port_dir = tmp_path / "port" / "sd-tiny"
    files = os.listdir(port_dir)
    assert any(f.startswith("noisy_latents_") for f in files)
    assert "config.yaml" in files
    assert "inversion_prompts.txt" in files
    want = (jax_dir / "inversion_prompts.txt").read_bytes()
    assert (port_dir / "inversion_prompts.txt").read_bytes() == want
    assert want.decode().split("\n") == (
        [PROMPTS[kind]] * N_FRAMES if kind == "string" else PROMPTS[kind])


def test_use_blip_warns_like_jax(tmp_path, capsys):
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    cfg = _config(tmp_path, PROMPTS["string"])
    cfg.inversion["use_blip"] = True
    JInv(make_tiny_bundle(), cfg, use_pallas=False)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if "use_blip" in ln]
    TInv(init_model("tiny", weight_dtype="fp32", device="cpu"), cfg)
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if "use_blip" in ln]
    assert len(want) == 1 and got == want
    cfg.inversion["use_blip"] = False
    TInv(init_model("tiny", weight_dtype="fp32", device="cpu"), cfg)
    assert "use_blip" not in capsys.readouterr().out
