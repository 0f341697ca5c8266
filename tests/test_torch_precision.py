"""``float_precision`` is read by the port's stages as the JAX package reads
it (``vidtome_tpu/pipeline/common.py:resolve_precision``): "bf16" and
"fp16" mean bf16, every other value fp32.  Each case starts from a bundle
in the other dtype, so the stage has to re-cast it, and sets the value at
the top level or per stage (over a top level that says the opposite)."""

from __future__ import annotations

import pytest
import torch

from vidtome_torch.models.registry import init_model
from vidtome_torch.pipeline.generator import Generator
from vidtome_torch.pipeline.inverter import Inverter
from vidtome_tpu.pipeline import common as jax_common

torch.set_num_threads(2)


def _config(value, where: str, stage: str) -> dict:
    cfg = {"seed": 123,
           "inversion": {"prompt": "a clip", "steps": 2},
           "generation": {"n_timesteps": 2, "guidance_scale": 7.5,
                          "prompt": {"edit": "an edit"}}}
    if where == "top":
        cfg["float_precision"] = value
    else:
        cfg["float_precision"] = "fp32" if value in ("bf16", "fp16") else "bf16"
        cfg[stage]["float_precision"] = value
    return cfg


@pytest.mark.parametrize("stage", ["inversion", "generation"])
@pytest.mark.parametrize("where", ["top", "stage"])
@pytest.mark.parametrize("value", ["bf16", "fp16", "fp32", "float32"])
def test_stage_dtype_matches_jax(value, where, stage):
    cfg = _config(value, where, stage)
    jax_prec = jax_common.resolve_precision(cfg, cfg[stage])
    want = torch.bfloat16 if jax_prec == "bf16" else torch.float32
    start = "fp32" if want == torch.bfloat16 else "bf16"
    bundle = init_model("tiny", weight_dtype=start, device="cpu")
    (Inverter if stage == "inversion" else Generator)(bundle, cfg)
    assert bundle.dtype == want
    assert next(bundle.unet.parameters()).dtype == want
    assert next(bundle.vae.parameters()).dtype == want
    assert next(bundle.text_encoder.parameters()).dtype == torch.float32
