"""The W8A8 fused resnet block: the port's plain version against the JAX
package, on the CPU.

* bf16: the port's ``fused_resnet_w8a8`` (its plain version on a CPU
  tensor) against the Pallas ``fused_resnet(..., quant=True)`` in interpret
  mode, on the same int8 weights (the JAX ``quantize_weight``), within
  3e-2 of max |ref| (the JAX test's bound: both round the activations and h
  to bf16, at different points of an fp32 sum order);
* fp32: the port's fused (plain) and unfused int8 blocks against the JAX
  package's unfused int8 ``ResnetBlock2D`` (XLA's int8 convolutions with
  the static post-norm scale) on the same weights and the same int8 table
  (``from_jax_qparams``), within 1e-3 of max |ref| (the fused version
  quantizes with the reciprocal of the scale, as the kernels do, where
  ``int8_conv`` divides: a rare one-step difference);
* the port's fused and unfused int8 blocks agree in bf16 within 3e-2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import module_state
from vidtome_torch.models import convert
from vidtome_torch.models.layers import ResnetBlock2D as TBlock
from vidtome_torch.ops import quant as tq
from vidtome_torch.ops import resnet as t_res
from vidtome_tpu.models.layers import ResnetBlock2D as JBlock
from vidtome_tpu.ops import quant as jq
from vidtome_tpu.ops import resnet as j_res

torch.set_num_threads(2)

SHAPES = [(1, 8, 8, 64, 64),     # identity shortcut
          (1, 8, 8, 128, 64)]    # 1x1 projection shortcut


def _inputs(rng, B, H, W, Ci, Co):
    n = lambda *shape, s=1.0, m=0.0: (  # noqa: E731
        rng.normal(size=shape) * s + m).astype(np.float32)
    p = dict(x=n(B, H, W, Ci), tvec=n(B, Co, s=0.3), n1s=n(Ci, s=0.2, m=1),
             n1b=n(Ci, s=0.1), w1=n(3, 3, Ci, Co, s=0.15), b1=n(Co, s=0.1),
             n2s=n(Co, s=0.2, m=1), n2b=n(Co, s=0.1),
             w2=n(3, 3, Co, Co, s=0.15), b2=n(Co, s=0.1))
    if Ci != Co:
        p.update(ws=n(Ci, Co, s=0.3), bs=n(Co, s=0.1))
    return p


@pytest.mark.parametrize("B,H,W,Ci,Co", SHAPES)
def test_plain_w8a8_matches_jax_kernel_bf16(B, H, W, Ci, Co):
    p = _inputs(np.random.default_rng(0), B, H, W, Ci, Co)
    jw1, js1 = jq.quantize_weight(jnp.asarray(p["w1"]))
    jw2, js2 = jq.quantize_weight(jnp.asarray(p["w2"]))
    j = {k: jnp.asarray(v) for k, v in p.items()}
    want = np.asarray(j_res.fused_resnet(
        j["x"].astype(jnp.bfloat16), j["tvec"], j["n1s"], j["n1b"], jw1,
        j["b1"], j["n2s"], j["n2b"], jw2, j["b2"], j.get("ws"), j.get("bs"),
        js1, js2, num_groups=32, quant=True, interpret=True), np.float32)

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    oihw = lambda w: t(np.asarray(w).transpose(3, 2, 0, 1))  # noqa: E731
    got = t_res.fused_resnet_w8a8(
        t(p["x"]).bfloat16(), t(p["tvec"]), t(p["n1s"]), t(p["n1b"]),
        oihw(jw1), t(p["b1"]), t(p["n2s"]), t(p["n2b"]), oihw(jw2),
        t(p["b2"]), t(p["ws"].T) if "ws" in p else None,
        t(p["bs"]) if "bs" in p else None, w1_scale=t(js1), w2_scale=t(js2))
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W, Co)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err < 3e-2
    assert t_res.fused_resnet_w8a8.launches == 0  # CPU tensors: plain path


def _jax_block(seed, B, H, W, Ci, Co):
    """A JAX fp32 ResnetBlock2D, its input, its int8 split and output."""
    key = jax.random.key(seed)
    x = jax.random.normal(key, (B, H, W, Ci), jnp.float32)
    temb = jax.random.normal(jax.random.fold_in(key, 1), (B, 32), jnp.float32)
    block = JBlock(Co, dtype=jnp.float32)
    params = block.init(jax.random.fold_in(key, 2), x, temb)["params"]
    # non-trivial norms and biases
    params = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.fold_in(key, 3),
                                              a.shape), params)
    res, qp = jq.quantize_params(params)
    y = block.apply({"params": res, "qparams": qp}, x, temb)
    return (np.array(x), np.array(temb), params,
            jax.tree.map(np.asarray, qp), np.array(y))


def _port_block(params, Ci, Co, dtype):
    block = TBlock(Ci, Co, 32)
    block.load_state_dict(module_state(params))
    return block.to(dtype)


@pytest.mark.parametrize("B,H,W,Ci,Co", SHAPES)
def test_int8_blocks_match_jax_fp32(B, H, W, Ci, Co):
    x, temb, params, qp, want = _jax_block(1, B, H, W, Ci, Co)
    block = _port_block(params, Ci, Co, torch.float32)
    qt = convert.from_jax_qparams(qp, block)
    assert sorted(qt.entries) == ["conv1", "conv2"]
    with torch.no_grad():
        off = block(torch.from_numpy(x), torch.from_numpy(temb), qt=qt)
        fused = block(torch.from_numpy(x), torch.from_numpy(temb),
                      resnet_mode="fused", qt=qt)
        plain = block(torch.from_numpy(x), torch.from_numpy(temb))
    scale = np.abs(want).max()
    assert np.abs(off.numpy() - want).max() < 1e-3 * scale
    assert np.abs(fused.numpy() - want).max() < 1e-3 * scale
    # and int8 really ran: the unquantized block differs by more
    assert np.abs(plain.numpy() - want).max() > 1e-3 * scale


@pytest.mark.parametrize("B,H,W,Ci,Co", SHAPES)
def test_fused_and_unfused_int8_blocks_agree_bf16(B, H, W, Ci, Co):
    _, _, params, _, _ = _jax_block(2, B, H, W, Ci, Co)
    block = _port_block(params, Ci, Co, torch.bfloat16)
    qt = tq.quantize_unet(block)
    assert sorted(qt.entries) == ["conv1", "conv2"]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(B, H, W, Ci)).astype(np.float32))
    temb = torch.from_numpy(rng.normal(size=(B, 32)).astype(np.float32))
    with torch.no_grad():
        off = block(x.bfloat16(), temb.bfloat16(), qt=qt).float()
        fused = block(x.bfloat16(), temb.bfloat16(), resnet_mode="fused",
                      qt=qt).float()
    err = (fused - off).abs().max() / off.abs().max()
    assert err.item() < 3e-2


def test_fused_int8_needs_both_convs_quantized():
    block = TBlock(32, 32, 32)
    qt = tq.quantize_unet(block, include=r"conv1")
    with pytest.raises(ValueError, match="together"):
        block(torch.zeros(1, 4, 4, 32), torch.zeros(1, 32),
              resnet_mode="fused", qt=qt)


def test_w8a8_plain_needs_the_weight_scales():
    p = [torch.zeros(1, 4, 4, 32), torch.zeros(1, 32), torch.ones(32),
         torch.zeros(32), torch.zeros(32, 32, 3, 3, dtype=torch.int8),
         torch.zeros(32), torch.ones(32), torch.zeros(32),
         torch.zeros(32, 32, 3, 3, dtype=torch.int8), torch.zeros(32)]
    with pytest.raises(ValueError, match="w1_scale"):
        t_res.reference_fused_resnet(*p, quant=True)
