"""SD1.5's full ControlNet and UNet, SD2-depth's full UNet, and the full
SDXL and SDXL-refiner UNets, on the port vs the JAX package (slow).

The parity tests elsewhere run the tiny topology (2 levels, 1 resnet a
block, 2 heads).  This one holds the full SD1.5 stack: 4 levels, 2 resnets
a block, 8 heads, widths 320-1280, cross-attention width 768.  The weights
are random from the JAX package's ``init_model("1.5", control="canny")``
(fp32), the ControlNet's zero convs and hint encoder ``conv_out`` moved off
zero (``tests/torch_parity.perturb_zero_convs``), carried into the port by
``convert.from_jax_params``; everything runs on the CPU in fp32 at a 16x16
latent (a 128x128 hint), batch 2, 77 context tokens.

SD2-depth (``init_model("depth")``: SD2.1's UNet with 5 input channels,
head dim 64, linear projections, cross-attention width 1024) runs at a
[2, 16, 16, 5] input whose fifth channel is a depth map in [-1, 1].

SDXL (``SDXL_UNET``: 3 levels, no attention at level 0, 2 and 10
transformer blocks at levels 1 and 2, cross-attention width 2048) and its
refiner (``SDXL_REFINER_UNET``: 4 levels, 96-wide heads 4 blocks deep,
width 1280) take the UNet parameters of the JAX ``init_model("xl")`` /
``("xl-refiner")`` (``registry._random_unet_params``, seed 0) at a
[2, 16, 16, 4] input with pooled embeds and the base's 6 / the refiner's 5
time ids.  Each is built alone: the JAX output is taken first, then the
JAX tree is carried into the port module by module and freed as it goes,
so one fp32 copy of the weights (10.3 / 9.0 GB) is alive at a time.

Held to 1e-4 of the output's max |value|: fp32 summation order over the
full depth (about 5e-6 for the bare UNet, ROADMAP.md queue 3).  Each stack
takes minutes and 10-20 GB on the CPU, so the file is marked ``slow`` (the
tier-1 run deselects it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import perturb_zero_convs, to_np
from vidtome_torch.models import convert
from vidtome_torch.models.controlnet import ControlNetModel as TControlNet
from vidtome_torch.models.unet import SD15_UNET as T_SD15
from vidtome_torch.models.unet import UNet2DConditionModel as TUNet

pytestmark = pytest.mark.slow
REL_TOL = 1e-4
T = 501


def _port(module_cls, tree, component, config=T_SD15):
    """The port module on the meta device, given the JAX tree's weights."""
    with torch.device("meta"):
        mod = module_cls(config)
    tree = jax.tree.map(np.asarray, jax.device_get(tree))
    mod.load_state_dict(convert.from_jax_params(tree, component),
                        strict=True, assign=True)
    return mod.float().eval()


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(to_np(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def stacks():
    from vidtome_tpu.models.controlnet import ControlNetModel
    from vidtome_tpu.models.registry import init_model
    from vidtome_tpu.models.unet import SD15_UNET, UNet2DConditionModel

    jb = init_model("1.5", control="canny", weight_dtype="fp32")
    cn_params = perturb_zero_convs(
        jax.tree.map(np.asarray, jax.device_get(jb.controlnet_params)))
    unet = UNet2DConditionModel(config=SD15_UNET, dtype=jnp.float32,
                                use_pallas=False)
    cn = ControlNetModel(config=SD15_UNET, dtype=jnp.float32,
                         use_pallas=False)
    ports = (_port(TUNet, jb.unet_params, "unet"),
             _port(TControlNet, cn_params, "controlnet"))
    return (unet, jb.unet_params, cn, cn_params), ports


def test_full_sd15_controlnet_and_unet_match_jax(stacks):
    (unet, unet_params, cn, cn_params), (t_unet, t_cn) = stacks
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4), np.float32)
    ctx = rng.standard_normal((2, 77, 768), np.float32)
    cond = rng.random((2, 128, 128, 3), np.float32)
    args = (jnp.asarray(x), jnp.asarray(T), jnp.asarray(ctx))
    down_j, mid_j = cn.apply({"params": cn_params}, *args, jnp.asarray(cond),
                             conditioning_scale=0.7)
    want = unet.apply({"params": unet_params}, *args,
                      down_residuals=down_j, mid_residual=mid_j)
    targs = (torch.from_numpy(x), T, torch.from_numpy(ctx))
    with torch.no_grad():
        down_t, mid_t = t_cn(*targs, torch.from_numpy(cond),
                             conditioning_scale=0.7)
        got = t_unet(*targs, down_residuals=down_t, mid_residual=mid_t)
        bare = t_unet(*targs)
    assert len(down_t) == len(down_j) == 12
    errs = [_rel(g, w) for g, w in zip(down_t + [mid_t],
                                       list(down_j) + [mid_j])]
    out_err = _rel(got, want)
    print(f"full SD1.5 ControlNet residuals max rel err {max(errs):.2e}; "
          f"UNet fed them {out_err:.2e}; the residuals move the UNet output "
          f"by {_rel(bare, want):.2e}")
    assert max(errs) < REL_TOL and out_err < REL_TOL
    assert _rel(bare, want) > 100 * REL_TOL


def test_full_sd2_depth_unet_matches_jax():
    import gc

    from vidtome_torch.models.unet import SD2_DEPTH_UNET as T_DEPTH
    from vidtome_tpu.models.registry import init_model
    from vidtome_tpu.models.unet import SD2_DEPTH_UNET, UNet2DConditionModel

    jb = init_model("depth", weight_dtype="fp32")
    params = jb.unet_params
    del jb
    gc.collect()
    unet = UNet2DConditionModel(config=SD2_DEPTH_UNET, dtype=jnp.float32,
                                use_pallas=False)
    t_unet = _port(TUNet, params, "unet", T_DEPTH)
    assert t_unet.conv_in.in_channels == 5
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 5), np.float32)
    x[..., 4] = rng.uniform(-1, 1, (2, 16, 16))
    ctx = rng.standard_normal((2, 77, 1024), np.float32)
    want = unet.apply({"params": params}, jnp.asarray(x), jnp.asarray(T),
                      jnp.asarray(ctx))
    flat = x.copy()
    flat[..., 4] = 0.0
    with torch.no_grad():
        got = t_unet(torch.from_numpy(x), T, torch.from_numpy(ctx))
        no_depth = t_unet(torch.from_numpy(flat), T, torch.from_numpy(ctx))
    err = _rel(got, want)
    print(f"full SD2-depth UNet max rel err {err:.2e}; a zero depth channel "
          f"moves its output by {_rel(no_depth, want):.2e}")
    assert err < REL_TOL
    assert _rel(no_depth, want) > 100 * REL_TOL


@pytest.mark.parametrize("version", ["xl", "xl-refiner"])
def test_full_sdxl_unet_matches_jax(version):
    import gc
    import resource

    from vidtome_torch.models import unet as t_unet
    from vidtome_tpu.models import unet as j_unet
    from vidtome_tpu.models.registry import _random_unet_params

    name = "SDXL_UNET" if version == "xl" else "SDXL_REFINER_UNET"
    cfg = getattr(j_unet, name)
    params = _random_unet_params(cfg, jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 4), np.float32)
    ctx = rng.standard_normal((2, 77, cfg.cross_attention_dim), np.float32)
    pooled = rng.standard_normal((2, 1280), np.float32)
    ids = np.float32([[1024, 1024, 0, 0, 1024, 1024] if version == "xl"
                      else [1024, 1024, 0, 0, s] for s in (2.5, 6.0)])
    unet = j_unet.UNet2DConditionModel(config=cfg, dtype=jnp.float32,
                                       use_pallas=False)
    want = np.asarray(unet.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(T), jnp.asarray(ctx),
        add_text_embeds=jnp.asarray(pooled), add_time_ids=jnp.asarray(ids)))
    tree = dict(params)
    del params
    state = {}
    for key in sorted(tree):  # one top-level module at a time, then freed
        state.update(convert.from_jax_params(
            {key: jax.device_get(tree.pop(key))}, "unet"))
        gc.collect()
    with torch.device("meta"):
        t_model = TUNet(getattr(t_unet, name))
    t_model.load_state_dict(state, strict=True, assign=True)
    del state
    t_model = t_model.float().eval()
    with torch.no_grad():
        got = t_model(torch.from_numpy(x), T, torch.from_numpy(ctx),
                      add_text_embeds=torch.from_numpy(pooled),
                      add_time_ids=torch.from_numpy(ids))
        no_pooled = t_model(torch.from_numpy(x), T, torch.from_numpy(ctx),
                            add_time_ids=torch.from_numpy(ids))
    err = _rel(got, want)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"full {name} max rel err {err:.2e}; zero pooled embeds move its "
          f"output by {_rel(no_pooled, want):.2e}; peak RSS {rss:.1f} GiB")
    assert err < REL_TOL
    assert _rel(no_pooled, want) > 100 * REL_TOL
