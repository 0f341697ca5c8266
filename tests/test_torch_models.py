"""Port models vs the JAX package at tiny size, fp32, same weights.

The JAX tiny bundle's parameter trees go through
``vidtome_torch.models.convert.from_jax_params`` into the port; inputs come
from numpy with a seed.  The UNet is compared unmerged and merged (bank
'init' then 'merge', the draws recomputed from the JAX keys).  Tolerance:
rtol 1e-4 with atol 1e-4 on O(1) outputs, fp32 summation-order noise
through ~40 layers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (jax_block_draws, port_bundle_from_jax,
                                port_tome, to_np)
from vidtome_torch.models import convert as t_convert
from vidtome_torch.models.tome import ToMeCall as TCall
from vidtome_torch.models.tome import ToMeConfig as TConfig
from vidtome_tpu.models import convert as j_convert
from vidtome_tpu.models.tome import ToMeCall as JCall
from vidtome_tpu.models.tome import ToMeConfig as JConfig
from vidtome_tpu.models.unet import TINY_UNET, UNet2DConditionModel
from vidtome_tpu.models.vae import AutoencoderKL

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def bundles():
    from tests.helpers import make_tiny_bundle

    jb = make_tiny_bundle()
    return jb, port_bundle_from_jax(jb)


def test_unet_unmerged(bundles):
    jb, tb = bundles
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 16, 32)).astype(np.float32)
    model = UNet2DConditionModel(config=TINY_UNET, dtype=jnp.float32,
                                 use_pallas=False)
    want = model.apply({"params": jb.unet_params}, jnp.asarray(x),
                       jnp.asarray(421), jnp.asarray(ctx))
    with torch.no_grad():
        got = tb.unet(torch.from_numpy(x), 421, torch.from_numpy(ctx))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("share_match,align", [(True, True), (False, False)])
def test_unet_merged_bank_init_then_merge(bundles, share_match, align):
    jb, tb = bundles
    jcfg = JConfig(frames=4, local_merge_ratio=0.9, merge_global=True,
                   global_merge_ratio=0.8, align_batch=align,
                   share_match=share_match, len_quantum=1024)
    tcfg = port_tome(jcfg)
    model = UNet2DConditionModel(config=TINY_UNET, tome=jcfg,
                                 dtype=jnp.float32, use_pallas=False)
    rng = np.random.default_rng(1)
    # two chunks of 2 lanes x 4 frames; lane contexts repeated per frame
    xs = [rng.normal(size=(8, 16, 16, 4)).astype(np.float32) for _ in range(2)]
    ctx = np.repeat(rng.normal(size=(2, 16, 32)).astype(np.float32), 4, 0)
    variables = {"params": jb.unet_params}
    banks: dict = {}
    for chunk, (x, mode) in enumerate(zip(xs, ("init", "merge"))):
        key = jax.random.key(40 + chunk)
        want, mut = model.apply(variables, jnp.asarray(x), jnp.asarray(301),
                                jnp.asarray(ctx),
                                tome_call=JCall(key=key, bank_mode=mode),
                                num_lanes=2, mutable=["tome_bank"])
        variables = {**variables, **mut}
        local, coin = jax_block_draws(key, 4, 4)
        call = TCall(cfg=tcfg, local_draws=local, coin=coin, bank_mode=mode,
                     banks=banks)
        with torch.no_grad():
            got = tb.unet(torch.from_numpy(x), 301, torch.from_numpy(ctx),
                          tome_call=call)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    # one bank per merging block, carried into the next chunk
    assert len(banks) == len(jax.tree.leaves(variables["tome_bank"]))


def test_vae_encode_decode(bundles):
    jb, tb = bundles
    vae = AutoencoderKL(block_out_channels=(8, 8, 8, 8), layers_per_block=1,
                        dtype=jnp.float32)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    lat_j = vae.apply({"params": jb.vae_params}, jnp.asarray(x),
                      method=AutoencoderKL.encode)
    img_j = vae.apply({"params": jb.vae_params}, lat_j,
                      method=AutoencoderKL.decode)
    with torch.no_grad():
        lat_t = tb.vae.encode(torch.from_numpy(x))
        img_t = tb.vae.decode(lat_t)
    np.testing.assert_allclose(to_np(lat_t), np.asarray(lat_j), **TOL)
    np.testing.assert_allclose(to_np(img_t), np.asarray(img_j), **TOL)


def test_clip_text(bundles):
    jb, tb = bundles
    ids = jb.tokenizer(["a watercolor sun", "", "rolling green hills, red"])
    want = jb.make_text_model().apply({"params": jb.text_params},
                                      jnp.asarray(ids))
    with torch.no_grad():
        got = tb.text_encoder(torch.as_tensor(ids, dtype=torch.long))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("component", ["unet", "vae", "text"])
def test_diffusers_round_trip(component):
    """diffusers state -> vidtome_tpu convert -> from_jax_params equals the
    port's direct diffusers load (VAE: legacy attention keys included)."""
    from tests import test_convert_golden as golden

    state = {"unet": golden.build_tiny_unet_state,
             "vae": golden.build_tiny_vae_state,
             "text": golden.build_tiny_text_state}[component]()
    tree = {"unet": j_convert.convert_unet, "vae": j_convert.convert_vae,
            "text": j_convert.convert_text_encoder}[component](dict(state))
    via_jax = t_convert.from_jax_params(tree, component)
    direct = t_convert.from_diffusers(state, component)
    assert sorted(via_jax) == sorted(direct)
    for k in direct:
        np.testing.assert_array_equal(via_jax[k].numpy(), direct[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("ratio,quantum,tokens", [
    (0.9, 1024, 4096), (0.9, 1024, 1024), (0.9, None, 4096), (0.5, 1024, 256)])
def test_merged_local_len(ratio, quantum, tokens):
    kw = dict(frames=4, local_merge_ratio=ratio, len_quantum=quantum)
    assert TConfig(**kw).merged_local_len(tokens) == \
        JConfig(**kw).merged_local_len(tokens)


def test_checkpoint_dir_loads(tmp_path):
    """A diffusers UNet in safetensors under <dir>/unet loads strictly."""
    from safetensors.numpy import save_file

    from tests import test_convert_golden as golden
    from vidtome_torch.models.unet import TINY_UNET as T_TINY
    from vidtome_torch.models.unet import UNet2DConditionModel as TUNet

    state = golden.build_tiny_unet_state()
    (tmp_path / "unet").mkdir()
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()},
              str(tmp_path / "unet" / "diffusion_pytorch_model.safetensors"))
    loaded = t_convert.from_diffusers(
        t_convert.load_component_state(str(tmp_path), "unet"), "unet")
    unet = TUNet(T_TINY)
    unet.load_state_dict(loaded, strict=True)
    np.testing.assert_array_equal(unet.conv_in.weight.detach().numpy(),
                                  state["conv_in.weight"])
