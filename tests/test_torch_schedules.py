"""The serving schedules and the UNet deep-feature split of the port vs the
JAX package, on the CPU.

* ``refresh_mask`` gives the JAX function's masks and raises where it
  raises;
* ``extrap_weights`` applied to random eps histories (the port's one
  predictor, used by both stages) equals the JAX generator's in-graph
  Newton form to 1e-6: the JAX sample block is driven over skip steps only,
  from x = 0, so its output is the predicted eps times the DDIM
  coefficient (the UNet it would call on a run step is a stub that returns
  zeros; no run step occurs);
* the tiny UNet's ``cache_mode`` "full" output (eps, deep) equals JAX's to
  rtol 1e-4 (fp32 summation order through the network, as in
  ``test_torch_models.py``); "shallow" fed that deep reproduces the full
  call's eps to 1e-6 and equals JAX's "shallow" to rtol 1e-4.
"""

from __future__ import annotations

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import port_bundle_from_jax, to_np
from vidtome_torch.core.scheduler import DDIMScheduler
from vidtome_torch.core.scheduler import ddim_step as t_ddim_step
from vidtome_torch.models.unet import UNet2DConditionModel as TUNet
from vidtome_torch.models.unet import UNetConfig
from vidtome_torch.pipeline import generator as t_gen
from vidtome_tpu.config import Config
from vidtome_tpu.models.unet import TINY_UNET, UNet2DConditionModel
from vidtome_tpu.pipeline import generator as j_gen

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("spec,interval,n,start", [
    (None, 1, 8, 0), (None, 3, 10, 0), (None, 2, 9, 3),
    ("full:2,uniform:3", 1, 10, 0), ("full:6,uniform:12", 1, 50, 0),
    ("full:6,uniform:6", 1, 50, 0), ("full:6,uniform:3", 1, 50, 0),
    ("full:2,shallow:3", 1, 8, 0), ("full:2,every:2x4,uniform:3", 1, 12, 0),
    ("full:1,every:3x6", 1, 10, 0), ("full:3", 1, 10, 2),
    ("full:1, shallow:1 ,uniform:1", 1, 5, 0),
])
def test_refresh_mask_matches_jax(spec, interval, n, start):
    np.testing.assert_array_equal(
        t_gen.refresh_mask(spec, interval, n, start),
        j_gen.refresh_mask(spec, interval, n, start))


@pytest.mark.parametrize("spec,kind", [
    ("shallow:1,uniform:2", "cache"), ("shallow:2", "eps"),
    ("bogus:2", "cache"), ("full:", "cache"), ("uniform:2,full:1", "cfg"),
    ("uniform:0", "cache"), ("full:1,every:3", "cache"),
    ("every:0x4", "cache"),
])
def test_refresh_mask_raises_where_jax_raises(spec, kind):
    with pytest.raises(ValueError) as want:
        j_gen.refresh_mask(spec, 1, 10, kind=kind)
    with pytest.raises(ValueError) as got:
        t_gen.refresh_mask(spec, 1, 10, kind=kind)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args", [
    (5, 4, -1, -1, 2), (5, 4, 4, 4, 2), (6, 4, 2, 2, 2), (3, 2, 1, 0, 1),
    (3, 2, 1, 0, 2), (7, 5, 3, 2, 2), (10, 6, 5, 1, 2), (9, 6, 3, 0, 0)])
def test_extrap_weights_matches_jax(args):
    assert t_gen.extrap_weights(*args) == j_gen.extrap_weights(*args)


class _ZeroUNet(nn.Module):
    """Stands in for the UNet in the JAX sample block: only skip steps
    run, so it is traced but never called."""

    @nn.compact
    def __call__(self, x, t, context, **kwargs):
        return jnp.zeros_like(x)


N_STEPS = 10


@pytest.fixture(scope="module")
def jax_skip_block():
    """order -> a JAX Generator with eps skip at that extrapolation order
    (its UNet a stub)."""
    from tests.helpers import make_tiny_bundle

    jb = make_tiny_bundle()
    object.__setattr__(jb, "make_unet", lambda **kw: _ZeroUNet())
    gens = {}
    for order in (0, 1, 2):
        cfg = Config({
            "sd_version": "1.5", "height": 64, "width": 64, "seed": 1,
            "work_dir": "unused", "float_precision": "fp32",
            "generation": {
                "control": "none", "guidance_scale": 7.5,
                "n_timesteps": N_STEPS, "prompt": {"e": "x"},
                "merge_global": False, "eps_interval": 2,
                "eps_extrapolate": order}})
        gens[order] = j_gen.Generator(jb, cfg, use_pallas=False)
    return gens


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("steps,t", [
    ([4], 5),            # one refresh: every slot aliases it
    ([2, 4], 7),         # two refreshes: the oldest slot aliases
    ([1, 3, 4], 6),      # three distinct refreshes, uneven spacing
    ([0, 3, 6], 9),      # three distinct, even spacing
])
def test_extrap_weights_is_the_jax_newton_form(jax_skip_block, order,
                                               steps, t):
    gen = jax_skip_block[order]
    rng = np.random.default_rng(10 * order + t)
    shape = (8, 8, 8, 4)
    history = t_gen.EpsHistory(order)
    for s in steps:
        history.push(torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)), s)
    x0 = jnp.zeros(shape, jnp.float32)
    caches = dict(gen._cache_buffers(x0))
    caches["eps"] = jnp.asarray(history.eps[0].numpy())
    if order:
        caches.update(eps_prev=jnp.asarray(history.eps[1].numpy()),
                      eps_step=jnp.float32(history.steps[0]),
                      eps_prev_step=jnp.float32(history.steps[1]))
    if order >= 2:
        caches.update(eps_prev2=jnp.asarray(history.eps[2].numpy()),
                      eps_prev2_step=jnp.float32(history.steps[2]))
    fidx = jnp.broadcast_to(jnp.stack([jnp.arange(8).reshape(2, 4)] * 2, -1),
                            (N_STEPS, 2, 4, 2)).astype(jnp.int32)
    zero = jnp.zeros((), jnp.float32)
    skip_all = jnp.zeros((N_STEPS, 3), jnp.int32)
    want, _ = gen._sample_block(
        gen._params, x0, caches, jnp.asarray(t, jnp.int32), skip_all, fidx,
        jnp.zeros((2, 16, 32), jnp.float32), zero, zero, zero,
        jnp.asarray(7.5, jnp.float32), n_steps=1)
    sch = DDIMScheduler.create(N_STEPS)
    got = t_ddim_step(torch.zeros(shape), history.predict(t),
                      *sch.sample_alpha_pair(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def unets():
    from tests.helpers import make_tiny_bundle

    jb = make_tiny_bundle()
    model = UNet2DConditionModel(config=TINY_UNET, dtype=jnp.float32,
                                 use_pallas=False)
    return jb, model, port_bundle_from_jax(jb).unet


def test_unet_full_and_shallow_match_jax(unets):
    jb, model, tunet = unets
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 16, 32)).astype(np.float32)
    variables = {"params": jb.unet_params}
    want_eps, want_deep = model.apply(variables, jnp.asarray(x),
                                      jnp.asarray(421), jnp.asarray(ctx),
                                      cache_mode="full")
    with torch.no_grad():
        eps, deep = tunet(torch.from_numpy(x), 421, torch.from_numpy(ctx),
                          cache_mode="full")
        # the deep cut: input of the last up block, level-0 size, ch1 wide
        assert deep.shape == (2, 16, 16, TINY_UNET.block_out_channels[1])
        np.testing.assert_allclose(to_np(eps), np.asarray(want_eps), **TOL)
        np.testing.assert_allclose(to_np(deep), np.asarray(want_deep), **TOL)
        np.testing.assert_array_equal(
            to_np(eps), to_np(tunet(torch.from_numpy(x), 421,
                                    torch.from_numpy(ctx))))

        same_t = tunet(torch.from_numpy(x), 421, torch.from_numpy(ctx),
                       cache_mode="shallow", deep_cache=deep)
        np.testing.assert_allclose(to_np(same_t), to_np(eps), atol=1e-6,
                                   rtol=0)

        # shallow at another timestep around the same cached deep feature
        want = model.apply(variables, jnp.asarray(x), jnp.asarray(301),
                           jnp.asarray(ctx), cache_mode="shallow",
                           deep_cache=want_deep)
        got = tunet(torch.from_numpy(x), 301, torch.from_numpy(ctx),
                    cache_mode="shallow",
                    deep_cache=torch.from_numpy(np.array(want_deep)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_unet_split_needs_two_levels():
    one_level = TUNet(UNetConfig(
        block_out_channels=(32,), layers_per_block=1, cross_attention_dim=32,
        num_heads=2, down_block_types=("DownBlock2D",),
        up_block_types=("UpBlock2D",)))
    x, ctx = torch.zeros(1, 8, 8, 4), torch.zeros(1, 4, 32)
    with torch.no_grad():
        assert one_level(x, 1, ctx).shape == (1, 8, 8, 4)
        for mode in ("full", "shallow"):
            with pytest.raises(ValueError, match="2 UNet levels"):
                one_level(x, 1, ctx, cache_mode=mode,
                          deep_cache=torch.zeros(1, 8, 8, 32))
        with pytest.raises(ValueError, match="cache_mode"):
            one_level(x, 1, ctx, cache_mode="deep")
