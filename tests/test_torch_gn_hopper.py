"""The GroupNorm kernel's plain versions, launch planner and routes, on the
CPU.

``csrc/group_norm.cu`` has four entries (full, stats, apply, finalize); the
kernel runs only on the card (``tests/test_torch_kernels.py``).  Here:

* the plain versions of stats, apply and finalize are held against the JAX
  package on numpy inputs from a seed: the port's group mean and rstd
  [B, G], expanded to channels, against the Pallas ``group_norm_stats`` in
  interpret mode (per channel [B, C]); apply of those statistics against
  the Pallas ``fused_group_norm``; finalize of per-tile channel partials of
  a slab against the statistics of the same slab.  atol 1e-5: fp32 sums in
  another order on O(1) values, as ``tests/test_torch_ops.py``;
* the planner (:func:`vidtome_torch.ops.groupnorm.plan`) over every
  GroupNorm shape of SD1.5's UNet at 512x512 and of the VAE at B = 8 and 4:
  whole groups a slice, rows a multiple of 16 bytes and at least 32, a
  resident slab within its shared memory, every UNet shape resident,
  clusters of at most 8 blocks, and the block count as planned;
* the route of each ``VIDTOME_GN_MODE`` over the same shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidtome_torch.ops import groupnorm as t_gn
from vidtome_tpu.ops import groupnorm as j_gn

torch.set_num_threads(2)

# [rows, C] of every GroupNorm of one SD1.5 UNet call at a 64x64 latent
# (61 norms: resnet GN1 / GN2 with SiLU, transformer input norms)
UNET_SHAPES = [(4096, 320), (4096, 640), (4096, 960), (1024, 320),
               (1024, 640), (1024, 960), (1024, 1280), (1024, 1920),
               (256, 640), (256, 1280), (256, 1920), (256, 2560),
               (64, 1280), (64, 2560)]
# the VAE encoder's and decoder's at 512x512
VAE_SHAPES = [(4096, 512), (16384, 256), (16384, 512), (65536, 128),
              (65536, 256), (65536, 512), (262144, 128), (262144, 256)]
ALL_SHAPES = [(B, rows, C) for B in (8, 4)
              for rows, C in UNET_SHAPES + VAE_SHAPES]


def _slab(seed, B, rows, C, scale=2.0, shift=0.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, rows, C)) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("B,rows,C,G,eps", [
    (2, 64, 320, 32, 1e-5),
    (2, 256, 128, 32, 1e-6),
    (1, 128, 640, 32, 1e-5),
    (3, 16, 64, 32, 1e-5),
    (2, 100, 96, 32, 1e-6),
])
def test_plain_stats_match_pallas_group_norm_stats(B, rows, C, G, eps):
    x = _slab(21, B, rows, C)
    mean, rstd = t_gn.group_stats(torch.from_numpy(x), G, eps)
    assert mean.shape == rstd.shape == (B, G)
    want_mean, want_inv = j_gn.group_norm_stats(jnp.asarray(x), G, eps,
                                                interpret=True)
    gsize = C // G
    for got, want in ((mean, want_mean), (rstd, want_inv)):
        np.testing.assert_allclose(
            got.repeat_interleave(gsize, dim=1).numpy(), np.asarray(want),
            atol=1e-5, rtol=0)
    assert t_gn.group_norm.launches == 0  # CPU tensors: plain path


@pytest.mark.parametrize("B,rows,C,G,silu,eps", [
    (2, 64, 320, 32, True, 1e-5),
    (2, 256, 128, 32, False, 1e-6),
    (1, 128, 640, 32, True, 1e-5),
    (3, 16, 64, 32, False, 1e-5),
    (2, 100, 96, 32, True, 1e-6),
])
def test_plain_apply_of_stats_matches_fused_group_norm(B, rows, C, G, silu,
                                                       eps):
    x = _slab(22, B, rows, C)
    rng = np.random.default_rng(23)
    w = (rng.normal(size=C) + 1).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    mean, rstd = t_gn.group_stats(xt, G, eps)
    got = t_gn.apply_group_norm(xt, mean, rstd, wt, bt, G, silu)
    want = j_gn.fused_group_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), G, eps, silu, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the composition is the plain full GroupNorm
    assert torch.equal(got, t_gn.reference_group_norm(xt, wt, bt, G, eps,
                                                      silu))
    assert t_gn.group_norm.launches == t_gn.full_group_norm.launches == 0


@pytest.mark.parametrize("B,rows,C,G,tiles", [
    (2, 256, 320, 32, 4),
    (2, 64, 128, 32, 8),
    (1, 1024, 640, 32, 16),
    (3, 96, 96, 32, 3),
])
def test_plain_finalize_of_tile_partials_matches_slab_stats(B, rows, C, G,
                                                            tiles):
    """Per-tile channel sums of a slab, as the fused resnet conv's epilogue
    writes them, reduce to the statistics of the slab."""
    x = _slab(24, B, rows, C)
    parts = torch.from_numpy(x).reshape(B, tiles, rows // tiles, C)
    sums, sqs = parts.sum(2), (parts * parts).sum(2)
    mean, rstd = t_gn.stats_from_partials(sums, sqs, G, rows, 1e-5)
    want_mean, want_inv = j_gn.group_norm_stats(jnp.asarray(x), G, 1e-5,
                                                interpret=True)
    gsize = C // G
    np.testing.assert_allclose(mean.repeat_interleave(gsize, 1).numpy(),
                               np.asarray(want_mean), atol=1e-5, rtol=0)
    np.testing.assert_allclose(rstd.repeat_interleave(gsize, 1).numpy(),
                               np.asarray(want_inv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        torch.stack(t_gn.group_stats(torch.from_numpy(x), G, 1e-5)).numpy(),
        torch.stack((mean, rstd)).numpy(), atol=1e-5, rtol=0)
    assert t_gn.group_norm.launches == 0


@pytest.mark.parametrize("B,rows,C", ALL_SHAPES)
def test_plan_takes_every_unet_and_vae_shape(B, rows, C):
    p = t_gn.plan(B, rows, C, 32, 2)
    gsize = C // 32
    row_bytes = 2 * p.sc
    # slices of whole groups, one TMA box wide, rows of whole 16-byte
    # vectors and at least a 32-byte sector
    assert p.sc % gsize == 0 and C % p.sc == 0
    assert p.sc <= t_gn.MAX_BOX and row_bytes % 16 == 0 and row_bytes >= 32
    assert p.cluster in t_gn.CLUSTERS
    # the cluster's ranks cover the rows, each rank's boxes its span
    assert p.span * p.cluster >= rows > p.span * (p.cluster - 1)
    assert p.boxes * p.box_rows >= p.span and p.box_rows <= t_gn.MAX_BOX
    assert p.stage_bytes % 128 == 0 and p.stage_bytes >= p.box_rows * row_bytes
    assert p.smem == t_gn.smem_bytes(2, p.sc, p.stages, p.stage_bytes)
    assert p.smem <= t_gn.SMEM_LIMIT
    if p.resident:
        assert p.stages == p.boxes
        assert p.boxes * p.stage_bytes <= t_gn.SLAB_BYTES
    else:
        assert p.stages == t_gn.STREAM_STAGES < p.boxes
    if (rows, C) in UNET_SHAPES:
        assert p.resident, "every UNet GroupNorm keeps its slab resident"
    # blocks: a (batch element, slice) a cluster, whole waves of the card
    assert p.blocks == B * (C // p.sc) * p.cluster
    assert t_gn.h100_clusters(p.cluster, p.smem) > 0
    assert p.blocks % 128 == 0
    waves = -(-p.blocks // t_gn.H100_SMS)
    assert p.blocks / (waves * t_gn.H100_SMS) >= 0.9


@pytest.mark.parametrize("B,rows,C,G,elem,sc,cluster", [
    (8, 4096, 320, 32, 2, 40, 2),      # 64 two-block clusters: one wave
    (8, 4096, 960, 32, 2, 120, 8),     # the one resident slice: 4 groups
    (8, 64, 2560, 32, 2, 160, 1),      # one-block clusters
    (8, 262144, 128, 32, 2, 64, 8),    # streaming, 128-byte rows
    (4, 262144, 128, 32, 2, 32, 8),    # streaming, the CFG-skip batch
    (2, 1000, 96, 32, 2, 24, 8),       # 3 channels a group: 48-byte rows
    (1, 300, 64, 32, 4, 8, 8),         # fp32: 32-byte rows
    (1, 64, 32, 32, 2, 16, 8),         # 1 channel a group
])
def test_plan_picks(B, rows, C, G, elem, sc, cluster):
    p = t_gn.plan(B, rows, C, G, elem)
    assert (p.sc, p.cluster) == (sc, cluster)


@pytest.mark.parametrize("C,G,elem", [(20, 4, 2), (100, 20, 2), (30, 3, 4),
                                      (36, 4, 2)])
def test_plan_refuses_what_tma_cannot_read(C, G, elem):
    with pytest.raises(ValueError, match="no slice"):
        t_gn.plan(2, 64, C, G, elem)


def test_plan_refuses_groups_that_do_not_divide():
    with pytest.raises(ValueError, match="do not split"):
        t_gn.plan(2, 64, 96, 5, 2)


@pytest.mark.parametrize("B,rows,C", ALL_SHAPES)
def test_auto_route_takes_the_full_entry(B, rows, C):
    """Every UNet and VAE shape: auto and full launch the full entry once,
    stats the stats and apply entries, each on the same plan."""
    assert t_gn.route("auto") == t_gn.route("full") == ("full",)
    assert t_gn.route("stats") == ("stats", "apply")
    p = t_gn.plan(B, rows, C, 32, 2)
    assert p == t_gn.plan(B, rows, C, 32, 2)  # one plan for all entries


@pytest.mark.parametrize("mode", ["xla", "pallas", ""])
def test_route_refuses_modes_that_would_hide_the_kernel(mode):
    with pytest.raises(ValueError, match="plain version"):
        t_gn.route(mode)


@pytest.mark.parametrize("C", sorted({C for _, C in UNET_SHAPES + VAE_SHAPES}
                                     | {96, 64, 32}))
def test_finalize_groups_fit_a_block(C):
    gpb = t_gn.finalize_groups(C, 32)
    assert 32 % gpb == 0 and gpb * (C // 32) <= t_gn.FINALIZE_CHANNELS
    assert 2 * gpb * (C // 32) > t_gn.FINALIZE_CHANNELS or gpb == 32
