"""Port token merging vs the JAX package, with the JAX draws.

Inputs are built so that every matching decision has a wide margin: each
token is a shared base vector plus noise of its own, distinct scale, so a
src token's best dst is clear and the best-scores that decide the kept set
are well apart.  Torch and JAX break argmax / top_k ties in their own ways,
so near-tie inputs are excluded on purpose.  Plans must agree exactly;
merged and restored tokens to fp32 rounding (atol 1e-6).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import jax_local_draws
from vidtome_torch.core import merge as TM
from vidtome_tpu.core import merge as JM

torch.set_num_threads(2)


def _frames(seed, B, F, tnum, C):
    """[B, F*tnum, C]: frame f token i = base[i] + sigma[f, i] * noise."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(B, 1, tnum, C))
    sigma = rng.permutation(np.linspace(0.05, 1.5, F * tnum)).reshape(
        1, F, tnum, 1)
    x = base + sigma * rng.normal(size=(B, F, tnum, C))
    return x.reshape(B, F * tnum, C).astype(np.float32)


def _pair(seed, B, n, C=256):
    """(a, b) [B, n, C] with cos(a_i, b_p(i)) = c_i exactly, the c_i evenly
    spread over [0.55, 0.98] (for hundreds of tokens, random inputs would
    put some best-scores within fp32 noise of each other)."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(B, n, C))
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    partner = b[:, rng.permutation(n)]
    u = rng.normal(size=(B, n, C))
    u -= (u * partner).sum(-1, keepdims=True) * partner
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    c = rng.permutation(np.linspace(0.55, 0.98, n)).reshape(1, n, 1)
    a = c * partner + np.sqrt(1 - c * c) * u
    return a.astype(np.float32), b.astype(np.float32)


def _assert_plans_equal(tp, jp):
    np.testing.assert_array_equal(tp.merge_gather.numpy(),
                                  np.asarray(jp.merge_gather))
    np.testing.assert_array_equal(tp.unmerge_gather.numpy(),
                                  np.asarray(jp.unmerge_gather))


@pytest.mark.parametrize("seed,F,tnum,ratio,align,quantum", [
    (0, 4, 64, 0.9, False, None),
    (1, 4, 64, 0.9, True, None),
    (2, 4, 64, 0.5, False, None),
    (3, 8, 32, 0.9, False, None),      # two rounds (8 frames, stride 4)
    (4, 2, 600, 0.25, False, 1024),    # len_quantum raises r (150 -> 176)
])
def test_compute_local_merge(seed, F, tnum, ratio, align, quantum):
    if quantum:  # two frames, each token's match in the other designed
        x = np.concatenate(_pair(seed, 2, tnum), axis=1)
    else:
        x = _frames(seed, 2, F, tnum, 32)
    key = jax.random.key(100 + seed)
    jt, jplans = JM.compute_local_merge(jnp.asarray(x), F, ratio, key,
                                        target_stride=4, align_batch=align,
                                        len_quantum=quantum)
    draws = jax_local_draws(key, F, 4)
    tt, tplans = TM.compute_local_merge(torch.from_numpy(x), F, ratio, draws,
                                        target_stride=4, align_batch=align,
                                        len_quantum=quantum)
    assert len(tplans) == len(jplans)
    for tp, jp in zip(tplans, jplans):
        _assert_plans_equal(tp, jp)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6, rtol=0)
    np.testing.assert_allclose(TM.unmerge_all(tt, tplans).numpy(),
                               np.asarray(JM.unmerge_all(jt, jplans)),
                               atol=1e-6, rtol=0)
    if quantum:
        assert tt.shape[1] % 256 == 0


@pytest.mark.parametrize("seed,L,ratio,align", [
    (0, 320, 0.8, False), (1, 320, 0.8, True), (2, 600, 0.8, False)])
def test_two_set_matching(seed, L, ratio, align):
    x = np.concatenate(_pair(seed, 2, L), axis=1)
    jp = JM.two_set_matching(jnp.asarray(x), L, ratio, align_batch=align,
                             len_quantum=1024)
    tp = TM.two_set_matching(torch.from_numpy(x), L, ratio, align_batch=align,
                             len_quantum=1024)
    _assert_plans_equal(tp, jp)
    merged_t = TM.merge(torch.from_numpy(x), tp)
    merged_j = JM.merge(jnp.asarray(x), jp)
    np.testing.assert_allclose(merged_t.numpy(), np.asarray(merged_j),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(TM.unmerge(merged_t, tp).numpy(),
                               np.asarray(JM.unmerge(merged_j, jp)),
                               atol=1e-6, rtol=0)


def test_merge_unmerge_round_trip():
    """Kept and dst tokens come back bit-exact; merged src tokens read their
    best dst."""
    x = torch.from_numpy(_frames(5, 2, 4, 16, 8))
    plan = TM.local_matching(x, 4, 0.75, 0, draw=2)
    y = TM.unmerge(TM.merge(x, plan), plan)
    kept = plan.merge_gather
    np.testing.assert_array_equal(y.gather(1, kept[..., None].expand(
        -1, -1, 8)).numpy(), x.gather(1, kept[..., None].expand(-1, -1, 8))
        .numpy())
    assert TM.merge(x, plan).shape == (2, 48 - 36 + 16, 8)


@pytest.mark.parametrize("S,r,D,q", [
    (12288, 11059, 4096, 1024), (3072, 2764, 1024, 1024), (5120, 4096, 5120, 1024),
    (1000, 500, 1000, 1024), (48, 43, 16, 1024), (12288, 11059, 4096, None),
    (1536, 1382, 512, 1024), (3000, 2000, 100, 512)])
def test_quantize_r(S, r, D, q):
    assert TM.quantize_r(S, r, D, q) == JM.quantize_r(S, r, D, q)


@pytest.mark.parametrize("F,stride", [(4, 4), (8, 4), (6, 4), (5, 4), (4, 2)])
def test_rounds(F, stride):
    assert TM.local_merge_rounds(F, stride) == JM.local_merge_rounds(F, stride)
    assert TM.round_stride(F, stride) == JM._round_stride(F, stride)
