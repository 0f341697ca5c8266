"""The single-launch GroupNorm's plain version and the GroupNorm route, on
the CPU.

The port's ``full_group_norm`` (its plain version on a CPU tensor) is held
against the Pallas ``full_group_norm`` in interpret mode at the JAX
package's own test shapes (``tests/test_groupnorm.py``), SiLU on and off,
within 1e-5 (fp32 sums in another order on O(1) values).
``VIDTOME_GN_MODE`` is read as the JAX package reads it; a CPU tensor takes
the plain version under every mode, and the CUDA routes (and the refusal of
``xla`` on a CUDA tensor) are checked on the card by
``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidtome_torch.ops import groupnorm as t_gn
from vidtome_tpu.ops import groupnorm as j_gn

torch.set_num_threads(2)


@pytest.mark.parametrize("B,rows,C,G,silu", [
    (2, 64, 320, 32, False),
    (2, 64, 320, 32, True),
    (1, 128, 128, 32, False),
    (2, 256, 640, 32, True),
    (2, 100, 64, 32, False),
])
def test_plain_full_group_norm_matches_jax(B, rows, C, G, silu):
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(B, rows, C)) * 1.5 + 0.25).astype(np.float32)
    w = (rng.normal(size=C) + 1).astype(np.float32)
    b = rng.normal(size=C).astype(np.float32)
    want = np.asarray(j_gn.full_group_norm(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b), G, silu=silu,
                                           interpret=True))
    got = t_gn.full_group_norm(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), G, silu=silu)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert t_gn.full_group_norm.launches == 0  # CPU tensors: plain path


@pytest.mark.parametrize("env,mode", [
    ({}, "auto"),
    ({"VIDTOME_GN_MODE": "full"}, "full"),
    ({"VIDTOME_GN_MODE": "STATS"}, "stats"),
    ({"VIDTOME_GN_MODE": "xla"}, "xla"),
    ({"VIDTOME_GN_MODE": "full", "VIDTOME_DISABLE_PALLAS_GN": "1"}, "xla"),
])
def test_gn_mode_is_read_as_the_jax_package_reads_it(monkeypatch, env, mode):
    for key in ("VIDTOME_GN_MODE", "VIDTOME_DISABLE_PALLAS_GN"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert t_gn._gn_mode() == mode == j_gn._gn_mode()
    # a CPU tensor takes the plain version under every mode
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 16, 64)).astype(np.float32))
    w, b = torch.ones(64), torch.zeros(64)
    got = t_gn.group_norm(x, w, b, 32, 1e-5, True)
    assert torch.equal(got, t_gn.reference_group_norm(x, w, b, 32, 1e-5,
                                                      True))
    assert t_gn.group_norm.launches == t_gn.full_group_norm.launches == 0
