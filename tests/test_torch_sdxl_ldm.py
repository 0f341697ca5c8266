"""LDM-variant merging (``merge_crossattn`` and ``merge_ff``, bench.py's
``bench_sdxl --ldm``) on the tiny SDXL stack with its refiner, port vs the
JAX package, on the CPU: the two-stage generation (base steps 0-3, refiner
4-5; the refiner inherits both keys) from the same seeded latents, fp32,
the JAX package's merge draws, 8 frames at 64x64 in 2 chunks with local
and global merging.  The frames are held to the 60 dB of
``tests/test_torch_sdxl.py``'s two-stage slice (above the repo's 35 dB
floor), and the LDM frames must differ from the plain two-stage ones.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_sdxl import (N_FRAMES, PSNR_SLICE, REFINER, config,
                                   jax_edits, jax_xl_bundle, port_sample)
from tests.torch_parity import port_bundle_from_jax, psnr

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bundles():
    from vidtome_tpu.models.registry import init_model as j_init

    return jax_xl_bundle(), j_init(sd_version="tiny-refiner",
                                   weight_dtype="fp32")


def test_sdxl_ldm_two_stage_matches_jax(bundles):
    jb, _ = bundles
    x = np.random.default_rng(8).standard_normal(
        (N_FRAMES, 8, 8, 4)).astype(np.float32)
    cfg = config(refiner=REFINER, merge_crossattn=True, merge_ff=True)
    want = jax_edits(jb, cfg, x, base=False)["two_stage"]
    tb = port_bundle_from_jax(jb)
    got, gen = port_sample(tb, bundles, cfg, x)
    assert gen.tome.merge_crossattn and gen.tome.merge_ff
    assert gen.refiner.tome.merge_crossattn and gen.refiner.tome.merge_ff
    score = psnr(got, want)
    print(f"SDXL + refiner LDM PSNR port vs JAX: {score:.2f} dB")
    assert score >= PSNR_SLICE
    plain, _ = port_sample(tb, bundles, config(refiner=REFINER), x)
    assert np.abs(plain - got).max() > 1e-3
