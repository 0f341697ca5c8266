"""The tiny model bundle of tests and dry runs (counterpart of
``vidtome_tpu/testing.py``).

The same module classes and pipeline code paths as the full SD bundles,
shrunk: ``TINY_UNET``, ``TINY_TEXT``, a VAE of (8, 8, 8, 8) channels with
one layer a block, and ``HashTokenizer(1000, 16)``, with random weights
drawn from seeds 0 (UNet), 1 (VAE) and 2 (text encoder), as the JAX
package's tiny bundle draws them."""

from __future__ import annotations

import torch

from vidtome_torch.models.registry import ModelBundle, init_model


def make_tiny_bundle(dtype: torch.dtype | None = None,
                     device: str | torch.device = "cpu") -> ModelBundle:
    """The tiny stack on ``device`` in ``dtype`` (default fp32), under the
    JAX tiny bundle's model key."""
    dtype = dtype or torch.float32
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the port's weights are fp32 or bf16, not {dtype}")
    bundle = init_model("tiny", weight_dtype=(
        "bf16" if dtype == torch.bfloat16 else "fp32"), device=device)
    bundle.model_key = "tiny-test-model"
    return bundle
