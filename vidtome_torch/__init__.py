"""vidtome-torch: the PyTorch/CUDA port of vidtome-tpu for NVIDIA Hopper.

Same system as ``vidtome_tpu`` (DDIM-invert a clip with Stable Diffusion,
then re-denoise it under an edit prompt while merging redundant
self-attention tokens across frames), with the same module layout
(``core/``, ``ops/``, ``models/``, ``pipeline/``, ``cli.py``).  Plain tensor
code is PyTorch; the kernels the JAX package writes in Pallas are written
by hand for Hopper in CUDA C++ (``csrc/``: attention, GroupNorm, the
fused resnet, best match, the fused sublayer).  Activations stay NHWC at module boundaries, as in
the JAX package, so the two compare like with like.

This package never imports ``jax`` or ``flax``.
"""

__version__ = "0.1.0"
