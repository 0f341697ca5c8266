"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit): the bounds the rooflines and ``mfu`` are
held to.  The port's table of kernels (``PERF.md``) holds its kernels to
the same two numbers."""

BF16_FLOPS = 989e12   # dense bf16 / fp16 tensor-core operations a second
HBM_BYTES = 3.35e12   # HBM3 bytes a second


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time of a call: operations at the peak or bytes at the
    bandwidth, whichever takes longer."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
