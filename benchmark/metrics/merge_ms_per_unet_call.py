"""Device milliseconds of the kernels launched inside the merge engine's
entries (``core/merge.py``), over the generation's UNet calls (the calls
that merge)."""


def read(rec):
    s = rec["kinds"].get("merge", {}).get("device_s", 0.0)
    n = rec["gen_unet_calls"]
    return 1e3 * s / n if s and n else None
