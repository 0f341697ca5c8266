"""Device milliseconds of the kernels launched in the merge engine's
``vidtome/merge_apply`` spans (the gathers and scatters that apply a
plan: merge, unmerge, a computed partition), over the generation's UNet
calls (``harness/spans.py``)."""


def read(rec):
    s = rec.get("program", {}).get("merge_apply", {}).get("device_s")
    n = rec.get("gen_unet_calls")
    return 1e3 * s / n if s and n else None
