"""Device milliseconds of the kernels launched in the merge engine's
``vidtome/merge_plan`` spans (matching and plan building: index builds,
the best-match kernel, sorts), over the generation's UNet calls
(``harness/spans.py``)."""


def read(rec):
    s = rec.get("program", {}).get("merge_plan", {}).get("device_s")
    n = rec.get("gen_unet_calls")
    return 1e3 * s / n if s and n else None
