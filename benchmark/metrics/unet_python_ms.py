"""Host milliseconds of a UNet call outside CUDA runtime and driver calls
(its mean): the Python and dispatch share of the call's host time, from
the program's ``vidtome/unet`` spans (``harness/spans.py``)."""


def read(rec):
    u = rec.get("program", {}).get("unet", {})
    if not u.get("calls"):
        return None
    return 1e3 * (u["host_s"] - u["runtime_s"]) / u["calls"]
