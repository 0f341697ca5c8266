"""Host milliseconds of a sampling step outside its UNet (and ControlNet)
calls, its mean: the lane gather and concat, CFG combine, scatter and DDIM
update around them, from the ``vidtome/gen_step`` spans' self time
(``harness/spans.py``)."""


def read(rec):
    g = rec.get("program", {}).get("gen_step", {})
    if not g.get("calls"):
        return None
    return 1e3 * g["self_s"] / g["calls"]
