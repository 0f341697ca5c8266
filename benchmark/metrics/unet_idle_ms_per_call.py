"""Device-idle milliseconds whose gap starts while the host is anywhere
inside a ``vidtome/unet`` span, over the UNet calls: the card waiting on
a call's launches (``harness/spans.py``)."""


def read(rec):
    u = rec.get("program", {}).get("unet", {})
    if not u.get("calls"):
        return None
    return 1e3 * u["idle_all_s"] / u["calls"]
