"""Percent of the card's roofline in the ``ResnetBlock2D`` calls (both
norms, both convolutions, the time projection, the shortcut): the sum of
each call's least time (its operations at the bf16 peak or its bytes at
the HBM bandwidth, whichever is longer, from the shapes it was given:
``benchmark/counts``) over the device time of every kernel launched inside
those calls."""


def read(rec):
    k = rec["kinds"].get("resnet", {})
    if not k.get("device_s"):
        return None
    return 100.0 * k["least_s"] / k["device_s"]
