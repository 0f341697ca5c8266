"""Percent of the traced window (whole edits) in which no kernel, copy or
fill ran on the card: one minus the union of the device intervals over the
window."""


def read(rec):
    if not rec["window_s"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
