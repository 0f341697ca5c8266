"""Host milliseconds from a UNet call's start to its return, with no
synchronize: what the host spends issuing a call (its mean)."""


def read(rec):
    u = rec["kinds"].get("unet", {})
    return 1e3 * u["host_s"] / u["calls"] if u.get("calls") else None
