"""Kernels launched inside the UNet's calls, a call."""


def read(rec):
    u = rec["kinds"].get("unet", {})
    return u["launches"] / u["calls"] if u.get("calls") else None
