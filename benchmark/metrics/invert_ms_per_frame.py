"""Host milliseconds of the inversion stage an edited frame: the harness's
span around ``Inverter.__call__`` (VAE encode, text encoder, DDIM
inversion), ended by a synchronize."""


def read(rec):
    s = rec["stage_s"].get("invert")
    return None if not s else 1e3 * s / rec["frames"]
