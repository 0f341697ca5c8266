"""Device milliseconds of the kernels launched inside the VAE ``Encoder``
and ``Decoder`` calls, an edited frame."""


def read(rec):
    k = rec["kinds"]
    s = sum(k.get(n, {}).get("device_s", 0.0) for n in ("vae_enc", "vae_dec"))
    return None if not s else 1e3 * s / rec["frames"]
