"""Percent of the card's bf16 peak over the traced window: the model
operations of every UNet, VAE and text-encoder call in it (dense layers,
convolutions and attention, counted from the shapes each call was given:
``benchmark/counts``) over the window's seconds at 989 TFLOP/s."""

from benchmark.counts import peaks


def read(rec):
    if not rec["window_s"] or not rec["model_flops"]:
        return None
    return 100.0 * rec["model_flops"] / (rec["window_s"] * peaks.BF16_FLOPS)
