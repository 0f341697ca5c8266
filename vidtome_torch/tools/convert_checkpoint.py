"""Convert a diffusers-layout SD checkpoint into a native bundle of the port
(counterpart of ``tools/convert_checkpoint.py``):

    python -m vidtome_torch.tools.convert_checkpoint \
        --src /ckpts/stable-diffusion-v1-5 --dst /ckpts/sd15-native \
        [--sd-version 1.5 --control softedge \
         --controlnet-root /ckpts/controlnets --dtype bf16 --device cpu]

The checkpoint is read on ``--device`` (the card by default) and written by
``models/checkpoint.save_bundle``; ``load_bundle`` reads it back without
converting again.  A missing ``--src`` raises rather than saving random
weights.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True,
                        help="diffusers-layout checkpoint dir")
    parser.add_argument("--dst", required=True, help="output bundle dir")
    parser.add_argument("--sd-version", default="1.5")
    parser.add_argument("--control", default="none")
    parser.add_argument("--controlnet-root", default=None)
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from vidtome_torch.models.checkpoint import save_bundle
    from vidtome_torch.models.registry import init_model

    bundle = init_model(
        sd_version=args.sd_version, model_key=args.src,
        weight_dtype=args.dtype, device=args.device, control=args.control,
        controlnet_root=args.controlnet_root, allow_random_weights=False)
    save_bundle(bundle, args.dst)
    print(f"[INFO] native bundle written to {args.dst}")


if __name__ == "__main__":
    main()
