"""One-command parity run of the port on a checkpoint (counterpart of
``tools/parity_run.py``):

    python -m vidtome_torch.tools.parity_run \
        --src /ckpts/stable-diffusion-v1-5 --work /tmp/parity \
        [--clip clip.mp4] [--ref-frames reference_output_frames] \
        [--frames 16 --steps 50 --size 512] \
        [--check-int8] [--check-serve] [--check-profile NAME]

Flow: load the diffusers checkpoint (``allow_random_weights=False``) and
save it as a native bundle; DDIM-invert the clip with reconstruction and
score the reconstruction's PSNR; run the PnP demo edit and score its
temporal consistency; rerun the edit under each checked serving profile
(``control: none``) and score it against the exact bf16 ``control: none``
edit; with ``--ref-frames``, score the edit against the reference
implementation's frames (``vidtome_torch.eval.compare``); write
everything to ``<work>/parity.json``, with the JAX tool's keys.
:func:`run_parity` takes any bundle (the tests run it on the tiny stack).
Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np

from vidtome_torch.tools.profiles import DEFAULT_SERVE_PROFILE, SERVE_PROFILES

# the profiles a parity run can check: plain int8 and bench.py's serving
# profiles, as "serve_<name>"
PROFILES = {"int8": {"quant": "int8"},
            **{f"serve_{k}": dict(v) for k, v in SERVE_PROFILES.items()}}


def _ensure_clip(path: str | None, work: str, n_frames: int,
                 size: int) -> str:
    """``path``, or a synthetic moving-gradient clip written as pngs under
    ``<work>/input_frames`` when none is given."""
    if path:
        return path
    from vidtome_torch.io.video import save_frames

    clip_dir = os.path.join(work, "input_frames")
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    frames = []
    for i in range(n_frames):
        phase = i / max(n_frames, 1)
        r = 0.5 + 0.5 * np.sin(2 * np.pi * (xx + phase))
        g = 0.5 + 0.5 * np.cos(2 * np.pi * (yy + phase / 2))
        b = np.full_like(r, 0.3) + 0.2 * phase
        frames.append(np.clip(np.stack([r, g, b], -1), 0, 1))
    save_frames(np.stack(frames), clip_dir)
    return clip_dir


def run_parity(bundle, work: str, clip: str, *, frames: int = 16,
               steps: int = 50, size: int = 512,
               edit_prompt: str = "a watercolor painting",
               inv_prompt: str = "a video clip",
               ref_frames: str | None = None,
               check_profiles: tuple = ()) -> dict:
    """Invert with reconstruction, then the PnP demo edit, on ``bundle``
    (and each of ``check_profiles``, keys of :data:`PROFILES`); returns the
    parity record and writes it to ``<work>/parity.json``."""
    from vidtome_torch.cli import run_generation, run_inversion
    from vidtome_torch.config import Config
    from vidtome_torch.eval import psnr, temporal_consistency
    from vidtome_torch.io.artifacts import get_latents_dir
    from vidtome_torch.io.video import load_video

    os.makedirs(work, exist_ok=True)
    latents = os.path.join(work, "latents")
    out_dir = os.path.join(work, "out")
    cfg = Config({
        "sd_version": bundle.sd_version, "input_path": clip,
        "work_dir": work, "height": size, "width": size, "seed": 123,
        "float_precision": "bf16",
        "inversion": {
            "save_path": latents, "prompt": inv_prompt, "steps": steps,
            "save_steps": steps, "save_intermediate": True,
            "batch_size": min(8, frames), "n_frames": frames,
            "force": True, "recon": True, "control": "none",
        },
        "generation": {
            "control": "pnp", "guidance_scale": 7.5, "n_timesteps": steps,
            "negative_prompt": "ugly, blurry, low res",
            "prompt": {"edit": edit_prompt},
            "latents_path": latents, "output_path": out_dir,
            "chunk_size": 4, "chunk_ord": "mix-4",
            "local_merge_ratio": 0.9, "merge_global": True,
            "global_merge_ratio": 0.8, "global_rand": 0.5,
            "align_batch": False, "save_frame": True,
            "frame_range": [frames],
        },
    })
    cfg["model_key"] = bundle.model_key

    record: dict = {"work_dir": work, "clip": clip, "frames": frames,
                    "steps": steps, "size": size,
                    "random_weights": bool(bundle.random_weights)}

    # stage 1: inversion and the reconstruction's fidelity
    run_inversion(cfg, bundle)
    recon_dir = os.path.join(get_latents_dir(latents, bundle.model_key),
                             "recon_frames")
    inp = load_video(clip, size, size)[:frames]
    rec = load_video(recon_dir, size, size)[:frames]
    recon_db = psnr(inp, rec)
    record["inversion_recon_psnr_db"] = round(float(recon_db), 2)
    print(f"[parity] inversion recon PSNR: {recon_db:.2f} dB")

    # stage 2: the demo edit (PnP from the inversion's latents)
    edited = run_generation(cfg, bundle)["edit"].float().cpu().numpy()
    record["edit_prompt"] = edit_prompt
    record["edit_frames"] = int(edited.shape[0])
    record["edit_output_dir"] = os.path.join(out_dir, "edit", "frames")
    record["edit_temporal_consistency"] = round(
        float(temporal_consistency(edited)), 4)

    # stage 2b: each serving profile against the exact bf16 edit, both with
    # control: none (the deep cache refuses PnP: its shallow steps skip the
    # up-block-1 injections)
    if check_profiles:
        def _edit(name, over):
            pcfg = copy.deepcopy(cfg)
            pcfg["generation"].update(control="none", **over)
            pcfg["generation"]["output_path"] = os.path.join(work,
                                                             f"out_{name}")
            out = run_generation(pcfg, bundle)["edit"]
            return out.float().cpu().numpy()

        base = _edit("exact_nopnp", {})
        for name in check_profiles:
            db = psnr(base, _edit(name, PROFILES[name]))
            record[f"profile_{name}_psnr_db"] = round(float(db), 2)
            record[f"profile_{name}_gate_35db"] = bool(db >= 35.0)
            print(f"[parity] profile {name}: {db:.2f} dB vs exact bf16")

    # stage 3: the edit against the reference implementation's frames
    if ref_frames:
        from vidtome_torch.eval import compare

        record["vs_reference"] = compare(record["edit_output_dir"],
                                         ref_frames, height=size,
                                         width=size)
        record["baseline_gate_35db"] = (
            record["vs_reference"]["psnr_mean"] >= 35.0)

    with open(os.path.join(work, "parity.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"[parity] record written to {os.path.join(work, 'parity.json')}")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="diffusers-layout checkpoint dir")
    ap.add_argument("--work", required=True)
    ap.add_argument("--clip", default=None,
                    help="input video / frame dir; synthesized if omitted")
    ap.add_argument("--ref-frames", default=None,
                    help="the reference implementation's output frames: "
                         "scores the edit against the 35 dB bar")
    ap.add_argument("--sd-version", default="1.5")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--edit-prompt", default="a watercolor painting")
    ap.add_argument("--inv-prompt", default="a video clip")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-bundle", action="store_true",
                    help="do not save the native bundle")
    ap.add_argument("--check-int8", action="store_true",
                    help="also run the edit in int8 and score it against "
                         "the exact bf16 edit")
    ap.add_argument("--check-serve", action="store_true",
                    help="the same for bench.py's shipped serving profile "
                         "(DEFAULT_SERVE_PROFILE)")
    ap.add_argument("--check-profile", default=None,
                    help="the same for a named SERVE_PROFILES entry")
    args = ap.parse_args(argv)

    from vidtome_torch.models.checkpoint import save_bundle
    from vidtome_torch.models.registry import init_model

    bundle = init_model(sd_version=args.sd_version, model_key=args.src,
                        weight_dtype="bf16", device=args.device,
                        allow_random_weights=False)
    if not args.skip_bundle:
        native = os.path.join(args.work, "native_bundle")
        save_bundle(bundle, native)
        print(f"[parity] native bundle written to {native}")

    clip = _ensure_clip(args.clip, args.work, args.frames, args.size)
    extra = args.check_profile
    if extra and not extra.startswith(("int8", "serve_")):
        extra = f"serve_{extra}"  # a bare SERVE_PROFILES name
    profiles = tuple(p for p, on in (
        ("int8", args.check_int8),
        (f"serve_{DEFAULT_SERVE_PROFILE}", args.check_serve),
        (extra, extra)) if on)
    record = run_parity(bundle, args.work, clip, frames=args.frames,
                        steps=args.steps, size=args.size,
                        edit_prompt=args.edit_prompt,
                        inv_prompt=args.inv_prompt,
                        ref_frames=args.ref_frames,
                        check_profiles=profiles)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
