"""Quality gates of the levers that leave the reference's exact semantics
(counterpart of ``tools/quality_gate.py``): the same initial noise (or the
same clip) through the exact and the fast configuration, and the PSNR
between the two outputs, over ``--seeds`` seeds.

    python -m vidtome_torch.tools.quality_gate --gate int8,ldm,serve \
        [--seeds 3 --frames 32 --steps 50 --size 512 --sd 1.5] \
        [--work DIR --out DIR --device cuda]

``GATES`` (generation: one Generator a side, the initial noise from a
seeded ``torch.Generator`` per seed) and ``INV_GATES`` (inversion: both
sides' inverted latents pushed through one exact generation) are the JAX
tool's tables.  With random weights a gate measures how far the lever
moves the output, in the units (dB) of the 35 dB fidelity bar, not
perceptual quality.  ``share_match`` also reports how many merge
assignments two matchings one block apart share.  Each gate prints one
JSON line and writes ``<out>/<gate>.json`` (``--out`` defaults to
``<work>/gates``, never the repo's ``gates/``, which hold the JAX
package's TPU records), its ``backend`` the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them.  Runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(1.0 / mse)


def make_config(frames, steps, size, seed, sd_version="1.5",
                work_dir=None, **gene_overrides):
    from vidtome_torch.config import Config

    work_dir = work_dir or os.path.join(tempfile.gettempdir(), "qgate")
    gene = {
        "control": "none", "guidance_scale": 7.5, "n_timesteps": steps,
        "negative_prompt": "ugly, blurry",
        "prompt": {"edit": "quality gate"},
        "latents_path": work_dir, "output_path": work_dir,
        "chunk_size": 4, "chunk_ord": "mix-4",
        "local_merge_ratio": 0.9, "merge_global": True,
        "global_merge_ratio": 0.8, "global_rand": 0.5,
        "align_batch": False, "save_frame": False,
    }
    if sd_version == "xl":
        # 1024p activations: decode at batch 2, and no refiner (the gate
        # holds the base's serving path)
        gene.setdefault("batch_size", 2)
    gene.update(gene_overrides)
    return Config({
        "sd_version": sd_version, "height": size, "width": size,
        "seed": seed, "work_dir": work_dir, "float_precision": "bf16",
        "generation": gene,
    })


# exact (reference-faithful) setting vs fast setting of each lever
GATES = {
    "share_match": ({"share_match": False}, {"share_match": True}),
    "len_quantum": ({"len_quantum": None}, {"len_quantum": 1024}),
    "ldm": ({}, {"merge_crossattn": True, "merge_ff": True}),
    "int8": ({}, {"quant": "int8"}),
    "deepcache2": ({}, {"cache_interval": 2}),
    "deepcache3": ({}, {"cache_interval": 3}),
    "cfgcache2": ({}, {"cfg_interval": 2}),
    "cfgcache3": ({}, {"cfg_interval": 3}),
    "deepcfg32": ({}, {"cache_interval": 3, "cfg_interval": 2}),
    "serve": ({}, {"quant": "int8", "cache_interval": 2}),
    "serve32": ({}, {"quant": "int8", "cache_interval": 3,
                     "cfg_interval": 2}),
    "deepcfg22": ({}, {"cache_interval": 2, "cfg_interval": 2}),
    "serve22": ({}, {"quant": "int8", "cache_interval": 2,
                     "cfg_interval": 2}),
    "deepcache_w3": ({}, {"cache_schedule": "full:6,uniform:3"}),
    "deepcache_w4": ({}, {"cache_schedule": "full:6,uniform:4"}),
    "serve_w3": ({}, {"quant": "int8",
                      "cache_schedule": "full:6,uniform:3"}),
    "deepcache_w5": ({}, {"cache_schedule": "full:6,uniform:5"}),
    "cfgcache_w2": ({}, {"cfg_schedule": "full:6,uniform:2"}),
    "deepw4_cfgw2": ({}, {"cache_schedule": "full:6,uniform:4",
                          "cfg_schedule": "full:6,uniform:2"}),
    "serve_w42": ({}, {"quant": "int8",
                       "cache_schedule": "full:6,uniform:4",
                       "cfg_schedule": "full:6,uniform:2"}),
    "serve_w63": ({}, {"quant": "int8",
                       "cache_schedule": "full:6,uniform:6",
                       "cfg_schedule": "full:6,uniform:3"}),
    "serve_w82": ({}, {"quant": "int8",
                       "cache_schedule": "full:6,uniform:8",
                       "cfg_schedule": "full:6,uniform:2"}),
    "local95": ({}, {"local_merge_ratio": 0.95}),
    "global9": ({}, {"global_merge_ratio": 0.9}),
    "serve_w42_m95": ({}, {"quant": "int8",
                           "cache_schedule": "full:6,uniform:4",
                           "cfg_schedule": "full:6,uniform:2",
                           "local_merge_ratio": 0.95}),
    "serve_w63_m95": ({}, {"quant": "int8",
                           "cache_schedule": "full:6,uniform:6",
                           "cfg_schedule": "full:6,uniform:3",
                           "local_merge_ratio": 0.95}),
    "serve_w82_m95": ({}, {"quant": "int8",
                           "cache_schedule": "full:6,uniform:8",
                           "cfg_schedule": "full:6,uniform:2",
                           "local_merge_ratio": 0.95}),
    "serve_max": ({}, {"quant": "int8",
                       "cache_schedule": "full:6,uniform:8",
                       "cfg_schedule": "full:6,uniform:2",
                       "local_merge_ratio": 0.95,
                       "global_merge_ratio": 0.9,
                       "resnet_mode": "fused"}),
    "epscache_w2": ({}, {"eps_schedule": "full:6,uniform:2"}),
    "epscache_w2x": ({}, {"eps_schedule": "full:6,uniform:2",
                          "eps_extrapolate": True}),
    "epscache_w3x": ({}, {"eps_schedule": "full:6,uniform:3",
                          "eps_extrapolate": True}),
    "serve_maxe2": ({}, {"quant": "int8",
                         "cache_schedule": "full:6,uniform:8",
                         "cfg_schedule": "full:6,uniform:4",
                         "eps_schedule": "full:6,uniform:2",
                         "local_merge_ratio": 0.95,
                         "global_merge_ratio": 0.9,
                         "resnet_mode": "fused"}),
    "serve_maxe2x": ({}, {"quant": "int8",
                          "cache_schedule": "full:6,uniform:8",
                          "cfg_schedule": "full:6,uniform:4",
                          "eps_schedule": "full:6,uniform:2",
                          "eps_extrapolate": True,
                          "local_merge_ratio": 0.95,
                          "global_merge_ratio": 0.9,
                          "resnet_mode": "fused"}),
    "serve_maxe2d": ({}, {"quant": "int8",
                          "cache_schedule": "full:6,uniform:16",
                          "cfg_schedule": "full:6,uniform:8",
                          "eps_schedule": "full:6,uniform:2",
                          "eps_extrapolate": True,
                          "local_merge_ratio": 0.95,
                          "global_merge_ratio": 0.9,
                          "resnet_mode": "fused"}),
    "serve_maxe36": ({}, {"quant": "int8",
                          "cache_schedule": "full:6,uniform:6",
                          "cfg_schedule": "full:6,uniform:6",
                          "eps_schedule": "full:6,uniform:3",
                          "eps_extrapolate": True,
                          "local_merge_ratio": 0.95,
                          "global_merge_ratio": 0.9,
                          "resnet_mode": "fused"}),
    "serve_maxe48": ({}, {"quant": "int8",
                          "cache_schedule": "full:6,uniform:8",
                          "cfg_schedule": "full:6,uniform:4",
                          "eps_schedule": "full:6,uniform:4",
                          "eps_extrapolate": True,
                          "local_merge_ratio": 0.95,
                          "global_merge_ratio": 0.9,
                          "resnet_mode": "fused"}),
    "serve_maxe3": ({}, {"quant": "int8",
                         "cache_schedule": "full:6,uniform:12",
                         "cfg_schedule": "full:6,uniform:6",
                         "eps_schedule": "full:6,uniform:3",
                         "local_merge_ratio": 0.95,
                         "global_merge_ratio": 0.9,
                         "resnet_mode": "fused"}),
    "serve_maxe3x": ({}, {"quant": "int8",
                          "cache_schedule": "full:6,uniform:12",
                          "cfg_schedule": "full:6,uniform:6",
                          "eps_schedule": "full:6,uniform:3",
                          "eps_extrapolate": True,
                          "local_merge_ratio": 0.95,
                          "global_merge_ratio": 0.9,
                          "resnet_mode": "fused"}),
    "serve_maxe2xb": ({}, {"cache_schedule": "full:6,uniform:8",
                           "cfg_schedule": "full:6,uniform:4",
                           "eps_schedule": "full:6,uniform:2",
                           "eps_extrapolate": True,
                           "local_merge_ratio": 0.95,
                           "global_merge_ratio": 0.9,
                           "resnet_mode": "fused"}),
    "serve_maxe36b": ({}, {"cache_schedule": "full:6,uniform:6",
                           "cfg_schedule": "full:6,uniform:6",
                           "eps_schedule": "full:6,uniform:3",
                           "eps_extrapolate": True,
                           "local_merge_ratio": 0.95,
                           "global_merge_ratio": 0.9,
                           "resnet_mode": "fused"}),
    "serve_maxe3xb": ({}, {"cache_schedule": "full:6,uniform:12",
                           "cfg_schedule": "full:6,uniform:6",
                           "eps_schedule": "full:6,uniform:3",
                           "eps_extrapolate": True,
                           "local_merge_ratio": 0.95,
                           "global_merge_ratio": 0.9,
                           "resnet_mode": "fused"}),
    "serve_maxe3xbf4": ({}, {"cache_schedule": "full:4,uniform:12",
                             "cfg_schedule": "full:4,uniform:6",
                             "eps_schedule": "full:4,uniform:3",
                             "eps_extrapolate": True,
                             "local_merge_ratio": 0.95,
                             "global_merge_ratio": 0.9,
                             "resnet_mode": "fused"}),
    "serve_maxe3xbf3": ({}, {"cache_schedule": "full:3,uniform:12",
                             "cfg_schedule": "full:3,uniform:6",
                             "eps_schedule": "full:3,uniform:3",
                             "eps_extrapolate": True,
                             "local_merge_ratio": 0.95,
                             "global_merge_ratio": 0.9,
                             "resnet_mode": "fused"}),
    "chunk_batch": ({}, {"chunk_batch": True}),
    "serve_maxe3xbB": ({}, {"cache_schedule": "full:6,uniform:12",
                            "cfg_schedule": "full:6,uniform:6",
                            "eps_schedule": "full:6,uniform:3",
                            "eps_extrapolate": True,
                            "local_merge_ratio": 0.95,
                            "global_merge_ratio": 0.9,
                            "resnet_mode": "fused",
                            "chunk_batch": True}),
    "serve_maxe3xbs": ({}, {"cache_schedule": "full:6,uniform:12",
                            "cfg_schedule": "full:6,uniform:6",
                            "eps_schedule": "full:6,uniform:3",
                            "eps_extrapolate": True,
                            "local_merge_ratio": 0.95,
                            "global_merge_ratio": 0.9,
                            "resnet_mode": "fused",
                            "sublayer_mode": "fused"}),
    "serve_maxe3xb2": ({}, {"cache_schedule": "full:6,uniform:12",
                            "cfg_schedule": "full:6,uniform:6",
                            "eps_schedule": "full:6,uniform:3",
                            "eps_extrapolate": 2,
                            "local_merge_ratio": 0.95,
                            "global_merge_ratio": 0.9,
                            "resnet_mode": "fused"}),
    "serve_maxe4xb2": ({}, {"cache_schedule": "full:6,uniform:12",
                            "cfg_schedule": "full:6,uniform:12",
                            "eps_schedule": "full:6,uniform:4",
                            "eps_extrapolate": 2,
                            "local_merge_ratio": 0.95,
                            "global_merge_ratio": 0.9,
                            "resnet_mode": "fused"}),
    "serve_maxe4xb2c6": ({}, {"cache_schedule": "full:6,uniform:12",
                              "cfg_schedule": "full:6,uniform:6",
                              "eps_schedule": "full:6,uniform:4",
                              "eps_extrapolate": 2,
                              "local_merge_ratio": 0.95,
                              "global_merge_ratio": 0.9,
                              "resnet_mode": "fused"}),
    "serve_maxe34xb2": ({}, {"cache_schedule": "full:6,uniform:12",
                             "cfg_schedule": "full:6,uniform:6",
                             "eps_schedule": "full:6,every:3x18,uniform:4",
                             "eps_extrapolate": 2,
                             "local_merge_ratio": 0.95,
                             "global_merge_ratio": 0.9,
                             "resnet_mode": "fused"}),
    "chunk8": ({}, {"chunk_size": 8}),
    "chunk16": ({}, {"chunk_size": 16}),
    "serve_maxe3xbc8": ({}, {"cache_schedule": "full:6,uniform:12",
                             "cfg_schedule": "full:6,uniform:6",
                             "eps_schedule": "full:6,uniform:3",
                             "eps_extrapolate": True,
                             "local_merge_ratio": 0.95,
                             "global_merge_ratio": 0.9,
                             "resnet_mode": "fused",
                             "chunk_size": 8}),
    "serve_maxe3xbc16": ({}, {"cache_schedule": "full:6,uniform:12",
                              "cfg_schedule": "full:6,uniform:6",
                              "eps_schedule": "full:6,uniform:3",
                              "eps_extrapolate": True,
                              "local_merge_ratio": 0.95,
                              "global_merge_ratio": 0.9,
                              "resnet_mode": "fused",
                              "chunk_size": 16}),
    "chunk_ragged": ({"chunk_boundaries": "ragged"}, {}),
    "chunk_ragged_pad": ({"chunk_boundaries": "ragged"}, {}),
}

# inversion gates: exact vs fast inversion of the same clip, judged
# through one exact generation of both (inversion feeds everything
# downstream); schedule specs run in inversion step order
INV_GATES = {
    "inv_int8": ({}, {"quant": "int8"}),
    "inv_cache2": ({}, {"cache_interval": 2}),
    "inv_cache_w4": ({}, {"cache_schedule": "full:6,uniform:4"}),
    "inv_cache_w4_rev": ({}, {"cache_schedule": "full:6,uniform:4",
                              "cache_reverse": True}),
    "inv_cache_w3": ({}, {"cache_schedule": "full:6,uniform:3"}),
    "inv_int8_w3": ({}, {"quant": "int8",
                         "cache_schedule": "full:6,uniform:3"}),
    "inv_int8_w2": ({}, {"quant": "int8",
                         "cache_schedule": "full:6,uniform:2"}),
    "inv_int8_w3f12": ({}, {"quant": "int8",
                            "cache_schedule": "full:12,uniform:3"}),
    "inv_eps_w2": ({}, {"eps_schedule": "full:6,uniform:2"}),
    "inv_eps_w2x": ({}, {"eps_schedule": "full:6,uniform:2",
                         "eps_extrapolate": True}),
    "inv_eps_w2f12": ({}, {"eps_schedule": "full:12,uniform:2",
                           "eps_extrapolate": True}),
    "inv_eps_w2f12n": ({}, {"eps_schedule": "full:12,uniform:2"}),
    "inv_eps_w2f16n": ({}, {"eps_schedule": "full:16,uniform:2"}),
    "inv_eps_w4x": ({}, {"eps_schedule": "full:6,uniform:4",
                         "eps_extrapolate": True}),
    "inv_eps_w3x": ({}, {"eps_schedule": "full:6,uniform:3",
                         "eps_extrapolate": True}),
    "inv_eps_w3x2": ({}, {"eps_schedule": "full:6,uniform:3",
                          "eps_extrapolate": 2}),
    "inv_eps_w4x2": ({}, {"eps_schedule": "full:6,uniform:4",
                          "eps_extrapolate": 2}),
    "inv_cache_w6_eps_w2": ({}, {"cache_schedule": "full:6,uniform:6",
                                 "eps_schedule": "full:6,uniform:2"}),
    "inv_cache_w6_eps_w2x": ({}, {"cache_schedule": "full:6,uniform:6",
                                  "eps_schedule": "full:6,uniform:2",
                                  "eps_extrapolate": True}),
}



def make_inv_config(frames, steps, size, seed, work_dir=None,
                    **inv_overrides):
    from vidtome_torch.config import Config

    inv = {
        "prompt": "a synthetic gradient clip", "steps": steps,
        "save_steps": steps, "batch_size": 8, "force": True,
        "recon": False, "control": "none", "n_frames": frames,
    }
    inv.update(inv_overrides)
    return Config({
        "sd_version": "1.5", "height": size, "width": size, "seed": seed,
        "work_dir": work_dir or os.path.join(tempfile.gettempdir(),
                                             "qgate_inv"),
        "float_precision": "bf16", "inversion": inv,
    })


def make_clip(n_frames, size, seed):
    """A moving-gradient clip [n, size, size, 3] in [0, 1], phase-shifted
    by ``seed`` (the JAX tool's clip)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    frames = []
    for i in range(n_frames):
        phase = i / max(n_frames, 1) + 0.173 * seed
        r = 0.5 + 0.5 * np.sin(2 * np.pi * (xx + phase))
        g = 0.5 + 0.5 * np.cos(2 * np.pi * (yy + phase / 2))
        b = np.full_like(r, 0.3) + 0.2 * (phase % 1.0)
        frames.append(np.clip(np.stack([r, g, b], -1), 0, 1))
    return np.stack(frames)


def _decode(gen, clean, n_frames):
    return gen.vae.decode(clean[:n_frames]).float().cpu().numpy()


def _pad(gen, x):
    return x[torch.as_tensor(gen.pad_src, device=x.device)]


def run_inv_gate(bundle, gate, args, gen_cache):
    """One inversion gate: invert each seed's clip exact and fast, push
    both inverted latents through the same exact generation, PSNR the
    decoded frames.  Each side's Inverter is built once; the seed varies
    the clip."""
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    work = getattr(args, "work", None)
    side_invs = [Inverter(bundle, make_inv_config(
        args.frames, args.steps, args.size, 123, work_dir=work, **over))
        for over in INV_GATES[gate]]
    conds = side_invs[0].text([str(side_invs[0].prompt)] * args.frames)
    if "gen" not in gen_cache:
        gen = Generator(bundle, make_config(args.frames, args.steps,
                                            args.size, 123, work_dir=work))
        gen.configure_frames(args.frames)
        gen_cache["gen"] = gen
        gen_cache["ctx"] = gen.context("quality gate")
    gen, ctx = gen_cache["gen"], gen_cache["ctx"]
    vals = []
    for seed in range(args.seeds):
        latents = side_invs[0].vae.encode(
            make_clip(args.frames, args.size, seed))
        outs = []
        for inv in side_invs:
            lat = inv.ddim_inversion(latents.clone(), conds)
            clean = gen.ddim_sample(_pad(gen, lat.to(bundle.dtype)), ctx)
            outs.append(_decode(gen, clean, args.frames))
        vals.append(psnr(outs[0], outs[1]))
        print(f"[gate:{gate}] seed {seed}: {vals[-1]:.2f} dB",
              file=sys.stderr)
    return vals


def run_gen_gate(bundle, gate, args, exact_cache=None):
    """One generation gate: the same initial noise (``torch.Generator``
    seeded 1000 + seed) through the exact and the fast config, PSNR of the
    decoded frames, over ``args.seeds`` seeds.  Each side's Generator is
    built once (config seed 123: the chunk schedule and merge draws).
    ``exact_cache`` (a dict) keeps the exact side's frames across gates of
    one process that share its config."""
    from vidtome_torch.pipeline.generator import Generator

    exact_over, fast_over = GATES[gate]
    n_frames = args.frames
    if gate == "chunk_ragged_pad" and n_frames % 4 == 0:
        n_frames -= 2  # pad slots
    latent = args.size // 8

    def build(over):
        cfg = make_config(n_frames, args.steps, args.size, 123,
                          sd_version=getattr(args, "sd", "1.5"),
                          work_dir=getattr(args, "work", None), **over)
        gen = Generator(bundle, cfg)
        gen.configure_frames(n_frames)
        return gen

    exact_key = (repr(sorted(exact_over.items(), key=repr)), n_frames)
    fast_gen = build(fast_over)
    exact_gen = None  # built only if a seed misses the cache
    ctx = fast_gen.context("quality gate")
    vals = []
    for seed in range(args.seeds):
        init = torch.randn((n_frames, latent, latent, 4),
                           generator=torch.Generator().manual_seed(
                               1000 + seed)).to(bundle.device, bundle.dtype)
        cache_key = exact_key + (seed,)
        exact_out = None if exact_cache is None else exact_cache.get(cache_key)
        if exact_out is None:
            if exact_gen is None:
                exact_gen = build(exact_over)
            clean = exact_gen.ddim_sample(_pad(exact_gen, init), ctx)
            exact_out = _decode(exact_gen, clean, n_frames)
            if exact_cache is not None:
                exact_cache[cache_key] = exact_out
        clean = fast_gen.ddim_sample(_pad(fast_gen, init), ctx)
        vals.append(psnr(exact_out, _decode(fast_gen, clean, n_frames)))
        print(f"[gate:{gate}] seed {seed}: {vals[-1]:.2f} dB",
              file=sys.stderr)
    return n_frames, vals


def backend(device) -> str:
    """The device a record was measured on: the card's name and power
    limit from nvidia-smi, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return (f"{torch.cuda.get_device_name(device)}, power limit not "
                f"read ({type(e).__name__})")
    return out[device.index or 0].strip()


def write_gate_record(gate, rec, gates_dir, device) -> str:
    """Write ``<gates_dir>/<gate>.json`` with the backend and a timestamp;
    returns its path."""
    os.makedirs(gates_dir, exist_ok=True)
    rec = dict(rec, backend=backend(device),
               timestamp=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
    path = os.path.join(gates_dir, f"{gate}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def share_match_plan_overlap(bundle, frames, size, seed):
    """Fraction of identical (src -> dst) merge assignments between a
    block's local matching and a fresh one on hidden states one block
    later (the same states plus 0.15 of noise)."""
    from vidtome_torch.core import merge as merge_ops

    latent = size // 8
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 4 * latent * latent, 320), generator=gen)
    dx = 0.15 * torch.randn(x.shape, generator=gen)
    draws = [int(torch.randint(0, merge_ops.round_stride(f, 4), (),
                               generator=gen))
             for f in merge_ops.local_merge_rounds(4, 4)]

    def pairs(tokens):
        # mode="mean" keeps the sorted src / dst indices
        _, plans = merge_ops.compute_local_merge(
            tokens.to(bundle.device, torch.bfloat16), 4, 0.9, draws,
            mode="mean")
        p = plans[0]
        src = p.a_idx.gather(1, p.src_idx)[0].tolist()
        dst = p.b_idx.gather(1, p.dst_idx)[0].tolist()
        return set(zip(src, dst))

    sa, sb = pairs(x), pairs(x + dx)
    return len(sa & sb) / max(len(sa), 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", default="all",
                    help="gate name, comma-separated gate names, 'all' "
                         "(generation gates) or 'inv_all' (inversion "
                         "gates); one process runs them in order")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--sd", default="1.5",
                    help="model family (1.5; 'xl' gates the SDXL base, its "
                         "records suffixed _xl)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(),
                                                   "qgate"))
    ap.add_argument("--out", default=None,
                    help="directory of the gate records (<work>/gates)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.work, "gates")

    from vidtome_torch.models.registry import init_model

    if args.gate == "all":
        gates = list(GATES)
    elif args.gate == "inv_all":
        gates = list(INV_GATES)
    else:
        gates = [g.strip() for g in args.gate.split(",") if g.strip()]
        unknown = [g for g in gates if g not in GATES and g not in INV_GATES]
        if unknown:
            ap.error(f"unknown gate(s): {unknown}")
    suffix = "" if args.sd == "1.5" else f"_{args.sd}"
    if suffix and any(g in INV_GATES for g in gates):
        ap.error(f"inversion gates are 1.5-only (got --sd {args.sd})")
    bundle = init_model(sd_version=args.sd, weight_dtype="bf16",
                        device=args.device)

    inv_gen_cache: dict = {}
    exact_cache: dict = {}
    records = []
    for gate in gates:
        t0 = time.time()
        if gate in INV_GATES:
            vals = run_inv_gate(bundle, gate, args, inv_gen_cache)
            rec = {
                "gate": gate,
                "psnr_exact_vs_fast_db": [round(v, 2) for v in vals],
                "psnr_mean_db": round(float(np.mean(vals)), 2),
                "seeds": args.seeds, "frames": args.frames,
                "steps": args.steps, "size": args.size,
                "harness": "joint: exact-vs-fast inversion -> exact "
                           "generation",
                "protocol": "per-seed clip; fixed inverter config (seed "
                            "123)",
                "weights": "random (no checkpoint)",
            }
        else:
            n_frames, vals = run_gen_gate(bundle, gate, args, exact_cache)
            rec = {
                "gate": gate + suffix,
                "psnr_exact_vs_fast_db": [round(v, 2) for v in vals],
                "psnr_mean_db": round(float(np.mean(vals)), 2),
                "seeds": args.seeds, "frames": n_frames,
                "steps": args.steps, "size": args.size,
                "sd_version": args.sd,
                "protocol": "per-seed init noise; fixed merge/chunk seed "
                            "(123)",
                "weights": "random (no checkpoint)",
            }
            if gate == "share_match":
                rec["plan_overlap"] = round(float(np.mean([
                    share_match_plan_overlap(bundle, args.frames, args.size,
                                             s)
                    for s in range(args.seeds)])), 4)
        rec["elapsed_s"] = round(time.time() - t0, 1)
        print(json.dumps(rec))
        write_gate_record(rec["gate"], rec, out, args.device)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
