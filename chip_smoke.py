"""Smoke run of the PyTorch/CUDA port (vidtome_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. device: the card's name and power limit;
  2. build: compile the CUDA libraries (flash attention, single-pass
     small-KV attention, the bf16 fused resnet, the W8A8 fused resnet,
     best match, fused cross-attention sublayer, GroupNorm: one nvcc each,
     all started together, sm_90a) from this checkout's sources;
  3. kernel vs plain: each of the eight kernels in bf16 against its plain
     PyTorch version (fp32 on the same bf16 inputs; the W8A8 resnet's in
     bf16, at the kernel's rounding points) at the main paths' shapes, with
     both times (CUDA events), the time of the one PyTorch call that
     computes the same function where there is one, and the card's bound
     (for attention also the exp floor: one exp2 a score, the device-only
     times of the kernel and of SDPA from a replayed CUDA graph, and for
     small-KV the sums per UNet call of each path, SMALL_KV_LAUNCHES; for
     both resnet variants the block's device-only time and each conv's
     tile and N (ops/resnet.conv_plan, conv_plan_w8a8); for the bf16 one,
     as its library call, cuDNN's two convolutions of the row, timed only:
     the convolutions alone, not the block; the W8A8 row also shows the
     bf16 block's time at the same row);
     flash is held to FLASH_TOL of max |ref| besides ATTN_TOL, small-KV to
     SMALL_KV_REL_TOL besides SMALL_KV_TOL; GroupNorm at every GN_SHAPES
     row (every UNet shape, the CFG-skip batch, the VAE's, resident and
     streaming), each entry against its plain version: full, stats (to
     GN_STATS_TOL), apply from those statistics, and finalize at the fused
     resnets' partials, each through the call and device-only, beside
     F.group_norm and the bound, and summed per exact UNet call; best
     match at every MATCH_SHAPES row (the local rounds and global merges
     of levels 0 and 1), through the call and device-only, with the
     planner's launch (ops/matching.match_plan) and, as a yardstick (two
     calls, not the same function), torch.bmm + amax/argmax device-only;
     then the device-only time of one core/merge._build_plan at the L0
     local round and of its pieces (normalize, the gathers with the bf16
     cast, the kernel, the lanes' best and the sort, the scatters); the
     fused sublayer at every SUBLAYER_SHAPES row through the call and
     device-only, with its plan (ops/sublayer.plan) and, as a yardstick,
     the port's unfused bf16 chain for the same work device-only;
  4. exact path: SD1.5 at full width with random weights (seeded), bf16,
     512x512, 8 frames made with numpy: CLIP + VAE encode, DDIM inversion,
     chunked CFG generation with local and global token merging (2 chunks:
     the bank is initialised on one and merged against on the other), VAE
     decode -- through the port's Inverter and Generator; the launch
     counters of the kernels it runs must rise during it, GroupNorm's full
     entry 61 times and best match 3 times a generation UNet call;
  5. reference check: one UNet call (unfused and fused resnet blocks) and
     one VAE decode of the same SD1.5 weights at a small input, on the card
     (bf16, kernels) and on the CPU (fp32, plain versions);
  6. serving path: the same clip through configs/serve.yaml's inversion and
     generation keys (deep / CFG / eps step caches, eps extrapolation,
     local 0.95 / global 0.9 merging, fused resnet blocks) at 50+50 DDIM
     steps; the UNet calls per kind must match the mode tables, all four
     kernels' launch counters must rise, the frames must be finite in
     [0, 1]; prints the stage seconds and the PSNR of the serving frames
     against the exact path's frames from the same inverted latents (with
     random weights the PSNR bounds nothing: printed only);
  7. int8 serving path (W8A8): the same clip with default.yaml's inversion
     keys plus bench.py's "int8_fused" profile (quant: int8, fused resnet
     blocks: 50 full UNet calls of batch 8) and configs/serve.yaml's
     generation keys with bench.py's "maxe3x" profile (quant: int8), at
     50+50 steps, under VIDTOME_GN_MODE=full (set for the phase only): the
     UNet calls per kind must match the mode tables, the W8A8 resnet kernel
     must launch once per resnet block each UNet call runs, the
     full GroupNorm entry must launch, and the stats and finalize entries
     twice per W8A8 block (GN1's and GN2's statistics);
  8. int8 reference check: one int8 UNet call (fused resnet blocks) at a
     32x32 latent under VIDTOME_GN_MODE=full, on the card (bf16 kernels)
     and on the CPU (fp32 plain versions), with the same int8 table;
  9. ControlNet path: the SD1.5 bundle's canny ControlNet (random, seeded,
     built by init_model(control="canny"); its zero convs and the hint
     encoder's conv_out moved by 0.05 N(0, 1), else it adds nothing), the
     same clip through configs/demo-canny.yaml's keys over demo.yaml's and
     default.yaml's at 50+50 DDIM steps with inversion.control: canny, so
     both stages run it before every UNet call; the control images through
     the png cache in a temporary work_dir.  Every ControlNet call must
     launch flash 4 times, small-KV 10 and the full GroupNorm entry 27
     (CONTROLNET_LAUNCHES, read per call from its forward hooks), beside
     the UNet's own; frames finite in [0, 1]; prints the stage seconds and
     the PSNR against the exact path's frames (printed only);
  10. ControlNet reference check: one ControlNet call and the UNet call fed
     its residuals, card (bf16 kernels) vs CPU (fp32 plain), at an 8x8
     latent (REF_TOL) and with both int8 tables at a 32x32 latent
     (INT8_REF_TOL); control_scale 0 must differ by more than the
     tolerance;
  11. PnP path: the SD1.5 bundle freed, SD2.1 at full width with random
     weights (seeded), bf16, the same clip through configs/dog.yaml's
     inversion and generation keys (prompts aside; default.yaml beneath
     them, as dog.yaml's base_config) at 50+50 DDIM steps, with
     save_intermediate and generation.sublayer_mode: fused: the source lane
     reads the inversion latents of every step, attention / conv injection
     on the first 25 / 40 steps.  The small-KV kernel must launch exactly
     once per inversion UNet call and transformer block routed to it, the
     sublayer kernel 16 times per generation UNet call (SD2.1's transformer
     blocks); flash, GroupNorm and best match must rise; then one
     generation UNet call (no merging) with sublayer_mode fused and off,
     its device time (torch.profiler) and its time through the call;
  12. SD2.1 reference check: one UNet call at an 8x8 latent with 3 lanes,
     both injections on and sublayer_mode="fused", card (bf16 kernels) vs
     CPU (fp32 plain); the same call with the injections off must differ
     from it by more than the tolerance;
  13. control models: random HED, lineart and pose nets (seeded, in their
     checkpoint layouts; the pose net's last layers set so that its peaks
     connect into a bounded number of people, write_control_nets) saved
     with torch.save and named by VIDTOME_HED_MODEL / VIDTOME_LINEART_MODEL
     / VIDTOME_POSE_MODEL; control_preprocess for softedge, lineart_anime
     and openpose on the 8 frames at 512x512 on the card (fp32, TF32 off)
     against the CPU: HED_SHARE_TOL of the safe_step pixels, lineart to
     LINEART_CARD_TOL, the pose detector's same peaks and people (scores
     to POSE_SCORE_RTOL) and drawn images; prints each net's ms a frame;
  14. LoRA path: a fresh SD1.5 bundle with a softedge ControlNet (random,
     zero convs moved), a synthetic kohya LoRA (rank LORA_RANK, alpha
     LORA_ALPHA, on every attention projection, resnet conv and
     time_emb_proj and the text encoder's q/k/v/out, seeded) written with
     the port's safetensors writer; configs/breakdance.yaml's keys at
     50+50 DDIM steps (the softedge images through the HED net of phase
     13): the generation without the LoRA, then a Generator with use_lora
     merges it (the merged weights must be W + delta within two bf16
     roundings) and generates from the same latents (the frames must
     differ); each UNet and ControlNet call of the LoRA generation, read
     from forward hooks, must launch what the plain generation's call at
     the same index did and what the topology says (flash 10, small-KV 22,
     full GroupNorm 61 a UNet call; flash 4, small-KV 10, full GroupNorm 27
     a ControlNet call); then, the weights restored,
     a LoRA generator in int8 must quantize the merged weights (LORA_PROBE);
  15. SD2-depth path: the SD2.1 bundle freed, SD2-depth at full width with
     random weights (seeded), configs/flamingo.yaml's keys at 50+50 DDIM
     steps, the proxy depth through the depth cache of a temporary
     work_dir concatenated as the fifth channel in both stages: every UNet
     call must launch flash, small-KV and the full GroupNorm entry as its
     topology says, best match 2 or 4 times a generation call;
  16. SD2-depth reference check: one UNet call at an 8x8 latent, card
     (bf16 kernels) vs CPU (fp32 plain); the depth channel zeroed must
     differ by more than the tolerance.
``python3 chip_smoke.py --cli-inputs DIR`` instead writes the inputs of the
CLI runs of configs/flamingo.yaml and configs/breakdance.yaml on
data/demo.mp4 (write_cli_inputs) and exits.
Then one JSON line with the kernels' numbers (launches: summed over the
exact, serving, int8, ControlNet, PnP, LoRA and SD2-depth paths, each
counted from 0; ms,
plain_ms,
library_ms and bound_ms summed over each kernel's phase-3 shapes, for
group_norm (the stats, apply and finalize entries) stats + apply a
GN_SHAPES row plus the finalize rows, for full_group_norm the full entry;
for the
two attention kernels also device_ms and library_device_ms, the kernel's
and SDPA's time in a replayed CUDA graph, without the host's, and for the
two resnet variants, both GroupNorm rows, best match and the sublayer
device_ms), and
last:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import concurrent.futures
import copy
import functools
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
STEPS = 5
SERVE_STEPS = 50
N_FRAMES = 8
SIZE = 512
ATTN_TOL = 2e-2   # absolute: bf16 probabilities and output, |out| <~ 1
# flash also to this share of max |ref|: over 1536-6144 keys its outputs
# are about 0.02 (sqrt(e / Skv) for unit-normal q, k, v), so ATTN_TOL alone
# would let a dropped K tile through.  Sound readings are at most 3.3e-3,
# a planted fault (a skipped K tile, a lost half-depth score) 0.43 or more
# (flash_ab.py, PERF.md)
FLASH_TOL = 1e-2
GN_TOL = 3e-2     # relative to max(1, |y|): one bf16 ulp at |y| < 4 is 2^-6
# GroupNorm statistics (mean, rstd), relative to max(1, |ref|): fp32 sums in
# another order
GN_STATS_TOL = 1e-4
RESNET_TOL = 2e-2  # relative to max |ref|: bf16 activations and h (2^-9 each)
MATCH_TOL = 1e-4  # absolute on max scores: fp32 sums in another order
MATCH_GAP = 1e-3  # argmax compared where the plain top-2 gap exceeds this
REF_TOL = 5e-2    # relative to max |ref|: bf16 path vs fp32 path, many layers
SMALL_KV_TOL = 2e-2  # absolute, as ATTN_TOL: bf16 probabilities and output
# small-KV also to this share of max |ref|: sound readings 3.0e-3 to 4.6e-3,
# the kv_len mask left out 1.35e-2 to 1.8e-2 at the 77-key rows, a dropped
# 16-key slab of S or 16 columns of P V 0.5 or more (flash_ab.py, PERF.md)
SMALL_KV_REL_TOL = 1e-2
SUBLAYER_TOL = 5e-2  # absolute on x3, y3: x3 up to |6| rounds by 2^-6, and
#                      y2, q, p, a are rounded in the kernel, not the plain
PNP_STEPS = 50
INT8_STEPS = 50
CONTROLNET_STEPS = 50
DEPTH_STEPS = 50
LORA_STEPS = 50
LORA_RANK, LORA_ALPHA = 8, 4.0
# the merged module whose int8 weight is held against W and W + delta
LORA_PROBE = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_k"
# the control nets on the card (fp32, TF32 off) vs the CPU (fp32): cuDNN
# sums in another order, so a value may cross a threshold.  HED: the share
# of its safe_step pixels (three levels) that may differ; lineart: its maps
# in [0, 1], through fourteen instance norms, absolute; the pose scores
# (peaks, limbs, people), relative, with the peaks and people themselves
# required to be the same
HED_SHARE_TOL = 1e-3
LINEART_CARD_TOL = 1e-3
POSE_SCORE_RTOL = 1e-3
# launches of one SD1.5 ControlNet call (batch 8, unmerged; its 7
# transformer blocks and 10 resnet blocks): flash for the self-attentions at
# 64x64 and 32x32, small-KV for the 7 cross-attentions and the
# self-attentions at 16x16 and 8x8, the full GroupNorm entry for the 20
# resnet and 7 transformer norms; its resnets are never fused
CONTROLNET_LAUNCHES = {"flash_attention": 4, "small_kv_attention": 10,
                       "full_group_norm": 27}
# the int8 UNet call on the card (bf16 activations quantized to int8) vs
# the CPU (fp32 activations quantized to int8): bf16 rounding (2^-9) moves
# activations near 127 steps by up to a quarter step, so a share of them
# crosses a rounding boundary (a whole int8 step each) in every quantized
# layer, on top of REF_TOL's bf16 noise.  That difference is as large as
# the int8 table's own effect (printed beside it), so this check bounds the
# error; that the int8 kernels ran, and agree with their plain versions,
# the launch counters and phase 3 show
INT8_REF_TOL = 1e-1
# the card's peaks (H100 SXM data sheet: HBM3, dense bf16 / int8 tensor-core
# and fp32 rates)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# exp2 on the special-function units (H100 SXM, as the FlashAttention-3
# paper gives it): one a score sets attention's floor beside the bound,
# which counts only the tensor-core operations
EXP2_S = 3.9e12

# demo.yaml on top of default.yaml (generation / inversion keys of the
# exact path), with STEPS DDIM steps instead of 50
CONFIG = {
    "seed": 123, "float_precision": "bf16",
    "inversion": {"prompt": "a sun over rolling green hills with a red "
                            "bouncing ball.", "steps": STEPS,
                  "save_steps": STEPS, "batch_size": 8},
    "generation": {
        "control": "none", "guidance_scale": 7.5, "n_timesteps": STEPS,
        "negative_prompt": "ugly, blurry, low res",
        "prompt": {"watercolor": "watercolor painting of a sun over green "
                                 "hills, red ball."},
        "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
        "merge_global": True, "global_merge_ratio": 0.8, "global_rand": 0.5,
        "align_batch": True, "target_stride": 4, "max_downsample": 2,
        "share_match": True, "len_quantum": 1024, "batch_size": 8},
}


def serve_config() -> dict:
    """CONFIG with configs/serve.yaml's inversion and generation keys as
    written there (prompts aside), at SERVE_STEPS DDIM steps."""
    import yaml

    with open(ROOT / "configs" / "serve.yaml") as f:
        serve = yaml.safe_load(f)
    cfg = copy.deepcopy(CONFIG)
    for stage in ("inversion", "generation"):
        cfg[stage].update({k: v for k, v in serve[stage].items()
                           if k != "prompt"})
    cfg["inversion"].update(steps=SERVE_STEPS, save_steps=SERVE_STEPS)
    cfg["generation"]["n_timesteps"] = SERVE_STEPS
    return cfg


def exact_config(steps: int) -> dict:
    cfg = copy.deepcopy(CONFIG)
    cfg["inversion"].update(steps=steps, save_steps=steps)
    cfg["generation"]["n_timesteps"] = steps
    return cfg


def pnp_config() -> dict:
    """configs/dog.yaml's inversion and generation keys over default.yaml's
    (dog.yaml's base_config), its first edit prompt only, at PNP_STEPS DDIM
    steps, with generation.sublayer_mode: fused."""
    import yaml

    def load(name):
        with open(ROOT / "configs" / name) as f:
            return yaml.safe_load(f)

    default, dog = load("default.yaml"), load("dog.yaml")
    cfg = {"seed": dog["seed"], "float_precision": "bf16",
           "sd_version": dog["sd_version"]}
    for stage in ("inversion", "generation"):
        cfg[stage] = {**default[stage], **dog[stage]}
    name, prompt = next(iter(dog["generation"]["prompt"].items()))
    cfg["generation"].update(prompt={name: prompt}, sublayer_mode="fused",
                             n_timesteps=PNP_STEPS)
    cfg["inversion"].update(steps=PNP_STEPS, save_steps=PNP_STEPS)
    return cfg


def controlnet_config() -> dict:
    """configs/demo-canny.yaml's inversion and generation keys over
    demo.yaml's over default.yaml's (its base_config chain), its edit
    prompt, at CONTROLNET_STEPS DDIM steps, with inversion.control: canny
    so that both stages run the ControlNet."""
    import yaml

    def load(name):
        with open(ROOT / "configs" / name) as f:
            return yaml.safe_load(f)

    chain = [load(n) for n in ("default.yaml", "demo.yaml",
                               "demo-canny.yaml")]
    cfg = {"seed": chain[0]["seed"], "float_precision": "bf16"}
    for stage in ("inversion", "generation"):
        cfg[stage] = {k: v for layer in chain
                      for k, v in layer[stage].items()}
    cfg["inversion"].update(control="canny", steps=CONTROLNET_STEPS,
                            save_steps=CONTROLNET_STEPS)
    cfg["generation"]["n_timesteps"] = CONTROLNET_STEPS
    return cfg


def int8_config() -> dict:
    """The int8 serving slice at INT8_STEPS DDIM steps: default.yaml's
    inversion keys (prompt and save path aside) with bench.py's
    INV_SERVE_PROFILES["int8_fused"] (quant: int8, resnet_mode: fused), and
    configs/serve.yaml's generation keys with bench.py's
    SERVE_PROFILES["maxe3x"] (serve.yaml's schedules, merge ratios and fused
    resnet blocks, plus quant: int8)."""
    import yaml

    with open(ROOT / "configs" / "default.yaml") as f:
        default = yaml.safe_load(f)
    cfg = serve_config()
    cfg["inversion"] = {
        **CONFIG["inversion"],
        **{k: v for k, v in default["inversion"].items()
           if k not in ("prompt", "save_path")},
        "quant": "int8", "resnet_mode": "fused", "steps": INT8_STEPS,
        "save_steps": INT8_STEPS}
    cfg["generation"].update(quant="int8", n_timesteps=INT8_STEPS)
    return cfg


KERNELS = ("flash_attention", "small_kv_attention", "group_norm",
           "full_group_norm", "fused_resnet", "fused_resnet_w8a8",
           "best_match", "fused_cross_sublayer")


def counters() -> dict:
    """The launch counter of each kernel wrapper."""
    from vidtome_torch.ops import (attention, groupnorm, matching, resnet,
                                   sublayer)

    return {"flash_attention": attention.flash_attention,
            "small_kv_attention": attention.small_kv_attention,
            "group_norm": groupnorm.group_norm,
            "full_group_norm": groupnorm.full_group_norm,
            "fused_resnet": resnet.fused_resnet,
            "fused_resnet_w8a8": resnet.fused_resnet_w8a8,
            "best_match": matching.best_match,
            "fused_cross_sublayer": sublayer.fused_cross_sublayer}


def reset_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


FLASH_SHAPES = [  # (B, H, Sq, Skv, D)
    (2, 8, 5120, 5120, 40),   # L0 merged self-attention (local merge)
    (2, 8, 6144, 6144, 40),   # L0 merged self-attention (+ global merge)
    (8, 8, 4096, 4096, 40),   # L0 per-frame self-attention (inversion)
    (8, 8, 1024, 1024, 80),   # L1 per frame (inversion, the ControlNet)
    (2, 8, 1536, 1536, 80),   # L1 merged self-attention
    (8, 8, 256, 256, 160),    # L2 per frame
    (8, 8, 4096, 77, 40),     # L0 cross-attention against the prompt
    (8, 1, 4096, 4096, 512),  # VAE mid-block attention
    (3, 5, 5120, 5120, 64),   # SD2.1 PnP: L0 merged, 3 lanes
    (3, 5, 6144, 6144, 64),   # SD2.1 PnP: L0 merged (+ global merge)
    (3, 10, 1536, 1536, 64),  # SD2.1 PnP: L1 merged (+ global merge)
    (8, 5, 4096, 4096, 64),   # SD2.1 inversion: L0 per frame
    (2, 5, 5120, 5120, 64),   # SD2-depth (flamingo.yaml): L0 local merge
    (2, 5, 5632, 5632, 64),   # SD2-depth: L0 after global merge at 0.9
    (2, 10, 1408, 1408, 64),  # SD2-depth: L1 after global merge at 0.9
    (2, 8, 7168, 7168, 40),   # SD1.5 + LoRA (breakdance.yaml): L0, global 0.6
]
SMALL_KV_SHAPES = [  # (B, H, Sq, Skv, D)
    (8, 5, 4096, 77, 64),     # SD2.1 inversion: L0 cross-attention
    (12, 5, 4096, 77, 64),    # SD2.1 PnP generation: L0 cross-attention
    (12, 20, 256, 256, 64),   # SD2.1 PnP generation: 16x16 self-attention
    (12, 20, 64, 77, 64),     # SD2.1 mid block cross-attention
    (8, 8, 4096, 77, 40),     # SD1.5 L0 cross-attention (flash above)
    (8, 8, 1024, 77, 80),     # SD1.5 L1 cross-attention
    (8, 8, 256, 77, 160),     # SD1.5 L2 cross-attention
    (8, 8, 256, 256, 160),    # SD1.5 16x16 self-attention: widest tile
    (8, 8, 64, 77, 160),      # SD1.5 mid block cross-attention
    (8, 8, 64, 64, 160),      # SD1.5 mid block self-attention
    (8, 20, 256, 256, 64),    # SD2-depth inversion: 16x16 self-attention
]
# launches of each SMALL_KV_SHAPES row per UNet call: SD1.5 (batch 8: every
# SD1.5 path; the 22 are all of its small-KV launches), an SD1.5 ControlNet
# call (its 7 cross-attentions and 3 self-attentions), SD2.1 inversion
# (batch 8), SD2.1 PnP generation (batch 12, sublayer_mode off, the
# default; under "fused" the sublayer kernel takes the cross-attentions)
# and SD2-depth (batch 8: inversion, and generation's 2 lanes x 4 frames).
# Each of the 16 transformer blocks runs one cross-attention: 5 at each of
# the 64x64, 32x32 and 16x16 levels, 1 in the mid block; the self-attention
# takes the kernel at 16x16 (5) and 8x8 (1).  The SD2.x columns cover the
# rows listed only (5, 11 and 10 of their 22)
SMALL_KV_LAUNCHES = {
    (8, 5, 4096, 77, 64): {"SD2.1 inversion": 5, "SD2-depth": 5},
    (8, 20, 256, 256, 64): {"SD2-depth": 5},
    (12, 5, 4096, 77, 64): {"SD2.1 PnP": 5},
    (12, 20, 256, 256, 64): {"SD2.1 PnP": 5},
    (12, 20, 64, 77, 64): {"SD2.1 PnP": 1},
    (8, 8, 4096, 77, 40): {"SD1.5": 5, "SD1.5 ControlNet": 2},
    (8, 8, 1024, 77, 80): {"SD1.5": 5, "SD1.5 ControlNet": 2},
    (8, 8, 256, 77, 160): {"SD1.5": 5, "SD1.5 ControlNet": 2},
    (8, 8, 256, 256, 160): {"SD1.5": 5, "SD1.5 ControlNet": 2},
    (8, 8, 64, 77, 160): {"SD1.5": 1, "SD1.5 ControlNet": 1},
    (8, 8, 64, 64, 160): {"SD1.5": 1, "SD1.5 ControlNet": 1},
}
SUBLAYER_SHAPES = [  # (B, S, C, heads): SD2.1 PnP generation, 77 keys
    (12, 4096, 320, 5),
    (12, 1024, 640, 10),
    (12, 256, 1280, 20),
    (12, 64, 1280, 20),
]
GN_SHAPES = [  # (B, rows, C, silu, eps, norms per exact UNet call)
    # SD1.5's UNet at a 64x64 latent, batch 8: all 61 GroupNorms of a call
    (8, 64 * 64, 320, True, 1e-5, 8),     # L0 resnets, conv_norm_out
    (8, 64 * 64, 320, False, 1e-6, 5),    # L0 Transformer2D input norms
    (8, 64 * 64, 640, True, 1e-5, 2),     # last up block, skip concat
    (8, 64 * 64, 960, True, 1e-5, 1),
    (8, 32 * 32, 320, True, 1e-5, 1),
    (8, 32 * 32, 640, True, 1e-5, 6),
    (8, 32 * 32, 640, False, 1e-6, 5),
    (8, 32 * 32, 960, True, 1e-5, 1),
    (8, 32 * 32, 1280, True, 1e-5, 1),
    (8, 32 * 32, 1920, True, 1e-5, 1),
    (8, 16 * 16, 640, True, 1e-5, 1),
    (8, 16 * 16, 1280, True, 1e-5, 6),
    (8, 16 * 16, 1280, False, 1e-6, 5),
    (8, 16 * 16, 1920, True, 1e-5, 1),
    (8, 16 * 16, 2560, True, 1e-5, 2),
    (8, 8 * 8, 1280, True, 1e-5, 11),
    (8, 8 * 8, 1280, False, 1e-6, 1),
    (8, 8 * 8, 2560, True, 1e-5, 3),      # up block 0, skip-concat width
    (4, 64 * 64, 960, True, 1e-5, 0),     # the CFG-skip batch
    # the VAE encoder and decoder at 512x512 (the last five stream)
    (8, 64 * 64, 512, True, 1e-5, 0),
    (8, 128 * 128, 256, True, 1e-5, 0),
    (8, 128 * 128, 512, True, 1e-5, 0),
    (8, 256 * 256, 128, True, 1e-5, 0),
    (8, 256 * 256, 256, True, 1e-5, 0),
    (8, 256 * 256, 512, True, 1e-5, 0),
    (8, 512 * 512, 128, True, 1e-5, 0),
    (8, 512 * 512, 256, True, 1e-5, 0),
]
# the four GroupNorm rows phase 3 timed before every UNet and VAE shape
# was listed: their sums are printed beside the earlier times in PERF.md
GN_EARLIER_ROWS = [(8, 512 * 512, 128, True, 1e-5), (8, 64 * 64, 320, True, 1e-5),
                   (8, 8 * 8, 2560, True, 1e-5), (8, 64 * 64, 320, False, 1e-6)]
RESNET_SHAPES = [  # (B, H, W, Cin, Cout): both fused resnet variants
    (8, 64, 64, 320, 320),     # L0, identity shortcut
    (8, 32, 32, 640, 640),     # L1, identity shortcut
    (8, 64, 64, 640, 320),     # last up block, projection shortcut
    (8, 16, 16, 2560, 1280),   # up block 1, skip-concat width
    (4, 64, 64, 960, 320),     # 15 channel chunks, cfg-skip batch
    (8, 8, 8, 1280, 1280),     # 8x8 level (mid, down 3, up 0): 4 a full call
]
MATCH_SHAPES = [  # (B, S, D, C); a level: its global merge vs the bank
    (2, 12288, 4096, 320),     # L0 local round
    (2, 3072, 1024, 640),      # L1 local round
    0,                         # L0 global merge, from the serving config
    1,                         # L1 global merge
]


def cuda_time(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` launches, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed, after warm-up: the card's time without the host's
    (Python, a wrapper's checks, the launch calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def timed(times: dict, name: str, fn):
    """``fn()``, its wall seconds up to the card's last launch in
    ``times[name]``."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[name] = time.perf_counter() - t0
    return out


def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {name} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name, smi


def phase_build(dev) -> None:
    from vidtome_torch.ops import (attention, groupnorm, matching, resnet,
                                   sublayer)
    from vidtome_torch.ops.cuda_build import build_library

    t0 = time.perf_counter()
    libs = {"vidtome_flash": "flash_attention.cu",
            "vidtome_small_kv": "small_kv_attention.cu",
            "vidtome_resnet_bf16": "resnet_bf16.cu",
            "vidtome_resnet_w8a8": "resnet_w8a8.cu",
            "vidtome_matching": "matching.cu",
            "vidtome_sublayer": "sublayer.cu",
            "vidtome_group_norm": "group_norm.cu"}
    logs = {name: [] for name in libs}
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(build_library, name, (src,), log=logs[name])
                    for name, src in libs.items()]:
            fut.result()
    attention._library(), attention._small_kv_library()
    resnet._library(), matching._library(), sublayer._library()
    groupnorm._library()
    t1 = time.perf_counter()
    for name, log in logs.items():
        for _name, secs, report in log:
            regs = [ln.split("Used")[1].split(",")[0].strip()
                    for ln in report.splitlines() if "Used" in ln]
            spills = [ln.strip() for ln in report.splitlines()
                      if "spill" in ln]
            print(f"[build] {name}: nvcc {secs:.1f} s; {len(spills)} "
                  f"kernels, registers {regs}, max spill line: "
                  f"{max(spills) if spills else 'n/a'}")
    print(f"[build] CUDA libraries ready in {t1 - t0:.1f} s (parallel nvcc)")


def match_shape(row) -> tuple:
    """A MATCH_SHAPES row; a level's global merge of the serving profile
    is the locally merged chunk against a bank of the same length, both
    lanes (align_batch): [2, 4711] at L0, [2, 1178] at L1."""
    from vidtome_torch.models.tome import ToMeConfig

    if isinstance(row, tuple):
        return row
    gene = serve_config()["generation"]
    n = ToMeConfig(frames=4, local_merge_ratio=gene["local_merge_ratio"],
                   len_quantum=gene["len_quantum"]).merged_local_len(
                       64 * 64 >> 2 * row)
    return (2, n, n, 320 << row)


def bound_ms(nbytes: float, **ops: float) -> tuple[float, float]:
    """(ms to move ``nbytes`` through HBM, ms to do ``ops`` operations of
    each type at its peak): the card's least time is the larger."""
    return (nbytes / HBM_BYTES_S * 1e3,
            sum(n / PEAK_OPS_S[kind] for kind, n in ops.items()) * 1e3)


class KernelStats:
    """Per kernel, over its phase-3 shapes: the largest error, and the
    summed kernel, plain-version, library-call and bound times (attention:
    also the kernel's and the library call's device-only times)."""

    def __init__(self):
        self.rows = {k: dict(err=0.0, ms=0.0, plain=0.0, library=None,
                             bytes_ms=0.0, ops_ms=0.0, bound=0.0,
                             device=None, library_device=None)
                     for k in KERNELS}

    def add(self, name, err, ms, plain, library, bound, device=None,
            library_device=None):
        r = self.rows[name]
        r["err"] = max(r["err"], err)
        r["ms"] += ms
        r["plain"] += plain
        for key, value in (("library", library), ("device", device),
                           ("library_device", library_device)):
            if value is not None:
                r[key] = (r[key] or 0.0) + value
        r["bytes_ms"] += bound[0]
        r["ops_ms"] += bound[1]
        r["bound"] += max(bound)


def phase_group_norm(dev, rng, stats: KernelStats) -> None:
    """Phase 3 for the GroupNorm entries of csrc/group_norm.cu."""
    from torch.nn import functional as F

    from vidtome_torch.ops import groupnorm, resnet

    def rel(got, want):  # relative to max(1, |want|)
        return ((got.float() - want).abs()
                / want.abs().clamp_min(1.0)).max().item()

    sms = groupnorm._sm_count(0)
    per_call = [0, 0.0, 0.0, 0.0, 0.0]  # launches x (full, pair, bound, lib)
    earlier = [0.0, 0.0]  # full, stats + apply over GN_EARLIER_ROWS
    for B, rows, C, silu, eps, n_call in GN_SHAPES:
        a = (rng.standard_normal((B, rows, C), np.float32) * 2.0 + 0.5)
        x = torch.from_numpy(a).to(dev, torch.bfloat16)
        del a
        w = torch.from_numpy(rng.standard_normal(C, np.float32) + 1).to(dev)
        b = torch.from_numpy(rng.standard_normal(C, np.float32)).to(dev)
        xf = x.float()
        want_mean, want_rstd = groupnorm.reference_group_stats(xf, 32, eps)
        want = groupnorm.reference_apply(xf, want_mean, want_rstd, w, b, 32,
                                         silu)
        got = groupnorm.full_group_norm(x, w, b, 32, eps, silu)
        err_full, abs_full = rel(got, want), (got.float() - want).abs().max(
        ).item()
        mean, rstd = groupnorm.group_stats(x, 32, eps)
        err_stats = max(rel(mean, want_mean), rel(rstd, want_rstd))
        got = groupnorm.apply_group_norm(x, mean, rstd, w, b, 32, silu)
        del want
        want = groupnorm.reference_apply(xf, mean, rstd, w, b, 32, silu)
        err_apply, abs_apply = rel(got, want), (got.float() - want).abs(
        ).max().item()
        del want, got

        def full():
            return groupnorm.full_group_norm(x, w, b, 32, eps, silu)

        def pair():
            return groupnorm.apply_group_norm(
                x, *groupnorm.group_stats(x, 32, eps), w, b, 32, silu)

        ms_full, dev_full = cuda_time(full, 10), graph_time(full, 10)
        ms_pair, dev_pair = cuda_time(pair, 10), graph_time(pair, 10)
        plain = cuda_time(lambda: groupnorm.reference_group_norm(
            xf, w, b, 32, eps, silu), 3)
        # one library call: F.group_norm on the NCHW (channels-last) view,
        # without the SiLU
        side = int(round(rows ** 0.5))
        x4 = x.view(B, side, side, C).permute(0, 3, 1, 2)
        wb, bb = w.bfloat16(), b.bfloat16()

        def lib_call():
            return F.group_norm(x4, 32, wb, bb, eps)

        lib, lib_dev = cuda_time(lib_call, 10), graph_time(lib_call, 10)
        nbytes = 2 * B * rows * C
        bound = bound_ms(2 * nbytes + 8 * C, fp32=(5 + 4 * silu) * B * rows * C)
        stats_bound = max(bound_ms(nbytes, fp32=3 * B * rows * C))
        p = groupnorm.plan(B, rows, C, 32, 2, sms)
        print(f"[kernel] group_norm [{B},{rows},{C}] silu={silu} eps={eps} "
              f"({p.slices} slices of {p.sc} ch, clusters of {p.cluster}, "
              f"{p.blocks} blocks, {'resident' if p.resident else 'streaming'}"
              f"): max rel err full {err_full:.2e}, apply {err_apply:.2e} "
              f"(tol {GN_TOL}), stats {err_stats:.2e} (tol {GN_STATS_TOL}); "
              f"full {ms_full:.4f} ms (device only {dev_full:.4f}), stats + "
              f"apply {ms_pair:.4f} ms (device only {dev_pair:.4f}), plain "
              f"{plain:.3f} ms, F.group_norm {lib:.4f} ms (device only "
              f"{lib_dev:.4f}); bound {max(bound):.4f} ms (stats alone "
              f"{stats_bound:.4f})")
        if not (err_full < GN_TOL and err_apply < GN_TOL
                and err_stats < GN_STATS_TOL):
            raise AssertionError(f"GroupNorm kernel disagrees at "
                                 f"{(B, rows, C)}")
        stats.add("full_group_norm", abs_full, ms_full, plain, lib, bound,
                  dev_full, lib_dev)
        stats.add("group_norm", abs_apply, ms_pair, plain, lib, bound,
                  dev_pair, lib_dev)
        for i, v in enumerate((n_call, n_call * dev_full, n_call * dev_pair,
                               n_call * max(bound), n_call * lib_dev)):
            per_call[i] += v
        if (B, rows, C, silu, eps) in GN_EARLIER_ROWS:
            earlier[0] += ms_full
            earlier[1] += ms_pair
        del x, xf, x4, mean, rstd
        torch.cuda.empty_cache()
    n, full_ms, pair_ms, bound_sum, lib_sum = per_call
    print(f"[kernel] group_norm per exact UNet call ({n} norms, device only, "
          f"at the rows above): full {full_ms:.4f} ms, stats + apply "
          f"{pair_ms:.4f} ms, F.group_norm {lib_sum:.4f} ms, bound "
          f"{bound_sum:.4f} ms")
    print(f"[kernel] group_norm over the earlier runs' four rows, through "
          f"the call: full {earlier[0]:.4f} ms, stats + apply "
          f"{earlier[1]:.4f} ms")

    # the finalize entry at the fused resnets' GN2 partials [B, tiles, Co]
    for B, H, W, Ci, Co in RESNET_SHAPES:
        tiles = resnet.conv_plan(B, H, W, Ci, Co, sms).tiles
        k = -(-H * W // tiles)  # rows a tile
        h = torch.from_numpy(rng.standard_normal((B, tiles, k, Co), np.float32)
                             * 2.0 + 0.5).to(dev)
        sums, sqs = h.sum(2).contiguous(), (h * h).sum(2).contiguous()
        del h
        count = tiles * k
        mean, rstd = groupnorm.stats_from_partials(sums, sqs, 32, count, 1e-5)
        want = groupnorm.reference_stats_from_partials(sums, sqs, 32, count,
                                                       1e-5)
        err = max(rel(mean, want[0]), rel(rstd, want[1]))
        abs_err = max((mean - want[0]).abs().max().item(),
                      (rstd - want[1]).abs().max().item())

        def fin():
            return groupnorm.stats_from_partials(sums, sqs, 32, count, 1e-5)

        ms, device = cuda_time(fin, 10), graph_time(fin, 10)
        plain = cuda_time(lambda: groupnorm.reference_stats_from_partials(
            sums, sqs, 32, count, 1e-5), 3)
        bound = bound_ms(2 * 4 * B * tiles * Co + 2 * 4 * B * 32,
                         fp32=2 * B * tiles * Co)
        print(f"[kernel] group_norm finalize [{B},{tiles},{Co}] (conv2 of "
              f"[{B},{H},{W},{Ci}]->{Co}): max rel err {err:.2e} (tol "
              f"{GN_STATS_TOL}); kernel {ms:.4f} ms (device only "
              f"{device:.4f}), plain {plain:.3f} ms, bound {max(bound):.4f} "
              f"ms")
        if not err < GN_STATS_TOL:
            raise AssertionError(f"GroupNorm finalize disagrees at "
                                 f"{(B, tiles, Co)}")
        stats.add("group_norm", abs_err, ms, plain, None, bound, device)
        del sums, sqs


def merge_engine_times(dev, rng) -> None:
    """Device-only ms of one core/merge._build_plan at the exact path's L0
    local round (CONFIG: 2 lanes sharing one matching, 4 frames of 64x64
    tokens, C = 320, frame 0 dst, ratio 0.9, len_quantum 1024), and of its
    pieces on the same inputs: the normalize, the two gathers with the
    bf16 cast, the best-match kernel, the lanes' best and the stable sort,
    and the index gathers, cat and three scatters."""
    from vidtome_torch.core import merge
    from vidtome_torch.ops import matching

    B, F, T, C = 2, 4, 64 * 64, 320
    metric = torch.from_numpy(rng.standard_normal(
        (B, F * T, C), np.float32)).to(dev, torch.bfloat16)
    a_idx = torch.arange(T, F * T, device=dev).expand(B, -1)
    b_idx = torch.arange(T, device=dev).expand(B, -1)
    S = (F - 1) * T
    r = merge.quantize_r(S, int(S * 0.9), T, 1024)
    U = S - r

    def plan():
        return merge._build_plan(metric, a_idx, b_idx, r, True, [0], T, 0)

    def normalize():
        return metric / metric.float().norm(dim=-1, keepdim=True).clamp_min(
            1e-6)
    mnorm = normalize()

    def gathers():
        return (merge._take(mnorm, a_idx).to(torch.bfloat16),
                merge._take(mnorm, b_idx).to(torch.bfloat16))
    src, dst = gathers()
    node_max, node_idx = matching.best_match(src, dst)

    def select():  # the lanes' best, then the U lowest
        best, lane = node_max.max(dim=0, keepdim=True)
        unm = torch.sort(best, dim=-1, stable=True).indices[:, :U]
        return unm.expand(B, U), node_idx.gather(0, lane).expand(B, S)
    unm_idx, idx = select()

    def scatters():  # _build_plan's tail
        kept = a_idx.gather(1, unm_idx)
        gather = torch.cat([kept, b_idx], dim=1)
        inv = torch.zeros(B, F * T, dtype=torch.long, device=dev)
        inv.scatter_(1, b_idx, U + torch.arange(T, device=dev).expand(B, T))
        inv.scatter_(1, a_idx, U + idx)
        inv.scatter_(1, kept, torch.arange(U, device=dev).expand(B, U))
        return gather, inv
    whole = graph_time(plan, 10)
    parts = {"normalize": normalize, "gathers + bf16 cast": gathers,
             "best_match": lambda: matching.best_match(src, dst),
             "lanes' best + stable sort": select,
             "index gathers + cat + 3 scatters": scatters}
    parts = {k: graph_time(fn, 10) for k, fn in parts.items()}
    print(f"[merge] _build_plan at the L0 local round [{B},{F * T},{C}] "
          f"(S {S}, D {T}, r {r}): device only {whole:.4f} ms, through the "
          f"call {cuda_time(plan, 10):.4f} ms; pieces device only: "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"; the kernel {parts['best_match'] / whole:.0%} of the plan")


def sublayer_inputs(rng, dev, B: int, S: int, C: int, skv: int = 77):
    """A sublayer row's inputs: x, a1 [B, S, C], k, v [B, skv, C], Wq, Wout
    [C, C] (bf16), bout, g2, b2, g3, b3 [C] (fp32), from ``rng``."""
    def bf16(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * scale).to(dev, torch.bfloat16)

    def f32(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * scale
                                + shift).to(dev)

    return [bf16((B, S, C)), bf16((B, S, C), 0.5), bf16((B, skv, C)),
            bf16((B, skv, C)), f32(C, C, scale=C ** -0.5).bfloat16(),
            f32(C, C, scale=C ** -0.5).bfloat16(), f32(C, scale=0.1),
            f32(C, scale=0.1, shift=1.0), f32(C, scale=0.1),
            f32(C, scale=0.1, shift=1.0), f32(C, scale=0.1)]


def sublayer_bound(B: int, S: int, C: int, skv: int = 77) -> tuple:
    """bound_ms of one sublayer call: x, a1 read, x3, y3 written, K, V and
    both weights read once, the five vectors (fp32); the two projections
    and the attention's two products."""
    return bound_ms(2 * (4 * B * S * C + 2 * B * skv * C + 2 * C * C)
                    + 4 * 5 * C, bf16=B * S * (4 * C * C + 4 * skv * C))


def unfused_sublayer(args, heads: int, kv_len: int, eps: float = 1e-5):
    """The port's unfused bf16 chain for the sublayer's work, as a
    TransformerBlock runs it with sublayer_mode off (K and V given): h = x +
    a1, norm2, to_q, attention (small-KV at these key counts), to_out,
    the residual, norm3.  Several calls: a yardstick, not one library
    call."""
    from torch.nn import functional as F

    from vidtome_torch.ops import attention

    x, a1, k, v, wq, wout, *vecs = args
    bout, g2, b2, g3, b3 = (t.bfloat16() for t in vecs)
    B, S, C = x.shape

    def split(t):  # [B, s, C] -> [B, heads, s, D] view
        return t.view(B, t.shape[1], heads, C // heads).transpose(1, 2)

    def run():
        h = x + a1
        q = F.linear(F.layer_norm(h, (C,), g2, b2, eps), wq)
        o = attention.attention(split(q), split(k), split(v), kv_len)
        x3 = h + F.linear(o.transpose(1, 2).reshape(B, S, C), wout, bout)
        return x3, F.layer_norm(x3, (C,), g3, b3, eps)
    return run


def phase_kernels(dev) -> KernelStats:
    from torch.nn import functional as F

    from vidtome_torch.ops import (attention, groupnorm, matching, quant,
                                   resnet, sublayer)

    rng = np.random.default_rng(0)

    def bf16(shape, scale=1.0, shift=0.0):
        a = (rng.standard_normal(shape, np.float32) * scale + shift)
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    def report(what, err, tol, ms, plain, library, bound, note=""):
        lib = "none" if library is None else f"{library:.3f} ms"
        print(f"[kernel] {what} max|err| {err:.2e} (tol {tol}); kernel "
              f"{ms:.3f} ms, plain {plain:.3f} ms, library call {lib}, "
              f"bound {max(bound):.4f} ms "
              f"({'bytes' if bound[0] >= bound[1] else 'operations'}){note}")

    stats = KernelStats()
    per_call = {}  # path -> summed launches x (ms, device ms, bound, SDPA)
    for name, shapes in (("flash_attention", FLASH_SHAPES),
                         ("small_kv_attention", SMALL_KV_SHAPES)):
        fn = getattr(attention, name)
        for B, H, Sq, Skv, D in shapes:
            q, k, v = (bf16((B, H, Sq, D)), bf16((B, H, Skv, D)),
                       bf16((B, H, Skv, D)))
            qf, kf, vf = q.float(), k.float(), v.float()
            got = fn(q, k, v)
            want = attention.reference_attention(qf, kf, vf)
            err = (got.float() - want).abs().max().item()
            rel = err / want.abs().max().item()
            del want
            ms = cuda_time(lambda: fn(q, k, v), 10)
            device = graph_time(lambda: fn(q, k, v), 10)
            plain = cuda_time(
                lambda: attention.reference_attention(qf, kf, vf), 3)

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v)

            lib = cuda_time(sdpa, 10)
            lib_device = graph_time(sdpa, 10)
            bound = bound_ms(2 * 2 * B * H * (Sq + Skv) * D,
                             bf16=4 * B * H * Sq * Skv * D)
            flash = name == "flash_attention"
            tol, rel_tol = ((ATTN_TOL, FLASH_TOL) if flash
                            else (SMALL_KV_TOL, SMALL_KV_REL_TOL))
            exp_floor = B * H * Sq * Skv / EXP2_S * 1e3
            report(f"{name} [{B},{H},{Sq}x{Skv},{D}] max|err| / max|ref| "
                   f"{rel:.2e} (tol {rel_tol}),", err, tol, ms, plain, lib,
                   bound, f", exp floor {exp_floor:.4f} ms; device only "
                   f"(CUDA graph of 10 calls): kernel {device:.4f} ms, "
                   f"library call {lib_device:.4f} ms")
            if not err < tol or not rel <= rel_tol:
                raise AssertionError(f"{name} kernel disagrees at "
                                     f"{(B, H, Sq, Skv, D)}")
            stats.add(name, err, ms, plain, lib, bound, device, lib_device)
            if not flash:
                for path, n in SMALL_KV_LAUNCHES[(B, H, Sq, Skv, D)].items():
                    row = per_call.setdefault(path, [0, 0.0, 0.0, 0.0, 0.0])
                    for i, x in enumerate((1, ms, device, max(bound),
                                           lib_device)):
                        row[i] += n * x
            del q, k, v, qf, kf, vf, got
            torch.cuda.empty_cache()
    for path, (n, ms, device, bound, lib_device) in per_call.items():
        print(f"[kernel] small_kv_attention per {path} UNet call, {n} "
              f"launches at the rows above: through the wrapper {ms:.4f} ms, "
              f"device only {device:.4f} ms (SDPA {lib_device:.4f} ms), "
              f"bound {bound:.4f} ms")

    phase_group_norm(dev, rng, stats)

    def f32(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * scale
                                + shift).to(dev)

    for B, H, W, Ci, Co in RESNET_SHAPES:
        # the conv weights as ResnetBlock2D holds them: OIHW views of
        # packed [O, 3, 3, I] storage (channels_last)
        args = [bf16((B, H, W, Ci)), f32(B, Co, scale=0.3),
                f32(Ci, scale=0.2, shift=1.0), f32(Ci, scale=0.1),
                f32(Co, Ci, 3, 3, scale=(9 * Ci) ** -0.5).bfloat16()
                .contiguous(memory_format=torch.channels_last),
                f32(Co, scale=0.1), f32(Co, scale=0.2, shift=1.0),
                f32(Co, scale=0.1),
                f32(Co, Co, 3, 3, scale=(9 * Co) ** -0.5).bfloat16()
                .contiguous(memory_format=torch.channels_last),
                f32(Co, scale=0.1)]
        proj = Ci != Co
        if proj:
            args += [f32(Co, Ci, scale=Ci ** -0.5).bfloat16(),
                     f32(Co, scale=0.1)]
        conv_ops = 2 * B * H * W * 9 * (Ci * Co + Co * Co)
        sc_ops = 2 * B * H * W * Ci * Co * proj
        act_bytes = 2 * B * H * W * (Ci + Co) + 4 * B * Co
        # bf16 weights; the plain version in fp32 on the same bf16 inputs
        args_f = [a.float() for a in args]
        got = resnet.fused_resnet(*args)
        want = resnet.reference_fused_resnet(*args_f)
        abs_err = (got.float() - want).abs().max().item()
        err = abs_err / want.abs().max().item()
        del want
        ms = cuda_time(lambda: resnet.fused_resnet(*args), 10)
        device = graph_time(lambda: resnet.fused_resnet(*args), 10)
        plain = cuda_time(lambda: resnet.reference_fused_resnet(*args_f), 3)
        # the library yardstick: cuDNN's two convolutions of the block
        # (bf16, channels_last), without its norms, bias and shortcut
        xc = args[0].permute(0, 3, 1, 2)
        hc = got.permute(0, 3, 1, 2)

        def cudnn():
            F.conv2d(xc, args[4], padding=1)
            F.conv2d(hc, args[8], padding=1)
        lib = cuda_time(cudnn, 10)
        bound = bound_ms(act_bytes + 2 * (9 * Ci * Co + 9 * Co * Co
                                          + Ci * Co * proj),
                         bf16=conv_ops + sc_ops)
        plan1 = resnet.conv_plan(B, H, W, Ci, Co, resnet._sm_count(0))
        plan2 = resnet.conv_plan(B, H, W, Co, Co, resnet._sm_count(0))
        report(f"fused_resnet [{B},{H},{W},{Ci}]->{Co} (tiles "
               f"{plan1.tile_h}x{plan1.tile_w}/{plan1.block_n}, "
               f"{plan2.tile_h}x{plan2.tile_w}/{plan2.block_n}): max rel err "
               f"{err:.2e}, ", abs_err, RESNET_TOL, ms, plain, lib, bound,
               f"; device only (CUDA graph of 10 calls) {device:.4f} ms; the "
               f"library call is cuDNN's two convolutions alone")
        if not err < RESNET_TOL:
            raise AssertionError(f"fused resnet kernel disagrees at "
                                 f"{(B, H, W, Ci, Co)}")
        stats.add("fused_resnet", abs_err, ms, plain, lib, bound, device)
        del args_f, got, xc, hc
        # W8A8: int8 weights packed, and each conv's static activation
        # scale taken once, as the int8 tables hold them (the resnet block
        # passes both, models/layers.py); the plain version in bf16 (the
        # kernel's rounding points, the same int8 activations up to fp32
        # sum order)
        kw = {"act_scales": (quant.static_act_scale(args[2], args[3]),
                             quant.static_act_scale(args[6], args[7]))}
        for i, key in ((4, "w1_scale"), (8, "w2_scale")):
            w_q, kw[key] = quant.quantize_weight(args[i])
            args[i] = quant.packed_conv_weight(w_q).permute(0, 3, 1, 2)
        got = resnet.fused_resnet_w8a8(*args, **kw)
        want = resnet.reference_fused_resnet(*args, quant=True, **kw).float()
        abs_err = (got.float() - want).abs().max().item()
        err = abs_err / want.abs().max().item()
        del want, got
        bf16_ms, bf16_device = ms, device
        ms = cuda_time(lambda: resnet.fused_resnet_w8a8(*args, **kw), 10)
        device = graph_time(lambda: resnet.fused_resnet_w8a8(*args, **kw), 10)
        plain = cuda_time(lambda: resnet.reference_fused_resnet(
            *args, quant=True, **kw), 3)
        bound = bound_ms(act_bytes + 9 * Ci * Co + 9 * Co * Co
                         + 2 * Ci * Co * proj + 8 * Co,
                         int8=conv_ops, bf16=sc_ops)
        plan1, plan2 = (resnet.conv_plan_w8a8(B, H, W, c, Co,
                                              resnet._sm_count(0))
                        for c in (Ci, Co))
        report(f"fused_resnet_w8a8 [{B},{H},{W},{Ci}]->{Co} (tiles "
               f"{plan1.tile_h}x{plan1.tile_w}/{plan1.block_n}, "
               f"{plan2.tile_h}x{plan2.tile_w}/{plan2.block_n}): max rel err "
               f"{err:.2e}, ", abs_err, RESNET_TOL, ms, plain, None, bound,
               f"; device only (CUDA graph of 10 calls) {device:.4f} ms; the "
               f"bf16 block at this row {bf16_ms:.4f} ms (device only "
               f"{bf16_device:.4f})")
        if not err < RESNET_TOL:
            raise AssertionError(f"W8A8 fused resnet kernel disagrees at "
                                 f"{(B, H, W, Ci, Co)}")
        stats.add("fused_resnet_w8a8", abs_err, ms, plain, None, bound,
                  device)
        del args
        torch.cuda.empty_cache()

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for row in MATCH_SHAPES:
        B, S, D, C = match_shape(row)
        src = torch.nn.functional.normalize(f32(B, S, C), dim=-1).bfloat16()
        dst = torch.nn.functional.normalize(f32(B, D, C), dim=-1).bfloat16()
        srcf, dstf = src.float(), dst.float()
        got_max, got_idx = matching.best_match(src, dst)
        want_max, want_idx = matching.reference_best_match(srcf, dstf)
        top2 = torch.bmm(srcf, dstf.transpose(1, 2)).topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > MATCH_GAP
        err = (got_max - want_max).abs().max().item()
        wrong = int((got_idx != want_idx)[clear].sum())
        del top2
        ms = cuda_time(lambda: matching.best_match(src, dst), 10)
        device = graph_time(lambda: matching.best_match(src, dst), 10)
        plain = cuda_time(lambda: matching.reference_best_match(srcf, dstf),
                          3)

        def yardstick():  # bf16 scores in memory between the two calls
            scores = torch.bmm(src, dst.transpose(1, 2))
            return scores.amax(dim=-1), scores.argmax(dim=-1)
        yard = graph_time(yardstick, 10)
        plan = matching.match_plan(B, S, D, C, sms)
        bound = bound_ms(2 * B * (S + D) * C + 12 * B * S,
                         bf16=2 * B * S * D * C)
        report(f"best_match [{B},{S}x{D},{C}]: argmax differs at {wrong} of "
               f"{int(clear.sum())} rows with a top-2 gap > {MATCH_GAP} "
               f"({B * S - int(clear.sum())} near-ties not compared),", err,
               MATCH_TOL, ms, plain, None, bound,
               f"; device only {device:.4f} ms; bmm + amax/argmax (a "
               f"yardstick, not the same function) device only {yard:.4f} "
               f"ms; plan: {plan.rows} rows a block, src tile "
               f"{'resident' if plan.resident else 'streamed'}, grid "
               f"{plan.grid}, {plan.smem} B shared memory")
        if not err < MATCH_TOL or wrong:
            raise AssertionError(f"best_match kernel disagrees at "
                                 f"{(B, S, D, C)}")
        stats.add("best_match", err, ms, plain, None, bound, device)
        del src, dst, srcf, dstf
        torch.cuda.empty_cache()
    merge_engine_times(dev, rng)

    for B, S, C, heads in SUBLAYER_SHAPES:
        args = sublayer_inputs(rng, dev, B, S, C)
        args_f = [a.float() for a in args]
        kw = dict(heads=heads, kv_len=77)
        x3, y3 = sublayer.fused_cross_sublayer(*args, **kw)
        wx3, wy3 = sublayer.reference_cross_sublayer(*args_f, **kw)
        err = max((x3.float() - wx3).abs().max().item(),
                  (y3.float() - wy3).abs().max().item())
        del x3, y3, wx3, wy3

        def fused():
            return sublayer.fused_cross_sublayer(*args, **kw)
        ms = cuda_time(fused, 10)
        device = graph_time(fused, 10)
        chain = graph_time(unfused_sublayer(args, heads, 77), 10)
        plain = cuda_time(lambda: sublayer.reference_cross_sublayer(
            *args_f, **kw), 3)
        bound = sublayer_bound(B, S, C)
        p = sublayer.plan(B, S, C, heads, 77, 77, sms,
                          sublayer._card_clusters(0))
        report(f"fused_cross_sublayer [{B},{S},{C}] heads {heads}, 77 keys "
               f"(x3, y3):", err, SUBLAYER_TOL, ms, plain, None, bound,
               f"; device only {device:.4f} ms; the port's unfused bf16 "
               f"chain (norm2, to_q, small-KV, to_out, residuals, norm3: a "
               f"yardstick of several calls) device only {chain:.4f} ms; "
               f"plan: clusters of {p.cluster} ({p.heads_rank} heads of "
               f"{p.head_dim} a rank), {p.stages} stages, {p.kv_bufs} K/V "
               f"buffers a consumer, grid {p.grid}, {p.smem} B shared "
               f"memory")
        if not err < SUBLAYER_TOL:
            raise AssertionError(f"fused sublayer kernel disagrees at "
                                 f"{(B, S, C, heads)}")
        stats.add("fused_cross_sublayer", err, ms, plain, None, bound, device)
        del args, args_f
        torch.cuda.empty_cache()
    return stats


def make_frames() -> np.ndarray:
    """8 frames of a moving colour gradient with a moving disc, [0, 1]."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    out = []
    for i in range(N_FRAMES):
        ph = i / N_FRAMES
        disc = ((xx - 0.3 - 0.4 * ph) ** 2 + (yy - 0.6) ** 2) < 0.01
        r = np.where(disc, 0.9, 0.5 + 0.4 * np.sin(2 * np.pi * (xx + ph)))
        g = np.where(disc, 0.1, 0.5 + 0.4 * np.cos(2 * np.pi * yy))
        out.append(np.stack([r, g, np.full_like(xx, 0.3 + 0.2 * ph)], -1))
    return np.stack(out).astype(np.float32)


def phase_main_path(dev, bundle) -> dict:
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    frames = make_frames()
    inverter = Inverter(bundle, CONFIG)
    generator = Generator(bundle, CONFIG)
    times = {}
    stage = functools.partial(timed, times)

    reset_launches()
    latents, conds = stage("encode", lambda: inverter.encode(frames))
    inverted = stage("invert", lambda: inverter.ddim_inversion(latents, conds))
    generator.configure_frames(N_FRAMES)
    name, prompt = next(iter(generator.prompt.items()))
    context = stage("text", lambda: generator.text.embed_cfg(
        prompt, generator.negative_prompt))
    table = generator.fidx_table()
    gen_before = read_launches()
    clean = stage("generate", lambda: generator.ddim_sample(
        inverted[torch.as_tensor(generator.pad_src, device=dev)], context,
        fidx_table=table))
    gen = {k: v - gen_before[k] for k, v in read_launches().items()}
    out = stage("decode", lambda: generator.vae.decode(clean[:N_FRAMES]))
    launches = read_launches()
    unet_calls = sum(generator.unet_calls.values())

    if table.shape[1] != 2:
        raise AssertionError(f"expected 2 chunks, got {table.shape[1]}")
    if tuple(out.shape) != (N_FRAMES, SIZE, SIZE, 3):
        raise AssertionError(f"frames shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("frames not finite or outside [0, 1]")
    if not torch.isfinite(inverted).all():
        raise AssertionError("inverted latents not finite")
    for k in ("flash_attention", "small_kv_attention", "full_group_norm",
              "best_match"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} kernel never launched on the exact "
                                 f"path")
    # every GroupNorm of the exact path (no fused resnets) takes the full
    # entry, once a norm: 61 a UNet call
    if launches["group_norm"] or gen["full_group_norm"] != 61 * unet_calls:
        raise AssertionError(f"exact path: GroupNorm launches {gen} over "
                             f"{unet_calls} UNet calls, want 61 full a call")
    print(f"[main] {N_FRAMES} frames {SIZE}x{SIZE}, {STEPS}+{STEPS} DDIM "
          f"steps, 2 chunks; frames mean {out.mean().item():.4f} std "
          f"{out.std().item():.4f}; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    # best match: the local rounds of levels 0 and 1 every UNet call, both
    # levels' global merges on the chunk that merges against the bank (one
    # of the two each step, the other initialises it): 3 a call
    if gen["best_match"] != 3 * unet_calls:
        raise AssertionError(f"exact path: {gen['best_match']} best_match "
                             f"launches over {unet_calls} UNet calls, want "
                             f"3 a call")
    print(f"[main] best_match launches per generation UNet call: "
          f"{gen['best_match'] / unet_calls:.0f}")
    print(f"[main] GroupNorm launches per generation UNet call: "
          f"{gen['full_group_norm'] / unet_calls:.0f} full entry "
          f"({unet_calls} UNet calls)")
    print(f"[main] kernel launches in this run: {launches}")
    return launches


def expected_calls(modes, per_step: int, cfg: bool) -> dict:
    """UNet calls per kind that a mode table implies (columns: deep
    refresh, CFG refresh, run); per_step calls each run step."""
    deep, cfgm, run = modes[:, 0], modes[:, 1], modes[:, 2]
    out = {"full": per_step * int((run & deep).sum()),
           "shallow": per_step * int((run & ~deep).sum()),
           "eps_skip": int((~run).sum())}
    if cfg:
        out["cfg_skip"] = per_step * int((run & ~cfgm).sum())
    return {k: v for k, v in out.items() if v}


def phase_serving(dev, bundle) -> dict:
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = serve_config()
    frames = make_frames()
    inverter = Inverter(bundle, cfg)
    generator = Generator(bundle, cfg)
    times = {}
    stage = functools.partial(timed, times)

    reset_launches()
    latents, conds = stage("encode", lambda: inverter.encode(frames))
    inverted = stage("invert", lambda: inverter.ddim_inversion(latents, conds))
    generator.configure_frames(N_FRAMES)
    name, prompt = next(iter(generator.prompt.items()))
    context = stage("text", lambda: generator.text.embed_cfg(
        prompt, generator.negative_prompt))
    table = generator.fidx_table()
    x0 = inverted[torch.as_tensor(generator.pad_src, device=dev)]
    clean = stage("generate", lambda: generator.ddim_sample(
        x0, context, fidx_table=table))
    out = stage("decode", lambda: generator.vae.decode(clean[:N_FRAMES]))
    launches = read_launches()

    n_chunks = table.shape[1]
    gen_modes = generator.mode_masks()
    mask, eps_mask = inverter.step_masks(inversion=True)
    n = SERVE_STEPS
    inv_modes = np.stack([mask if mask is not None else np.ones(n, bool),
                          np.ones(n, bool),
                          eps_mask if eps_mask is not None
                          else np.ones(n, bool)], axis=1)
    want_gen = expected_calls(gen_modes, n_chunks, cfg=True)
    want_inv = expected_calls(inv_modes, -(-N_FRAMES // inverter.batch_size),
                              cfg=False)
    got_gen = {k: v for k, v in generator.unet_calls.items() if v}
    got_inv = {k: v for k, v in inverter.unet_calls.items() if v}
    print(f"[serve] UNet calls: generation {got_gen} (mode table "
          f"{want_gen}); inversion {got_inv} (mode table {want_inv})")
    if got_gen != want_gen or got_inv != want_inv:
        raise AssertionError("UNet calls per kind differ from the mode "
                             "tables")
    if not all(k in got_gen for k in ("full", "shallow", "cfg_skip",
                                      "eps_skip")):
        raise AssertionError(f"the serving profile ran no step of some "
                             f"kind: {got_gen}")
    if tuple(out.shape) != (N_FRAMES, SIZE, SIZE, 3):
        raise AssertionError(f"frames shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("serving frames not finite or outside [0, 1]")
    for k in ("flash_attention", "small_kv_attention", "group_norm",
              "full_group_norm", "fused_resnet", "best_match"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} kernel never launched on the serving "
                                 f"path")
    # the fused resnet blocks take GN1's statistics from the stats entry
    # and GN2's from the finalize entry; every other GroupNorm the full one
    if launches["group_norm"] != 2 * launches["fused_resnet"]:
        raise AssertionError(f"serving path: {launches['group_norm']} stats "
                             f"and finalize launches for "
                             f"{launches['fused_resnet']} fused resnets")
    runs = sum(v for calls in (generator.unet_calls, inverter.unet_calls)
               for k, v in calls.items() if k != "eps_skip")

    # the exact path from the same inverted latents (not counted)
    exact = Generator(bundle, exact_config(SERVE_STEPS))
    exact.configure_frames(N_FRAMES)
    t0 = time.perf_counter()
    ref = exact.vae.decode(exact.ddim_sample(
        x0, context, fidx_table=exact.fidx_table())[:N_FRAMES])
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    mse = ((out.float() - ref.float()) ** 2).mean().item()
    psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
    print(f"[serve] {N_FRAMES} frames {SIZE}x{SIZE}, {n}+{n} DDIM steps, "
          f"{n_chunks} chunks, configs/serve.yaml keys; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; exact generate + decode {t_exact:.3f}")
    print(f"[serve] PSNR serving vs exact frames (same inverted latents, "
          f"random weights: printed only) {psnr:.2f} dB")
    print(f"[serve] GroupNorm launches: full {launches['full_group_norm']}, "
          f"stats + finalize {launches['group_norm']} over {runs} UNet "
          f"calls run")
    print(f"[serve] kernel launches in this run: {launches}")
    return launches


def phase_reference(dev, bundle) -> None:
    """Same SD1.5 weights at a small input: bf16 kernels on the card vs
    fp32 plain versions on the CPU."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4), np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 768), np.float32))
    results, cpu_copies = {}, {}
    for name, mod_fn in (
            ("unet", lambda m, d: m(x.to(d), 501, ctx.to(d))),
            ("unet_fused", lambda m, d: m(x.to(d), 501, ctx.to(d),
                                          resnet_mode="fused")),
            ("vae", lambda m, d: m.decode(
                x.to(d, next(m.parameters()).dtype)))):
        key = name.split("_")[0]
        module = getattr(bundle, key)
        if key not in cpu_copies:
            cpu_copies.clear()
            cpu_copies[key] = copy.deepcopy(module).to("cpu", torch.float32)
        with torch.inference_mode():
            got = mod_fn(module, dev).float().cpu()
            want = mod_fn(cpu_copies[key], "cpu").float()
        err = ((got - want).abs().max() / want.abs().max()).item()
        results[name] = err
        if not err < REF_TOL:
            raise AssertionError(f"{name}: card vs CPU reference rel err {err}")
    print("[reference] SD1.5 weights, 64x64 input, card bf16 kernels vs CPU "
          "fp32 plain (unet_fused: fused resnet blocks): max rel err "
          + ", ".join(
              f"{k} {v:.2e}" for k, v in results.items())
          + f" (tol {REF_TOL})")


class gn_mode:
    """VIDTOME_GN_MODE set to ``mode`` inside the block, restored after."""

    def __init__(self, mode: str):
        self.mode, self.saved = mode, None

    def __enter__(self):
        self.saved = os.environ.get("VIDTOME_GN_MODE")
        os.environ["VIDTOME_GN_MODE"] = self.mode

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("VIDTOME_GN_MODE", None)
        else:
            os.environ["VIDTOME_GN_MODE"] = self.saved


def resnets_per_call(unet) -> dict:
    """ResnetBlock2Ds a full UNet call runs, and a shallow one (the level-0
    path around the deep cache)."""
    return {"full": sum(len(b.resnets) for b in (*unet.down_blocks,
                                                 unet.mid_block,
                                                 *unet.up_blocks)),
            "shallow": (len(unet.down_blocks[0].resnets)
                        + len(unet.up_blocks[-1].resnets))}


def phase_int8(dev, bundle) -> dict:
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = int8_config()
    frames = make_frames()
    times = {}
    stage = functools.partial(timed, times)

    with gn_mode("full"):
        t0 = time.perf_counter()
        inverter = Inverter(bundle, cfg)
        generator = Generator(bundle, cfg)
        torch.cuda.synchronize()
        times["quantize"] = time.perf_counter() - t0
        reset_launches()
        latents, conds = stage("encode", lambda: inverter.encode(frames))
        enc = read_launches()
        inverted = stage("invert",
                         lambda: inverter.ddim_inversion(latents, conds))
        inv_launches = {k: v - enc[k] for k, v in read_launches().items()}
        generator.configure_frames(N_FRAMES)
        name, prompt = next(iter(generator.prompt.items()))
        context = stage("text", lambda: generator.text.embed_cfg(
            prompt, generator.negative_prompt))
        table = generator.fidx_table()
        x0 = inverted[torch.as_tensor(generator.pad_src, device=dev)]
        gen_before = read_launches()
        clean = stage("generate", lambda: generator.ddim_sample(
            x0, context, fidx_table=table))
        gen_launches = {k: v - gen_before[k]
                        for k, v in read_launches().items()}
        out = stage("decode", lambda: generator.vae.decode(clean[:N_FRAMES]))
        launches = read_launches()

    n = INT8_STEPS
    want_gen = expected_calls(generator.mode_masks(), table.shape[1],
                              cfg=True)
    got_gen = {k: v for k, v in generator.unet_calls.items() if v}
    got_inv = {k: v for k, v in inverter.unet_calls.items() if v}
    want_inv = {"full": n * -(-N_FRAMES // inverter.batch_size)}
    per_call = resnets_per_call(bundle.unet)
    want_w8a8 = (sum(per_call[k] * got_inv.get(k, 0) for k in per_call),
                 sum(per_call[k] * got_gen.get(k, 0) for k in per_call))
    got_w8a8 = (inv_launches["fused_resnet_w8a8"],
                gen_launches["fused_resnet_w8a8"])
    print(f"[int8] SD1.5, {N_FRAMES} frames {SIZE}x{SIZE}, {n}+{n} DDIM "
          f"steps, {table.shape[1]} chunks; inversion quant "
          f"{inverter.quant} resnet {inverter.resnet_mode}, generation quant "
          f"{generator.quant} resnet {generator.resnet_mode}; "
          f"VIDTOME_GN_MODE=full; {len(generator.qt)} int8 tensors a stage")
    print(f"[int8] UNet calls: generation {got_gen} (mode table {want_gen}); "
          f"inversion {got_inv} (want {want_inv}); W8A8 resnet launches "
          f"inversion, generation {got_w8a8} (want {want_w8a8}: "
          f"{per_call} resnet blocks a call)")
    if got_gen != want_gen or got_inv != want_inv:
        raise AssertionError("UNet calls per kind differ from the mode "
                             "tables")
    if got_w8a8 != want_w8a8:
        raise AssertionError("W8A8 resnet launches differ from the resnet "
                             "blocks the UNet calls ran")
    if launches["fused_resnet"]:
        raise AssertionError("the bf16 resnet launched on the int8 path")
    if launches["group_norm"] != 2 * launches["fused_resnet_w8a8"]:
        raise AssertionError(f"int8 path: {launches['group_norm']} stats and "
                             f"finalize launches for "
                             f"{launches['fused_resnet_w8a8']} W8A8 resnets")
    for k in ("full_group_norm", "flash_attention", "small_kv_attention",
              "best_match"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} kernel never launched on the int8 "
                                 f"path")
    if tuple(out.shape) != (N_FRAMES, SIZE, SIZE, 3):
        raise AssertionError(f"frames shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("int8 frames not finite or outside [0, 1]")
    if not torch.isfinite(inverted).all():
        raise AssertionError("int8 inverted latents not finite")
    print(f"[int8] frames mean {out.mean().item():.4f} std "
          f"{out.std().item():.4f}; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    print(f"[int8] kernel launches in this run: {launches}")
    return launches


def phase_int8_reference(dev, bundle) -> None:
    """One int8 UNet call (fused resnet blocks) at a 32x32 latent, the
    smallest at which every int8 product has more than 16 rows: bf16
    kernels on the card under VIDTOME_GN_MODE=full vs fp32 plain versions on
    the CPU, with the same int8 table."""
    from vidtome_torch.ops.quant import QuantTable, QWeight, quantize_unet

    rng = np.random.default_rng(3)
    width = bundle.unet.config.cross_attention_dim
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 4), np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, width), np.float32))
    table = quantize_unet(bundle.unet)
    cpu = copy.deepcopy(bundle.unet).to("cpu", torch.float32)
    cpu_table = QuantTable(cpu, {
        name: QWeight(e.weight.cpu(), e.scale.cpu(),
                      None if e.act_scale is None else e.act_scale.cpu())
        for name, e in table.entries.items()})
    with torch.inference_mode(), gn_mode("full"):
        before = read_launches()
        got = bundle.unet(x.to(dev), 501, ctx.to(dev), resnet_mode="fused",
                          qt=table).float().cpu()
        ran = {k: v - before[k] for k, v in read_launches().items()}
        want = cpu(x, 501, ctx, resnet_mode="fused", qt=cpu_table).float()
        plain = cpu(x, 501, ctx, resnet_mode="fused").float()
    scale = want.abs().max()
    err = ((got - want).abs().max() / scale).item()
    effect = ((plain - want).abs().max() / scale).item()
    print(f"[reference] SD1.5 weights, int8 UNet call at a 32x32 latent, "
          f"fused resnet blocks, full GroupNorm: card bf16 kernels vs CPU "
          f"fp32 plain max rel err {err:.2e} (tol {INT8_REF_TOL}); the int8 "
          f"table's own effect on the CPU output {effect:.2e}; kernels "
          f"launched on the card {ran}")
    if not err < INT8_REF_TOL:
        raise AssertionError(f"int8 card vs CPU reference rel err {err}")
    if not (ran["fused_resnet_w8a8"] and ran["full_group_norm"]):
        raise AssertionError("the int8 reference call ran no W8A8 resnet "
                             "or full GroupNorm kernel")
    del cpu, cpu_table


@torch.no_grad()
def perturb_controlnet(controlnet, seed: int = 5) -> None:
    """Move the ControlNet's zero-initialised convs (its zero convs and the
    hint encoder's conv_out) by 0.05 N(0, 1), as trained ControlNets have
    them (tests/test_pipeline_control.py perturbs the zero convs): at zero
    the network adds nothing and the control images reach nothing."""
    gen = torch.Generator().manual_seed(seed)
    for mod in controlnet.zero_init_modules():
        for p in (mod.weight, mod.bias):
            noise = torch.randn(p.shape, generator=gen) * 0.05
            p.add_(noise.to(p.device, p.dtype))


class LaunchesPerCall:
    """The kernel launches of each call of ``module``, from its forward
    hooks (read before and after every call)."""

    def __init__(self, module):
        self.calls: list[dict] = []
        self._handles = [module.register_forward_pre_hook(self._pre),
                         module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        self._before = read_launches()

    def _post(self, module, args, out):
        self.calls.append({k: v - self._before[k]
                           for k, v in read_launches().items()})

    def close(self) -> None:
        for h in self._handles:
            h.remove()


def phase_controlnet(dev, bundle) -> dict:
    """configs/demo-canny.yaml on the SD1.5 bundle, both stages through the
    ControlNet, 50+50 DDIM steps, the control images through the png
    cache."""
    import tempfile

    from vidtome_torch.io.artifacts import control_image_dir
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = controlnet_config()
    perturb_controlnet(bundle.controlnet)
    frames = make_frames()
    frame_ids = list(range(N_FRAMES))
    inverter = Inverter(bundle, cfg)
    generator = Generator(bundle, cfg)
    times = {}
    stage = functools.partial(timed, times)
    per_call = LaunchesPerCall(bundle.controlnet)
    try:
        with tempfile.TemporaryDirectory() as work_dir:
            reset_launches()
            latents, conds = stage("encode", lambda: inverter.encode(frames))
            control_inv = stage("control_inv",
                                lambda: inverter.control_images(frames))
            inv_before = read_launches()
            inverted = stage("invert", lambda: inverter.ddim_inversion(
                latents, conds, control=control_inv))
            inv_launches = {k: v - inv_before[k]
                            for k, v in read_launches().items()}
            n_inv_cn = len(per_call.calls)
            generator.configure_frames(N_FRAMES)
            pad = torch.as_tensor(generator.pad_src, device=dev)
            control = stage("control", lambda: generator.load_control(
                frames, frame_ids, work_dir))
            cdir = Path(control_image_dir(work_dir, generator.control))
            pngs = sorted(p.name for p in cdir.glob("*.png"))
            again = generator.load_control(frames, frame_ids, work_dir)
            name, prompt = next(iter(generator.prompt.items()))
            context = stage("text", lambda: generator.context(prompt))
            table = generator.fidx_table()
            x0 = inverted[pad]
            gen_before = read_launches()
            clean = stage("generate", lambda: generator.ddim_sample(
                x0, context, fidx_table=table, control=control[pad]))
            gen_launches = {k: v - gen_before[k]
                            for k, v in read_launches().items()}
            out = stage("decode",
                        lambda: generator.vae.decode(clean[:N_FRAMES]))
            launches = read_launches()
    finally:
        per_call.close()

    inv_calls = sum(inverter.unet_calls.values())
    gen_calls = sum(generator.unet_calls.values())
    cn_calls = per_call.calls
    want = {k: CONTROLNET_LAUNCHES.get(k, 0) for k in KERNELS}
    odd = [c for c in cn_calls if c != want]
    print(f"[controlnet] SD1.5 + canny ControlNet (random, zero convs "
          f"moved), {N_FRAMES} frames {SIZE}x{SIZE}, {CONTROLNET_STEPS}+"
          f"{CONTROLNET_STEPS} DDIM steps, {table.shape[1]} chunks, "
          f"configs/demo-canny.yaml keys, inversion.control canny, "
          f"control_scale {generator.control_scale}; UNet calls inversion "
          f"{dict(inverter.unet_calls)}, generation "
          f"{dict(generator.unet_calls)}; ControlNet calls {len(cn_calls)} "
          f"(inversion {n_inv_cn})")
    print(f"[controlnet] launches per ControlNet call: "
          f"{cn_calls[0] if cn_calls else None} (want {CONTROLNET_LAUNCHES}; "
          f"{len(odd)} calls differ); control images {tuple(control.shape)} "
          f"{control.dtype}, {len(pngs)} pngs in <work_dir>/{cdir.name}")
    if not (inverter.use_controlnet and generator.use_controlnet):
        raise AssertionError("a stage runs without its ControlNet")
    if n_inv_cn != inv_calls or len(cn_calls) != inv_calls + gen_calls:
        raise AssertionError("ControlNet calls differ from the UNet calls")
    if odd:
        raise AssertionError(f"ControlNet launches per call {odd[0]}, want "
                             f"{want}")
    if pngs != [f"{i:04}.png" for i in frame_ids] or not torch.equal(
            again, control):
        raise AssertionError("the control images did not go through the "
                             "png cache")
    if not 0 < control.float().mean().item() < 1:
        raise AssertionError("canny found no edges in the clip")
    # the UNet's own launches beside the ControlNet's: every GroupNorm the
    # full entry (61 a UNet call), best match 3 a generation call
    for part, n_unet, n_cn, got in (
            ("inversion", inv_calls, n_inv_cn, inv_launches),
            ("generation", gen_calls, gen_calls, gen_launches)):
        want_gn = 61 * n_unet + CONTROLNET_LAUNCHES["full_group_norm"] * n_cn
        if got["full_group_norm"] != want_gn or got["group_norm"]:
            raise AssertionError(f"{part}: GroupNorm launches {got}, want "
                                 f"{want_gn} full")
    if gen_launches["best_match"] != 3 * gen_calls:
        raise AssertionError(f"generation: {gen_launches['best_match']} "
                             f"best_match launches over {gen_calls} UNet "
                             f"calls")
    if tuple(out.shape) != (N_FRAMES, SIZE, SIZE, 3):
        raise AssertionError(f"frames shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("ControlNet frames not finite or outside "
                             "[0, 1]")
    if not torch.isfinite(inverted).all():
        raise AssertionError("ControlNet inverted latents not finite")

    # the exact path (no ControlNet) from the same inverted latents, not
    # counted
    exact_cfg = copy.deepcopy(cfg)
    exact_cfg["generation"]["control"] = "none"
    exact = Generator(bundle, exact_cfg)
    exact.configure_frames(N_FRAMES)
    t0 = time.perf_counter()
    ref = exact.vae.decode(exact.ddim_sample(
        x0, context, fidx_table=exact.fidx_table())[:N_FRAMES])
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    mse = ((out.float() - ref.float()) ** 2).mean().item()
    psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
    print(f"[controlnet] frames mean {out.mean().item():.4f} std "
          f"{out.std().item():.4f}; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; exact generate + decode {t_exact:.3f}")
    print(f"[controlnet] PSNR ControlNet vs exact frames (same inverted "
          f"latents, random weights: printed only) {psnr:.2f} dB")
    print(f"[controlnet] kernel launches in this run: {launches}")
    controlnet_call_times(dev, bundle, control[:N_FRAMES])
    return launches


def controlnet_call_times(dev, bundle, cond) -> None:
    """One ControlNet call and one UNet call at the inversion's batch (8
    frames at a 64x64 latent, 512x512 control images), in turns (ControlNet,
    UNet, UNet, ControlNet): device ms summed over their kernels
    (torch.profiler) and ms through the call (CUDA events)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((N_FRAMES, SIZE // 8, SIZE // 8,
                                              4), np.float32))
    ctx = torch.from_numpy(rng.standard_normal((N_FRAMES, 77, 768),
                                               np.float32))
    x, ctx = x.to(dev, torch.bfloat16), ctx.to(dev, torch.bfloat16)
    calls = {"controlnet": lambda: bundle.controlnet(x, 501, ctx, cond),
             "unet": lambda: bundle.unet(x, 501, ctx)}
    device, wall = {}, {}
    with torch.inference_mode():
        for name in ("controlnet", "unet", "unet", "controlnet"):
            try:
                device.setdefault(name, []).append(
                    profiled_device_ms(calls[name]))
            except Exception as exc:  # a measurement only: say so, go on
                print(f"[controlnet] device time not measured ({exc!r})")
                device.setdefault(name, []).append(None)
            wall.setdefault(name, []).append(cuda_time(calls[name], 3))
    print(f"[controlnet] one call at [{N_FRAMES},{SIZE // 8},{SIZE // 8},4], "
          f"{SIZE}x{SIZE} control images: device ms (torch.profiler, summed "
          f"over its kernels) ControlNet {device['controlnet']}, UNet "
          f"{device['unet']}; through the call (CUDA events) ControlNet "
          f"{[round(v, 3) for v in wall['controlnet']]}, UNet "
          f"{[round(v, 3) for v in wall['unet']]}")


def phase_controlnet_reference(dev, bundle) -> None:
    """One ControlNet call and the UNet call fed its residuals, on the card
    (bf16 kernels) and on the CPU (fp32 plain versions): at an 8x8 latent
    and a 64x64 hint to REF_TOL, and with both int8 tables at a 32x32
    latent and a 256x256 hint (the smallest at which every int8 product has
    more than 16 rows) to INT8_REF_TOL; the same call at control_scale 0
    must differ by more than the tolerance."""
    from vidtome_torch.ops.quant import (CONTROLNET_EXCLUDE, QuantTable,
                                         QWeight, quantize_unet)

    def cpu_table(table, root):
        return QuantTable(root, {
            n: QWeight(e.weight.cpu(), e.scale.cpu(),
                       None if e.act_scale is None else e.act_scale.cpu())
            for n, e in table.entries.items()})

    rng = np.random.default_rng(4)
    width = bundle.unet.config.cross_attention_dim
    cpu_unet = copy.deepcopy(bundle.unet).to("cpu", torch.float32)
    cpu_cn = copy.deepcopy(bundle.controlnet).to("cpu", torch.float32)
    for latent, quant, tol in ((8, False, REF_TOL), (32, True, INT8_REF_TOL)):
        x = torch.from_numpy(rng.standard_normal((2, latent, latent, 4),
                                                 np.float32))
        ctx = torch.from_numpy(rng.standard_normal((2, 77, width),
                                                   np.float32))
        cond = torch.from_numpy(rng.random((2, 8 * latent, 8 * latent, 3),
                                           np.float32))
        tables = cpu_tables = (None, None)
        if quant:
            tables = (quantize_unet(bundle.controlnet,
                                    exclude=CONTROLNET_EXCLUDE),
                      quantize_unet(bundle.unet))
            cpu_tables = (cpu_table(tables[0], cpu_cn),
                          cpu_table(tables[1], cpu_unet))

        def run(cn, unet, d, scale, qts):
            down, mid = cn(x.to(d), 501, ctx.to(d), cond.to(d),
                           conditioning_scale=scale, qt=qts[0])
            return unet(x.to(d), 501, ctx.to(d), down_residuals=down,
                        mid_residual=mid, qt=qts[1]).float().cpu()

        with torch.inference_mode():
            before = read_launches()
            got = run(bundle.controlnet, bundle.unet, dev, 1.0, tables)
            ran = {k: v - before[k] for k, v in read_launches().items()}
            want = run(cpu_cn, cpu_unet, "cpu", 1.0, cpu_tables)
            zero = run(cpu_cn, cpu_unet, "cpu", 0.0, cpu_tables)
        scale = want.abs().max()
        err = ((got - want).abs().max() / scale).item()
        gap = ((zero - want).abs().max() / scale).item()
        what = "int8 tables" if quant else "bf16"
        print(f"[reference] SD1.5 ControlNet + UNet ({what}) at a "
              f"{latent}x{latent} latent, {8 * latent}x{8 * latent} hint: "
              f"card kernels vs CPU fp32 plain max rel err {err:.2e} (tol "
              f"{tol}); control_scale 0 vs 1 {gap:.2e} (must exceed {tol}); "
              f"kernels launched on the card {ran}")
        if not err < tol:
            raise AssertionError(f"ControlNet ({what}) card vs CPU reference "
                                 f"rel err {err}")
        if not gap > tol:
            raise AssertionError(f"the ControlNet changes the output by only "
                                 f"{gap}")
        if not (ran["full_group_norm"] and ran["small_kv_attention"]):
            raise AssertionError("the reference call ran no GroupNorm or "
                                 "small-KV kernel")
    del cpu_unet, cpu_cn


def small_kv_blocks(unet, latent: int) -> int:
    """Attentions of one unmerged UNet call at a latent x latent input that
    the dispatch sends to the small-KV kernel: every cross-attention (77
    keys) and the self-attentions over at most SMALL_KV tokens."""
    from vidtome_torch.models.layers import TransformerBlock
    from vidtome_torch.ops.attention import SMALL_KV

    blocks = [m for m in unet.modules() if isinstance(m, TransformerBlock)]
    return sum(1 + ((latent // b.downsample) ** 2 <= SMALL_KV)
               for b in blocks)


def phase_pnp(dev, bundle) -> dict:
    from vidtome_torch.models.layers import TransformerBlock
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = pnp_config()
    frames = make_frames()
    inverter = Inverter(bundle, cfg)
    generator = Generator(bundle, cfg)
    times = {}
    stage = functools.partial(timed, times)

    reset_launches()
    latents, conds = stage("encode", lambda: inverter.encode(frames))
    enc = read_launches()
    inverted = stage("invert", lambda: inverter.ddim_inversion(latents, conds))
    inv_launches = {k: v - enc[k] for k, v in read_launches().items()}
    generator.configure_frames(N_FRAMES)
    name, prompt = next(iter(generator.prompt.items()))
    context = stage("text", lambda: generator.context(prompt))
    table = generator.fidx_table()
    pad = torch.as_tensor(generator.pad_src, device=dev)
    src = inverter.source_table(generator.scheduler.timesteps)[:, pad]
    gen_before = read_launches()
    clean = stage("generate", lambda: generator.ddim_sample(
        inverted[pad], context, fidx_table=table, src_table=src))
    gen_launches = {k: v - gen_before[k] for k, v in read_launches().items()}
    out = stage("decode", lambda: generator.vae.decode(clean[:N_FRAMES]))
    launches = read_launches()

    n_blocks = sum(isinstance(m, TransformerBlock)
                   for m in bundle.unet.modules())
    inv_calls = sum(inverter.unet_calls.values())
    gen_calls = sum(v for k, v in generator.unet_calls.items()
                    if k != "eps_skip")
    want_small = inv_calls * small_kv_blocks(bundle.unet, SIZE // 8)
    print(f"[pnp] SD2.1, {N_FRAMES} frames {SIZE}x{SIZE}, {PNP_STEPS}+"
          f"{PNP_STEPS} DDIM steps, {table.shape[1]} chunks x 3 lanes, "
          f"configs/dog.yaml keys, sublayer_mode fused; steps with attention "
          f"injection {generator.pnp_attn_steps}, with conv injection "
          f"{generator.pnp_conv_steps}; {n_blocks} transformer blocks")
    print(f"[pnp] UNet calls: inversion {dict(inverter.unet_calls)}, "
          f"generation {dict(generator.unet_calls)}; small-KV launches in "
          f"the inversion {inv_launches['small_kv_attention']} (want "
          f"{want_small}); sublayer launches in the generation "
          f"{gen_launches['fused_cross_sublayer']} (want {n_blocks} x "
          f"{gen_calls})")
    if table.shape[1] != 2 or generator.num_lanes != 3:
        raise AssertionError("expected 2 chunks of 3 lanes")
    if inv_launches["small_kv_attention"] != want_small:
        raise AssertionError("small-KV launches differ from the inversion's "
                             "UNet calls x routed attentions")
    if gen_launches["fused_cross_sublayer"] != n_blocks * gen_calls:
        raise AssertionError("sublayer launches differ from 16 per "
                             "generation UNet call")
    if (inv_launches["fused_cross_sublayer"] or launches["fused_resnet"]
            or launches["group_norm"]):
        raise AssertionError("a kernel outside this path launched")
    for k in ("flash_attention", "full_group_norm", "best_match",
              "small_kv_attention"):
        if gen_launches[k] <= 0:
            raise AssertionError(f"{k} kernel never launched in the PnP "
                                 f"generation")
    if tuple(out.shape) != (N_FRAMES, SIZE, SIZE, 3):
        raise AssertionError(f"frames shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("PnP frames not finite or outside [0, 1]")
    if not torch.isfinite(inverted).all():
        raise AssertionError("inverted latents not finite")
    print(f"[pnp] frames mean {out.mean().item():.4f} std "
          f"{out.std().item():.4f}; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    print(f"[pnp] kernel launches in this run: {launches}")
    return launches


def profiled_device_ms(fn) -> float | None:
    """Device milliseconds summed over the kernels of one call of ``fn``
    (torch.profiler, after a warm-up call); None where the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the kernels' own entries (a launching op's entry repeats their time)
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 if us > 0 else None


def phase_pnp_call(dev, bundle) -> None:
    """One SD2.1 PnP generation UNet call (3 lanes x 4 frames at a 64x64
    latent, both injections on, no merging) with sublayer_mode fused and
    off, in turns (fused, off, off, fused): its device time summed over its
    kernels (torch.profiler) and its time through the call (CUDA events,
    the host's gaps included)."""
    rng = np.random.default_rng(3)
    width = bundle.unet.config.cross_attention_dim
    x = torch.from_numpy(rng.standard_normal((12, 64, 64, 4), np.float32))
    ctx = torch.from_numpy(rng.standard_normal((12, 77, width), np.float32))
    x, ctx = x.to(dev, torch.bfloat16), ctx.to(dev, torch.bfloat16)
    device, wall = {}, {}
    with torch.inference_mode():
        for mode in ("fused", "off", "off", "fused"):
            def call(mode=mode):
                return bundle.unet(x, 501, ctx, sublayer_mode=mode,
                                   attn_inject=True, conv_inject=True,
                                   num_lanes=3)
            try:
                device.setdefault(mode, []).append(profiled_device_ms(call))
            except Exception as exc:  # a measurement only: say so, go on
                print(f"[pnp] device time not measured ({exc!r})")
                device.setdefault(mode, []).append(None)
            wall.setdefault(mode, []).append(cuda_time(call, 3))
    print(f"[pnp] one SD2.1 PnP generation UNet call [12,64,64,4], 3 "
          f"lanes, injections on, no merging: device ms (torch.profiler, "
          f"summed over its kernels) fused {device['fused']}, off "
          f"{device['off']}; through the call (CUDA events) fused "
          f"{[round(v, 3) for v in wall['fused']]}, off "
          f"{[round(v, 3) for v in wall['off']]}")


def phase_reference_sd21(dev, bundle) -> None:
    """SD2.1 weights, one UNet call at an 8x8 latent with 3 lanes, both PnP
    injections on and sublayer_mode="fused": bf16 kernels on the card vs
    fp32 plain versions on the CPU; injections off must differ."""
    rng = np.random.default_rng(2)
    width = bundle.unet.config.cross_attention_dim
    x = torch.from_numpy(rng.standard_normal((3, 8, 8, 4), np.float32))
    ctx = torch.from_numpy(rng.standard_normal((3, 77, width), np.float32))
    cpu = copy.deepcopy(bundle.unet).to("cpu", torch.float32)
    with torch.inference_mode():
        def run(m, d, inject):
            return m(x.to(d), 501, ctx.to(d), sublayer_mode="fused",
                     attn_inject=inject, conv_inject=inject,
                     num_lanes=3).float().cpu()

        before = counters()["fused_cross_sublayer"].launches
        got = run(bundle.unet, dev, True)
        if counters()["fused_cross_sublayer"].launches == before:
            raise AssertionError("the reference call ran no sublayer kernel")
        want = run(cpu, "cpu", True)
        off = run(cpu, "cpu", False)
    scale = want.abs().max()
    err = ((got - want).abs().max() / scale).item()
    gap = ((off - want).abs().max() / scale).item()
    print(f"[reference] SD2.1 weights, 64x64 input, 3 lanes, injections on, "
          f"sublayer fused: card bf16 kernels vs CPU fp32 plain max rel err "
          f"{err:.2e} (tol {REF_TOL}); injections off vs on {gap:.2e} (must "
          f"exceed {REF_TOL})")
    if not err < REF_TOL:
        raise AssertionError(f"SD2.1 card vs CPU reference rel err {err}")
    if not gap > REF_TOL:
        raise AssertionError(f"PnP injections change the output by only "
                             f"{gap}")
    del cpu


def load_yaml(name: str) -> dict:
    import yaml

    with open(ROOT / "configs" / name) as f:
        return yaml.safe_load(f)


def stage_chain(names, steps: int) -> dict:
    """The inversion and generation keys of ``names`` (a base_config chain,
    base first) merged in order, the first edit prompt only, at ``steps``
    DDIM steps."""
    chain = [load_yaml(n) for n in names]
    cfg = {"seed": next(c["seed"] for c in chain[::-1] if "seed" in c),
           "float_precision": "bf16"}
    for stage in ("inversion", "generation"):
        cfg[stage] = {k: v for layer in chain
                      for k, v in (layer.get(stage) or {}).items()}
    name, prompt = next(iter(cfg["generation"]["prompt"].items()))
    cfg["generation"].update(prompt={name: prompt}, n_timesteps=steps)
    cfg["inversion"].update(steps=steps, save_steps=steps)
    return cfg


def flamingo_config() -> dict:
    """configs/flamingo.yaml's keys over default.yaml's (its base_config):
    chunk_ord rand, local 0.9 / global 0.9 merging, an empty negative
    prompt, seed 142857, at DEPTH_STEPS DDIM steps."""
    return stage_chain(("default.yaml", "flamingo.yaml"), DEPTH_STEPS)


def breakdance_config(lora_path: str | None) -> dict:
    """configs/breakdance.yaml's keys over default.yaml's: the softedge
    ControlNet at control_scale 0.4, global 0.6 / global_rand 0.5 merging,
    at LORA_STEPS DDIM steps; use_lora with the adapter at ``lora_path``
    (None: without it)."""
    cfg = stage_chain(("default.yaml", "breakdance.yaml"), LORA_STEPS)
    gene = cfg["generation"]
    gene["use_lora"] = lora_path is not None
    gene["lora"] = {"path": lora_path, "weight": 1.0} if lora_path else {}
    return cfg


def he_init(module, seed: int):
    """He-normal convolution weights and zero biases, from a torch seed (a
    random control net in its checkpoint layout)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim == 4:
                p.copy_(torch.randn(p.shape, generator=gen)
                        * (2.0 / p[0].numel()) ** 0.5)
            else:
                p.zero_()
    return module


def write_control_nets(out_dir: str) -> dict:
    """Random HED, lineart and pose nets (seeded) as .pth checkpoints under
    ``out_dir``; {control: (variable, path)}.  A random pose net's heatmaps
    put about a thousand peaks a 512x512 frame on unrelated parts, so its
    last heatmap layer gives every part channel 0's weights, with the bias
    that puts the peak threshold (0.1) at the 99th percentile of the first
    smoke frame's map, and its last PAF layer a field pointing down and
    right (weights x 0.1, bias 0.6): the peaks then connect into a bounded
    number of people."""
    from vidtome_torch.control import pose as pose_mod
    from vidtome_torch.control.edge_hed import HEDNetwork
    from vidtome_torch.control.lineart import UnetGenerator
    from vidtome_torch.control.pose import BodyPoseModel

    hed = he_init(HEDNetwork(), 11)
    pose = he_init(BodyPoseModel(), 13).eval()
    with torch.no_grad():
        hed.norm.copy_(torch.tensor([104.0, 117.0, 123.0]).reshape(1, 3, 1, 1))
        heat, paf = pose.Mconv7_stage6_L2, pose.Mconv7_stage6_L1
        heat.weight.copy_(heat.weight[:1].expand_as(heat.weight))
        heat.bias.zero_()
        paf.weight.mul_(0.1)
        paf.bias.fill_(0.6)

        def fwd(x):
            p, h = pose(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
            return (p.permute(0, 2, 3, 1).numpy(),
                    h.permute(0, 2, 3, 1).numpy())

        frame = make_frames()[0]
        bgr = (np.clip(frame, 0, 1) * 255).astype(np.uint8)[:, :, ::-1]
        heat_map, _ = pose_mod.infer_maps(bgr, fwd)
        heat.bias.fill_(float(0.1 - np.quantile(heat_map[..., 0], 0.99)))
    nets = {"softedge": ("VIDTOME_HED_MODEL", hed, "ControlNetHED.pth"),
            "lineart_anime": ("VIDTOME_LINEART_MODEL",
                              he_init(UnetGenerator(), 12), "netG.pth"),
            "openpose": ("VIDTOME_POSE_MODEL", pose, "body_pose_model.pth")}
    out = {}
    for control, (env, net, name) in nets.items():
        path = os.path.join(out_dir, name)
        torch.save(net.state_dict(), path)
        out[control] = (env, path)
    return out


def phase_control_models(dev, nets: dict) -> None:
    """control_preprocess for softedge, lineart_anime and openpose through
    the random nets of ``nets`` (write_control_nets), the 8 smoke frames at
    512x512 on the card against the same on the CPU: HED's safe_step
    pixels may differ on HED_SHARE_TOL of them, lineart's maps by
    LINEART_CARD_TOL, the pose detector must find the same peaks and people
    (scores to POSE_SCORE_RTOL) and draw the same images.  Prints each net's
    ms per frame on the card (its forward alone, CUDA events) and the whole
    preprocess's wall per frame on both."""
    from vidtome_torch.control import edge_hed, lineart, loading, pose
    from vidtome_torch.control.preprocess import control_preprocess

    frames = make_frames()
    loaders = {"softedge": ("hed", edge_hed.load_hed),
               "lineart_anime": ("lineart", lineart.load_lineart),
               "openpose": ("pose", pose.load_pose)}
    inputs = {  # one forward's input on the card, as the preprocessor feeds
        "softedge": (N_FRAMES, 3, SIZE, SIZE),
        "lineart_anime": (1, 3, SIZE, SIZE),
        "openpose": (1, 3, 184, 184)}
    tf32 = torch.backends.cudnn.allow_tf32
    for control, (env, path) in nets.items():
        os.environ[env] = path
        wall = {}
        out = {}
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            out[where] = control_preprocess(frames, control, device=where)
            wall[str(where)] = (time.perf_counter() - t0) * 1e3 / N_FRAMES
        kind, loader = loaders[control]
        model = loading.cached_model(kind, path, dev, loader)
        x = torch.rand(inputs[control], device=dev)
        with torch.inference_mode(), loading.exact_fp32():
            net_ms = cuda_time(lambda: model(x), 3) / inputs[control][0]
        card, cpu = out[dev], out["cpu"]
        if card.shape != (N_FRAMES, SIZE, SIZE, 3) or card.shape != cpu.shape:
            raise AssertionError(f"{control}: control images {card.shape}")
        if control == "softedge":
            share = float((card != cpu).mean())
            what = (f"safe_step pixels that differ {share:.2e} (tol "
                    f"{HED_SHARE_TOL}); levels "
                    f"{sorted(float(v) for v in np.unique(card))}")
            ok = share <= HED_SHARE_TOL and len(np.unique(card)) > 1
        elif control == "lineart_anime":
            err = float(np.abs(card - cpu).max())
            what = (f"max |card - CPU| {err:.2e} (tol {LINEART_CARD_TOL}); "
                    f"mean {card.mean():.4f} std {card.std():.4f}")
            ok = err < LINEART_CARD_TOL and card.std() > 0.01
        else:
            fwd = {w: pose.pose_forward(path, w) for w in (dev, "cpu")}
            bgr = (np.clip(frames, 0, 1) * 255).astype(np.uint8)[..., ::-1]
            lists = [[pose.detect(f, fwd[w]) for f in bgr]
                     for w in (dev, "cpu")]
            same = all(pose.pose_difference(a, b, POSE_SCORE_RTOL) is None
                       for a, b in zip(*lists))
            peaks = [sum(len(p) for p in pl[0]) for pl in lists[0]]
            people = [len(pl[4]) for pl in lists[0]]
            what = (f"peaks a frame {peaks}, people {people}; same peaks "
                    f"and people on both {same}; drawn images equal "
                    f"{np.array_equal(card, cpu)}")
            ok = (same and np.array_equal(card, cpu) and sum(people) > 0
                  and max(peaks) < 1000)
        print(f"[control] {control} ({kind} net, random, {N_FRAMES} frames "
              f"{SIZE}x{SIZE}): {what}; net forward {net_ms:.3f} ms a frame "
              f"on the card; preprocess wall {wall[str(dev)]:.1f} ms a frame "
              f"(card), {wall['cpu']:.1f} (CPU)")
        if not ok:
            raise AssertionError(f"{control}: the card's control images "
                                 f"disagree with the CPU's")
    if torch.backends.cudnn.allow_tf32 != tf32:
        raise AssertionError("the control nets left TF32 switched")


def lora_targets(bundle) -> list[tuple[str, str, torch.nn.Module]]:
    """(kohya prefix, module name, module) of every attention projection,
    resnet conv and time_emb_proj of the UNet, and the text encoder's
    q/k/v/out projections."""
    import re

    from torch import nn

    unet_re = re.compile(r"(attn[12]\.(to_q|to_k|to_v|to_out\.0)|resnets\.\d+"
                         r"\.(conv1|conv2|conv_shortcut|time_emb_proj))$")
    text_re = re.compile(r"self_attn\.(q_proj|k_proj|v_proj|out_proj)$")
    out = []
    for prefix, root, pat in (("lora_unet_", bundle.unet, unet_re),
                              ("lora_te_", bundle.text_encoder, text_re)):
        for name, mod in root.named_modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)) and pat.search(name):
                out.append((prefix, name, mod))
    return out


def write_lora(bundle, path: str, seed: int = 7) -> dict:
    """A kohya LoRA of rank LORA_RANK, alpha LORA_ALPHA over
    lora_targets(bundle), from a torch seed, written with the port's
    safetensors writer; returns {module: fp32 delta on the card} with the
    delta alpha / rank * up @ down in the module's layout."""
    from vidtome_torch.io.safetensors import save_file

    gen = torch.Generator().manual_seed(seed)
    state, deltas = {}, {}
    for prefix, name, mod in lora_targets(bundle):
        w = mod.weight
        fan_in = w[0].numel()
        down = torch.randn((LORA_RANK,) + tuple(w.shape[1:]),
                           generator=gen) / fan_in ** 0.5
        up = torch.randn((w.shape[0], LORA_RANK) + (1, 1) * (w.ndim == 4),
                         generator=gen) * 0.25
        base = prefix + name.replace(".", "_")
        state[f"{base}.lora_down.weight"] = down
        state[f"{base}.lora_up.weight"] = up
        state[f"{base}.alpha"] = torch.tensor(LORA_ALPHA)
        delta = (up.reshape(w.shape[0], LORA_RANK)
                 @ down.reshape(LORA_RANK, -1)).reshape(w.shape)
        deltas[mod] = (delta * (LORA_ALPHA / LORA_RANK)).to(w.device)
    save_file(state, path)
    return deltas


def unet_call_want(unet) -> dict:
    """The launches of one UNet call at the smoke frames' latent, by the
    topology: flash for the self-attentions over more than SMALL_KV tokens,
    small-KV for the rest and every cross-attention, the full GroupNorm
    entry for all 61 GroupNorms; best match (2 or 4 a generation call) is
    left at 0."""
    from vidtome_torch.models.layers import TransformerBlock
    from vidtome_torch.ops.attention import SMALL_KV

    blocks = [m for m in unet.modules() if isinstance(m, TransformerBlock)]
    latent = SIZE // 8
    want = {k: 0 for k in KERNELS}
    want.update(flash_attention=sum((latent // b.downsample) ** 2 > SMALL_KV
                                    for b in blocks),
                full_group_norm=61,
                small_kv_attention=small_kv_blocks(unet, latent))
    return want


def phase_lora(dev, bundle) -> dict:
    """configs/breakdance.yaml on SD1.5 with a synthetic kohya LoRA (random
    softedge ControlNet, its zero convs moved, the softedge images through
    the random HED net when VIDTOME_HED_MODEL is set): the generation
    without the adapter, then with it merged on load by the Generator; the
    merged weights must be W + delta within two bf16 roundings, each UNet
    and ControlNet call of the LoRA generation must launch what the same
    call of the plain one did (``LaunchesPerCall``), which the topology
    gives, and the edit must change; then the int8 table of a LoRA
    generator must quantize the merged weights."""
    from vidtome_torch.ops.quant import quantize_weight
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    perturb_controlnet(bundle.controlnet)
    frames = make_frames()
    frame_ids = list(range(N_FRAMES))
    times = {}
    stage = functools.partial(timed, times)
    unet_calls = LaunchesPerCall(bundle.unet)
    cn_calls = LaunchesPerCall(bundle.controlnet)
    try:
        with tempfile.TemporaryDirectory() as work_dir:
            lora_path = os.path.join(work_dir, "pixelart.safetensors")
            deltas = write_lora(bundle, lora_path)
            cfg_plain, cfg_lora = (breakdance_config(None),
                                   breakdance_config(lora_path))
            inverter = Inverter(bundle, cfg_plain)
            plain = Generator(bundle, cfg_plain)
            # the weights as the stages run them, before the merge
            saved = {m: m.weight.detach().clone() for m in deltas}
            reset_launches()
            latents, conds = stage("encode", lambda: inverter.encode(frames))
            inverted = stage("invert", lambda: inverter.ddim_inversion(
                latents, conds))
            plain.configure_frames(N_FRAMES)
            pad = torch.as_tensor(plain.pad_src, device=dev)
            control = stage("control", lambda: plain.load_control(
                frames, frame_ids, work_dir))
            name, prompt = next(iter(plain.prompt.items()))
            table = plain.fidx_table()
            marks = [(len(unet_calls.calls), len(cn_calls.calls))]
            out_plain = stage("generate_plain", lambda: plain.vae.decode(
                plain.ddim_sample(inverted[pad], plain.context(prompt),
                                  fidx_table=table,
                                  control=control[pad])[:N_FRAMES]))
            marks.append((len(unet_calls.calls), len(cn_calls.calls)))
            generator = stage("merge", lambda: Generator(bundle, cfg_lora))
            errs = []
            for mod, delta in deltas.items():
                want = saved[mod].float() + delta
                got = mod.weight.detach().float()
                # the delta rounded to bf16, then the sum: two bf16
                # roundings (2^-9 relative each), bounded here by twice
                # their sum
                tol = 2.0 ** -8 * (delta.abs() + want.abs())
                errs.append(((got - want).abs() - tol).max())
            excess = torch.stack(errs).max().item()
            generator.configure_frames(N_FRAMES)
            marks.append((len(unet_calls.calls), len(cn_calls.calls)))
            out = stage("generate", lambda: generator.vae.decode(
                generator.ddim_sample(inverted[pad], generator.context(prompt),
                                      fidx_table=table,
                                      control=control[pad])[:N_FRAMES]))
            marks.append((len(unet_calls.calls), len(cn_calls.calls)))
            launches = read_launches()

            # int8: the unmerged weights back (the bundle then holds no
            # LoRA), then a LoRA generator in int8
            with torch.no_grad():
                for mod, w in saved.items():
                    mod.weight.copy_(w)
            bundle.lora = None
            int8 = Generator(bundle, {**cfg_lora, "generation": {
                **cfg_lora["generation"], "quant": "int8"}})
            probe = bundle.unet.get_submodule(LORA_PROBE)
            entry = int8.qt.get(probe)
            q, scale = quantize_weight(probe.weight)
            deq = entry.weight.float() * entry.scale.reshape(-1, 1)
            w0 = saved[probe].float()
            merged = w0 + deltas[probe]
            d_merged = (deq - merged).abs().mean().item()
            d_plain = (deq - w0).abs().mean().item()
            int8_ok = (torch.equal(entry.weight, q)
                       and torch.equal(entry.scale, scale)
                       and d_merged < d_plain)
    finally:
        unet_calls.close()
        cn_calls.close()

    # each generation's own UNet and ControlNet calls, by the marks
    (u0, c0), (u1, c1), (u2, c2), (u3, c3) = marks
    plain_unet, lora_unet = unet_calls.calls[u0:u1], unet_calls.calls[u2:u3]
    plain_cn, lora_cn = cn_calls.calls[c0:c1], cn_calls.calls[c2:c3]
    n_calls = sum(generator.unet_calls.values())
    want = unet_call_want(bundle.unet)
    want_cn = {k: CONTROLNET_LAUNCHES.get(k, 0) for k in KERNELS}
    odd_unet = [i for i, c in enumerate(lora_unet)
                if c != plain_unet[i] or {**c, "best_match": 0} != want]
    odd_cn = [i for i, c in enumerate(lora_cn)
              if c != plain_cn[i] or c != want_cn]
    best = sum(c["best_match"] for c in lora_unet)
    kinds = {}
    for c in lora_unet:
        kinds.setdefault(f"best_match {c['best_match']}", c)
    diff = (out.float() - out_plain.float()).abs()
    mse = (diff ** 2).mean().item()
    psnr = float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)
    n_text = sum(1 for p, _, _ in lora_targets(bundle) if p == "lora_te_")
    print(f"[lora] SD1.5 + softedge ControlNet (random, zero convs moved) + "
          f"a synthetic kohya LoRA (rank {LORA_RANK}, alpha {LORA_ALPHA}: "
          f"{len(deltas) - n_text} UNet and {n_text} text-encoder modules), "
          f"{N_FRAMES} frames {SIZE}x{SIZE}, {LORA_STEPS}+{LORA_STEPS} DDIM "
          f"steps, configs/breakdance.yaml keys (global "
          f"{generator.tome.global_merge_ratio}, global_rand "
          f"{generator.tome.global_rand}, control_scale "
          f"{generator.control_scale}); UNet calls {dict(generator.unet_calls)}")
    print(f"[lora] merged weights - (W + delta): largest excess over two bf16 "
          f"roundings {excess:.3e} (must be <= 0)")
    print(f"[lora] launches per UNet call of the LoRA generation by kind: "
          f"{kinds} (want {want} besides best_match); per ControlNet call "
          f"{lora_cn[0] if lora_cn else None} (want {CONTROLNET_LAUNCHES}); "
          f"{len(lora_unet)} UNet and {len(lora_cn)} ControlNet calls with "
          f"the LoRA, {len(plain_unet)} and {len(plain_cn)} without; calls "
          f"that differ from the plain generation's call at the same index "
          f"or from the topology: {len(odd_unet)} UNet, {len(odd_cn)} "
          f"ControlNet; best_match {best} over {len(lora_unet)} calls")
    print(f"[lora] frames with vs without the LoRA: max |diff| "
          f"{diff.max().item():.4f}, PSNR {psnr:.2f} dB (must differ); "
          f"stage seconds " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in times.items()))
    print(f"[lora] int8 table of a LoRA generator at {LORA_PROBE} "
          f"{tuple(probe.weight.shape)}: equals the quantized merged weight "
          f"{torch.equal(entry.weight, q)}; mean |dequantized - (W + delta)| "
          f"{d_merged:.3e}, |dequantized - W| {d_plain:.3e}")
    if not excess <= 0:
        raise AssertionError(f"LoRA merge off W + delta by {excess}")
    if not (len(lora_unet) == len(plain_unet) == n_calls
            and len(lora_cn) == len(plain_cn) == n_calls):
        raise AssertionError("the generations' UNet and ControlNet calls "
                             "differ in number")
    if odd_unet or odd_cn or best != 3 * n_calls:
        raise AssertionError(
            f"LoRA generation launches per call differ from the plain "
            f"generation's or the topology's: UNet calls {odd_unet[:3]}, "
            f"ControlNet calls {odd_cn[:3]}, best_match {best}")
    if not diff.max().item() > 0.05:
        raise AssertionError("the LoRA does not change the edit")
    if not int8_ok:
        raise AssertionError("the int8 table was not built from the merged "
                             "weights")
    if tuple(out.shape) != (N_FRAMES, SIZE, SIZE, 3) or not (
            torch.isfinite(out).all() and 0 <= out.min() and out.max() <= 1):
        raise AssertionError("LoRA frames not finite or outside [0, 1]")
    print(f"[lora] kernel launches in this run: {launches}")
    return launches


def phase_depth(dev, bundle) -> dict:
    """configs/flamingo.yaml on SD2-depth, 50+50 DDIM steps, the proxy
    depth through the depth cache in a temporary work_dir: every UNet call
    of each kind must launch flash, small-KV and the full GroupNorm entry
    as the topology says (and best match 2 or 4 times a generation call,
    3 on average)."""
    from vidtome_torch.pipeline.common import stage_depth
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = flamingo_config()
    frames = make_frames()
    frame_ids = list(range(N_FRAMES))
    times = {}
    stage = functools.partial(timed, times)
    per_call = LaunchesPerCall(bundle.unet)
    try:
        with tempfile.TemporaryDirectory() as work_dir:
            cfg["work_dir"] = work_dir
            inverter = Inverter(bundle, cfg)
            generator = Generator(bundle, cfg)
            reset_launches()
            latents, conds = stage("encode", lambda: inverter.encode(frames))
            depth = stage("depth", lambda: stage_depth(
                bundle, frames, frame_ids, work_dir))
            cached = sorted(os.listdir(os.path.join(work_dir, "depth")))
            inverted = stage("invert", lambda: inverter.ddim_inversion(
                latents, conds, depth=depth))
            n_inv = len(per_call.calls)
            generator.configure_frames(N_FRAMES)
            pad = torch.as_tensor(generator.pad_src, device=dev)
            depth_gen = stage_depth(bundle, frames, frame_ids, work_dir)
            name, prompt = next(iter(generator.prompt.items()))
            context = stage("text", lambda: generator.context(prompt))
            table = generator.fidx_table()
            clean = stage("generate", lambda: generator.ddim_sample(
                inverted[pad], context, fidx_table=table,
                depth=depth_gen[pad]))
            out = stage("decode",
                        lambda: generator.vae.decode(clean[:N_FRAMES]))
            launches = read_launches()
    finally:
        per_call.close()

    want = unet_call_want(bundle.unet)
    inv_calls, gen_calls = per_call.calls[:n_inv], per_call.calls[n_inv:]
    odd_inv = [c for c in inv_calls if c != want]
    odd_gen = [c for c in gen_calls
               if {**c, "best_match": 0} != want or c["best_match"] not in (2, 4)]
    best = sum(c["best_match"] for c in gen_calls)
    kinds = {"inversion": inv_calls[0] if inv_calls else None}
    for c in gen_calls:
        kinds.setdefault(f"generation, best_match {c['best_match']}", c)
    print(f"[depth] SD2-depth (random), {N_FRAMES} frames {SIZE}x{SIZE}, "
          f"{DEPTH_STEPS}+{DEPTH_STEPS} DDIM steps, {table.shape[1]} chunks, "
          f"configs/flamingo.yaml keys (chunk_ord {generator.chunk_ord}, "
          f"local {generator.tome.local_merge_ratio}, global "
          f"{generator.tome.global_merge_ratio}, seed {generator.seed}); "
          f"depth latents {tuple(depth.shape)} in [{depth.min().item():.2f}, "
          f"{depth.max().item():.2f}], {len(cached)} cache files; UNet calls "
          f"inversion {dict(inverter.unet_calls)}, generation "
          f"{dict(generator.unet_calls)}")
    print(f"[depth] launches per UNet call by kind: {kinds} (want {want} "
          f"besides best_match; {len(odd_inv)} inversion and {len(odd_gen)} "
          f"generation calls differ); best_match {best} over {len(gen_calls)} "
          f"generation calls")
    if not (inverter.bundle.use_depth and generator.use_depth):
        raise AssertionError("a stage runs without the depth channel")
    if bundle.unet.conv_in.in_channels != 5 or table.shape[1] != 2:
        raise AssertionError("expected a 5-channel UNet and 2 chunks")
    if cached != sorted(f"{i:04}.{e}" for i in frame_ids
                        for e in ("npy", "png")):
        raise AssertionError(f"depth cache files {cached}")
    if not torch.equal(depth_gen, depth):
        raise AssertionError("the generation's depth differs from the cache")
    if odd_inv or odd_gen or best != 3 * len(gen_calls):
        raise AssertionError(f"SD2-depth launches per UNet call differ from "
                             f"{want}: {(odd_inv or odd_gen or [None])[0]}")
    if len(inv_calls) != sum(inverter.unet_calls.values()) or len(
            gen_calls) != sum(generator.unet_calls.values()):
        raise AssertionError("UNet calls counted twice or missed")
    if tuple(out.shape) != (N_FRAMES, SIZE, SIZE, 3):
        raise AssertionError(f"frames shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("SD2-depth frames not finite or outside [0, 1]")
    if not torch.isfinite(inverted).all():
        raise AssertionError("SD2-depth inverted latents not finite")
    print(f"[depth] frames mean {out.mean().item():.4f} std "
          f"{out.std().item():.4f}; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    print(f"[depth] kernel launches in this run: {launches}")
    return launches


def phase_depth_reference(dev, bundle) -> None:
    """One SD2-depth UNet call at an 8x8 latent (4 latent channels and a
    depth channel in [-1, 1]): card bf16 kernels vs CPU fp32 plain versions
    to REF_TOL; the same call with the depth channel zeroed must differ by
    more than REF_TOL."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    x[..., 4] = rng.uniform(-1, 1, (2, 8, 8))
    flat = x.copy()
    flat[..., 4] = 0.0
    ctx = rng.standard_normal((2, 77, 1024)).astype(np.float32)
    cpu = copy.deepcopy(bundle.unet).to("cpu", torch.float32)
    with torch.inference_mode():
        def run(m, d, inp):
            return m(torch.from_numpy(inp).to(d), 501,
                     torch.from_numpy(ctx).to(d)).float().cpu()

        before = read_launches()
        got = run(bundle.unet, dev, x)
        ran = {k: v - before[k] for k, v in read_launches().items()}
        want = run(cpu, "cpu", x)
        zero = run(cpu, "cpu", flat)
    scale = want.abs().max()
    err = ((got - want).abs().max() / scale).item()
    gap = ((zero - want).abs().max() / scale).item()
    print(f"[reference] SD2-depth weights, 64x64 input, 5 channels: card bf16 "
          f"kernels vs CPU fp32 plain max rel err {err:.2e} (tol {REF_TOL}); "
          f"depth channel zeroed vs not {gap:.2e} (must exceed {REF_TOL}); "
          f"kernels launched on the card {ran}")
    if not err < REF_TOL:
        raise AssertionError(f"SD2-depth card vs CPU reference rel err {err}")
    if not gap > REF_TOL:
        raise AssertionError(f"the depth channel changes the output by only "
                             f"{gap}")
    if not (ran["full_group_norm"] and ran["small_kv_attention"]):
        raise AssertionError("the reference call ran no GroupNorm or small-KV "
                             "kernel")
    del cpu


def write_cli_inputs(out_dir: str) -> None:
    """Inputs of the CLI runs of this slice's configs on data/demo.mp4
    (neither data/flamingo.mp4 nor data/breakdance.mp4 is shipped):
    <out_dir>/flamingo.yaml and breakdance.yaml (base_config the shipped
    config, 16 frames, outputs under out_dir), the breakdance LoRA
    (a synthetic kohya file over the SD1.5 stack, seeded) and random
    control nets (write_control_nets; VIDTOME_HED_MODEL=<out_dir>/
    ControlNetHED.pth runs breakdance's softedge through HED)."""
    import types

    import yaml

    from vidtome_torch.models.clip_text import SD15_TEXT, CLIPTextModel
    from vidtome_torch.models.unet import SD15_UNET, UNet2DConditionModel

    os.makedirs(out_dir, exist_ok=True)
    out = os.path.abspath(out_dir)
    with torch.device("meta"):  # the LoRA needs the modules' shapes only
        stack = types.SimpleNamespace(unet=UNet2DConditionModel(SD15_UNET),
                                      text_encoder=CLIPTextModel(SD15_TEXT))
    lora = os.path.join(out, "pixelart.safetensors")
    write_lora(stack, lora)
    write_control_nets(out)
    for name, extra in (("flamingo", {}),
                        ("breakdance", {"lora": {"path": lora,
                                                 "weight": 1.0}})):
        cfg = {"base_config": f"configs/{name}.yaml",
               "input_path": "data/demo.mp4",
               "work_dir": os.path.join(out, name),
               "generation": {"frame_range": [16], "save_frame": True,
                              **extra}}
        with open(os.path.join(out, f"{name}.yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
    print(f"[cli] configs, LoRA and control nets written to {out}")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--cli-inputs"] and len(argv) == 2:
        write_cli_inputs(argv[1])
        return 0
    if argv:
        print("usage: python3 chip_smoke.py [--cli-inputs DIR]",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name, _ = phase_device()
    phase_build(dev)
    torch.cuda.synchronize()
    stats = phase_kernels(dev)
    torch.cuda.synchronize()

    from vidtome_torch.models.registry import init_model

    t0 = time.perf_counter()
    bundle = init_model("1.5", weight_dtype="bf16", device=dev, seed=0,
                        control="canny")
    torch.cuda.synchronize()
    print(f"[main] SD1.5 and a canny ControlNet, random weights, on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    exact = phase_main_path(dev, bundle)
    torch.cuda.synchronize()
    phase_reference(dev, bundle)
    torch.cuda.synchronize()
    launches = phase_serving(dev, bundle)
    torch.cuda.synchronize()
    int8 = phase_int8(dev, bundle)
    torch.cuda.synchronize()
    phase_int8_reference(dev, bundle)
    torch.cuda.synchronize()
    controlnet = phase_controlnet(dev, bundle)
    torch.cuda.synchronize()
    phase_controlnet_reference(dev, bundle)
    torch.cuda.synchronize()

    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bundle = init_model("2.1", weight_dtype="bf16", device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[pnp] SD2.1 random weights on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    pnp = phase_pnp(dev, bundle)
    torch.cuda.synchronize()
    phase_pnp_call(dev, bundle)
    torch.cuda.synchronize()
    phase_reference_sd21(dev, bundle)
    torch.cuda.synchronize()

    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as nets_dir:
        nets = write_control_nets(nets_dir)
        phase_control_models(dev, nets)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle = init_model("1.5", weight_dtype="bf16", device=dev, seed=0,
                            control="softedge")
        torch.cuda.synchronize()
        print(f"[lora] SD1.5 and a softedge ControlNet, random weights, on "
              f"the card in {time.perf_counter() - t0:.1f} s")
        lora = phase_lora(dev, bundle)
        torch.cuda.synchronize()
        for env, _ in nets.values():
            os.environ.pop(env, None)

    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bundle = init_model("depth", weight_dtype="bf16", device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[depth] SD2-depth random weights on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    depth = phase_depth(dev, bundle)
    torch.cuda.synchronize()
    phase_depth_reference(dev, bundle)
    torch.cuda.synchronize()
    for path in (exact, int8, controlnet, lora, pnp, depth):
        launches = {k: launches[k] + path[k] for k in KERNELS}
    missing = [k for k in KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"never launched on a main path: {missing}")

    sources = {
        "flash_attention": ("cuda", "vidtome_torch/csrc/flash_attention.cu",
                            "vidtome_tpu/ops/attention.py:121"),
        "small_kv_attention": ("cuda",
                               "vidtome_torch/csrc/small_kv_attention.cu",
                               "vidtome_tpu/ops/attention.py:248"),
        "fused_cross_sublayer": ("cuda", "vidtome_torch/csrc/sublayer.cu",
                                 "vidtome_tpu/ops/sublayer.py:165"),
        "group_norm": ("cuda", "vidtome_torch/csrc/group_norm.cu",
                       "vidtome_tpu/ops/groupnorm.py:108"),
        "full_group_norm": ("cuda", "vidtome_torch/csrc/group_norm.cu",
                            "vidtome_tpu/ops/groupnorm.py:212"),
        "fused_resnet": ("cuda", "vidtome_torch/csrc/resnet_bf16.cu",
                         "vidtome_tpu/ops/resnet.py:232"),
        "fused_resnet_w8a8": ("cuda", "vidtome_torch/csrc/resnet_w8a8.cu",
                              "vidtome_tpu/ops/resnet.py:232"),
        "best_match": ("cuda", "vidtome_torch/csrc/matching.cu",
                       "vidtome_tpu/ops/matching.py:72")}
    rows = stats.rows
    print(json.dumps({"kernels": [
        {"name": k, "route": sources[k][0], "source": sources[k][1],
         "replaces": sources[k][2], "launches": launches[k],
         "max_abs_err": rows[k]["err"], "ms": rows[k]["ms"],
         "plain_ms": rows[k]["plain"], "bound_ms": rows[k]["bound"],
         "bound_by": ("bytes" if rows[k]["bytes_ms"] >= rows[k]["ops_ms"]
                      else "operations"),
         "library_ms": rows[k]["library"], "device_ms": rows[k]["device"],
         "library_device_ms": rows[k]["library_device"]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
