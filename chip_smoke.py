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
  9. PnP path: the SD1.5 bundle freed, SD2.1 at full width with random
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
  10. SD2.1 reference check: one UNet call at an 8x8 latent with 3 lanes,
     both injections on and sublayer_mode="fused", card (bf16 kernels) vs
     CPU (fp32 plain); the same call with the injections off must differ
     from it by more than the tolerance.
Then one JSON line with the kernels' numbers (launches: summed over the
exact, serving, int8 and PnP paths, each counted from 0; ms, plain_ms,
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
    (2, 8, 1536, 1536, 80),   # L1 merged self-attention
    (8, 8, 256, 256, 160),    # L2 per frame
    (8, 8, 4096, 77, 40),     # L0 cross-attention against the prompt
    (8, 1, 4096, 4096, 512),  # VAE mid-block attention
    (3, 5, 5120, 5120, 64),   # SD2.1 PnP: L0 merged, 3 lanes
    (3, 5, 6144, 6144, 64),   # SD2.1 PnP: L0 merged (+ global merge)
    (3, 10, 1536, 1536, 64),  # SD2.1 PnP: L1 merged (+ global merge)
    (8, 5, 4096, 4096, 64),   # SD2.1 inversion: L0 per frame
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
]
# launches of each SMALL_KV_SHAPES row per UNet call: SD1.5 (batch 8: every
# SD1.5 path; the 22 are all of its small-KV launches), SD2.1 inversion
# (batch 8) and SD2.1 PnP generation (batch 12, sublayer_mode off, the
# default; under "fused" the sublayer kernel takes the cross-attentions).
# Each of the 16 transformer blocks runs one cross-attention: 5 at each of
# the 64x64, 32x32 and 16x16 levels, 1 in the mid block; the self-attention
# takes the kernel at 16x16 (5) and 8x8 (1).  The SD2.1 columns cover the
# rows listed only (5 and 11 of their 22)
SMALL_KV_LAUNCHES = {
    (8, 5, 4096, 77, 64): {"SD2.1 inversion": 5},
    (12, 5, 4096, 77, 64): {"SD2.1 PnP": 5},
    (12, 20, 256, 256, 64): {"SD2.1 PnP": 5},
    (12, 20, 64, 77, 64): {"SD2.1 PnP": 1},
    (8, 8, 4096, 77, 40): {"SD1.5": 5},
    (8, 8, 1024, 77, 80): {"SD1.5": 5},
    (8, 8, 256, 77, 160): {"SD1.5": 5},
    (8, 8, 256, 256, 160): {"SD1.5": 5},
    (8, 8, 64, 77, 160): {"SD1.5": 1},
    (8, 8, 64, 64, 160): {"SD1.5": 1},
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
    bundle = init_model("1.5", weight_dtype="bf16", device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[main] SD1.5 random weights on the card in "
          f"{time.perf_counter() - t0:.1f} s")
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
    for path in (exact, int8, pnp):
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
    sys.exit(main())
