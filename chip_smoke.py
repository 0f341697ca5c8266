"""Smoke run of the PyTorch/CUDA port (vidtome_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. device: the card's name and power limit;
  2. build: compile the CUDA libraries (flash attention, single-pass
     small-KV attention, the bf16 fused resnet, the W8A8 fused resnet,
     best match, fused cross-attention sublayer, GroupNorm, GEGLU's gate:
     one nvcc each, all started together, sm_90a) from this checkout's
     sources;
  3. kernel vs plain: each of the nine kernels in bf16 against its plain
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
     the port's unfused bf16 chain for the same work device-only.  The
     SDXL phases' and phases 25-33's shapes too: every shape a kernel is
     given by the call kinds of those phases (meta_rows, read by
     ModuleLaunches from forwards on the meta device: the merged levels
     at the lengths each phase's merging gives, the refiner's 96-wide
     heads, the VAE's mid attention at 16384 tokens, the PnP, serving and
     chunk_batch batches), each summed per call of each kind, with
     GN_FP32_ROWS; the W8A8 resnet at the int8 phase's rows only; GEGLU's
     gate at the benchmark cells' rows (GEGLU_SHAPES) and every meta row,
     equal to the eager h * F.gelu(gate) to the bit, through the call and
     device-only beside the eager pair (its library call), the fp32 plain
     version and the bound, summed per call of each path;
  4. exact path: SD1.5 at full width with random weights (seeded), bf16,
     512x512, 8 frames made with numpy: CLIP + VAE encode, DDIM inversion,
     chunked CFG generation with local and global token merging (2 chunks:
     the bank is initialised on one and merged against on the other), VAE
     decode -- through the port's Inverter and Generator; the launch
     counters of the kernels it runs must rise during it, GroupNorm's full
     entry 61 times and best match 3 times a generation UNet call, GEGLU's
     gate 16 times every UNet call;
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
     default.yaml's at CONTROLNET_STEPS+CONTROLNET_STEPS DDIM steps with
     inversion.control: canny, so
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
     LORA_STEPS+LORA_STEPS DDIM steps (the softedge images through the HED
     net of phase
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
     random weights (seeded), configs/flamingo.yaml's keys at
     DEPTH_STEPS+DEPTH_STEPS DDIM
     steps, the proxy depth through the depth cache of a temporary
     work_dir concatenated as the fifth channel in both stages: every UNet
     call must launch flash, small-KV and the full GroupNorm entry as its
     topology says, best match 2 or 4 times a generation call;
  16. SD2-depth reference check: one UNet call at an 8x8 latent, card
     (bf16 kernels) vs CPU (fp32 plain); the depth channel zeroed must
     differ by more than the tolerance;
  17. SDXL path: the SD2-depth bundle freed, SDXL at full width with random
     weights (seeded), bench.py's bench_sdxl keys (sdxl_config: 8 frames
     at 1024x1024, inversion batch 4, chunk 4, local 0.9 / global 0.8, VAE
     batch 2) at SDXL_STEPS+SDXL_STEPS DDIM steps, with a refiner
     (xl-refiner, random, built by the Generator) from step SDXL_SPLIT:
     Generator.sample runs the base, then the refiner.  Every UNet call of
     the inversion, the base stage and the refiner stage must launch what
     SDXL_LAUNCHES says, best match 1 or 2 times a generation call;
     prints the stage seconds (invert, base stage,
     refiner stage, decode) and the device time of one base and one
     refiner UNet call at batch 8 (torch.profiler) beside its time through
     the call;
  18. SDXL reference check: one SDXL and one refiner UNet call at a 16x16
     latent with pooled embeds and time ids, card (bf16 kernels) vs CPU
     (fp32 plain); the pooled embeds zeroed must differ by more than the
     tolerance;
  19. SDXL int8: sdxl_config with bench_sdxl's --int8 (quant: int8 in both
     stages, the refiner's included) and fused resnet blocks in both, under
     VIDTOME_GN_MODE=full: every UNet call must launch the W8A8 resnet once
     per ResnetBlock2D (17 a base call, 22 a refiner call), the GroupNorm
     stats and finalize entries twice per W8A8 launch, the bf16 resnet
     never (sdxl_call_want); then one int8 base and refiner call timed;
  20. SDXL int8 reference check: one int8 base call at a 16x16 latent and
     one int8 refiner call at a 32x32 latent (the smallest at which its
     int8 products have more than 16 rows), card vs CPU (INT8_REF_TOL);
  21. SDXL PnP: control: pnp on the base stage with the fused sublayer (in
     the refiner stage too, which runs control: none), the inversion
     saving every step's latents: every UNet call must launch the sublayer
     once per TransformerBlock (70 a base call, 44 a refiner call) and
     small-KV only where no sublayer runs; then one PnP base call (3 lanes
     x 4 frames) and one refiner call timed;
  22. SDXL PnP reference check: one base call at a 16x16 latent with 3
     lanes, both injections on, sublayer fused, card vs CPU; injections
     off must differ by more than the tolerance;
  23. SDXL serving: bench.py's SDXL serve sidecar keys (SERVE_PROFILES
     ["maxe3xbs"]: the step caches, merging 0.95 / 0.9, fused resnets and
     sublayers) from phase 17's inverted latents, with the refiner: the
     UNet calls per kind of both stages must match the mode tables, and
     every call must launch what its kind gives (full: the bf16 resnet once
     a ResnetBlock2D, the sublayer once a TransformerBlock; shallow: its
     level-0 resnets); then one serving base and refiner call timed;
  24. SDXL LoRA: a synthetic kohya LoRA over the UNet and both text
     encoders (write_lora), merged by a Generator with use_lora into the
     base and offered to its refiner: the merged counts per namespace, a
     probe weight of each namespace at W + delta, the context and pooled
     embeds moved, each UNet call of the LoRA generation launching what
     the plain generation's call at the same index did.
  The SDXL phases (17, 19, 21, 23, 24, 32) and the gated-off generation
  modes (phases 25-29 run on the SD1.5 bundle after phase 10, 30-31 on
  SD2.1 after phase 12, 32-33 on SDXL after phase 23) record every UNet
  call (ModuleLaunches, which phases 9, 14 and 15 read each ControlNet
  and UNet call's launches from): its rows, the launches its module calls
  imply by the wrappers' dispatch, which must be the launches the
  counters saw, and every shape it and the VAE give a kernel, which must
  be a phase-3 row (meta_rows: the same call kinds on the meta device).
  Phases 25-33 each print their stage seconds, their UNet calls per kind
  and the merge statistics of their last step (ToMeConfig.collect_stats:
  per merging block, the tokens attn1 saw against the tokens it was
  given):
  25. chunk_batch serving: bench.py's maxe3xbB (configs/serve.yaml's keys
     plus chunk_batch) on BATCH_FRAMES frames at 512x512, 50+50 steps from
     the serving inversion: every step that runs the UNet makes 2 calls,
     8 rows then 56 (4 and 28 on CFG-skip steps), the calls per kind as
     the mode tables say; then the same keys without chunk_batch (8 calls
     a step, not counted) for its stage seconds, and one step's calls at
     full size, device ms (torch.profiler) and through the call, batched
     and sequential;
  26. chunk_batch reference: a step at a 16x16 latent (a call of 8 rows,
     then one of 16 against its banks repeated per chunk), card (bf16
     kernels, fused resnets) vs CPU (fp32 plain) with the card's
     matchings (reference_steps);
  27. ragged: the exact keys with chunk_boundaries: ragged at 10 and 8
     frames (RAGGED_FRAMES), STEPS+STEPS steps: K = 1 + ceil((n - 1) / 4)
     calls a step of 8 rows (8 frames: 3, in 12 slots), the table the
     host's core/chunk.build_fidx_table, writes to the waste slot, n
     frames out;
  28. LDM on SD1.5: the exact keys with bench.py's --ldm (merge_crossattn,
     merge_ff), STEPS+STEPS steps: the merged cross-attentions a call are
     the merging blocks (10 of 16); then the exact keys with the mean
     merge mode (ToMeConfig.merge_mode, which no config key reaches) from
     the same inversion; one step's calls at full size with and without
     --ldm, device ms and through the call, in turns;
  29. its reference (reference_steps, 16x16);
  30. LDM on SD2.1 PnP: configs/dog.yaml's keys with the fused sublayer and
     --ldm from phase 11's inversion, LDM_PNP_STEPS steps: the sublayer
     launches at the blocks that do not merge (6 a call) and small-KV at
     the merging blocks' cross-attentions and the others' short
     self-attentions (10 + 6), by the topology (ldm_topology);
  31. its reference (3 lanes, injections on, the fused sublayer);
  32. LDM on SDXL and its refiner: bench_sdxl's keys with --ldm from phase
     17's inverted latents (the refiner inherits the keys): every call as
     SDXL_LAUNCHES says (check_calls); one base step at full size with and
     without --ldm;
  33. its reference (one lane, 16x16, without the CPU's own matchings),
     for the base and for the refiner (its 96-wide heads, 20 merging
     blocks).
  Phases 34-36 run on the SD1.5 bundle after phase 29:
  34. native bundle: the bundle (random, with its canny ControlNet) saved
     by models/checkpoint.save_bundle into a temporary directory and
     loaded back onto the card by load_bundle: every tensor the same
     shape, dtype, strides and bits, one merged step (2 UNet calls of 8
     rows at 512x512) the same bits on both (and on the same UNet twice);
     prints the save's and the load's seconds, init_model's random init and
     the bundle's bytes on disk;
  35. stages alone: a config over configs/demo.yaml (8 frames of
     data/demo.mp4, STEPS+STEPS steps, temporary paths, tpu.profile_dir)
     through `python -m vidtome_torch.pipeline.inverter`, then
     `.generator`, as subprocesses that must exit 0 and leave the latents,
     inversion_prompts.txt, the edited frames and one Chrome trace a stage
     (invert_*, ddim_sample_*, each with its vidtome/ step spans); the
     generator trace's launches of each hand-written kernel of the exact path
     (TRACE_SYMBOLS) must equal what ModuleLaunches reads over the same
     config's generation in this process (cli.setup_from_argv,
     run_inversion, run_generation), whose frames must agree with the
     subprocess's (max |diff|, PSNR through `python -m vidtome_torch.eval`,
     >= 35 dB); prints the loop's wall untraced and traced;
  36. tools: tools/parity_run.run_parity on the bundle (8 frames, 512x512,
     GATE_STEPS steps, the int8 and serve_maxe3xb profiles checked) and
     tools/quality_gate's main for GATES_RUN (1 seed, 8 frames,
     GATE_STEPS steps): each gate's dB and its record's backend, the
     card's name and power limit.  Random weights: the dB measure how far
     a lever moves the output, not perceptual quality.
  Phase 37 runs right after phase 3, in ranks of its own
  (vidtome_torch.parallel.launch.spawn: a card each over NCCL where as
  many are visible, else card 0 shared over gloo; phase_mesh): two ranks,
  full width, random weights (seeded alike), each run against a one-rank
  run of the same config and seed on rank 0:
  37. the mesh: (a) the exact keys (STEPS+STEPS) at {data: 2}; (b) the same
     at {model: 2}; (c) configs/serve.yaml's keys (MESH_SERVE_STEPS) at
     {data: 2}; (d) SD2.1 on configs/dog.yaml's PnP keys with the fused
     sublayer (MESH_PNP_STEPS) at {data: 2} (12 rows) and {model: 2} (5
     heads: 3 / 2); (e) one int8 UNet call (W8A8 fused resnets) at {model:
     2}; (f) one SDXL and one refiner UNet call at 1024x1024 (batch 4) at
     {model: 2}; (g) (a) at {data: 2, model: 2} over NCCL when four cards
     are visible (else said not run); (h) `python -m vidtome_torch.cli` at
     {data: 2}, its ranks self-started and under torchrun, against the CLI
     on one rank, when two cards are visible (else said not run); (d data)
     again with the one-rank run's matchings handed over, then its
     generation alone from the one-rank run's inversion and matchings
     (mesh_witness: how many calls matched otherwise, the inverted
     latents' dB and each run's).  Every rank's UNet
     calls launch what their modules imply (ModuleLaunches), every shape a
     rank gives a kernel is a phase-3 row (meta_rows' mesh kinds,
     mesh_kinds), every rank ends with the same latents (or output) bit
     for bit, and the frames (or the output) are at least MESH_DB against
     the one-rank run;
     prints each rank's launches, peak memory, stage seconds and the
     collectives' calls, ms and bytes a UNet call, and the dB and max
     |diff| with the one-rank run's peak memory and seconds.
  Phase 38 runs after phase 36:
  38. cluster starts (phase_starts): `python -m vidtome_torch.cli` on (h)'s
     config with tpu.multihost: true under a SLURM and an Open MPI start
     (simulated by their variables alone: vidtome_torch.testing.start_env)
     and torchrun, one rank each beside the plain CLI, all at once on card
     0; with two cards or more the same starts at {data: 2}, a card a
     rank.  Each must exit 0 and print its start line (process, world,
     backend nccl, card, start), and write frames at least MESH_DB
     against the plain run's (and, at {data: 2}, against (h)'s torchrun
     run's), their dB and max |diff| printed; then (h)'s witness: one
     rank's CLI edit from its inversion moved by a bf16 step (mesh_nudge),
     against itself, in dB.
``python3 chip_smoke.py --cli-inputs DIR`` instead writes the inputs of the
CLI runs of configs/flamingo.yaml and configs/breakdance.yaml on
data/demo.mp4 (write_cli_inputs) and exits.
Then the command's seconds and one JSON line with the kernels' numbers
(launches: summed over the exact, serving, int8, ControlNet, PnP, LoRA,
SD2-depth, the five SDXL paths and the paths of phases 25, 27, 28, 30 and
32, each counted from 0, and phase 37's ranks; ms,
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

import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import gc
import inspect
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import types
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
CONTROLNET_STEPS = 25  # these three 50 until PR 19: cut for phase 37's
DEPTH_STEPS = 25       # time (widths kept)
LORA_STEPS = 25
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
                       "full_group_norm": 27, "geglu": 7}
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


def serve_config(steps: int = SERVE_STEPS) -> dict:
    """CONFIG with configs/serve.yaml's inversion and generation keys as
    written there (prompts aside), at ``steps`` DDIM steps."""
    import yaml

    with open(ROOT / "configs" / "serve.yaml") as f:
        serve = yaml.safe_load(f)
    cfg = copy.deepcopy(CONFIG)
    for stage in ("inversion", "generation"):
        cfg[stage].update({k: v for k, v in serve[stage].items()
                           if k != "prompt"})
    cfg["inversion"].update(steps=steps, save_steps=steps)
    cfg["generation"]["n_timesteps"] = steps
    return cfg


def exact_config(steps: int) -> dict:
    cfg = copy.deepcopy(CONFIG)
    cfg["inversion"].update(steps=steps, save_steps=steps)
    cfg["generation"]["n_timesteps"] = steps
    return cfg


def pnp_config(steps: int = PNP_STEPS) -> dict:
    """configs/dog.yaml's inversion and generation keys over default.yaml's
    (dog.yaml's base_config), its first edit prompt only, at ``steps`` DDIM
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
                             n_timesteps=steps)
    cfg["inversion"].update(steps=steps, save_steps=steps)
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
    resnet blocks, plus quant: int8); the profiles from the port's copy of
    bench.py's tables, vidtome_torch/tools/profiles.py."""
    import yaml

    from vidtome_torch.tools.profiles import (INV_SERVE_PROFILES,
                                              SERVE_PROFILES)

    with open(ROOT / "configs" / "default.yaml") as f:
        default = yaml.safe_load(f)
    cfg = serve_config()
    cfg["inversion"] = {
        **CONFIG["inversion"],
        **{k: v for k, v in default["inversion"].items()
           if k not in ("prompt", "save_path")},
        **INV_SERVE_PROFILES["int8_fused"][0], "steps": INT8_STEPS,
        "save_steps": INT8_STEPS}
    cfg["generation"].update(SERVE_PROFILES["maxe3x"],
                             n_timesteps=INT8_STEPS)
    return cfg


KERNELS = ("flash_attention", "small_kv_attention", "group_norm",
           "full_group_norm", "fused_resnet", "fused_resnet_w8a8",
           "best_match", "fused_cross_sublayer", "geglu")


def counters() -> dict:
    """The launch counter of each kernel wrapper."""
    from vidtome_torch.ops import (attention, geglu, groupnorm, matching,
                                   resnet, sublayer)

    return {"flash_attention": attention.flash_attention,
            "small_kv_attention": attention.small_kv_attention,
            "group_norm": groupnorm.group_norm,
            "full_group_norm": groupnorm.full_group_norm,
            "fused_resnet": resnet.fused_resnet,
            "fused_resnet_w8a8": resnet.fused_resnet_w8a8,
            "best_match": matching.best_match,
            "fused_cross_sublayer": sublayer.fused_cross_sublayer,
            "geglu": geglu.geglu}


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
    # the refiner's widths in heads of 64 (12 and 24: three a cluster
    # rank), which no path here runs (the refiner's heads are 96 wide);
    # the SDXL phases' rows come from meta_rows
    (8, 4096, 768, 12),
    (8, 1024, 1536, 24),
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
# GEGLU's gate in the benchmark's two cells at 512x512, (B, S, inner) rows
# by the UNet calls that run them: {path: rows of the call} x {(tokens,
# inner): GEGLUs a call} (5 at each of the three levels, 1 in the mid
# block: 16)
GEGLU_CALLS = {"SD1.5 exact, first chunk": 8,
               "SD1.5 exact, batched chunks": 56,
               "SD1.5 / SD2.1 inversion": 32,
               "SD2.1 PnP, first chunk": 12,
               "SD2.1 PnP, batched chunks": 84}
GEGLU_LEVELS = {(4096, 1280): 5, (1024, 2560): 5, (256, 5120): 5,
                (64, 5120): 1}
GEGLU_SHAPES = {(b, s, inner): {path: n}
                for path, b in GEGLU_CALLS.items()
                for (s, inner), n in GEGLU_LEVELS.items()}
MATCH_SHAPES = [  # (B, S, D, C); a level: its global merge vs the bank
    (2, 12288, 4096, 320),     # L0 local round
    (2, 3072, 1024, 640),      # L1 local round
    0,                         # L0 global merge, from the serving config
    1,                         # L1 global merge
]


# SDXL (bench.py's bench_sdxl workload): 1024x1024, the base for the first
# SDXL_SPLIT of SDXL_STEPS steps and the refiner for the rest
SDXL_SIZE = 1024
SDXL_STEPS = 14  # 20 until PR 19; cut for phase 37's time (widths kept;
SDXL_SPLIT = 11  # step 9 still runs a shallow, CFG-skip serving call)
# each SDXL UNet call of the SDXL phase, by the topology at a 128x128
# latent: flash for the self-attentions of levels 1 and 2 and the mid block
# (base: 10 + 50 + 10 blocks; refiner: 20 + 20), small-KV for every
# cross-attention (77 keys) and the refiner mid block's self-attention (16x16
# = 256 tokens, 4 blocks), the full GroupNorm entry for every GroupNorm
# (base: 17 resnets x 2 + 11 transformers + conv_norm_out; refiner: 22 x 2
# + 11 + 1), GEGLU's gate for every transformer block (base 70, refiner
# 44); best match (1 or 2 a generation call: level 1 only) is checked apart
SDXL_LAUNCHES = {
    "SDXL": {"flash_attention": 70, "small_kv_attention": 70,
             "full_group_norm": 46, "geglu": 70},
    "refiner": {"flash_attention": 40, "small_kv_attention": 48,
                "full_group_norm": 56, "geglu": 44}}
# the refiner's level-0 resnets in fp32: slices of one 12-channel group (not
# on a main path; the bf16 rows of gn_rows are)
GN_FP32_ROWS = [(8, 128 * 128, 384, True, 1e-5, torch.float32)]


def meta_step(rec, unet, path: str, latent: int, lanes: int,
              groups: list[int], tome, mesh=None, **kw) -> None:
    """One step's UNet calls on the meta device under ``rec`` (a
    ModuleLaunches), recorded under ``path``: chunk groups in turn, a group
    of n chunks one call of lanes * n * chunk rows; with global merging the
    first initialises the banks and the others merge against them, a group
    of several chunks against each lane's bank repeated per chunk (as
    Generator.ddim_sample).  With ``mesh`` (a vidtome_torch.parallel Mesh
    without process groups, on the meta device) the calls of its rank: the
    UNet sharded on its model axis by the caller, this rank's rows of
    every call under its data axis (collectives give shapes only)."""
    from vidtome_torch.models.tome import ToMeCall
    from vidtome_torch.pipeline.generator import call_rows

    cfg = unet.config
    chunk = tome.frames if tome is not None else 4
    banks: dict = {}
    if all(u is not unet for u in rec.unets.values()):
        rec.watch(f"meta {len(rec.unets)}", unet)
    rec.label = path
    for g, n in enumerate(groups):
        B = lanes * n * chunk
        mode = "off"
        if tome is not None and tome.merge_global:
            mode = "init" if g == 0 else "merge"
        if n > 1:
            banks = {k: b.repeat_interleave(n, dim=0)
                     for k, b in banks.items()}
        call = None if tome is None else ToMeCall(
            cfg=tome, local_draws=[0] * len(tome.rounds()), coin=0.0,
            bank_mode=mode, banks=banks)
        rows = call_rows(mesh, B)
        extra = dict(kw, rows=rows)
        B = B if rows is None else rows.per
        if cfg.addition_num_time_ids:
            extra.update(
                add_text_embeds=torch.empty(B, cfg.addition_pooled_dim,
                                            dtype=torch.bfloat16),
                add_time_ids=torch.empty(B, cfg.addition_num_time_ids))
        if extra.get("cache_mode") == "shallow":
            extra["deep_cache"] = torch.empty(
                B, latent, latent, cfg.block_out_channels[1],
                dtype=torch.bfloat16)
        unet(torch.empty(B, latent, latent, cfg.in_channels,
                         dtype=torch.bfloat16), 1,
             torch.empty(B, 77, cfg.cross_attention_dim,
                         dtype=torch.bfloat16),
             tome_call=call, num_lanes=lanes, **extra)
    rec.label = None


@functools.cache
def meta_rows(only: str = "") -> dict:
    """The kernel shapes of the call kinds the SDXL phases (17-24, 32) and
    phases 25-31 run, {kernel: {shape: {"<path> call <i>": launches a
    call}}}, recorded by ModuleLaunches on forwards on the meta device
    (shapes only, no memory), one step of each kind (meta_step); ``only``
    keeps the kinds whose path holds it.  SDXL and its refiner at a
    128x128 latent on bench_sdxl's keys: the inversion's unmerged calls
    (batch 4), a generation step (2 lanes: the chunk that initialises the
    banks, then the one that merges against them), both with fused
    resnets as the int8 phases run them (paths " int8": the W8A8 resnet's
    rows), PnP (3 base lanes, injections on and off; the refiner's 2) with
    fused sublayers, the serving sidecar's full and shallow steps with
    both lanes or the CFG-skip step's cond lane (fused resnets and
    sublayers), --ldm; a 1024p VAE encode (batch 4) and decode (batch 2).
    SD1.5 at a 64x64 latent: the serving inversion (batch 8); maxe3xbB's
    full and shallow steps, both lanes or the cond lane, the first chunk's
    call and the batched call of the other seven, and the sequential calls
    of the same keys; the exact keys with ragged boundaries and with
    --ldm.  SD2.1 PnP with --ldm and the fused sublayer (3 lanes,
    injections on)."""
    from vidtome_torch.models.unet import (SD15_UNET, SD21_UNET, SDXL_UNET,
                                           SDXL_REFINER_UNET,
                                           UNet2DConditionModel)
    from vidtome_torch.models.vae import AutoencoderKL
    from vidtome_torch.parallel.mesh import shard_params
    from vidtome_torch.pipeline.generator import stage_tome

    def tome(cfg, pnp=False):
        return stage_tome(cfg["generation"], pnp)

    xl = SDXL_SIZE // 8
    fused = {"resnet_mode": "fused"}
    sub = {"sublayer_mode": "fused"}
    pnp = {**sub, "attn_inject": True, "conv_inject": True}
    # (path, UNet, latent, lanes, chunk groups, ToMeConfig, UNet kwargs,
    # the mesh rank's place or None)
    kinds = [
        ("SDXL inversion", "SDXL", xl, 1, [1], None, {}),
        ("SDXL int8 inversion", "SDXL", xl, 1, [1], None, fused),
        ("SDXL PnP", "SDXL", xl, 3, [1, 1], tome(sdxl_pnp_config(), True),
         pnp),
        ("SDXL PnP, no injection", "SDXL", xl, 3, [1, 1],
         tome(sdxl_pnp_config(), True), sub),
        ("refiner PnP stage", "refiner", xl, 2, [1, 1],
         tome(sdxl_pnp_config()), sub)]
    for name in ("SDXL", "refiner"):
        kinds += [
            (name, name, xl, 2, [1, 1], tome(sdxl_config()), {}),
            (f"{name} int8", name, xl, 2, [1, 1], tome(sdxl_config()), fused),
            (f"{name} LDM", name, xl, 2, [1, 1], tome(sdxl_ldm_config()), {})]
        kinds += [(f"{name} serve {cache}, {lanes} lanes", name, xl, lanes,
                   [1, 1], tome(sdxl_serve_config()),
                   {**fused, **sub, "cache_mode": cache})
                  for cache in ("full", "shallow") for lanes in (2, 1)]
    kinds += [("SD1.5 inversion", "SD1.5", 64, 2, [1], None, {})]
    kinds += [(f"SD1.5 maxe3xbB {cache}, {lanes} lanes, "
               f"{'batched' if n > 1 else 'sequential'}", "SD1.5", 64, lanes,
               [1, n], tome(chunk_batch_config()),
               {**fused, "cache_mode": cache})
              for cache in ("full", "shallow") for lanes in (2, 1)
              for n in (BATCH_FRAMES // 4 - 1, 1)]
    kinds += [
        ("SD1.5 ragged", "SD1.5", 64, 2, [1, 1], tome(CONFIG), {}),
        ("SD1.5 LDM", "SD1.5", 64, 2, [1, 1], tome(ldm(CONFIG)), {}),
        ("SD2.1 PnP LDM", "SD2.1", 64, 3, [1, 1],
         tome(ldm(pnp_config()), True), pnp)]
    kinds = [k + (None,) for k in kinds] + mesh_kinds(tome)
    configs = {"SDXL": SDXL_UNET, "refiner": SDXL_REFINER_UNET,
               "SD1.5": SD15_UNET, "SD2.1": SD21_UNET}
    unets: dict = {}
    with torch.device("meta"), torch.no_grad():
        # every UNet (a mesh rank's: a sharded copy) before any hook
        for path, name, *_, mesh in kinds:
            if only in path and name not in unets:
                unets[name] = UNet2DConditionModel(
                    configs[name]).to(torch.bfloat16)
        for path, name, *_, mesh in kinds:
            key = (name, mesh.data, mesh.model, mesh.rank) if mesh else name
            if only in path and key not in unets:
                unets[key] = shard_params(mesh, copy.deepcopy(unets[name]))
    with torch.device("meta"), torch.no_grad(), \
            ModuleLaunches({}, count=False) as rec:
        for path, name, latent, lanes, groups, t, kw, mesh in kinds:
            if only in path:
                key = ((name, mesh.data, mesh.model, mesh.rank) if mesh
                       else name)
                meta_step(rec, unets[key], path, latent, lanes, groups, t,
                          mesh=mesh, **kw)
        if only in "VAE":
            vae = AutoencoderKL().to(torch.bfloat16)
            rec.watch("VAE encode", vae.encoder)
            rec.watch("VAE decode", vae.decoder)
            vae.encode(torch.empty(4, SDXL_SIZE, SDXL_SIZE, 3,
                                   dtype=torch.bfloat16))
            vae.decode(torch.empty(2, xl, xl, 4, dtype=torch.bfloat16))
    rows: dict = {k: {} for k in KERNELS}
    for path, calls in rec.calls.items():
        for i, call in enumerate(calls):
            for (kernel, shape), n in call["shapes"].items():
                rows[kernel].setdefault(shape, {})[f"{path} call {i}"] = n
    return rows


def gn_rows() -> list[tuple]:
    """Phase 3's GroupNorm rows, ((B, rows, C, silu, eps, dtype), {path:
    norms a call}): GN_SHAPES (bf16), every shape of meta_rows (both
    GroupNorm routes) and GN_FP32_ROWS."""
    rows = {(*row[:5], torch.bfloat16): (
        {"SD1.5 exact UNet": row[5]} if row[5] else {}) for row in GN_SHAPES}
    meta = meta_rows()
    for key, paths in merged_rows(meta["full_group_norm"],
                                  meta["group_norm"]).items():
        rows.setdefault(key, {}).update(paths)
    rows.update({row: {} for row in GN_FP32_ROWS})
    return list(rows.items())


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
    from vidtome_torch.ops import (attention, geglu, groupnorm, matching,
                                   resnet, sublayer)
    from vidtome_torch.ops.cuda_build import build_library

    t0 = time.perf_counter()
    libs = {"vidtome_flash": "flash_attention.cu",
            "vidtome_small_kv": "small_kv_attention.cu",
            "vidtome_resnet_bf16": "resnet_bf16.cu",
            "vidtome_resnet_w8a8": "resnet_w8a8.cu",
            "vidtome_matching": "matching.cu",
            "vidtome_sublayer": "sublayer.cu",
            "vidtome_group_norm": "group_norm.cu",
            "vidtome_geglu": "geglu.cu"}
    logs = {name: [] for name in libs}
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(build_library, name, (src,), log=logs[name])
                    for name, src in libs.items()]:
            fut.result()
    attention._library(), attention._small_kv_library()
    resnet._library(), matching._library(), sublayer._library()
    groupnorm._library(), geglu._library()
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
    # path -> launches x (full, pair, bound, lib) summed over its rows
    per_call = {}
    earlier = [0.0, 0.0]  # full, stats + apply over GN_EARLIER_ROWS
    gen = torch.Generator(device=dev).manual_seed(0)
    for (B, rows, C, silu, eps, dtype), paths in gn_rows():
        x = (torch.randn((B, rows, C), generator=gen, device=dev) * 2.0
             + 0.5).to(dtype)
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
        wb, bb = w.to(dtype), b.to(dtype)

        def lib_call():
            return F.group_norm(x4, 32, wb, bb, eps)

        lib, lib_dev = cuda_time(lib_call, 10), graph_time(lib_call, 10)
        nbytes = x.element_size() * B * rows * C
        bound = bound_ms(2 * nbytes + 8 * C, fp32=(5 + 4 * silu) * B * rows * C)
        stats_bound = max(bound_ms(nbytes, fp32=3 * B * rows * C))
        p = groupnorm.plan(B, rows, C, 32, x.element_size(), sms)
        print(f"[kernel] group_norm [{B},{rows},{C}] {str(dtype)[6:]} "
              f"silu={silu} eps={eps} (norms a call: {paths or 'none'}) "
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
        for path, n in paths.items():
            row = per_call.setdefault(path, [0, 0.0, 0.0, 0.0, 0.0])
            for i, v in enumerate((1, dev_full, dev_pair, max(bound),
                                   lib_dev)):
                row[i] += n * v
        if (B, rows, C, silu, eps) in GN_EARLIER_ROWS:
            earlier[0] += ms_full
            earlier[1] += ms_pair
        del x, xf, x4, mean, rstd
        torch.cuda.empty_cache()
    for path, (n, full_ms, pair_ms, bound_sum, lib_sum) in per_call.items():
        print(f"[kernel] group_norm per {path} call ({n} norms, device only, "
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
        return merge._build_plan(metric, a_idx, b_idx, r, True,
                                 dst_starts=[0], dst_run_len=T)

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


def print_per_call(per_call: dict, library: str) -> None:
    """Phase 3's sums per UNet call of a path: {(kernel, path): [launches,
    ms, device ms, bound ms, library ms]}, each row's times weighted by its
    launches a call."""
    for (name, path), (n, ms, device, bound, lib) in per_call.items():
        print(f"[kernel] {name} per {path} call, {n} launches at the rows "
              f"above: through the wrapper {ms:.4f} ms, device only "
              f"{device:.4f} ms ({library} {lib:.4f} ms), bound "
              f"{bound:.4f} ms")


def phase_kernels(dev) -> KernelStats:
    from torch.nn import functional as F

    from vidtome_torch.ops import (attention, groupnorm, matching, quant,
                                   resnet, sublayer)

    rng = np.random.default_rng(0)
    # the rows' inputs are drawn on the card: at the batched call's 56 rows
    # numpy's draws took seconds a row
    gen = torch.Generator(device=dev).manual_seed(0)

    def f32(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    def bf16(shape, scale=1.0, shift=0.0):
        return f32(*shape, scale=scale, shift=shift).bfloat16()

    def report(what, err, tol, ms, plain, library, bound, note=""):
        lib = "none" if library is None else f"{library:.3f} ms"
        print(f"[kernel] {what} max|err| {err:.2e} (tol {tol}); kernel "
              f"{ms:.3f} ms, plain {plain:.3f} ms, library call {lib}, "
              f"bound {max(bound):.4f} ms "
              f"({'bytes' if bound[0] >= bound[1] else 'operations'}){note}")

    stats = KernelStats()
    t0 = time.perf_counter()
    lap = {}

    def mark(part):  # seconds of each part of the phase, printed last
        nonlocal t0
        torch.cuda.synchronize()
        lap[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
    # (kernel, path) -> summed launches x (ms, device ms, bound, library)
    per_call = {}
    meta = meta_rows()
    mark("rows (meta forwards)")
    flash_rows = meta["flash_attention"]
    small_rows = merged_rows(SMALL_KV_LAUNCHES, meta["small_kv_attention"])
    for name, shapes, a_call in (
            ("flash_attention",
             list(dict.fromkeys(FLASH_SHAPES + list(flash_rows))), flash_rows),
            ("small_kv_attention",
             list(dict.fromkeys(SMALL_KV_SHAPES + list(small_rows))),
             small_rows)):
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
            for path, n in a_call.get((B, H, Sq, Skv, D), {}).items():
                row = per_call.setdefault((name, path), [0, 0.0, 0.0, 0.0,
                                                         0.0])
                for i, x in enumerate((1, ms, device, max(bound),
                                       lib_device)):
                    row[i] += n * x
            del q, k, v, qf, kf, vf, got
            torch.cuda.empty_cache()
    print_per_call(per_call, "SDPA device only")
    per_call.clear()
    mark("attention")

    phase_group_norm(dev, rng, stats)
    mark("GroupNorm")

    resnet_rows = meta["fused_resnet"]
    # the W8A8 variant at the rows of the int8 paths (and the listed ones;
    # phase 37's int8 call at {model: 2}: " W8A8")
    w8a8_rows = merged_rows(meta_rows(" int8")["fused_resnet"],
                            meta_rows(" W8A8")["fused_resnet"])
    for B, H, W, Ci, Co in dict.fromkeys(RESNET_SHAPES + list(resnet_rows)):
        paths = resnet_rows.get((B, H, W, Ci, Co), {})
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
        for path, n in paths.items():
            row = per_call.setdefault(("fused_resnet", path), [0] + [0.0] * 4)
            for i, x in enumerate((1, ms, device, max(bound), lib)):
                row[i] += n * x
        del args_f, got, xc, hc
        if (B, H, W, Ci, Co) not in w8a8_rows and (
                B, H, W, Ci, Co) not in RESNET_SHAPES:
            del args
            torch.cuda.empty_cache()
            continue
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
        for path, n in w8a8_rows.get((B, H, W, Ci, Co), {}).items():
            row = per_call.setdefault(("fused_resnet_w8a8", path),
                                      [0] + [0.0] * 4)
            for i, x in enumerate((1, ms, device, max(bound), bf16_device)):
                row[i] += n * x
        del args
        torch.cuda.empty_cache()
    mark("resnets")
    for name, library in (("fused_resnet", "cuDNN's two convolutions"),
                          ("fused_resnet_w8a8", "the bf16 block device only")):
        print_per_call({k: v for k, v in per_call.items() if k[0] == name},
                       library)
    per_call.clear()

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    match_rows = [match_shape(r) for r in MATCH_SHAPES]
    for row in dict.fromkeys(match_rows + list(meta["best_match"])):
        B, S, D, C = row
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
    mark("best match, merge engine")

    sub_rows = meta["fused_cross_sublayer"]
    for B, S, C, heads in dict.fromkeys(SUBLAYER_SHAPES + list(sub_rows)):
        paths = sub_rows.get((B, S, C, heads), {})
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
        for path, n in paths.items():
            row = per_call.setdefault(("fused_cross_sublayer", path),
                                      [0] + [0.0] * 4)
            for i, x in enumerate((1, ms, device, max(bound), chain)):
                row[i] += n * x
        del args, args_f
        torch.cuda.empty_cache()
    print_per_call(per_call, "the unfused bf16 chain device only")
    mark("sublayer")
    phase_geglu(dev, stats, meta["geglu"])
    mark("GEGLU")
    print(f"[kernel] phase 3 seconds by part: {lap}")
    return stats


def phase_geglu(dev, stats: KernelStats, meta: dict) -> None:
    """Phase 3's GEGLU rows: GEGLU_SHAPES and every row of ``meta``
    (meta_rows()["geglu"]), bf16 [B, S, 2 * inner] inputs drawn on the card.
    The kernel must equal the eager h * F.gelu(gate) (geglu_plain in bf16)
    to the bit; timed through the wrapper and device only, beside the plain
    version in fp32, the eager pair (the library yardstick: the two calls
    the kernel replaces) and the bound, 6 bytes an output element at
    HBM_BYTES_S."""
    from torch.nn import functional as F

    from vidtome_torch.ops import geglu

    gen = torch.Generator(device=dev).manual_seed(26)
    per_call = {}
    for row in dict.fromkeys([*GEGLU_SHAPES, *meta]):
        *lead, inner = row
        y = (torch.randn((*lead, 2 * inner), generator=gen, device=dev)
             * 2.0).bfloat16()
        yf = y.float()
        h, gate = y.chunk(2, dim=-1)
        got = geglu.geglu(y)
        want = geglu.geglu_plain(y)
        wrong = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        err = (got.float() - geglu.geglu_plain(yf)).abs().max().item()
        del got, want

        def eager():
            return h * F.gelu(gate)
        ms = cuda_time(lambda: geglu.geglu(y), 10)
        device = graph_time(lambda: geglu.geglu(y), 10)
        plain = cuda_time(lambda: geglu.geglu_plain(yf), 3)
        lib = cuda_time(eager, 10)
        lib_device = graph_time(eager, 10)
        nbytes = 3 * y.numel()  # y read, out written once: 6 B an output
        bound = bound_ms(nbytes)
        shape = geglu.thread_shape(inner, 2)
        print(f"[kernel] geglu {list(row)}: bits differing from the eager "
              f"path {wrong} of {y.numel() // 2}; max|err| against the fp32 "
              f"plain version {err:.2e} (bf16 rounding); kernel {ms:.4f} ms, "
              f"device only {device:.4f} ms ({nbytes / device / 1e9:.3f} "
              f"TB/s, {100 * bound[0] / device:.1f}% of the bound), plain "
              f"(fp32) {plain:.4f} ms, eager h * F.gelu(gate) {lib:.4f} ms "
              f"(device only {lib_device:.4f}), bound {bound[0]:.4f} ms "
              f"(bytes); block {shape.threads_x}x{shape.threads_y}, "
              f"{shape.col_blocks} a row, {shape.vec} elements an access")
        if wrong:
            raise AssertionError(f"GEGLU kernel differs from the eager path "
                                 f"at {row}")
        stats.add("geglu", err, ms, plain, lib, bound, device, lib_device)
        for path, n in {**GEGLU_SHAPES.get(row, {}),
                        **meta.get(row, {})}.items():
            acc = per_call.setdefault(("geglu", path), [0] + [0.0] * 4)
            for i, x in enumerate((1, ms, device, max(bound), lib_device)):
                acc[i] += n * x
        del y, yf, h, gate
        torch.cuda.empty_cache()
    print_per_call(per_call, "the eager pair device only")
    # the host's cost of a call, at a row small enough that the card keeps
    # up with the launches: the wrapper against the eager pair it replaces
    y = torch.randn((1, 64, 2 * 320), generator=gen, device=dev).bfloat16()

    def host_us(fn, n: int = 2000) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us
    wrapper = host_us(lambda: geglu.geglu(y))
    eager = host_us(lambda: geglu.geglu_plain(y))
    print(f"[kernel] geglu host cost a call (no synchronize, [1, 64, 640]): "
          f"the wrapper {wrapper:.2f} us, the eager chunk + gelu + mul "
          f"{eager:.2f} us")


def make_frames(size: int = SIZE, n: int = N_FRAMES) -> np.ndarray:
    """n frames of a moving colour gradient with a moving disc, [0, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = []
    for i in range(n):
        ph = i / n
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
              "best_match", "geglu"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} kernel never launched on the exact "
                                 f"path")
    # GEGLU's gate: once each of a call's 16 transformer blocks, in the
    # inversion and the generation alike
    inv_calls = sum(inverter.unet_calls.values())
    if (gen["geglu"] != 16 * unet_calls
            or launches["geglu"] != 16 * (unet_calls + inv_calls)):
        raise AssertionError(f"exact path: {launches['geglu']} GEGLU "
                             f"launches ({gen['geglu']} generating) over "
                             f"{inv_calls} + {unet_calls} UNet calls, want "
                             f"16 a call")
    print(f"[main] GEGLU launches per UNet call: inversion "
          f"{(launches['geglu'] - gen['geglu']) / inv_calls:.0f}, "
          f"generation {gen['geglu'] / unet_calls:.0f}")
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
              "full_group_norm", "fused_resnet", "best_match", "geglu"):
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


class ModuleLaunches:
    """Every call of the modules ``unets`` ({path: module}: a UNet, a
    ControlNet, a VAE encoder or decoder) inside the block, a list of
    {batch, shapes, got, want} per path: its batch, the launches the
    counters saw (``got``, with ``count``: on the card) and the ones its
    module calls imply by the kernel wrappers' dispatch (``want``).  A call
    implies: flash or small-KV for each CrossAttention call
    (ops/attention.attention's rule: small-KV where it is built for the
    head dim and the keys), flash for each VAE attention block, the
    entries of VIDTOME_GN_MODE's route for each GroupNorm call, the fused
    resnet (W8A8 where the call's int8 table holds conv1) and GroupNorm's
    stats and finalize entries for each ResnetBlock2D called with
    resnet_mode "fused" and no injection, the fused sublayer for each
    TransformerBlock whose chain fuses, best match for each matching
    (core/merge.best_match), GEGLU's gate for each GEGLU.  Every shape a
    kernel is given goes into
    ``shapes`` ({kernel: Counter}) and, inside a call, into its call's."""

    def __init__(self, unets: dict, count: bool = True):
        self.unets, self.count = dict(unets), count
        self.calls = {path: [] for path in unets}
        self.shapes = {k: collections.Counter() for k in KERNELS}
        self.label = None  # records every call under this path when set
        self._cur = None

    def watch(self, path: str, unet) -> None:
        """Record the calls of ``unet`` under ``path`` too."""
        from vidtome_torch.models.layers import (GEGLU, CrossAttention,
                                                 GroupNorm, ResnetBlock2D,
                                                 TransformerBlock)
        from vidtome_torch.models.vae import VAEAttentionBlock

        self.unets[path] = unet
        self.calls.setdefault(path, [])
        self._handles += [
            unet.register_forward_pre_hook(self._unet_pre(path),
                                           with_kwargs=True),
            unet.register_forward_hook(self._unet_post, with_kwargs=True)]
        for m in unet.modules():
            for kind, hook in ((CrossAttention, self._attention),
                               (ResnetBlock2D, self._resnet),
                               (TransformerBlock, self._block)):
                if isinstance(m, kind):
                    self._handles.append(m.register_forward_pre_hook(
                        hook, with_kwargs=True))
            for kind, hook in ((GroupNorm, self._group_norm),
                               (VAEAttentionBlock, self._vae_attention),
                               (GEGLU, self._geglu)):
                if isinstance(m, kind):
                    self._handles.append(m.register_forward_pre_hook(hook))

    def __enter__(self):
        from vidtome_torch.core import merge

        self._handles = []
        for path, unet in list(self.unets.items()):
            self.watch(path, unet)
        self._best_match = merge.best_match

        def best_match(src, dst):
            self._add("best_match", (src.shape[0], src.shape[1],
                                     dst.shape[1], src.shape[2]))
            return self._best_match(src, dst)

        merge.best_match = best_match
        return self

    def __exit__(self, *exc):
        from vidtome_torch.core import merge

        merge.best_match = self._best_match
        for h in self._handles:
            h.remove()

    def _add(self, kernel: str, shape: tuple, n: int = 1) -> None:
        self.shapes[kernel][shape] += 1
        if self._cur is not None:
            self._cur["want"][kernel] += n
            self._cur["shapes"][(kernel, shape)] += 1

    def _unet_pre(self, path):
        def hook(mod, args, kwargs):
            self._cur = {"path": self.label or path,
                         "batch": args[0].shape[0],
                         "want": collections.Counter(),
                         "shapes": collections.Counter(),
                         "before": read_launches() if self.count else None}
        return hook

    def _unet_post(self, mod, args, kwargs, out):
        cur, self._cur = self._cur, None
        got = None
        if self.count:
            now = read_launches()
            got = {k: now[k] - cur["before"][k] for k in KERNELS}
        self.calls.setdefault(cur["path"], []).append({
            "batch": cur["batch"], "shapes": cur["shapes"], "got": got,
            "want": {k: cur["want"][k] for k in KERNELS}})

    @staticmethod
    def _bound(mod, args, kwargs) -> dict:
        bound = inspect.signature(type(mod).forward).bind(mod, *args,
                                                          **kwargs)
        bound.apply_defaults()
        return bound.arguments

    def _attention(self, mod, args, kwargs):
        from vidtome_torch.ops.attention import small_kv_takes

        x = args[0]
        ctx = args[1] if len(args) > 1 else kwargs.get("context")
        kv = x if ctx is None else ctx
        name = ("small_kv_attention" if small_kv_takes(mod.head_dim,
                                                       kv.shape[1])
                else "flash_attention")
        self._add(name, (x.shape[0], mod.heads, x.shape[1], kv.shape[1],
                         mod.head_dim))

    def _vae_attention(self, mod, args):
        B, H, W, C = args[0].shape
        self._add("flash_attention", (B, 1, H * W, H * W, C))

    def _geglu(self, mod, args):
        # (rows..., inner): the projection's output is [rows..., 2 * inner]
        # (a model rank's share on the model axis)
        self._add("geglu", (*args[0].shape[:-1],
                            mod.proj.weight.shape[0] // 2))

    def _group_norm(self, mod, args):
        from vidtome_torch.ops import groupnorm

        x = args[0]
        shape = (x.shape[0], int(np.prod(x.shape[1:-1])), x.shape[-1],
                 mod.silu, mod.eps, x.dtype)
        if groupnorm.route(groupnorm._gn_mode()) == ("full",):
            self._add("full_group_norm", shape)
        else:
            self._add("group_norm", shape, 2)

    def _resnet(self, mod, args, kwargs):
        a = self._bound(mod, args, kwargs)
        if a["resnet_mode"] != "fused" or a["inject"] is not None:
            return
        qt = a["qt"]
        name = ("fused_resnet_w8a8"
                if qt is not None and qt.get(mod.conv1) is not None
                else "fused_resnet")
        self._add(name, (*a["x"].shape, mod.conv1.out_channels))
        if self._cur is not None:  # GN1's statistics, GN2's finalize
            self._cur["want"]["group_norm"] += 2

    def _block(self, mod, args, kwargs):
        a = self._bound(mod, args, kwargs)
        call = a["tome_call"]
        cfg = call.cfg if call is not None else None
        do_merge = (cfg is not None and mod.downsample <= cfg.max_downsample
                    and cfg.frames > 1)
        if mod._fused_sublayer_ok(a["sublayer_mode"], cfg, do_merge):
            self._add("fused_cross_sublayer",
                      (*a["x"].shape, mod.attn2.total_heads))

    def check(self, tag: str, paths=None) -> None:
        """Each call's counted launches equal the ones its module calls
        imply."""
        paths = list(self.calls) if paths is None else paths
        odd = {p: [i for i, c in enumerate(self.calls[p])
                   if c["got"] != c["want"]] for p in paths}
        first = {p: self.calls[p][0]["got"] for p in paths if self.calls[p]}
        print(f"[{tag}] UNet calls by path {({p: len(self.calls[p]) for p in paths})}; "
              f"launches of the first call of each: {first}; calls whose "
              f"launches differ from what their modules imply: "
              f"{ {p: len(i) for p, i in odd.items()} }")
        if any(odd.values()):
            p = next(p for p, i in odd.items() if i)
            c = self.calls[p][odd[p][0]]
            raise AssertionError(f"[{tag}] {p} call {odd[p][0]}: launched "
                                 f"{c['got']}, its modules imply "
                                 f"{c['want']}")

    def check_rows(self, tag: str, rows: dict | None = None) -> None:
        """Every shape the run gave a kernel is a phase-3 row (``rows``:
        phase3_rows(), passed to a process that did not run phase 3)."""
        rows = phase3_rows() if rows is None else rows
        unchecked = [(k, sh, n) for k, c in self.shapes.items()
                     for sh, n in c.items() if sh not in rows[k]]
        print(f"[{tag}] kernel shapes the run gave, with their launches: "
              + "; ".join(f"{k} {dict(c)}" for k, c in self.shapes.items()
                          if c)
              + f"; not a phase-3 row: {unchecked}")
        if unchecked:
            raise AssertionError(f"[{tag}] shapes phase 3 did not check: "
                                 f"{unchecked}")


def phase_controlnet(dev, bundle) -> dict:
    """configs/demo-canny.yaml on the SD1.5 bundle, both stages through the
    ControlNet, CONTROLNET_STEPS+CONTROLNET_STEPS DDIM steps, the control
    images through the png
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
    with ModuleLaunches({"ControlNet": bundle.controlnet}) as rec, \
            tempfile.TemporaryDirectory() as work_dir:
        reset_launches()
        latents, conds = stage("encode", lambda: inverter.encode(frames))
        control_inv = stage("control_inv",
                            lambda: inverter.control_images(frames))
        inv_before = read_launches()
        inverted = stage("invert", lambda: inverter.ddim_inversion(
            latents, conds, control=control_inv))
        inv_launches = {k: v - inv_before[k]
                        for k, v in read_launches().items()}
        n_inv_cn = len(rec.calls["ControlNet"])
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

    inv_calls = sum(inverter.unet_calls.values())
    gen_calls = sum(generator.unet_calls.values())
    cn_calls = [c["got"] for c in rec.calls["ControlNet"]]
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


def phase_pnp(dev, bundle) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """Phase 11.  Returns the launches, the inverted latents and the
    source table (for phase 30)."""
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
    if (gen_launches["geglu"] != n_blocks * gen_calls
            or inv_launches["geglu"] != n_blocks * inv_calls):
        raise AssertionError(f"GEGLU launches {inv_launches['geglu']} / "
                             f"{gen_launches['geglu']} differ from 16 per "
                             f"UNet call ({inv_calls} / {gen_calls})")
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
    return launches, inverted, src


def profiled_device_ms(fn, top: int = 0):
    """Device milliseconds summed over the kernels of one call of ``fn``
    (torch.profiler, after a warm-up call); None where the profiler
    records no device time.  With ``top``, also the ``top`` kernels that
    take most of it, [(name, ms, launches)]."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the kernels' own entries (a launching op's entry repeats their time)
    kernels = [(e.key, (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0)) / 1e3,
                e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = sum(k[1] for k in kernels)
    ms = ms if ms > 0 else None
    if not top:
        return ms
    kernels.sort(key=lambda k: -k[1])
    return ms, [(name[:60], round(t, 3), n) for name, t, n in kernels[:top]]


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
    q/k/v/out projections (SDXL: both encoders', lora_te1_ / lora_te2_)."""
    import re

    from torch import nn

    unet_re = re.compile(r"(attn[12]\.(to_q|to_k|to_v|to_out\.0)|resnets\.\d+"
                         r"\.(conv1|conv2|conv_shortcut|time_emb_proj))$")
    text_re = re.compile(r"self_attn\.(q_proj|k_proj|v_proj|out_proj)$")
    roots = [("lora_unet_", bundle.unet, unet_re)]
    if bundle.text_encoder_2 is None:
        roots.append(("lora_te_", bundle.text_encoder, text_re))
    else:
        roots += [("lora_te1_", bundle.text_encoder, text_re),
                  ("lora_te2_", bundle.text_encoder_2, text_re)]
    out = []
    for prefix, root, pat in roots:
        for name, mod in root.named_modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)) and pat.search(name):
                out.append((prefix, name, mod))
    return out


def write_lora(bundle, path: str, seed: int = 7,
               probes: set | None = None) -> dict:
    """A kohya LoRA of rank LORA_RANK, alpha LORA_ALPHA over
    lora_targets(bundle), from a torch seed, written with the port's
    safetensors writer; returns {module: fp32 delta on the card} with the
    delta alpha / rank * up @ down in the module's layout, for every target
    or the (prefix, name) pairs in ``probes``."""
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
        if probes is not None and (prefix, name) not in probes:
            continue
        delta = (up.reshape(w.shape[0], LORA_RANK)
                 @ down.reshape(LORA_RANK, -1)).reshape(w.shape)
        deltas[mod] = (delta * (LORA_ALPHA / LORA_RANK)).to(w.device)
    save_file(state, path)
    return deltas


def unet_call_want(unet) -> dict:
    """The launches of one UNet call at the smoke frames' latent, by the
    topology: flash for the self-attentions over more than SMALL_KV tokens,
    small-KV for the rest and every cross-attention, the full GroupNorm
    entry for all 61 GroupNorms, GEGLU's gate once a transformer block;
    best match (2 or 4 a generation call) is left at 0."""
    from vidtome_torch.models.layers import TransformerBlock
    from vidtome_torch.ops.attention import SMALL_KV

    blocks = [m for m in unet.modules() if isinstance(m, TransformerBlock)]
    latent = SIZE // 8
    want = {k: 0 for k in KERNELS}
    want.update(flash_attention=sum((latent // b.downsample) ** 2 > SMALL_KV
                                    for b in blocks),
                full_group_norm=61,
                small_kv_attention=small_kv_blocks(unet, latent),
                geglu=len(blocks))
    return want


def phase_lora(dev, bundle) -> dict:
    """configs/breakdance.yaml on SD1.5 with a synthetic kohya LoRA (random
    softedge ControlNet, its zero convs moved, the softedge images through
    the random HED net when VIDTOME_HED_MODEL is set): the generation
    without the adapter, then with it merged on load by the Generator; the
    merged weights must be W + delta within two bf16 roundings, each UNet
    and ControlNet call of the LoRA generation must launch what the same
    call of the plain one did (``ModuleLaunches``), which the topology
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
    with ModuleLaunches({"UNet": bundle.unet,
                         "ControlNet": bundle.controlnet}) as rec, \
            tempfile.TemporaryDirectory() as work_dir:
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
        marks = [tuple(map(len, rec.calls.values()))]
        out_plain = stage("generate_plain", lambda: plain.vae.decode(
            plain.ddim_sample(inverted[pad], plain.context(prompt),
                              fidx_table=table,
                              control=control[pad])[:N_FRAMES]))
        marks.append(tuple(map(len, rec.calls.values())))
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
        marks.append(tuple(map(len, rec.calls.values())))
        out = stage("generate", lambda: generator.vae.decode(
            generator.ddim_sample(inverted[pad], generator.context(prompt),
                                  fidx_table=table,
                                  control=control[pad])[:N_FRAMES]))
        marks.append(tuple(map(len, rec.calls.values())))
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

    # each generation's own UNet and ControlNet calls, by the marks
    (u0, c0), (u1, c1), (u2, c2), (u3, c3) = marks
    unet_calls, cn_calls = ([c["got"] for c in rec.calls[p]]
                            for p in ("UNet", "ControlNet"))
    plain_unet, lora_unet = unet_calls[u0:u1], unet_calls[u2:u3]
    plain_cn, lora_cn = cn_calls[c0:c1], cn_calls[c2:c3]
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
    """configs/flamingo.yaml on SD2-depth, DEPTH_STEPS+DEPTH_STEPS DDIM
    steps, the proxy
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
    with ModuleLaunches({"UNet": bundle.unet}) as rec, \
            tempfile.TemporaryDirectory() as work_dir:
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
        n_inv = len(rec.calls["UNet"])
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

    want = unet_call_want(bundle.unet)
    calls = [c["got"] for c in rec.calls["UNet"]]
    inv_calls, gen_calls = calls[:n_inv], calls[n_inv:]
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


def sdxl_config() -> dict:
    """bench.py's bench_sdxl keys (1024x1024, inversion batch 4, chunk 4,
    mix-4, local 0.9 / global 0.8, global_rand 0.5, guidance 7.5, VAE batch
    2), SDXL_STEPS DDIM steps in both stages instead of 50, and a refiner
    (random weights) from 0.8 of the steps on."""
    return {
        "sd_version": "xl", "height": SDXL_SIZE, "width": SDXL_SIZE,
        "seed": 123, "float_precision": "bf16",
        "inversion": {"prompt": "benchmark", "steps": SDXL_STEPS,
                      "save_steps": SDXL_STEPS, "save_intermediate": False,
                      "batch_size": 4, "control": "none", "quant": "none"},
        "generation": {
            "control": "none", "guidance_scale": 7.5,
            "n_timesteps": SDXL_STEPS, "negative_prompt": "ugly, blurry",
            "prompt": {"edit": "benchmark prompt"}, "chunk_size": 4,
            "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
            "merge_global": True, "global_merge_ratio": 0.8,
            "global_rand": 0.5, "align_batch": False, "quant": "none",
            "batch_size": 2,
            "refiner": {"sd_version": "xl-refiner",
                        "denoising_start": 0.8}}}


def phase_sdxl(dev, bundle):
    """sdxl_config on the SDXL base and its refiner through the port's
    Inverter and Generator.sample (drive_sdxl): every UNet call of each
    stage must launch what SDXL_LAUNCHES says, best match 1 or 2 times a
    generation call (3 a step); every shape the run gives a kernel in the
    UNets and the VAE must be a phase-3 row (check_calls).  Returns the
    launches, the refiner's bundle and the inverted latents."""
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = sdxl_config()
    times = {}
    inverter = Inverter(bundle, cfg)
    generator = timed(times, "build the refiner",
                      lambda: Generator(bundle, cfg))
    refiner = generator.refiner
    run = drive_sdxl(dev, bundle, generator, times, inverter=inverter)
    best = {p: sum(c["got"]["best_match"] for c in run.rec.calls[p])
            for p in ("SDXL", "refiner")}
    print(f"[sdxl] SDXL + refiner (random), {N_FRAMES} frames "
          f"{SDXL_SIZE}x{SDXL_SIZE}, {SDXL_STEPS}+{SDXL_STEPS} DDIM steps, "
          f"the refiner from step {generator.split_step()}, "
          f"{run.table.shape[1]} chunks, bench_sdxl keys; UNet calls: "
          f"inversion {dict(inverter.unet_calls)}, base "
          f"{dict(generator.unet_calls)}, refiner "
          f"{dict(refiner.unet_calls)}; best_match over the calls {best}")
    if generator.split_step() != SDXL_SPLIT or run.table.shape[1] != 2:
        raise AssertionError("expected the refiner from step "
                             f"{SDXL_SPLIT} and 2 chunks")
    check_calls("sdxl", run, sdxl_wants(bundle, refiner))
    if best["SDXL"] != 3 * SDXL_SPLIT or best["refiner"] != 3 * (
            SDXL_STEPS - SDXL_SPLIT):
        raise AssertionError(f"best_match launches {best}, 3 a step")
    print_run("sdxl", run, times)
    return run.launches, refiner.bundle, run.inverted


def sdxl_unet_args(dev, unet, batch: int, latent: int, seed: int):
    """A UNet call's inputs on ``dev``: x [batch, latent, latent, 4], 77
    context tokens, pooled embeds and the time ids of a 1024p frame (the
    refiner's with the aesthetic scores 2.5 / 6.0 on alternate rows)."""
    cfg = unet.config
    rng = np.random.default_rng(seed)
    ids = ([SDXL_SIZE, SDXL_SIZE, 0, 0, SDXL_SIZE, SDXL_SIZE]
           if cfg.addition_num_time_ids == 6 else
           [SDXL_SIZE, SDXL_SIZE, 0, 0, 2.5])
    ids = np.tile(np.float32(ids), (batch, 1))
    if cfg.addition_num_time_ids == 5:
        ids[1::2, 4] = 6.0
    arrays = (rng.standard_normal((batch, latent, latent, 4), np.float32),
              rng.standard_normal((batch, 77, cfg.cross_attention_dim),
                                  np.float32),
              rng.standard_normal((batch, cfg.addition_pooled_dim),
                                  np.float32), ids)
    return [torch.from_numpy(a).to(dev) for a in arrays]


def phase_sdxl_reference(dev, bundle, refiner) -> None:
    """One SDXL base and one refiner UNet call at a 16x16 latent, batch 2,
    with pooled embeds and time ids: card bf16 kernels vs CPU fp32 plain
    versions to REF_TOL; the same call with the pooled embeds zeroed must
    differ by more than REF_TOL."""
    for name, b in (("SDXL", bundle), ("refiner", refiner)):
        x, ctx, pooled, ids = sdxl_unet_args("cpu", b.unet, 2, 16, 9)
        cpu = copy.deepcopy(b.unet).to("cpu", torch.float32)
        with torch.inference_mode():
            def run(m, d, p):
                return m(x.to(d), 501, ctx.to(d), add_text_embeds=p.to(d),
                         add_time_ids=ids.to(d)).float().cpu()

            before = read_launches()
            got = run(b.unet, dev, pooled)
            ran = {k: v - before[k] for k, v in read_launches().items()}
            want = run(cpu, "cpu", pooled)
            zero = run(cpu, "cpu", torch.zeros_like(pooled))
        del cpu
        gc.collect()
        scale = want.abs().max()
        err = ((got - want).abs().max() / scale).item()
        gap = ((zero - want).abs().max() / scale).item()
        print(f"[reference] {name} weights, 128x128 input, pooled embeds and "
              f"time ids: card bf16 kernels vs CPU fp32 plain max rel err "
              f"{err:.2e} (tol {REF_TOL}); pooled embeds zeroed vs not "
              f"{gap:.2e} (must exceed {REF_TOL}); kernels launched on the "
              f"card {ran}")
        if not err < REF_TOL:
            raise AssertionError(f"{name} card vs CPU reference rel err {err}")
        if not gap > REF_TOL:
            raise AssertionError(f"{name}: the pooled embeds change the "
                                 f"output by only {gap}")
        if not (ran["full_group_norm"] and ran["small_kv_attention"]):
            raise AssertionError("the reference call ran no GroupNorm or "
                                 "small-KV kernel")


def drive_sdxl(dev, bundle, generator, times: dict, inverter=None,
               inverted=None) -> types.SimpleNamespace:
    """One edit of the SDXL phases' 8 frames through the port's Inverter
    (or from the given ``inverted`` latents) and Generator.sample, the base
    and then the refiner (under PnP the base reads the inversion's saved
    latents), the launch counters set to 0 before and read after.  Returns
    the launches, the ModuleLaunches of the UNets (paths "SDXL inversion",
    "SDXL", "refiner") and of the VAE's encoder and decoder, the chunk
    table, the inverted latents and the frames; the stage seconds go into
    ``times``, the base and refiner stages apart."""
    stage = functools.partial(timed, times)
    refiner_unet = generator.refiner.bundle.unet
    split_at = []

    def at_split(module, args):  # the refiner stage's first UNet call
        if not split_at:
            torch.cuda.synchronize()
            split_at.append(time.perf_counter())

    hook = refiner_unet.register_forward_pre_hook(at_split)
    try:
        with ModuleLaunches({"SDXL": bundle.unet, "refiner": refiner_unet,
                             "VAE encode": bundle.vae.encoder,
                             "VAE decode": bundle.vae.decoder}) as rec:
            reset_launches()
            if inverter is not None:
                frames = make_frames(SDXL_SIZE)
                latents, conds = stage("encode",
                                       lambda: inverter.encode(frames))
                rec.label = "SDXL inversion"
                inverted = stage("invert", lambda: inverter.ddim_inversion(
                    latents, conds))
                rec.label = None
            generator.configure_frames(N_FRAMES)
            pad = torch.as_tensor(generator.pad_src, device=dev)
            table = generator.fidx_table()
            prompt = next(iter(generator.prompt.values()))
            inputs = {}
            if generator.use_pnp:
                inputs["src_table"] = inverter.source_table(
                    generator.scheduler.timesteps)[:, pad]
            t0 = time.perf_counter()
            clean = stage("generate", lambda: generator.sample(
                inverted[pad], prompt, fidx_table=table, **inputs))
            out = stage("decode",
                        lambda: generator.vae.decode(clean[:N_FRAMES]))
            launches = read_launches()
    finally:
        hook.remove()
    times["base stage"] = split_at[0] - t0
    times["refiner stage"] = times["generate"] - times["base stage"]
    if tuple(out.shape) != (N_FRAMES, SDXL_SIZE, SDXL_SIZE, 3):
        raise AssertionError(f"frames shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("SDXL frames not finite or outside [0, 1]")
    if not torch.isfinite(inverted).all():
        raise AssertionError("SDXL inverted latents not finite")
    return types.SimpleNamespace(launches=launches, rec=rec, table=table,
                                 inverted=inverted, out=out)


def sdxl_call_want(unet, kind: str = "full", resnet: str | None = None,
                   sublayer: bool = False) -> dict:
    """The launches of one SDXL or refiner UNet call by its topology (best
    match left out): SDXL_LAUNCHES for a full call; the fused resnet kernel
    (``resnet``: "fused_resnet" or "fused_resnet_w8a8") once a
    ResnetBlock2D, with the GroupNorm stats and finalize entries twice, in
    place of its two full GroupNorms; under ``sublayer`` the fused
    sublayer once a TransformerBlock, in place of its small-KV
    cross-attention.  A shallow call (the level-0 path around the deep
    cache, which has no attention on the SDXL family) runs only its
    resnets and conv_norm_out."""
    from vidtome_torch.models.layers import TransformerBlock

    refiner = unet.config.addition_num_time_ids == 5
    blocks = sum(isinstance(m, TransformerBlock) for m in unet.modules())
    n_res = resnets_per_call(unet)[kind]
    want = {k: 0 for k in KERNELS if k != "best_match"}
    if kind == "full":
        want.update(SDXL_LAUNCHES["refiner" if refiner else "SDXL"])
        if sublayer:
            want["small_kv_attention"] -= blocks
            want["fused_cross_sublayer"] = blocks
    else:
        if len(unet.down_blocks[0].attentions) or len(
                unet.up_blocks[-1].attentions):
            raise AssertionError("a shallow call of this UNet runs attention")
        want["full_group_norm"] = 2 * n_res + 1
    if resnet is not None:
        want[resnet] = n_res
        want["group_norm"] = 2 * n_res
        want["full_group_norm"] -= 2 * n_res
    return want


def sdxl_wants(bundle, refiner, inversion: bool = True,
               **modes) -> dict:
    """The launches each UNet call of an SDXL phase must show, {path:
    [(launches, best-match counts allowed)], one a call}: the inversion's
    calls (batch 4, no merging, no sublayer: the stage leaves it off) and
    the base and refiner stages' full calls (best match 1 or 2), the
    stages' ``modes`` (sdxl_call_want) on both."""
    steps = {"SDXL": SDXL_SPLIT, "refiner": SDXL_STEPS - SDXL_SPLIT}
    unets = {"SDXL": bundle.unet, "refiner": refiner.bundle.unet}
    wants = {p: [(sdxl_call_want(unets[p], **modes), (1, 2))] * 2 * n
             for p, n in steps.items()}
    if inversion:
        inv = {k: v for k, v in modes.items() if k != "sublayer"}
        wants["SDXL inversion"] = [(sdxl_call_want(bundle.unet, **inv),
                                    (0,))] * SDXL_STEPS * -(-N_FRAMES // 4)
    return wants


def check_calls(tag: str, run, wants: dict) -> None:
    """Every UNet call of a drive_sdxl run against ``wants`` ({path:
    [(launches, best-match counts allowed)], one a call}): the number of
    calls and each call's launches, which must also be the ones its module
    calls imply (ModuleLaunches.check); and every shape the run gave a
    kernel a phase-3 row."""
    odd = {}
    calls = {p: [c["got"] for c in run.rec.calls[p]] for p in wants}
    for path, want in wants.items():
        if len(calls[path]) != len(want):
            raise AssertionError(f"[{tag}] {path}: {len(calls[path])} UNet "
                                 f"calls, want {len(want)}")
        odd[path] = [i for i, (c, (w, best)) in enumerate(zip(calls[path],
                                                              want))
                     if {k: v for k, v in c.items() if k != "best_match"} != w
                     or c["best_match"] not in best]
    print(f"[{tag}] calls that differ from what the topology says they "
          f"must launch: {({p: len(i) for p, i in odd.items()})}")
    if any(odd.values()):
        raise AssertionError(f"[{tag}] launches per UNet call differ: "
                             f"{ {p: i[:3] for p, i in odd.items()} }")
    run.rec.check(tag, list(wants))
    run.rec.check_rows(tag)


def print_run(tag: str, run, times: dict) -> None:
    print(f"[{tag}] frames mean {run.out.mean().item():.4f} std "
          f"{run.out.std().item():.4f}; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    print(f"[{tag}] kernel launches in this run: {run.launches}")


def sdxl_call_times(dev, tag: str, calls: list) -> None:
    """One UNet call of each (name, unet, batch, kwargs) at a 128x128
    latent (no merging): device ms summed over its kernels, with the five
    kernels that take most of it (torch.profiler), and ms through the call
    (CUDA events, the host's gaps included)."""
    for name, unet, batch, kw in calls:
        x, ctx, pooled, ids = sdxl_unet_args(dev, unet, batch, SDXL_SIZE // 8,
                                             8)
        x, ctx = x.bfloat16(), ctx.bfloat16()

        def call(unet=unet, x=x, ctx=ctx, pooled=pooled, ids=ids, kw=kw):
            with torch.inference_mode():
                return unet(x, 501, ctx, add_text_embeds=pooled,
                            add_time_ids=ids, **kw)
        try:
            device, top = profiled_device_ms(call, top=5)
        except Exception as exc:  # a measurement only: say so, go on
            print(f"[{tag}] device time not measured ({exc!r})")
            device, top = None, []
        wall = cuda_time(call, 3)
        print(f"[{tag}] one {name} UNet call [{batch},{SDXL_SIZE // 8},"
              f"{SDXL_SIZE // 8},4], no merging: device ms (torch.profiler, "
              f"summed over its kernels) {device}; through the call (CUDA "
              f"events) {wall:.3f} ms; the kernels that take most, (name, "
              f"ms, launches): {top}")
        del x, ctx, pooled, ids
        torch.cuda.empty_cache()


def sdxl_int8_config() -> dict:
    """sdxl_config with bench_sdxl's --int8 (quant: int8 in both stages,
    so in the refiner's too) and fused resnet blocks in both stages."""
    cfg = sdxl_config()
    for stage in ("inversion", "generation"):
        cfg[stage].update(quant="int8", resnet_mode="fused")
    return cfg


def phase_sdxl_int8(dev, bundle):
    """sdxl_int8_config under VIDTOME_GN_MODE=full: every UNet call of the
    inversion, the base stage and the refiner stage must launch the W8A8
    resnet once per ResnetBlock2D (17 a base call, 22 a refiner call), the
    GroupNorm stats and finalize entries twice per W8A8 launch, the bf16
    resnet never, and otherwise what SDXL_LAUNCHES says; every fused-resnet
    shape a phase-3 row; the frames finite in [0, 1].  Then one int8 base
    and refiner call timed.  Returns the launches and the refiner's
    Generator."""
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = sdxl_int8_config()
    times = {}
    with gn_mode("full"):
        inverter = timed(times, "quantize the base (inversion)",
                         lambda: Inverter(bundle, cfg))
        generator = timed(times, "quantize the base, build and quantize the "
                          "refiner", lambda: Generator(bundle, cfg))
        refiner = generator.refiner
        run = drive_sdxl(dev, bundle, generator, times, inverter=inverter)
        print(f"[sdxl int8] SDXL + refiner int8 (W8A8, fused resnets, "
              f"VIDTOME_GN_MODE=full), {N_FRAMES} frames "
              f"{SDXL_SIZE}x{SDXL_SIZE}, {SDXL_STEPS}+{SDXL_STEPS} DDIM "
              f"steps, the refiner from step {generator.split_step()}; int8 "
              f"tensors: base {len(generator.qt)}, refiner "
              f"{len(refiner.qt)}; UNet calls: inversion "
              f"{dict(inverter.unet_calls)}, base "
              f"{dict(generator.unet_calls)}, refiner "
              f"{dict(refiner.unet_calls)}")
        check_calls("sdxl int8", run, sdxl_wants(
            bundle, refiner, resnet="fused_resnet_w8a8"))
        print_run("sdxl int8", run, times)
        sdxl_call_times(dev, "sdxl int8", [
            (f"int8 {name}", u, 8, dict(resnet_mode="fused", qt=g.qt))
            for name, u, g in (("SDXL", bundle.unet, generator),
                               ("refiner", refiner.bundle.unet, refiner))])
    return run.launches, refiner


def phase_sdxl_int8_reference(dev, bundle, refiner) -> None:
    """One int8 SDXL call at a 16x16 latent and one int8 refiner call at a
    32x32 latent (its 2x2 level at 16x16 would give its int8 products 8
    rows, fewer than torch._int_mm takes), batch 2, fused resnet blocks,
    with the stages' int8 tables: bf16 kernels on the card under
    VIDTOME_GN_MODE=full vs fp32 plain versions on the CPU, to
    INT8_REF_TOL."""
    from vidtome_torch.ops.quant import QuantTable, QWeight, quantize_unet

    for name, b, table, latent in (
            ("SDXL", bundle, quantize_unet(bundle.unet), 16),
            ("refiner", refiner.bundle, refiner.qt, 32)):
        t0 = time.perf_counter()
        x, ctx, pooled, ids = sdxl_unet_args("cpu", b.unet, 2, latent, 9)
        cpu = copy.deepcopy(b.unet).to("cpu", torch.float32)
        cpu_table = QuantTable(cpu, {
            n: QWeight(e.weight.cpu(), e.scale.cpu(),
                       None if e.act_scale is None else e.act_scale.cpu())
            for n, e in table.entries.items()})
        with torch.inference_mode(), gn_mode("full"):
            def run(m, d, qt):
                return m(x.to(d), 501, ctx.to(d), add_text_embeds=pooled.to(d),
                         add_time_ids=ids.to(d), resnet_mode="fused",
                         qt=qt).float().cpu()

            before = read_launches()
            got = run(b.unet, dev, table)
            ran = {k: v - before[k] for k, v in read_launches().items()}
            want = run(cpu, "cpu", cpu_table)
            plain = run(cpu, "cpu", None)
        del cpu, cpu_table
        gc.collect()
        scale = want.abs().max()
        err = ((got - want).abs().max() / scale).item()
        effect = ((plain - want).abs().max() / scale).item()
        print(f"[reference] {name} weights, int8 UNet call at a "
              f"{latent}x{latent} latent, fused resnet blocks, full "
              f"GroupNorm: card bf16 kernels vs CPU fp32 plain max rel err "
              f"{err:.2e} (tol {INT8_REF_TOL}); the int8 table's own effect "
              f"on the CPU output {effect:.2e}; kernels launched on the card "
              f"{ran}; {time.perf_counter() - t0:.1f} s")
        if not err < INT8_REF_TOL:
            raise AssertionError(f"{name} int8 card vs CPU rel err {err}")
        if not (ran["fused_resnet_w8a8"] and ran["full_group_norm"]):
            raise AssertionError("the int8 reference call ran no W8A8 resnet "
                                 "or full GroupNorm kernel")


def sdxl_pnp_config() -> dict:
    """sdxl_config with PnP in the base stage (control: pnp, default.yaml's
    pnp_attn_t 0.5 / pnp_f_t 0.8; the refiner stage runs control: none),
    the inversion saving every step's latents, and the fused sublayer in
    the generation (so in the refiner's too)."""
    cfg = sdxl_config()
    cfg["inversion"]["save_intermediate"] = True
    cfg["generation"].update(control="pnp", pnp_attn_t=0.5, pnp_f_t=0.8,
                             sublayer_mode="fused")
    return cfg


def phase_sdxl_pnp(dev, bundle) -> dict:
    """sdxl_pnp_config: the inversion keeps every step's latents, the base
    stage runs 3 lanes (source first, fed from them) and the refiner 2.
    Every UNet call must launch the fused sublayer once per
    TransformerBlock (70 a base call, 44 a refiner call), small-KV only
    where no sublayer runs (the refiner mid block's self-attention), and
    otherwise what SDXL_LAUNCHES says; the inversion's calls SDXL_LAUNCHES
    (no sublayer there); every sublayer shape a phase-3 row; the frames
    finite in [0, 1].  Then one PnP base call (3 lanes x 4 frames, both
    injections on) and one refiner call timed."""
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = sdxl_pnp_config()
    times = {}
    inverter = Inverter(bundle, cfg)
    generator = timed(times, "build the refiner",
                      lambda: Generator(bundle, cfg))
    refiner = generator.refiner
    run = drive_sdxl(dev, bundle, generator, times, inverter=inverter)
    print(f"[sdxl pnp] SDXL PnP + refiner, {N_FRAMES} frames "
          f"{SDXL_SIZE}x{SDXL_SIZE}, {SDXL_STEPS}+{SDXL_STEPS} DDIM steps, "
          f"the refiner from step {generator.split_step()}; base lanes "
          f"{generator.num_lanes}, refiner lanes {refiner.num_lanes}; "
          f"attention injection on {generator.pnp_attn_steps} steps, conv "
          f"on {generator.pnp_conv_steps}; saved latents "
          f"{len(inverter.saved)}; sublayer_mode base "
          f"{generator.sublayer_mode}, refiner {refiner.sublayer_mode}; "
          f"UNet calls: inversion {dict(inverter.unet_calls)}, base "
          f"{dict(generator.unet_calls)}, refiner {dict(refiner.unet_calls)}")
    if (generator.num_lanes, refiner.num_lanes, run.table.shape[1]) != (
            3, 2, 2):
        raise AssertionError("expected 3 base lanes, 2 refiner lanes, 2 "
                             "chunks")
    check_calls("sdxl pnp", run, sdxl_wants(bundle, refiner, sublayer=True))
    print_run("sdxl pnp", run, times)
    pnp = dict(sublayer_mode="fused", attn_inject=True, conv_inject=True,
               num_lanes=3)
    sdxl_call_times(dev, "sdxl pnp", [
        ("PnP SDXL", bundle.unet, 12, pnp),
        ("PnP-stage refiner", refiner.bundle.unet, 8,
         dict(sublayer_mode="fused"))])
    return run.launches


def phase_sdxl_pnp_reference(dev, bundle) -> None:
    """One SDXL call at a 16x16 latent with 3 lanes, both PnP injections
    on and sublayer_mode="fused": bf16 kernels on the card vs fp32 plain
    versions on the CPU, to REF_TOL; the injections off must differ by
    more than REF_TOL."""
    t0 = time.perf_counter()
    x, ctx, pooled, ids = sdxl_unet_args("cpu", bundle.unet, 3, 16, 10)
    cpu = copy.deepcopy(bundle.unet).to("cpu", torch.float32)
    with torch.inference_mode():
        def run(m, d, inject):
            return m(x.to(d), 501, ctx.to(d), add_text_embeds=pooled.to(d),
                     add_time_ids=ids.to(d), sublayer_mode="fused",
                     attn_inject=inject, conv_inject=inject,
                     num_lanes=3).float().cpu()

        before = read_launches()
        got = run(bundle.unet, dev, True)
        ran = {k: v - before[k] for k, v in read_launches().items()}
        want = run(cpu, "cpu", True)
        off = run(cpu, "cpu", False)
    del cpu
    gc.collect()
    scale = want.abs().max()
    err = ((got - want).abs().max() / scale).item()
    gap = ((off - want).abs().max() / scale).item()
    print(f"[reference] SDXL weights, PnP UNet call at a 16x16 latent, 3 "
          f"lanes, injections on, sublayer fused: card bf16 kernels vs CPU "
          f"fp32 plain max rel err {err:.2e} (tol {REF_TOL}); injections off "
          f"vs on {gap:.2e} (must exceed {REF_TOL}); kernels launched on the "
          f"card {ran}; {time.perf_counter() - t0:.1f} s")
    if not err < REF_TOL:
        raise AssertionError(f"SDXL PnP card vs CPU reference rel err {err}")
    if not gap > REF_TOL:
        raise AssertionError(f"PnP injections change the output by only "
                             f"{gap}")
    if not ran["fused_cross_sublayer"]:
        raise AssertionError("the reference call ran no sublayer kernel")


def sdxl_serve_config() -> dict:
    """sdxl_config with bench.py's SDXL serve sidecar keys: its generation
    keys with SERVE_PROFILES["maxe3xbs"] (tools/profiles.py, bench.py:168:
    the deep, CFG and eps step caches, linear eps extrapolation, local 0.95
    / global 0.9 merging, fused resnet blocks and fused sublayers), which
    the refiner's copy of the config carries too."""
    from vidtome_torch.tools.profiles import SERVE_PROFILES

    cfg = sdxl_config()
    cfg["generation"].update(SERVE_PROFILES["maxe3xbs"])
    return cfg


def phase_sdxl_serving(dev, bundle, inverted) -> dict:
    """sdxl_serve_config's generation from phase 17's inverted latents
    (bench.py's sidecar serves from them): the UNet calls per kind (full,
    shallow, CFG skip, eps skip) of both stages must match their mode
    tables, and every call must launch what its kind gives (sdxl_call_want:
    the bf16 fused resnet once a ResnetBlock2D, the sublayer once a
    TransformerBlock in a full call); every fused-resnet and sublayer shape
    a phase-3 row; the frames finite in [0, 1].  Then one serving base and
    refiner call timed."""
    from vidtome_torch.pipeline.generator import Generator

    cfg = sdxl_serve_config()
    times = {}
    generator = timed(times, "build the refiner",
                      lambda: Generator(bundle, cfg))
    refiner = generator.refiner
    run = drive_sdxl(dev, bundle, generator, times, inverted=inverted)
    split, n_chunks = generator.split_step(), run.table.shape[1]
    stages = {"SDXL": (generator, generator.mode_masks(), 0, split),
              "refiner": (refiner, refiner.mode_masks(split), split,
                          SDXL_STEPS)}
    wants, got_calls, want_calls = {}, {}, {}
    for path, (gen, modes, start, stop) in stages.items():
        unet = gen.bundle.unet
        # the kind of each UNet call: a step that runs, n_chunks calls
        wants[path] = [
            (sdxl_call_want(unet, kind, "fused_resnet", sublayer=True),
             (1, 2) if kind == "full" else (0,))
            for i in range(start, stop) if modes[i, 2]
            for kind in ("full" if modes[i, 0] else "shallow",) * n_chunks]
        want_calls[path] = expected_calls(modes[start:stop], n_chunks,
                                          cfg=True)
        got_calls[path] = {k: v for k, v in gen.unet_calls.items() if v}
    print(f"[sdxl serve] SDXL + refiner, bench.py's SDXL serve sidecar keys "
          f"(maxe3xbs), {N_FRAMES} frames {SDXL_SIZE}x{SDXL_SIZE}, "
          f"{SDXL_STEPS} DDIM steps, the refiner from step {split}; UNet "
          f"calls {got_calls} (mode tables {want_calls})")
    if got_calls != want_calls:
        raise AssertionError("UNet calls per kind differ from the mode "
                             "tables")
    if not all(k in got_calls["SDXL"] for k in ("full", "shallow",
                                                "cfg_skip", "eps_skip")):
        raise AssertionError(f"the serving base stage ran no step of some "
                             f"kind: {got_calls['SDXL']}")
    check_calls("sdxl serve", run, wants)
    print_run("sdxl serve", run, times)
    fused = dict(resnet_mode="fused", sublayer_mode="fused")
    sdxl_call_times(dev, "sdxl serve", [
        ("serving SDXL", bundle.unet, 8, fused),
        ("serving refiner", refiner.bundle.unet, 8, fused)])
    return run.launches


def phase_sdxl_lora(dev, bundle, inverted) -> dict:
    """sdxl_config with a synthetic kohya LoRA (write_lora: every attention
    projection, resnet conv and time_emb_proj of the UNet and the q/k/v/out
    projections of both text encoders) merged on load: the generation
    without the adapter, then a Generator with use_lora merges it into the
    base and offers it to its refiner (as the JAX package's copied config
    does) and generates from the same latents.  The merged counts per
    namespace must be the file's targets (the refiner's printed: its UNet
    and encoder take the pairs whose names and shapes fit, its te2 pairs
    are warned about); a probe weight of each namespace must be W + delta
    within two bf16 roundings; the context and the pooled embeds must
    differ from the plain ones; each UNet call of the plain generation
    must launch what the topology gives, each of the LoRA generation what
    the plain generation's call at the same index did; the frames must
    differ.  The base bundle keeps the LoRA: run this phase last."""
    import contextlib
    import io
    import re

    from vidtome_torch.pipeline.generator import Generator

    probes = {("lora_unet_", LORA_PROBE),
              ("lora_te1_", "text_model.encoder.layers.0.self_attn.q_proj"),
              ("lora_te2_", "text_model.encoder.layers.0.self_attn.q_proj")}
    times = {}
    targets = collections.Counter(p for p, _, _ in lora_targets(bundle))
    with tempfile.TemporaryDirectory() as work_dir:
        path = os.path.join(work_dir, "lora.safetensors")
        deltas = timed(times, "write the LoRA",
                       lambda: write_lora(bundle, path, probes=probes))
        saved = {m: m.weight.detach().clone() for m in deltas}
        cfg_lora = sdxl_config()
        cfg_lora["generation"].update(use_lora=True,
                                      lora={"path": path, "weight": 1.0})
        plain = Generator(bundle, sdxl_config())
        prompt = next(iter(plain.prompt.values()))
        ctx_plain = plain.context(prompt)
        plain_times = {}
        plain_run = drive_sdxl(dev, bundle, plain, plain_times,
                               inverted=inverted)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            generator = timed(times, "merge (base and refiner)",
                              lambda: Generator(bundle, cfg_lora))
        print(log.getvalue(), end="")
        ctx_lora = generator.context(prompt)
        run = drive_sdxl(dev, bundle, generator, times, inverted=inverted)
    merged = [(m[1], int(m[2])) for m in re.finditer(
        r"LoRA\[(\w+)\]: merged (\d+) modules", log.getvalue())]
    want_merged = [("unet", targets["lora_unet_"]),
                   ("text_encoder", targets["lora_te1_"]),
                   ("text_encoder_2", targets["lora_te2_"])]
    excess = []
    for mod, delta in deltas.items():
        want = saved[mod].float() + delta
        tol = 2.0 ** -8 * (delta.abs() + want.abs())
        excess.append(((mod.weight.detach().float() - want).abs()
                       - tol).max().item())
    moved = [((a - b).abs().max() / b.abs().max()).item()
             for a, b in zip(ctx_lora[:2], ctx_plain[:2])]
    diff = (run.out.float() - plain_run.out.float()).abs().max().item()
    print(f"[sdxl lora] SDXL + refiner with a synthetic kohya LoRA (rank "
          f"{LORA_RANK}, alpha {LORA_ALPHA}; targets {dict(targets)}), "
          f"{N_FRAMES} frames {SDXL_SIZE}x{SDXL_SIZE}, {SDXL_STEPS} DDIM "
          f"steps, the refiner from step {generator.split_step()}; merged "
          f"{merged} (base want {want_merged}); the refiner's bundle holds "
          f"{generator.refiner.bundle.lora}")
    print(f"[sdxl lora] probes (UNet {LORA_PROBE}, both encoders' layer 0 "
          f"q_proj): largest excess of |merged - (W + delta)| over two bf16 "
          f"roundings {max(excess):.3e} (must be <= 0); context and pooled "
          f"embeds moved by {moved} of max |plain| (must exceed 1e-3); "
          f"frames with vs without the LoRA max |diff| {diff:.4f}; the plain "
          f"generation's stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in plain_times.items()))
    if merged[:3] != want_merged:
        raise AssertionError(f"merged {merged[:3]}, want {want_merged}")
    if "text_encoder_2 tensors but the model has a single" not in (
            log.getvalue()):
        raise AssertionError("the refiner did not warn about the te2 pairs")
    if len(excess) != len(probes) or not max(excess) <= 0:
        raise AssertionError(f"LoRA merge off W + delta at the probes: "
                             f"{excess}")
    if not min(moved) > 1e-3:
        raise AssertionError(f"the LoRA moves the text embeddings by {moved}")
    check_calls("sdxl lora plain", plain_run,
                sdxl_wants(bundle, generator.refiner, inversion=False))
    check_calls("sdxl lora", run, {
        p: [({k: v for k, v in c["got"].items() if k != "best_match"},
             (c["got"]["best_match"],)) for c in plain_run.rec.calls[p]]
        for p in ("SDXL", "refiner")})
    if not diff > 0.05:
        raise AssertionError("the LoRA does not change the edit")
    print_run("sdxl lora", run, times)
    return {k: v + plain_run.launches[k] for k, v in run.launches.items()}


# ---------------------------------------------------------------------------
# The gated-off generation modes (phases 25-29): batched chunks, ragged chunk
# boundaries, LDM-variant merging.
# ---------------------------------------------------------------------------

BATCH_FRAMES = 32        # phase 25: bench.py's clip, 8 chunks of 4
RAGGED_FRAMES = (10, 8)  # phase 26: 4 chunks in 12 slots; 3, one of them
#                          from the waste slot's chunk of padding
LDM_KEYS = {"merge_crossattn": True, "merge_ff": True}  # bench.py's --ldm
LDM_PNP_STEPS = 50


def chunk_batch_config() -> dict:
    """bench.py's SERVE_PROFILES["maxe3xbB"] (tools/profiles.py: the keys
    of configs/serve.yaml plus chunk_batch: true) over serve_config
    (SERVE_STEPS DDIM steps)."""
    from vidtome_torch.tools.profiles import SERVE_PROFILES

    cfg = serve_config()
    cfg["generation"].update(SERVE_PROFILES["maxe3xbB"])
    return cfg


def ragged_config() -> dict:
    """The exact path's keys at STEPS DDIM steps with chunk_boundaries:
    ragged."""
    cfg = exact_config(STEPS)
    cfg["generation"]["chunk_boundaries"] = "ragged"
    return cfg


def ldm(cfg: dict) -> dict:
    """``cfg`` with bench.py's --ldm keys (merge_crossattn, merge_ff) in
    generation."""
    cfg = copy.deepcopy(cfg)
    cfg["generation"].update(LDM_KEYS)
    return cfg


def sdxl_ldm_config() -> dict:
    """bench_sdxl's keys with --ldm (sdxl_config: the refiner inherits the
    generation keys)."""
    return ldm(sdxl_config())


def merged_rows(*tables) -> dict:
    """Row tables ({shape: {path: launches a call}}) joined, in order."""
    out: dict = {}
    for table in tables:
        for shape, paths in table.items():
            out.setdefault(shape, {}).update(paths)
    return out


@functools.cache
def phase3_rows() -> dict:
    """{kernel: set of shapes} phase 3 holds against the plain versions."""
    meta = meta_rows()
    gn = {row for row, _ in gn_rows()}
    return {
        "flash_attention": set(FLASH_SHAPES) | set(meta["flash_attention"]),
        "small_kv_attention": set(SMALL_KV_SHAPES)
        | set(meta["small_kv_attention"]),
        "full_group_norm": gn, "group_norm": gn,
        "fused_resnet": set(RESNET_SHAPES) | set(meta["fused_resnet"]),
        "fused_resnet_w8a8": set(RESNET_SHAPES)
        | set(meta_rows(" int8")["fused_resnet"])
        | set(meta_rows(" W8A8")["fused_resnet"]),
        "best_match": {match_shape(r) for r in MATCH_SHAPES}
        | set(meta["best_match"]),
        "fused_cross_sublayer": set(SUBLAYER_SHAPES)
        | set(meta["fused_cross_sublayer"]),
        "geglu": set(GEGLU_SHAPES) | set(meta["geglu"])}


def print_stats(tag: str, generator, unet) -> None:
    """The merge statistics of the last step's UNet calls
    (ToMeConfig.collect_stats): per merging block, the tokens its
    self-attention saw against the tokens it was given."""
    from vidtome_torch.logging_utils import collect_tome_stats

    for pos, stats in sorted(generator.tome_stats.items()):
        blocks = collect_tome_stats(stats, unet)
        print(f"[{tag}] ToMe stats, last step, call at chunk {pos} "
              f"(block: merged_len / seq_len): "
              + ", ".join(f"{k.replace('transformer_blocks.', 'tb')}: "
                          f"{v['merged_len']}/{v['seq_len']}"
                          for k, v in blocks.items()))
    if not generator.tome_stats:
        raise AssertionError(f"[{tag}] no merge statistics collected")


def with_stats(generator):
    """``generator`` with ToMeConfig.collect_stats on."""
    generator.tome = dataclasses.replace(generator.tome, collect_stats=True)
    return generator


def check_frames(tag: str, out, n: int, size: int = SIZE) -> None:
    if tuple(out.shape) != (n, size, size, 3):
        raise AssertionError(f"[{tag}] frames shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"[{tag}] frames not finite or outside [0, 1]")


def step_inputs(unet, lanes: int, rows: list[int], latent: int, seed: int):
    """Seeded inputs of a step's UNet calls (CPU, fp32): per call of B
    rows x [B, latent, latent, 4] and the lane contexts repeated per frame,
    on the SDXL family with the lanes' pooled embeds and the time ids of a
    1024p frame (the refiner's aesthetic score 2.5 on every lane but the
    last, 6.0 there)."""
    cfg = unet.config
    rng = np.random.default_rng(seed)
    lane_ctx = torch.from_numpy(rng.standard_normal(
        (lanes, 77, cfg.cross_attention_dim), np.float32))
    lane_kw = {}
    if cfg.addition_num_time_ids:
        ids = ([SDXL_SIZE, SDXL_SIZE, 0, 0, SDXL_SIZE, SDXL_SIZE]
               if cfg.addition_num_time_ids == 6 else
               [SDXL_SIZE, SDXL_SIZE, 0, 0, 2.5])
        ids = np.tile(np.float32(ids), (lanes, 1))
        if cfg.addition_num_time_ids == 5:
            ids[-1, 4] = 6.0
        lane_kw = {"add_text_embeds": torch.from_numpy(rng.standard_normal(
            (lanes, cfg.addition_pooled_dim), np.float32)),
                   "add_time_ids": torch.from_numpy(ids)}
    out = []
    for B in rows:
        per_lane = B // lanes
        out.append((torch.from_numpy(rng.standard_normal(
            (B, latent, latent, 4), np.float32)),
            lane_ctx.repeat_interleave(per_lane, dim=0),
            {k: v.repeat_interleave(per_lane, dim=0)
             for k, v in lane_kw.items()}))
    return out


def plans_on(cache: dict, dev) -> dict:
    """A ``share_match`` plan cache with every plan's tensors on ``dev``."""
    def move(plan):
        return dataclasses.replace(plan, **{
            f.name: getattr(plan, f.name).to(dev)
            for f in dataclasses.fields(plan)
            if isinstance(getattr(plan, f.name), torch.Tensor)})
    return {key: {k: ([move(p) for p in v] if isinstance(v, list)
                      else move(v)) for k, v in entry.items()}
            for key, entry in cache.items()}


def step_calls(dev, unet, tome, lanes: int, groups: list[int], latent: int,
               dtype, plan_caches=None, **kw) -> tuple[list, list]:
    """A step's UNet calls on ``dev`` in ``dtype`` (step_inputs, fixed
    draws), each group of n chunks one call, the first initialising the
    banks and the others merging against them repeated per chunk, as
    Generator.ddim_sample runs them.  ``plan_caches`` (one a call) hands
    each call the matchings of another run (``share_match``: every block
    then takes them).  Returns the outputs (fp32, on the CPU) and each
    call's plan cache."""
    from vidtome_torch.models.tome import ToMeCall

    if not tome.share_match:
        raise ValueError("step_calls hands plans over through share_match")
    rows = [lanes * n * tome.frames for n in groups]
    banks: dict = {}
    outs, caches = [], []
    with torch.inference_mode():
        for g, (n, (x, ctx, add)) in enumerate(zip(
                groups, step_inputs(unet, lanes, rows, latent, 4))):
            if n > 1:
                banks = {k: b.repeat_interleave(n, dim=0)
                         for k, b in banks.items()}
            call = ToMeCall(cfg=tome, local_draws=[1] * len(tome.rounds()),
                            coin=0.7 if g % 2 else 0.3,
                            bank_mode="init" if g == 0 else "merge",
                            banks=banks)
            if plan_caches is not None:
                call.plan_cache = plans_on(plan_caches[g], dev)
            add = {k: v.to(dev) for k, v in add.items()}
            outs.append(unet(x.to(dev, dtype), 501, ctx.to(dev, dtype),
                             tome_call=call, num_lanes=lanes, **add,
                             **kw).float().cpu())
            caches.append(call.plan_cache)
    return outs, caches


def reference_steps(tag: str, dev, unet, tome, lanes: int, groups,
                    latent: int, own: bool = True, **kw) -> list:
    """step_calls on the card (bf16 kernels) and on a CPU fp32 copy of
    ``unet`` with the card's matchings (a bf16 metric and an fp32 one pick
    different best matches where two scores are within bf16 rounding, and
    a token merged into another dst moves the output by more than
    REF_TOL: the matching is phase 3's best-match rows' and the CPU parity
    tests' to check), each call's max rel err held to REF_TOL, printed with
    the launches the card's calls made and (``own``), printed only, the
    error against the CPU's own matchings."""
    cpu = copy.deepcopy(unet).to("cpu", torch.float32)
    before = read_launches()
    got, caches = step_calls(dev, unet, tome, lanes, groups, latent,
                             torch.bfloat16, **kw)
    ran = {k: v - before[k] for k, v in read_launches().items()}
    want, _ = step_calls("cpu", cpu, tome, lanes, groups, latent,
                         torch.float32, plan_caches=caches, **kw)
    own = step_calls("cpu", cpu, tome, lanes, groups, latent,
                     torch.float32, **kw)[0] if own else []
    del cpu
    gc.collect()
    errs = [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]
    own = [((g - w).abs().max() / w.abs().max()).item()
           for g, w in zip(got, own)]
    print(f"[{tag}] reference: {latent}x{latent} latent, {lanes} lane(s), "
          f"calls of {[lanes * n * tome.frames for n in groups]} rows (the "
          f"later ones against the first's banks, repeated per chunk): card "
          f"bf16 kernels vs CPU fp32 plain with the card's matchings max rel "
          f"err {[float(f'{e:.3g}') for e in errs]} (tol {REF_TOL}); with "
          f"the CPU's own matchings (printed only) "
          f"{[float(f'{e:.3g}') for e in own]}; kernels launched on the "
          f"card {ran}")
    if not max(errs) < REF_TOL:
        raise AssertionError(f"[{tag}] card vs CPU reference rel err {errs}")
    if not (ran["best_match"] and ran["small_kv_attention"]):
        raise AssertionError(f"[{tag}] the reference calls merged nothing "
                             f"or ran no small-KV kernel")
    return errs


def step_device_ms(tag: str, dev, unet, tome, lanes: int, groups,
                   latent: int, **kw) -> list:
    """Each call of a step (as step_calls, at full size on the card): its
    device ms summed over its kernels (torch.profiler) and its ms through
    the call (CUDA events, the host's gaps included)."""
    from vidtome_torch.models.tome import ToMeCall

    rows = [lanes * n * tome.frames for n in groups]
    banks: dict = {}
    out = []
    for g, (n, (x, ctx, add)) in enumerate(zip(
            groups, step_inputs(unet, lanes, rows, latent, 6))):
        x, ctx = x.to(dev, torch.bfloat16), ctx.to(dev, torch.bfloat16)
        add = {k: v.to(dev) for k, v in add.items()}
        given = {k: b.repeat_interleave(n, dim=0) if n > 1 else b
                 for k, b in banks.items()}

        def call(x=x, ctx=ctx, add=add, given=given, g=g):
            with torch.inference_mode():
                c = ToMeCall(cfg=tome, local_draws=[1] * len(tome.rounds()),
                             coin=0.7, bank_mode="init" if g == 0 else "merge",
                             banks=dict(given))
                unet(x, 501, ctx, tome_call=c, num_lanes=lanes, **add, **kw)
                return c.banks
        made = call()
        if g == 0:
            banks = made
        try:
            device = profiled_device_ms(call)
        except Exception as exc:  # a measurement only: say so, go on
            print(f"[{tag}] device time not measured ({exc!r})")
            device = None
        out.append((x.shape[0], device, cuda_time(call, 3)))
        del x, ctx
    torch.cuda.empty_cache()
    print(f"[{tag}] one step's UNet calls at {latent}x{latent}, {lanes} lanes "
          f"(rows, device ms summed over its kernels by torch.profiler, ms "
          f"through the call by CUDA events): "
          + ", ".join(f"({B}, {d if d is None else round(d, 3)}, {w:.3f})"
                      for B, d, w in out))
    return out


def phase_chunk_batch(dev, bundle) -> tuple[dict, object]:
    """Phase 25: bench.py's maxe3xbB (configs/serve.yaml's keys plus
    chunk_batch) on SD1.5, BATCH_FRAMES frames: the serving inversion, then
    generation with chunks 2..8 of every step in one UNet call.  Returns
    the launches and the generation's ToMeConfig."""
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = chunk_batch_config()
    frames = make_frames(n=BATCH_FRAMES)
    inverter = Inverter(bundle, cfg)
    generator = with_stats(Generator(bundle, cfg))
    times = {}
    stage = functools.partial(timed, times)
    with ModuleLaunches({"SD1.5": bundle.unet}) as rec:
        reset_launches()
        latents, conds = stage("encode", lambda: inverter.encode(frames))
        inverted = stage("invert", lambda: inverter.ddim_inversion(latents,
                                                                   conds))
        n_inv = len(rec.calls["SD1.5"])
        generator.configure_frames(BATCH_FRAMES)
        _, prompt = next(iter(generator.prompt.items()))
        context = stage("text", lambda: generator.text.embed_cfg(
            prompt, generator.negative_prompt))
        table = generator.fidx_table()
        x0 = inverted[torch.as_tensor(generator.pad_src, device=dev)]
        clean = stage("generate", lambda: generator.ddim_sample(
            x0, context, fidx_table=table))
        out = stage("decode", lambda: generator.vae.decode(
            clean[:BATCH_FRAMES]))
        launches = read_launches()

    K = table.shape[1]
    modes = generator.mode_masks()
    deep, cfgm, run = modes[:, 0], modes[:, 1], modes[:, 2]
    # 2 calls a step that runs the UNet: the first chunk, then the other
    # K - 1 in one call; the CFG-skip steps run the cond lane alone
    want_rows = []
    for i in range(SERVE_STEPS):
        if run[i]:
            lanes = 2 if cfgm[i] else 1
            want_rows += [4 * lanes, 4 * lanes * (K - 1)]
    rows = [c["batch"] for c in rec.calls["SD1.5"][n_inv:]]
    want_kinds = expected_calls(modes, 2, cfg=True)
    got_kinds = {k: v for k, v in generator.unet_calls.items() if v}
    print(f"[batch] SD1.5, {BATCH_FRAMES} frames {SIZE}x{SIZE}, "
          f"{SERVE_STEPS}+{SERVE_STEPS} DDIM steps, {K} chunks, bench.py's "
          f"maxe3xbB (serve.yaml + chunk_batch); UNet calls: inversion "
          f"{dict(inverter.unet_calls)}, generation {got_kinds} (mode table, "
          f"2 a step: {want_kinds}); rows of the generation's calls "
          f"{dict(collections.Counter(rows))}")
    if K != BATCH_FRAMES // 4 or rows != want_rows:
        raise AssertionError(f"[batch] {K} chunks and calls of rows "
                             f"{rows[:6]}..., want 2 a step: 8 and 56, or 4 "
                             f"and 28 on CFG-skip steps")
    if got_kinds != want_kinds or not all(
            k in got_kinds for k in ("full", "shallow", "cfg_skip",
                                     "eps_skip")):
        raise AssertionError(f"[batch] UNet calls per kind {got_kinds}, "
                             f"want {want_kinds}, every kind")
    rec.check("batch")
    rec.check_rows("batch")
    check_frames("batch", out, BATCH_FRAMES)
    print_stats("batch", generator, bundle.unet)

    # the same keys, each chunk one call (not counted): 8 calls a step
    seq = Generator(bundle, serve_config())
    seq.configure_frames(BATCH_FRAMES)
    seq_times = {}
    with ModuleLaunches({"SD1.5": bundle.unet}) as rec_seq:
        ref = timed(seq_times, "generate", lambda: seq.ddim_sample(
            x0, context, fidx_table=table))
    rec_seq.check("batch, sequential")
    rec_seq.check_rows("batch, sequential")
    ran = sum(v for k, v in seq.unet_calls.items()
              if k in ("full", "shallow"))
    if ran != K * int(run.sum()):
        raise AssertionError(f"[batch] the sequential run made {ran} UNet "
                             f"calls, want {K} a step")
    ref = seq.vae.decode(ref[:BATCH_FRAMES])
    mse = ((out.float() - ref.float()) ** 2).mean().item()
    print(f"[batch] stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; the same keys without chunk_batch ({K} calls a step): "
          f"generate {seq_times['generate']:.3f}; PSNR batched vs "
          f"sequential frames (star vs chain banks, random weights: printed "
          f"only) {10 * np.log10(1.0 / max(mse, 1e-20)):.2f} dB")
    print(f"[batch] kernel launches in this run: {launches}")
    step_device_ms("batch", dev, bundle.unet, generator.tome, 2, [1, K - 1],
                   SIZE // 8, resnet_mode="fused")
    step_device_ms("batch, sequential", dev, bundle.unet, seq.tome, 2,
                   [1, 1], SIZE // 8, resnet_mode="fused")
    return launches, generator.tome


def phase_ragged(dev, bundle) -> dict:
    """Phase 27: the exact keys with chunk_boundaries: ragged at each of
    RAGGED_FRAMES frames, STEPS+STEPS DDIM steps."""
    from vidtome_torch.core import chunk as chunking
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = ragged_config()
    total = {k: 0 for k in KERNELS}
    for n in RAGGED_FRAMES:
        frames = make_frames(n=n)
        inverter = Inverter(bundle, cfg)
        generator = with_stats(Generator(bundle, cfg))
        times = {}
        stage = functools.partial(timed, times)
        with ModuleLaunches({"SD1.5": bundle.unet}) as rec:
            reset_launches()
            latents, conds = stage("encode", lambda: inverter.encode(frames))
            inverted = stage("invert", lambda: inverter.ddim_inversion(
                latents, conds))
            n_inv = len(rec.calls["SD1.5"])
            generator.configure_frames(n)
            _, prompt = next(iter(generator.prompt.items()))
            context = stage("text", lambda: generator.text.embed_cfg(
                prompt, generator.negative_prompt))
            table = generator.fidx_table()
            pad = torch.as_tensor(generator.pad_src, device=dev)
            clean = stage("generate", lambda: generator.ddim_sample(
                inverted[pad], context, fidx_table=table))
            out = stage("decode", lambda: generator.vae.decode(clean[:n]))
            launches = read_launches()
        total = {k: total[k] + launches[k] for k in KERNELS}
        host = chunking.build_fidx_table(
            generator.n_padded, 4, np.random.default_rng(generator.seed),
            STEPS, chunk_ord=generator.chunk_ord,
            perm_div=generator.perm_div, merge_global=True, ragged=True,
            n_frames=n)
        K = 1 + -(-(n - 1) // 4)
        rows = [c["batch"] for c in rec.calls["SD1.5"][n_inv:]]
        waste = int((table[..., 1] == n).sum())
        print(f"[ragged] {n} frames {SIZE}x{SIZE} in {generator.n_padded} "
              f"slots, {STEPS}+{STEPS} DDIM steps, exact keys with ragged "
              f"boundaries: {table.shape[1]} chunks a step (first chunks of "
              f"{sorted({int((t[0, :, 1] < n).sum()) for t in table})} real "
              f"frames), {waste} writes to the waste slot {n}; UNet calls: "
              f"inversion {dict(inverter.unet_calls)}, generation "
              f"{dict(generator.unet_calls)}; stage seconds "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
        if not np.array_equal(table, host) or table.shape[1] != K:
            raise AssertionError(f"[ragged] {n} frames: the table differs "
                                 f"from the host's, or has not {K} chunks")
        if rows != [8] * (K * STEPS) or generator.n_padded != 12 or not waste:
            raise AssertionError(f"[ragged] {n} frames: generation calls of "
                                 f"rows {rows}, want {K} of 8 a step; "
                                 f"{generator.n_padded} slots")
        rec.check(f"ragged {n}")
        rec.check_rows(f"ragged {n}")
        check_frames(f"ragged {n}", out, n)
        print_stats(f"ragged {n}", generator, bundle.unet)
    print(f"[ragged] kernel launches in this run: {total}")
    return total


def ldm_topology(unet, tome, latent: int) -> dict:
    """What the LDM variant gives one UNet call: the TransformerBlocks
    that merge (their cross-attention on the merged tokens, small-KV) and
    the others, with those whose self-attention small-KV takes."""
    from vidtome_torch.models.layers import TransformerBlock
    from vidtome_torch.ops.attention import SMALL_KV

    blocks = [m for m in unet.modules() if isinstance(m, TransformerBlock)]
    merged = [b for b in blocks if b.downsample <= tome.max_downsample]
    other = [b for b in blocks if b.downsample > tome.max_downsample]
    return {"blocks": len(blocks), "merged": len(merged),
            "unmerged": len(other),
            "unmerged_small_self": sum((latent // b.downsample) ** 2
                                       <= SMALL_KV for b in other)}


def phase_ldm(dev, bundle) -> tuple[dict, object]:
    """Phase 28: the exact keys with bench.py's --ldm on SD1.5: 8 frames,
    STEPS+STEPS DDIM steps.  Returns the launches and the ToMeConfig."""
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    cfg = ldm(exact_config(STEPS))
    frames = make_frames()
    inverter = Inverter(bundle, cfg)
    generator = with_stats(Generator(bundle, cfg))
    times = {}
    stage = functools.partial(timed, times)
    with ModuleLaunches({"SD1.5": bundle.unet}) as rec:
        reset_launches()
        latents, conds = stage("encode", lambda: inverter.encode(frames))
        inverted = stage("invert", lambda: inverter.ddim_inversion(latents,
                                                                   conds))
        n_inv = len(rec.calls["SD1.5"])
        generator.configure_frames(N_FRAMES)
        _, prompt = next(iter(generator.prompt.items()))
        context = stage("text", lambda: generator.text.embed_cfg(
            prompt, generator.negative_prompt))
        table = generator.fidx_table()
        clean = stage("generate", lambda: generator.ddim_sample(
            inverted[torch.as_tensor(generator.pad_src, device=dev)],
            context, fidx_table=table))
        out = stage("decode", lambda: generator.vae.decode(clean[:N_FRAMES]))
        launches = read_launches()
    topo = ldm_topology(bundle.unet, generator.tome, SIZE // 8)
    gen = rec.calls["SD1.5"][n_inv:]
    # attention on merged tokens runs one row per chunk and lane
    merged_cross = [sum(n for (k, sh), n in c["shapes"].items()
                        if k == "small_kv_attention"
                        and sh[0] * 4 == c["batch"]) for c in gen]
    print(f"[ldm] SD1.5, {N_FRAMES} frames {SIZE}x{SIZE}, {STEPS}+{STEPS} "
          f"DDIM steps, exact keys with merge_crossattn and merge_ff; "
          f"transformer blocks {topo}; cross-attentions on merged tokens a "
          f"generation call {sorted(set(merged_cross))}; UNet calls: "
          f"inversion {dict(inverter.unet_calls)}, generation "
          f"{dict(generator.unet_calls)}; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    if set(merged_cross) != {topo["merged"]}:
        raise AssertionError(f"[ldm] merged cross-attentions a call "
                             f"{merged_cross}, want {topo['merged']}")
    rec.check("ldm")
    rec.check_rows("ldm")
    check_frames("ldm", out, N_FRAMES)
    print_stats("ldm", generator, bundle.unet)
    print(f"[ldm] kernel launches in this run: {launches}")

    # the mean merge mode, which only ToMeConfig.merge_mode reaches: the
    # exact keys from the same inversion (launches counted with the LDM
    # run's)
    mean = with_stats(Generator(bundle, exact_config(STEPS)))
    mean.tome = dataclasses.replace(mean.tome, merge_mode="mean")
    mean.configure_frames(N_FRAMES)
    with ModuleLaunches({"SD1.5": bundle.unet}) as rec:
        before = read_launches()
        clean = timed(times, "generate (mean merge)", lambda: mean.ddim_sample(
            inverted[torch.as_tensor(mean.pad_src, device=dev)], context,
            fidx_table=table))
        launches = {k: v + launches[k] - before[k]
                    for k, v in read_launches().items()}
    print(f"[ldm] the exact keys with merge_mode mean: UNet calls "
          f"{dict(mean.unet_calls)}; generate "
          f"{times['generate (mean merge)']:.3f} s")
    rec.check("mean")
    rec.check_rows("mean")
    check_frames("mean", mean.vae.decode(clean[:N_FRAMES]), N_FRAMES)
    print_stats("mean", mean, bundle.unet)
    plain = dataclasses.replace(generator.tome, merge_crossattn=False,
                                merge_ff=False)
    for tag, tome in (("ldm", generator.tome), ("ldm, plain", plain),
                      ("ldm", generator.tome), ("ldm, plain", plain)):
        step_device_ms(tag, dev, bundle.unet, tome, 2, [1, 1], SIZE // 8)
    return launches, generator.tome


def phase_ldm_pnp(dev, bundle, inverted, src) -> tuple[dict, object]:
    """Phase 30: configs/dog.yaml's PnP keys with the fused sublayer and
    bench.py's --ldm on SD2.1, from phase 11's inversion (its latents and
    source table), LDM_PNP_STEPS DDIM steps.  Returns the launches and the
    ToMeConfig."""
    from vidtome_torch.pipeline.generator import Generator

    cfg = ldm(pnp_config())
    cfg["generation"]["n_timesteps"] = LDM_PNP_STEPS
    generator = with_stats(Generator(bundle, cfg))
    times = {}
    stage = functools.partial(timed, times)
    with ModuleLaunches({"SD2.1": bundle.unet}) as rec:
        reset_launches()
        generator.configure_frames(N_FRAMES)
        _, prompt = next(iter(generator.prompt.items()))
        context = stage("text", lambda: generator.context(prompt))
        table = generator.fidx_table()
        pad = torch.as_tensor(generator.pad_src, device=dev)
        clean = stage("generate", lambda: generator.ddim_sample(
            inverted[pad], context, fidx_table=table, src_table=src))
        out = stage("decode", lambda: generator.vae.decode(clean[:N_FRAMES]))
        launches = read_launches()
    topo = ldm_topology(bundle.unet, generator.tome, SIZE // 8)
    calls = rec.calls["SD2.1"]
    sub = sorted({c["got"]["fused_cross_sublayer"] for c in calls})
    small = sorted({c["got"]["small_kv_attention"] for c in calls})
    want_small = topo["merged"] + topo["unmerged_small_self"]
    print(f"[ldm pnp] SD2.1, {N_FRAMES} frames {SIZE}x{SIZE}, "
          f"{LDM_PNP_STEPS} DDIM steps from phase 11's inversion, "
          f"configs/dog.yaml's keys with the fused sublayer and "
          f"merge_crossattn / merge_ff; transformer blocks {topo}; launches "
          f"a UNet call: sublayer {sub} (want {topo['unmerged']}: the "
          f"unmerged blocks), small-KV {small} (want {want_small}: the "
          f"merged blocks' cross-attentions and the unmerged blocks' "
          f"self-attentions over at most SMALL_KV tokens); UNet calls "
          f"{dict(generator.unet_calls)}; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    if sub != [topo["unmerged"]] or small != [want_small]:
        raise AssertionError("[ldm pnp] sublayer / small-KV launches a call "
                             "differ from the topology")
    rec.check("ldm pnp")
    rec.check_rows("ldm pnp")
    check_frames("ldm pnp", out, N_FRAMES)
    print_stats("ldm pnp", generator, bundle.unet)
    print(f"[ldm pnp] kernel launches in this run: {launches}")
    return launches, generator.tome


def phase_sdxl_ldm(dev, bundle, inverted) -> tuple:
    """Phase 32: bench_sdxl's keys with --ldm (sdxl_ldm_config) on SDXL and
    its refiner from phase 17's inverted latents.  Returns the launches,
    the base's ToMeConfig, the refiner's bundle and its ToMeConfig."""
    from vidtome_torch.pipeline.generator import Generator

    cfg = sdxl_ldm_config()
    times = {}
    generator = timed(times, "build the refiner",
                      lambda: Generator(bundle, cfg))
    refiner = generator.refiner
    with_stats(generator)
    with_stats(refiner)
    run = drive_sdxl(dev, bundle, generator, times, inverted=inverted)
    if not (refiner.tome.merge_crossattn and refiner.tome.merge_ff):
        raise AssertionError("[sdxl ldm] the refiner did not inherit --ldm")
    print(f"[sdxl ldm] SDXL + refiner, {N_FRAMES} frames "
          f"{SDXL_SIZE}x{SDXL_SIZE}, {SDXL_STEPS} DDIM steps from phase 17's "
          f"inversion, the refiner from step {generator.split_step()}, "
          f"bench_sdxl keys with merge_crossattn / merge_ff; transformer "
          f"blocks: base {ldm_topology(bundle.unet, generator.tome, 128)}, "
          f"refiner {ldm_topology(refiner.bundle.unet, refiner.tome, 128)}; "
          f"UNet calls: base {dict(generator.unet_calls)}, refiner "
          f"{dict(refiner.unet_calls)}")
    check_calls("sdxl ldm", run, sdxl_wants(bundle, refiner,
                                            inversion=False))
    print_stats("sdxl ldm", generator, bundle.unet)
    print_stats("sdxl ldm, refiner", refiner, refiner.bundle.unet)
    print_run("sdxl ldm", run, times)
    tome, refiner_bundle, refiner_tome = (generator.tome, refiner.bundle,
                                          refiner.tome)
    del refiner, generator
    gc.collect()
    torch.cuda.empty_cache()
    plain = dataclasses.replace(tome, merge_crossattn=False, merge_ff=False)
    for tag, t in (("sdxl ldm", tome), ("sdxl ldm, plain", plain)):
        step_device_ms(tag, dev, bundle.unet, t, 2, [1, 1], SDXL_SIZE // 8)
    return run.launches, tome, refiner_bundle, refiner_tome


# the tail of the port (phases 34-36): native bundles, the stages run
# alone with a torch.profiler trace, the parity run and the quality gates
GATE_STEPS = 10
# int8, the step caches, and two modes the JAX package gates off: LDM
# merging and ragged chunk boundaries (ragged the exact side there)
GATES_RUN = ("int8", "ldm", "serve", "deepcache_w3", "chunk_ragged")
PARITY_PROFILES = ("int8", "serve_maxe3xb")
# the __global__ function of each hand-written kernel the exact path
# launches, as a trace names it (the full GroupNorm entry launches
# group_norm_kernel, as the stats and apply entries do, which the exact
# path does not run)
TRACE_SYMBOLS = {"flash_attention": "flash_fwd_kernel",
                 "small_kv_attention": "small_kv_kernel",
                 "full_group_norm": "group_norm_kernel",
                 "best_match": "best_match_kernel",
                 "geglu": "geglu_kernel"}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype, strides and bytes."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.stride() == b.stride()
            and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                            b.reshape(-1).contiguous().view(torch.uint8)))


def phase_checkpoint(dev, bundle, init_seconds: float) -> None:
    """Phase 34: the SD1.5 bundle (random, with its canny ControlNet) saved
    as a native bundle and loaded back onto the card: every tensor the same
    bits, one merged step (two UNet calls: the bank initialised, then merged
    against) the same bits on both; the save's and the load's seconds
    beside init_model's random init, and the bundle's bytes on disk."""
    from vidtome_torch.models.checkpoint import load_bundle, save_bundle
    from vidtome_torch.pipeline.generator import stage_tome

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sd15-native")
        t0 = time.perf_counter()
        save_bundle(bundle, path)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        back = load_bundle(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    mods = {"unet": "unet", "vae": "vae", "text": "text_encoder",
            "controlnet": "controlnet"}
    n = 0
    for name, attr in mods.items():
        sa = getattr(bundle, attr).state_dict()
        sb = getattr(back, attr).state_dict()
        odd = [k for k in sa if k not in sb or not same_bits(sa[k], sb[k])]
        if odd or sa.keys() != sb.keys():
            raise AssertionError(f"[checkpoint] {name}: {len(odd)} tensors "
                                 f"differ after the round trip, e.g. "
                                 f"{odd[:3]}")
        if any(t.device.type != dev.type for t in sb.values()):
            raise AssertionError(f"[checkpoint] {name} not on {dev}")
        n += len(sa)
    tome = stage_tome(CONFIG["generation"], use_pnp=False)
    runs = [step_calls(dev, unet, tome, 2, [1, 1], SIZE // 8,
                       torch.bfloat16)[0]
            for unet in (bundle.unet, bundle.unet, back.unet)]
    if not all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])):
        raise AssertionError("[checkpoint] two merged steps on the same "
                             "UNet differ: the step is not deterministic")
    if not all(torch.equal(a, b) for a, b in zip(runs[0], runs[2])):
        raise AssertionError("[checkpoint] a merged step on the loaded "
                             "bundle differs from the original's")
    print(f"[checkpoint] SD1.5 + canny ControlNet bf16 (text encoder fp32) "
          f"saved in {save_s:.3f} s, {nbytes} bytes on disk "
          f"({nbytes / 2 ** 30:.3f} GiB), loaded onto the card in "
          f"{load_s:.3f} s (init_model's random init of the same stack "
          f"{init_seconds:.3f} s); {n} tensors the same bits; a merged step "
          f"(2 UNet calls of 8 rows, {SIZE}x{SIZE}) the same bits on both")
    del back


def stage_yaml(work: str, profile_dir: str | None,
               mesh: dict | None = None, multihost: bool = False) -> str:
    """A config over configs/demo.yaml (its keys and default.yaml's
    beneath them): 8 frames of data/demo.mp4, STEPS+STEPS DDIM steps, its
    paths under ``work``, ``tpu.profile_dir``, ``tpu.mesh`` and
    ``tpu.multihost`` if given; written to ``<work>.yaml``, whose path it
    returns."""
    import yaml

    cfg = {"base_config": str(ROOT / "configs" / "demo.yaml"),
           "input_path": str(ROOT / "data" / "demo.mp4"), "work_dir": work,
           "inversion": {"n_frames": N_FRAMES, "steps": STEPS,
                         "save_steps": STEPS},
           "generation": {"n_timesteps": STEPS, "frame_range": [N_FRAMES]}}
    tpu = {"profile_dir": profile_dir, "mesh": mesh, "multihost": multihost}
    if any(tpu.values()):
        cfg["tpu"] = {k: v for k, v in tpu.items() if v}
    with open(work + ".yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return work + ".yaml"


def run_module(tag: str, *argv, timeout: int = 600) -> str:
    """``python -m argv...`` from the checkout's root; fails the phase on a
    non-zero exit.  Returns its standard output."""
    return run_modules({tag: (argv, {})}, timeout)[tag]


def run_modules(runs: dict, timeout: int = 600) -> dict:
    """``python -m argv...`` of each ``{tag: (argv, env)}`` from the
    checkout's root, ``env`` over this process's environment, all started
    together; fails the phase on a non-zero exit, or when one has not
    exited within ``timeout`` seconds (the others are killed as soon as
    one fails or the time is up).  Returns each one's standard output by
    tag."""
    procs, logs, ended = {}, {}, {}
    t0 = time.perf_counter()
    try:
        for tag, (argv, env) in runs.items():
            logs[tag] = (tempfile.TemporaryFile("w+"),
                         tempfile.TemporaryFile("w+"))
            procs[tag] = subprocess.Popen(
                [sys.executable, "-m", *argv], cwd=ROOT,
                env={**os.environ, **env}, stdout=logs[tag][0],
                stderr=logs[tag][1], text=True)
        while len(ended) < len(procs) and time.perf_counter() < t0 + timeout:
            for tag, p in procs.items():
                if tag not in ended and p.poll() is not None:
                    ended[tag] = time.perf_counter() - t0
            if any(procs[tag].returncode for tag in ended):
                break
            time.sleep(0.2)
        out = {}
        for tag, p in procs.items():
            if p.poll() is None:
                p.kill()
                p.wait()
            print(f"[{tag}] python -m {' '.join(runs[tag][0])}: exit "
                  f"{p.returncode} in "
                  f"{ended.get(tag, time.perf_counter() - t0):.1f} s"
                  + ("" if tag in ended else " (killed)"))
            stdout, stderr = logs[tag]
            stdout.seek(0)
            stderr.seek(0)
            out[tag] = stdout.read()
            if tag not in ended or p.returncode != 0:
                print(out[tag][-4000:], stderr.read()[-4000:], sep="\n",
                      file=sys.stderr)
        failed = [t for t, p in procs.items() if t not in ended
                  or p.returncode != 0]
        if failed:
            raise AssertionError(f"[{failed[0]}] {runs[failed[0]][0][0]} "
                                 f"exited {procs[failed[0]].returncode}")
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for files in logs.values():
            for f in files:
                f.close()


def trace_kernels(path: str) -> collections.Counter:
    """The launches of each hand-written kernel in a Chrome trace."""
    import re

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    pats = {k: re.compile(rf"\b{s}\b") for k, s in TRACE_SYMBOLS.items()}
    got = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            for k, pat in pats.items():
                if pat.search(e.get("name", "")):
                    got[k] += 1
    return got


def phase_stages(dev) -> None:
    """Phase 35: the two stages alone, as subprocesses (python -m
    vidtome_torch.pipeline.inverter, then .generator) on stage_yaml's
    config with tpu.profile_dir, each must exit 0, leaving the latents,
    inversion_prompts.txt, the edited frames and a trace of each stage
    holding its vidtome/ step spans; the generator's trace must name each
    hand-written kernel of the exact path as many times as ModuleLaunches
    reads from the same config's generation in this process (cli's
    setup_from_argv, run_inversion, run_generation: every call also
    launching what its modules imply), and the subprocess's frames must
    agree with this process's (max |diff|, and the PSNR through python -m
    vidtome_torch.eval, >= 35 dB).  The generation loop's wall time traced
    and untraced, here, both warm."""
    import contextlib

    from vidtome_torch import cli
    from vidtome_torch.io.video import load_video
    from vidtome_torch.pipeline.generator import Generator

    with tempfile.TemporaryDirectory() as tmp:
        sub = stage_yaml(os.path.join(tmp, "sub"), os.path.join(tmp, "trace"))
        run_module("stages", "vidtome_torch.pipeline.inverter", "--config",
                   sub)
        log = run_module("stages", "vidtome_torch.pipeline.generator",
                         "--config", sub)
        lat = Path(tmp, "sub", "latents", "stable-diffusion-v1-5")
        frames_sub = Path(tmp, "sub", "watercolor", "frames")
        traces = sorted(Path(tmp, "trace").glob("ddim_sample_*.json"))
        inverts = sorted(Path(tmp, "trace").glob("invert_*.json"))
        have = {"latents": sorted(p.name for p in lat.glob("noisy_*.npy")),
                "prompts": (lat / "inversion_prompts.txt").is_file(),
                "frames": len(list(frames_sub.glob("*.png"))),
                "traces": [p.name for p in traces + inverts]}
        print(f"[stages] on disk: {have}")
        if not (have["latents"] and have["prompts"]
                and have["frames"] == N_FRAMES and len(traces) == 1
                and len(inverts) == 1):
            raise AssertionError(f"[stages] missing outputs: {have}")
        for path, step in ((inverts[0], "vidtome/invert_step"),
                           (traces[0], "vidtome/gen_step")):
            with open(path) as f:
                if not any(e.get("name", "").startswith(step)
                           for e in json.load(f)["traceEvents"]):
                    raise AssertionError(f"[stages] {path.name} holds no "
                                         f"{step} span")
        if f"profiler trace written to {traces[0]}" not in log:
            raise AssertionError("[stages] the generator did not report "
                                 "its trace")
        traced_sub = float(log.split(f"{traces[0]} (")[1].split(" s")[0])
        in_trace = trace_kernels(str(traces[0]))

        # the same config in this process, untraced, then traced
        here = stage_yaml(os.path.join(tmp, "here"), None)
        with contextlib.chdir(ROOT), contextlib.redirect_stdout(io.StringIO()):
            config, sd = cli.setup_from_argv(["--config", here])
        cli.run_inversion(config, sd)
        loops = []
        plain_loop = Generator.ddim_sample

        def timed_loop(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = plain_loop(self, *args, **kwargs)
            torch.cuda.synchronize()
            loops.append(time.perf_counter() - t0)
            return out

        Generator.ddim_sample = timed_loop
        try:
            with ModuleLaunches({"SD1.5 stages": sd.unet}) as rec:
                cli.run_generation(config, sd)
            cli.run_generation(config, sd)  # timed without the hooks
            traced_cfg = copy.deepcopy(config)
            traced_cfg["tpu"] = {"profile_dir": os.path.join(tmp, "trace2")}
            traced_cfg["generation"]["output_path"] = os.path.join(
                tmp, "here-traced")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.run_generation(traced_cfg, sd)
        finally:
            Generator.ddim_sample = plain_loop
        traced_here = float(buf.getvalue().split(" s traced)")[0]
                            .rsplit("(", 1)[1])
        rec.check("stages")
        calls = rec.calls["SD1.5 stages"]
        want = {k: sum(c["got"][k] for c in calls) for k in KERNELS}
        got = {k: in_trace[k] for k in TRACE_SYMBOLS}
        print(f"[stages] trace of the generator's loop: kernel launches "
              f"{got}; ModuleLaunches over the {len(calls)} UNet calls of "
              f"the same generation here {want}; per call "
              + ", ".join(f"{k} {got[k] / len(calls):.1f} / "
                          f"{want[k] / len(calls):.1f}" for k in got))
        odd = [k for k in KERNELS if (want[k] > 0) != (k in TRACE_SYMBOLS)
               or got.get(k, 0) != want[k]]
        if odd:
            raise AssertionError(f"[stages] trace launches {got} against "
                                 f"{want}: {odd}")

        frames_here = Path(config["generation"]["output_path"], "watercolor",
                           "frames")
        a = load_video(str(frames_sub), SIZE, SIZE)
        b = load_video(str(frames_here), SIZE, SIZE)
        out = run_module("stages", "vidtome_torch.eval", "--a",
                         str(frames_sub), "--b", str(frames_here),
                         "--height", str(SIZE), "--width", str(SIZE))
        score = json.loads(out[out.index("{"):])
        print(f"[stages] subprocess frames vs this process's: max |diff| "
              f"{np.abs(a - b).max():.6f}, python -m vidtome_torch.eval: "
              f"PSNR mean {score['psnr_mean']:.2f} dB (min "
              f"{score['psnr_min']:.2f}), SSIM {score['ssim_mean']:.6f}")
        if score["frames"] != N_FRAMES or score["psnr_mean"] < 35.0:
            raise AssertionError(f"[stages] subprocess and in-process frames "
                                 f"differ: {score}")
        print(f"[stages] generation loop ({STEPS} steps, {len(calls)} UNet "
              f"calls) wall here: untraced {loops[1]:.3f} s, traced "
              f"{traced_here:.3f} s ({traced_here / loops[1]:.2f}x; "
              f"{loops[2]:.3f} s with the trace's export); traced in the "
              f"generator's subprocess {traced_sub:.3f} s (the process's "
              f"first loop)")
        del sd


def phase_tools(dev, bundle) -> None:
    """Phase 36: tools/parity_run.run_parity on the SD1.5 bundle (random
    weights): 8 frames at 512x512, GATE_STEPS steps, the int8 and
    serve_maxe3xb profiles checked against the exact bf16 edit; then
    python -m vidtome_torch.tools.quality_gate's main for GATES_RUN, one
    seed, 8 frames, GATE_STEPS steps: each gate's dB and its record's
    backend (the card's name and power limit).  With random weights the dB
    measure how far a lever moves the output, not perceptual quality."""
    from vidtome_torch.tools import parity_run, quality_gate

    with tempfile.TemporaryDirectory() as tmp:
        clip = parity_run._ensure_clip(None, tmp, N_FRAMES, SIZE)
        t0 = time.perf_counter()
        record = parity_run.run_parity(
            bundle, os.path.join(tmp, "parity"), clip, frames=N_FRAMES,
            steps=GATE_STEPS, size=SIZE, check_profiles=PARITY_PROFILES)
        print(f"[tools] run_parity in {time.perf_counter() - t0:.1f} s: "
              f"{json.dumps(record)}")
        for name in PARITY_PROFILES:
            if not np.isfinite(record[f"profile_{name}_psnr_db"]):
                raise AssertionError(f"[tools] parity profile {name}")
        if not np.isfinite(record["inversion_recon_psnr_db"]):
            raise AssertionError("[tools] parity reconstruction")
        records = quality_gate.main([
            "--gate", ",".join(GATES_RUN), "--seeds", "1", "--frames",
            str(N_FRAMES), "--steps", str(GATE_STEPS), "--size", str(SIZE),
            "--work", tmp])
        for rec in records:
            with open(Path(tmp, "gates", f"{rec['gate']}.json")) as f:
                saved = json.load(f)
            print(f"[tools] gate {rec['gate']}: {rec['psnr_mean_db']} dB "
                  f"({rec['elapsed_s']} s; backend {saved['backend']!r})")
            if saved["psnr_mean_db"] != rec["psnr_mean_db"] or \
                    "power limit not read" in saved["backend"]:
                raise AssertionError(f"[tools] gate record {saved}")
        if [r["gate"] for r in records] != list(GATES_RUN):
            raise AssertionError(f"[tools] gates run: {records}")


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


# ---------------------------------------------------------------------------
# Phase 37: the mesh (vidtome_torch/parallel/), two ranks
# ---------------------------------------------------------------------------

MESH_SERVE_STEPS = 20  # serve.yaml's schedules: 6 full steps, then cached
MESH_PNP_STEPS = 10    # attention injection on 5 steps, conv on 8
MESH_DB = 35.0         # frames (or a call's output) against the one-rank run


def mesh_kinds(tome) -> list:
    """meta_rows' kinds of phase 37: SD1.5's inversion and exact
    generation at {data: 2}, {model: 2} and {data: 2, model: 2}; the
    serving keys' calls at {data: 2}; SD2.1's inversion and PnP calls
    (injections on and off, the fused sublayer) at {data: 2} and {model:
    2}; one int8 call (fused W8A8 resnets) and one SDXL and one refiner
    call (batch 4) at {model: 2}.  Rank 0's: these calls split evenly over
    the ranks (rows, heads), so each rank gives the kernels rank 0's
    shapes, except SD2.1's 5 heads at {model: 2} (3 and 2): there every
    rank's.  Phase 37 holds each rank's shapes to these rows."""
    from vidtome_torch.parallel.mesh import Mesh

    def ranks(data, model, every=False):
        return [Mesh(data, model, rank=r, device="meta")
                for r in range(data * model if every else 1)]

    xl = SDXL_SIZE // 8
    fused = {"resnet_mode": "fused"}
    sub = {"sublayer_mode": "fused"}
    pnp = {**sub, "attn_inject": True, "conv_inject": True}
    out = []
    for data, model in ((2, 1), (1, 2), (2, 2)):
        for m in ranks(data, model):
            r = f"mesh {data}x{model} rank {m.rank}"
            out += [(f"{r} SD1.5 inversion", "SD1.5", 64, 2, [1], None, {},
                     m),
                    (f"{r} SD1.5 exact", "SD1.5", 64, 2, [1, 1],
                     tome(CONFIG), {}, m)]
    for m in ranks(2, 1):
        out += [(f"mesh 2x1 rank {m.rank} SD1.5 serve {cache}, {lanes} "
                 f"lanes", "SD1.5", 64, lanes, [1, 1],
                 tome(serve_config(MESH_SERVE_STEPS)),
                 {**fused, "cache_mode": cache}, m)
                for cache in ("full", "shallow") for lanes in (2, 1)]
    for data, model in ((2, 1), (1, 2)):
        for m in ranks(data, model, every=model > 1):
            r = f"mesh {data}x{model} rank {m.rank}"
            out += [(f"{r} SD2.1 inversion", "SD2.1", 64, 2, [1], None, {},
                     m),
                    (f"{r} SD2.1 PnP", "SD2.1", 64, 3, [1, 1],
                     tome(pnp_config(MESH_PNP_STEPS), True), pnp, m),
                    (f"{r} SD2.1 PnP, no injection", "SD2.1", 64, 3, [1, 1],
                     tome(pnp_config(MESH_PNP_STEPS), True), sub, m)]
    for m in ranks(1, 2):
        r = f"mesh 1x2 rank {m.rank}"
        out += [(f"{r} SD1.5 W8A8", "SD1.5", 64, 2, [1], None, fused, m),
                (f"{r} SDXL", "SDXL", xl, 1, [1], None, {}, m),
                (f"{r} refiner", "refiner", xl, 1, [1], None, {}, m)]
    return out


def frames_db(a: torch.Tensor, b: torch.Tensor, peak: float = 1.0) -> float:
    """PSNR of ``a`` against ``b`` at ``peak``, in dB (inf when equal)."""
    mse = ((a.float() - b.float()) ** 2).mean().item()
    return float("inf") if mse == 0 else 10 * np.log10(peak ** 2 / mse)


def taped_draws(table: np.ndarray, caches: list | None, dev):
    """The Generator's draws (DrawSource of ``table``) with a tape of the
    merging calls' ``share_match`` plan caches: ``caches`` None records
    each call's cache (``.caches``, in call order), a list hands the calls
    its caches in that order (the matchings of another run)."""
    from vidtome_torch.models.tome import DrawSource

    class Taped(DrawSource):
        def __init__(self):
            super().__init__(table)
            self.replay = caches is not None
            self.caches = list(caches) if self.replay else []

        def call(self, *args, **kwargs):
            call = super().call(*args, **kwargs)
            if self.replay:
                call.plan_cache = plans_on(self.caches.pop(0), dev)
            else:
                self.caches.append(call.plan_cache)
            return call

    return Taped()


def plans_differ(a: list, b: list) -> int:
    """How many calls of two plan tapes matched differently."""
    def tensors(cache):
        out = []
        for key in sorted(cache, key=str):
            entry = cache[key]
            plans = list(entry.get("plans", []))
            plans += [entry["global_plan"]] if "global_plan" in entry else []
            out += [t.cpu() for p in plans for t in (
                p.merge_gather, p.unmerge_gather, p.unm_idx)]
        return out

    if len(a) != len(b):
        raise AssertionError(f"plan tapes of {len(a)} and {len(b)} calls")
    return sum(not all(x.shape == y.shape and torch.equal(x, y)
                       for x, y in zip(tensors(p), tensors(q)))
               or len(tensors(p)) != len(tensors(q)) for p, q in zip(a, b))


def mesh_edit(bundle, cfg: dict, mesh, size: int = SIZE,
              plans: list | str | None = None,
              given: dict | None = None,
              frames: np.ndarray | None = None) -> dict:
    """One edit of ``frames`` (default ``make_frames()``) under ``cfg``
    through the port's Inverter and Generator (PnP from the inversion's
    saved latents) on ``mesh`` (None: this rank alone): the clean latents,
    the frames, the stage seconds, the UNet calls by kind, the peak memory
    and, on a mesh, its ModuleLaunches and the collectives' calls and
    seconds.  ``plans`` "record" keeps the generation's plan tape
    (``"plans"``), a tape hands its matchings to the generation's calls
    (taped_draws); ``given`` (the ``inverted`` latents and PnP ``src``
    table another run returned) takes the place of this run's
    inversion."""
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    dev = bundle.device
    frames = make_frames(size) if frames is None else frames
    times: dict = {}
    stage = functools.partial(timed, times)
    torch.cuda.reset_peak_memory_stats(dev)
    inverter = Inverter(bundle, cfg, mesh=mesh)
    generator = Generator(bundle, cfg, mesh=mesh)
    if mesh is not None:
        mesh.stats.clear()
    rec = ModuleLaunches({"UNet": bundle.unet}, count=mesh is not None)
    with rec:
        reset_launches()
        if given is None:
            latents, conds = stage("encode",
                                   lambda: inverter.encode(frames))
            inverted = stage("invert",
                             lambda: inverter.ddim_inversion(latents, conds))
        else:
            inverted = given["inverted"].to(dev)
        generator.configure_frames(N_FRAMES)
        prompt = next(iter(generator.prompt.values()))
        context = generator.context(prompt)
        pad = torch.as_tensor(generator.pad_src, device=dev)
        inputs = {}
        if generator.use_pnp:
            inputs["src_table"] = (inverter.source_table(
                generator.scheduler.timesteps)[:, pad] if given is None
                else given["src"].to(dev))
        table = generator.fidx_table()
        if plans is not None:
            inputs["draws"] = taped_draws(
                generator.draw_source(table.shape[1]).table,
                None if plans == "record" else plans, dev)
        clean = stage("generate", lambda: generator.ddim_sample(
            inverted[pad], context, fidx_table=table, **inputs))
        out = stage("decode", lambda: generator.vae.decode(clean[:N_FRAMES]))
        launches = read_launches()
    check_frames("mesh", out, N_FRAMES, size)
    calls = {"inversion": dict(inverter.unet_calls),
             "generation": dict(generator.unet_calls)}
    return {"clean": clean, "frames": out, "times": times, "calls": calls,
            "launches": launches, "rec": rec,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "collectives": dict(mesh.stats) if mesh is not None else {},
            "plans": inputs["draws"].caches if plans == "record" else None,
            "inverted": inverted, "src": inputs.get("src_table")}


def mesh_same_bits(mesh, t: torch.Tensor) -> bool:
    """Whether every rank of ``mesh`` holds ``t`` bit for bit."""
    every = mesh.all_gather(t.contiguous()[None], "mesh")
    return all(torch.equal(every[r], every[0]) for r in range(mesh.size))


def mesh_report(tag: str, mesh, got: dict, ref, rows: dict, unet_calls: int,
                out_dir: str, same: str, compare: str) -> dict:
    """Phase 37's checks of one meshed run on this rank: each UNet call's
    launches what its modules imply, every kernel shape a phase-3 row,
    every rank's ``same`` output (the latents) the same bits; on rank 0
    the dB (and max |diff|) of its ``compare`` output against the one-rank
    run ``ref``, at least MESH_DB (frames at peak 1, a UNet call's output
    at its max |ref|).  Writes this rank's record to ``out_dir`` and
    returns it."""
    rec = got.pop("rec")
    rec.check(f"mesh {tag} rank {mesh.rank}")
    rec.check_rows(f"mesh {tag} rank {mesh.rank}", rows)
    if not mesh_same_bits(mesh, got[same].float()):
        raise AssertionError(f"[mesh {tag}] the ranks' {same} differ")
    kinds = collections.Counter(
        json.dumps({k: v for k, v in c["got"].items() if v})
        for c in rec.calls["UNet"])
    record = {"tag": tag, "rank": mesh.rank, "shape": mesh.shape,
              "launches_by_call": {k: n for k, n in kinds.items()},
              "unet_calls": len(rec.calls["UNet"]),
              "launches": got["launches"], "peak_gib": got["peak_gib"],
              "times": got.get("times", {}), "calls": got.get("calls", {}),
              "collective_calls": got["collectives"].get("calls", 0),
              "collective_ms_a_call": 1e3 * got["collectives"].get(
                  "seconds", 0.0) / max(1, unet_calls),
              "collective_mib_a_call": got["collectives"].get("bytes", 0)
              / 2 ** 20 / max(1, unet_calls)}
    if ref is not None:
        a, b = got[compare].float(), ref[compare].float()
        peak = 1.0 if compare == "frames" else b.abs().max().item()
        record.update(db=frames_db(a, b, peak),
                      max_abs_diff=(a - b).abs().max().item(),
                      ref_peak_gib=ref["peak_gib"],
                      ref_times=ref.get("times", {}))
        if not record["db"] >= MESH_DB:
            raise AssertionError(f"[mesh {tag}] {record['db']:.2f} dB "
                                 f"against one rank (want >= {MESH_DB})")
    with open(os.path.join(out_dir, f"{tag}.rank{mesh.rank}.json"),
              "w") as f:
        json.dump(record, f)
    return record


def mesh_witness(tag: str, bundle, cfg: dict, mesh, ref, got: dict,
                 out_dir: str) -> None:
    """Witnesses of a data-axis edit's distance from the one-rank run, each
    held like the run itself (launches, the ranks' latents the same bits,
    at least MESH_DB): the edit again on ``mesh`` with the one-rank run's
    matchings handed to every merging call (its plan tape), and its
    generation alone from the one-rank run's inversion (inverted latents,
    PnP source table) with those matchings, all from rank 0 through
    ``out_dir``.  Rank 0 prints how many calls the meshed run matched
    otherwise than one rank, its inverted latents' dB against one rank's,
    and each run's frames' dB against one rank's, beside the one-rank
    run's own sensitivity (``ref["nudged_db"]``, mesh_nudge)."""
    path = os.path.join(out_dir, f"{tag}.ref.pt")
    if mesh.rank == 0:
        torch.save({"plans": [plans_on(c, "cpu") for c in ref["plans"]],
                    "inverted": ref["inverted"].cpu(),
                    "src": ref["src"].cpu()}, path)
    mesh.barrier()
    one = torch.load(path, weights_only=False)
    runs = {"own matchings": got}
    for what, given in (("one rank's matchings", None),
                        ("one rank's inversion and matchings", one)):
        run = mesh_edit(bundle, cfg, mesh, plans=one["plans"], given=given)
        run.pop("rec").check(f"mesh {tag} witness rank {mesh.rank}")
        if not mesh_same_bits(mesh, run["clean"].float()):
            raise AssertionError(f"[mesh {tag} witness] the ranks' latents "
                                 f"differ")
        runs[what] = run
    if mesh.rank != 0:
        return
    inv = frames_db(got["inverted"], ref["inverted"],
                    ref["inverted"].abs().max().item())
    dbs = {k: frames_db(r["frames"], ref["frames"]) for k, r in runs.items()}
    worst = {k: (r["frames"].float() - ref["frames"].float()).abs().max()
             for k, r in runs.items()}
    print(f"[mesh] ({tag} witness) rank 0: "
          f"{plans_differ(got['plans'], ref['plans'])} of "
          f"{len(ref['plans'])} merging calls matched otherwise than one "
          f"rank; inverted latents {inv:.2f} dB against one rank's; frames "
          f"against one rank's: " + ", ".join(
              f"{k} {dbs[k]:.2f} dB (max |diff| {worst[k].item():.3e})"
              for k in runs) + f"; one rank's generation from its inversion "
          f"moved by a bf16 step, against its own: {ref['nudged_db']:.2f} "
          f"dB", flush=True)
    low = {k: v for k, v in dbs.items() if not v >= MESH_DB}
    if low:
        raise AssertionError(f"[mesh {tag} witness] against one rank {low} "
                             f"(want >= {MESH_DB})")


def mesh_nudge(bundle, cfg: dict, ref: dict) -> float:
    """The one-rank edit's own sensitivity: its generation again, alone on
    this rank (``bundle`` unsharded), from ``ref``'s inversion with every
    inverted latent moved by about one bf16 rounding step (a relative
    2**-8, seeded normal) and ``ref``'s matchings; the frames' dB against
    ``ref``'s."""
    x = ref["inverted"]
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    moved = (x.float() * (1 + 2 ** -8 * noise.to(x.device))).to(x.dtype)
    out = mesh_edit(bundle, cfg, None, plans=ref["plans"],
                    given={"inverted": moved, "src": ref["src"]})
    return frames_db(out["frames"], ref["frames"])


def mesh_call(unet, args: tuple, kwargs: dict, mesh, qt=None) -> dict:
    """One UNet call on this rank of ``mesh`` (None: alone): its output
    (gathered under a data axis), launches, ModuleLaunches and peak
    memory."""
    from vidtome_torch.pipeline.generator import call_rows

    x = args[0]
    rows = call_rows(mesh, x.shape[0])
    own = (lambda a: a) if rows is None else rows.take
    dev = x.device
    torch.cuda.reset_peak_memory_stats(dev)
    if mesh is not None:
        mesh.stats.clear()
    rec = ModuleLaunches({"UNet": unet}, count=mesh is not None)
    with rec, torch.inference_mode():
        reset_launches()
        out = unet(own(x), *args[1:2], own(args[2]), qt=qt, rows=rows,
                   **{k: own(v) if isinstance(v, torch.Tensor) else v
                      for k, v in kwargs.items()})
        out = out if rows is None else rows.gather(out)
        torch.cuda.synchronize()
        launches = read_launches()
    return {"out": out.float(), "launches": launches, "rec": rec,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "collectives": dict(mesh.stats) if mesh is not None else {}}


def mesh_rank(out_dir: str, devices: list[str], rows: dict,
              runs: tuple[str, ...]) -> None:
    """One rank of phase 37 (the process group exists): each of ``runs``
    ("a".."g", see phase_mesh) against a one-rank run of the same config
    and seed on rank 0, at full width with random weights."""
    from vidtome_torch.models.registry import init_model
    from vidtome_torch.ops.quant import quantize_unet
    from vidtome_torch.parallel.mesh import make_mesh, shard_bundle

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = torch.distributed.get_rank()
    dev = torch.device(devices[rank])
    lead = rank == 0

    def edit_runs(sd: str, cfgs: dict, meshes: dict,
                  witness: tuple = ()) -> None:
        # the one-rank edits on rank 0 first, from an unsharded bundle; a
        # fresh bundle (same seed) for each mesh; the runs in ``witness``
        # record their plan tapes and run again with one rank's
        def tape(k):
            return "record" if k in witness else None

        bundle = init_model(sd, weight_dtype="bf16", device=dev, seed=0)
        refs = ({k: mesh_edit(bundle, cfgs[k], None, plans=tape(k))
                 for k in meshes} if lead else {})
        for k in witness if lead else ():
            refs[k]["nudged_db"] = mesh_nudge(bundle, cfgs[k], refs[k])
        for k in refs.values():
            k.pop("rec")
        by_mesh: dict = {}
        for k, axes in meshes.items():
            by_mesh.setdefault(axes, []).append(k)
        for axes, keys in by_mesh.items():
            mesh = make_mesh(*axes, devices)
            if bundle.mesh is not None:
                del bundle
                gc.collect()
                torch.cuda.empty_cache()
                bundle = init_model(sd, weight_dtype="bf16", device=dev,
                                    seed=0)
            shard_bundle(bundle, mesh)
            for k in keys:
                got = mesh_edit(bundle, cfgs[k], mesh, plans=tape(k))
                n = sum(v for c in got["calls"].values()
                        for kind, v in c.items()
                        if kind in ("full", "shallow"))
                mesh_report(k, mesh, got, refs.get(k), rows, n, out_dir,
                            "clean", "frames")
                if k in witness:
                    mesh_witness(k, bundle, cfgs[k], mesh, refs.get(k), got,
                                 out_dir)
        del bundle
        gc.collect()
        torch.cuda.empty_cache()

    if "a" in runs or "b" in runs or "c" in runs:
        cfgs = {"a": CONFIG, "b": CONFIG,
                "c": serve_config(MESH_SERVE_STEPS)}
        meshes = {k: v for k, v in (("a", (2, 1)), ("c", (2, 1)),
                                    ("b", (1, 2))) if k in runs}
        edit_runs("1.5", cfgs, meshes)
    if "d" in runs:
        cfg = pnp_config(MESH_PNP_STEPS)
        edit_runs("2.1", {"d data": cfg, "d model": cfg},
                  {"d data": (2, 1), "d model": (1, 2)}, ("d data",))
    if "g" in runs:
        edit_runs("1.5", {"g": CONFIG}, {"g": (2, 2)})
    if "e" in runs:
        from vidtome_torch.tools.profiles import INV_SERVE_PROFILES

        bundle = init_model("1.5", weight_dtype="bf16", device=dev, seed=0)
        if INV_SERVE_PROFILES["int8_fused"][0] != {"quant": "int8",
                                                    "resnet_mode": "fused"}:
            raise AssertionError("bench.py's int8_fused keys changed")
        latent, width = SIZE // 8, bundle.unet.config.cross_attention_dim
        x, ctx = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (
            np.random.default_rng(5).standard_normal(s, np.float32)
            for s in ((8, latent, latent, 4), (8, 77, width))))
        args, kw = (x, 501, ctx), {"resnet_mode": "fused"}
        with gn_mode("full"):
            ref = (mesh_call(bundle.unet, args, kw, None,
                             quantize_unet(bundle.unet)) if lead else None)
            mesh = make_mesh(1, 2, devices)
            shard_bundle(bundle, mesh)
            got = mesh_call(bundle.unet, args, kw, mesh,
                            quantize_unet(bundle.unet))
            if ref is not None:
                ref.pop("rec")
            mesh_report("e", mesh, got, ref, rows, 1, out_dir, "out", "out")
        del bundle
        gc.collect()
        torch.cuda.empty_cache()
    if "f" in runs:
        for sd, tag in (("xl", "f SDXL"), ("xl-refiner", "f refiner")):
            bundle = init_model(sd, weight_dtype="bf16", device=dev, seed=0)
            x, ctx, pooled, ids = sdxl_unet_args(dev, bundle.unet, 4,
                                                 SDXL_SIZE // 8, 8)
            args = (x.bfloat16(), 501, ctx.bfloat16())
            kw = {"add_text_embeds": pooled, "add_time_ids": ids}
            ref = mesh_call(bundle.unet, args, kw, None) if lead else None
            if ref is not None:
                ref.pop("rec")
            mesh = make_mesh(1, 2, devices)
            shard_bundle(bundle, mesh)
            got = mesh_call(bundle.unet, args, kw, mesh)
            mesh_report(tag, mesh, got, ref, rows, 1, out_dir, "out", "out")
            del bundle, ref, got
            gc.collect()
            torch.cuda.empty_cache()


def mesh_cli() -> dict:
    """Phase 37 (h): ``python -m vidtome_torch.cli`` on stage_yaml's config
    without a mesh (one rank), with ``tpu.mesh: {data: 2}`` (the entry
    starts its two ranks itself, a card each over NCCL, each building its
    mesh from the config, its card its rank's), and the same through
    torchrun (``--standalone --nproc-per-node 2``: the ranks join the
    launcher's group, each on its LOCAL_RANK's card).  Each must exit 0; a
    meshed run reports the mesh on both ranks; its rank 0 alone writes the
    latents, the prompt file and the frames, at least MESH_DB against the
    one-rank run's.  Returns the frames by run."""
    from vidtome_torch.io.video import load_video

    runs = {"one rank": ("vidtome_torch.cli",),
            "self-started": ("vidtome_torch.cli",),
            "torchrun": ("torch.distributed.run", "--standalone",
                         "--nproc-per-node", "2", "-m", "vidtome_torch.cli")}
    with tempfile.TemporaryDirectory() as tmp:
        frames = {}
        for tag, argv in runs.items():
            work = os.path.join(tmp, tag.replace(" ", "-"))
            cfg = stage_yaml(work, None,
                             None if tag == "one rank" else {"data": 2})
            log = run_module(f"mesh cli {tag}", *argv, "--config", cfg)
            wall = [line for line in log.splitlines() if "wall time" in line]
            print(f"[mesh] (h) CLI {tag}: {wall}")
            if tag != "one rank":
                want = ["device mesh: {'data': 2, 'model': 1} (rank "
                        f"{r}: data {r}, model 0, on cuda:{r})"
                        for r in range(2)]
                if tag == "self-started":
                    want.append("starting 2 ranks for tpu.mesh "
                                "{'data': 2}")
                missing = [w for w in want if w not in log]
                if missing or len(wall) != 2:
                    raise AssertionError(f"[mesh cli {tag}] {missing}, "
                                         f"{len(wall)} wall lines")
            lat = Path(work, "latents", "stable-diffusion-v1-5")
            if not (lat / "inversion_prompts.txt").is_file():
                raise AssertionError(f"[mesh cli {tag}] no prompt file")
            frames[tag] = torch.from_numpy(load_video(
                str(Path(work, "watercolor", "frames")), SIZE, SIZE))
        for tag in ("self-started", "torchrun"):
            db = frames_db(frames[tag], frames["one rank"])
            print(f"[mesh] (h) CLI {tag} on {{data: 2}}: {db:.2f} dB against"
                  f" one rank, max |diff| "
                  f"{(frames[tag] - frames['one rank']).abs().max():.3e}")
            if not db >= MESH_DB:
                raise AssertionError(f"[mesh cli {tag}] {db:.2f} dB against "
                                     f"one rank (want >= {MESH_DB})")
    return frames


def phase_mesh(dev) -> tuple[dict, dict | None]:
    """Phase 37: vidtome_torch.parallel on two ranks, the main path's
    kernels on each (the counters read in the ranks' own processes).
    Runs, each against a one-rank run of the same config and seed:
      (a) the exact keys (CONFIG, STEPS+STEPS) at {data: 2};
      (b) the same at {model: 2};
      (c) configs/serve.yaml's keys (MESH_SERVE_STEPS) at {data: 2}: fused
          resnets, the step caches, CFG-skip calls of 4 rows;
      (d) SD2.1 on configs/dog.yaml's PnP keys with the fused sublayer
          (MESH_PNP_STEPS) at {data: 2} (12 rows: lane 1 split over the
          ranks) and at {model: 2} (5 heads split 3 / 2);
      (e) one int8 UNet call (bench.py's int8_fused keys: W8A8 fused
          resnets, VIDTOME_GN_MODE=full) at {model: 2};
      (f) one SDXL and one refiner UNet call at 1024x1024 (batch 4) at
          {model: 2}: the refiner's 96-wide heads 4 / 8 a rank;
      (g) (a) at {data: 2, model: 2} over NCCL, when four cards are
          visible;
      (h) the CLI at {data: 2}, the ranks self-started and under torchrun
          (mesh_cli), when two cards or more are visible.
    (d data) also runs with the one-rank run's matchings handed over, and
    its generation alone from the one-rank run's inversion and matchings
    (mesh_witness).
    Ranks get a card each over NCCL where as many are visible, else share
    card 0 over gloo (collectives through host memory).  Each run: each
    rank's launches per UNet call equal what its modules imply, every
    kernel shape a phase-3 row, every rank's latents (or output) the same
    bits, at least MESH_DB against the one-rank run.  Returns the ranks'
    launches summed (of (a)-(g)) and (h)'s frames by run (None where it did
    not run)."""
    from vidtome_torch.parallel.launch import backend_for, rank_devices, spawn

    rows = phase3_rows()
    launches = collections.Counter()
    plans = [(2, ("a", "b", "c", "d", "e", "f"))]
    if torch.cuda.device_count() >= 4:
        plans.append((4, ("g",)))
    else:
        print(f"[mesh] (g) not run: {torch.cuda.device_count()} card(s) "
              f"visible, it needs 4")
    for world, runs in plans:
        devices = [str(d) for d in rank_devices(world)]
        print(f"[mesh] runs {', '.join(runs)}: world size {world}, backend "
              f"{backend_for(devices)}, devices {devices}")
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            spawn(mesh_rank, world, (out, devices, rows, runs), devices)
            seconds = time.perf_counter() - t0
            records = []
            for name in sorted(os.listdir(out)):
                if name.endswith(".json"):
                    with open(os.path.join(out, name)) as f:
                        records.append(json.load(f))
        for r in records:
            launches.update(r["launches"])
            db = (f"; {r['db']:.2f} dB against one rank, max |diff| "
                  f"{r['max_abs_diff']:.3e}, one-rank peak "
                  f"{r['ref_peak_gib']:.2f} GiB, stage seconds "
                  + ", ".join(f"{k} {v:.3f}" for k, v in r["ref_times"].items())
                  if "db" in r else "")
            print(f"[mesh] ({r['tag']}) {r['shape']} rank {r['rank']}: "
                  f"{r['unet_calls']} UNet calls, launches a call (calls: "
                  f"launches) {r['launches_by_call']}; peak "
                  f"{r['peak_gib']:.2f} GiB; stage seconds "
                  + ", ".join(f"{k} {v:.3f}" for k, v in r["times"].items())
                  + f"; UNet calls {r['calls']}; collectives "
                  f"{r['collective_calls']}, {r['collective_ms_a_call']:.2f}"
                  f" ms and {r['collective_mib_a_call']:.1f} MiB a UNet call"
                  + db)
        want = {f"{t}.rank{k}" for t in runs for k in range(world)}
        got = {f"{r['tag'].split()[0]}.rank{r['rank']}" for r in records}
        if not want <= got:
            raise AssertionError(f"[mesh] runs without a record: "
                                 f"{sorted(want - got)}")
        print(f"[mesh] world size {world}: {len(records)} records in "
              f"{seconds:.1f} s")
    cli_frames = None
    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        cli_frames = mesh_cli()
        print(f"[mesh] (h) {time.perf_counter() - t0:.1f} s")
    else:
        print(f"[mesh] (h) not run: {torch.cuda.device_count()} card(s) "
              f"visible, it needs 2")
    return {k: launches[k] for k in KERNELS}, cli_frames


# ---------------------------------------------------------------------------
# Phase 38: the CLI under cluster starts (vidtome_torch/parallel/distributed)
# ---------------------------------------------------------------------------

STARTS = ("slurm", "ompi", "torchrun")


def start_runs(tmp: str, world: int) -> dict:
    """run_modules' runs of phase 38 at ``world`` ranks: stage_yaml's config
    with ``tpu.multihost: true`` (and ``tpu.mesh: {data: world}`` above
    one) under each of STARTS, a SLURM and an Open MPI start simulated by
    their variables alone (start_env), torchrun started as itself; at one
    rank also the plain CLI.  Keyed "<start> <rank>" ("torchrun" starts
    its ranks itself); each run's work dir is ``<tmp>/<start>-<world>``."""
    from vidtome_torch.testing import cluster_ports, start_env

    cli = ("vidtome_torch.cli", "--config")
    mesh = {"data": world} if world > 1 else None
    ports = dict(zip(STARTS[:2], cluster_ports(2)))
    runs = {}
    if world == 1:
        runs["plain"] = (cli + (stage_yaml(os.path.join(tmp, "plain"),
                                           None),), {})
    for kind in STARTS:
        cfg = stage_yaml(os.path.join(tmp, f"{kind}-{world}"), None, mesh,
                         multihost=True)
        if kind == "torchrun":
            runs[kind] = (("torch.distributed.run", "--standalone",
                           "--nproc-per-node", str(world), "-m") + cli
                          + (cfg,), {})
            continue
        for rank in range(world):
            runs[f"{kind} {rank}"] = (cli + (cfg,), start_env(
                kind, world, rank, ports[kind]))
    return runs


def start_witness(tmp: str) -> float:
    """(h)'s one-rank CLI edit (its config, weights, clip; setup_from_argv
    as the CLI builds them) from its own inversion, every inverted latent
    moved by about one bf16 step (mesh_nudge), against itself: dB."""
    from vidtome_torch import cli
    from vidtome_torch.io.video import load_video

    argv = ["--config", stage_yaml(os.path.join(tmp, "witness"), None)]
    with contextlib.redirect_stdout(io.StringIO()):
        cfg, bundle = cli.setup_from_argv(argv)
        clip = load_video(cfg["input_path"], SIZE, SIZE)[:N_FRAMES]
    ref = mesh_edit(bundle, cfg, None, plans="record", frames=clip)
    ref.pop("rec")
    db = mesh_nudge(bundle, cfg, ref)
    del bundle, ref
    gc.collect()
    torch.cuda.empty_cache()
    return db


def phase_starts(h_frames: dict | None) -> None:
    """Phase 38: ``python -m vidtome_torch.cli`` on stage_yaml's config (h's
    depth, full width, 512x512) with ``tpu.multihost: true``, each start
    as vidtome_torch.parallel.distributed resolves it (start_runs): a
    one-task SLURM start, a one-rank Open MPI start and ``torchrun
    --nproc-per-node 1``, beside the plain CLI, all four at once on card
    0; each must exit 0, print its start line (process 0/1, backend nccl,
    card 0, from its start) and write frames at least MESH_DB against the
    plain run's.  With two cards or more the same three starts at {data:
    2} on two ranks (a card each), whose frames must read at least MESH_DB
    against the plain run's and against (h)'s torchrun run's
    (``h_frames``).  Then (h)'s witness (start_witness), its dB printed."""
    import re

    from vidtome_torch.io.video import load_video

    def check(tag: str, world: int, logs: dict, frames, ref: dict) -> None:
        for rank in range(world):
            log = logs[tag if tag == "torchrun" else f"{tag} {rank}"]
            want = (f"initialized: process {rank}/{world}, backend nccl, "
                    f"card {rank}, from {tag}")
            line = re.search(rf"multi-host \S+ {re.escape(want)}[^\[\n]*",
                             log)
            if line is None:
                raise AssertionError(f"[starts] {tag}: no {want!r}")
            print(f"[starts] {tag}: {line.group()}")
            if world > 1 and f"(rank {rank}: data {rank}, model 0, on " \
                    f"cuda:{rank})" not in log:
                raise AssertionError(f"[starts] {tag}: rank {rank}'s mesh")
        for name, other in ref.items():
            db = frames_db(frames, other)
            print(f"[starts] {tag} on {world} rank(s): {db:.2f} dB against "
                  f"{name}, max |diff| {(frames - other).abs().max():.3e}")
            if not db >= MESH_DB:
                raise AssertionError(f"[starts] {tag}: {db:.2f} dB against "
                                     f"{name} (want >= {MESH_DB})")

    def frames_of(work: str):
        return torch.from_numpy(load_video(
            str(Path(work, "watercolor", "frames")), SIZE, SIZE))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        logs = run_modules(start_runs(tmp, 1))
        plain = frames_of(os.path.join(tmp, "plain"))
        wall = [line for line in logs["plain"].splitlines()
                if "wall time" in line]
        print(f"[starts] plain CLI on one rank: {wall}")
        for kind in STARTS:
            check(kind, 1, logs, frames_of(os.path.join(tmp, f"{kind}-1")),
                  {"the plain one-rank CLI": plain})
        cards = torch.cuda.device_count()
        if cards >= 2:
            logs = run_modules(start_runs(tmp, 2))
            ref = {"the plain one-rank CLI": plain}
            if h_frames is not None:
                ref["(h)'s torchrun run"] = h_frames["torchrun"]
            for kind in STARTS:
                check(kind, 2, logs, frames_of(
                    os.path.join(tmp, f"{kind}-2")), ref)
        else:
            print(f"[starts] the starts at {{data: 2}} not run: {cards} "
                  f"card(s) visible, they need 2")
        print(f"[starts] (h)'s witness: one rank's CLI edit from its "
              f"inversion moved by a bf16 step, against its own: "
              f"{start_witness(tmp):.2f} dB")
    print(f"[starts] phase 38 {time.perf_counter() - t0:.1f} s")


def main(argv: list[str]) -> int:
    start = time.perf_counter()
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
    seconds = {}

    def step(tag, fn, *args, **kwargs):  # a phase, its seconds kept
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[tag] = round(time.perf_counter() - t, 1)
        return out

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    name, _ = step("1", phase_device)
    step("2", phase_build, dev)
    stats = step("3", phase_kernels, dev)
    free()
    mesh, h_frames = step("37", phase_mesh, dev)

    from vidtome_torch.models.registry import init_model

    t0 = time.perf_counter()
    bundle = init_model("1.5", weight_dtype="bf16", device=dev, seed=0,
                        control="canny")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"[main] SD1.5 and a canny ControlNet, random weights, on the "
          f"card in {init_s:.1f} s")
    exact = step("4", phase_main_path, dev, bundle)
    step("5", phase_reference, dev, bundle)
    launches = step("6", phase_serving, dev, bundle)
    int8 = step("7", phase_int8, dev, bundle)
    step("8", phase_int8_reference, dev, bundle)
    controlnet = step("9", phase_controlnet, dev, bundle)
    step("10", phase_controlnet_reference, dev, bundle)
    batch, tome = step("25", phase_chunk_batch, dev, bundle)
    step("26", reference_steps, "batch", dev, bundle.unet, tome, 2, [1, 2],
         16, resnet_mode="fused")
    ragged = step("27", phase_ragged, dev, bundle)
    ldm15, tome = step("28", phase_ldm, dev, bundle)
    step("29", reference_steps, "ldm", dev, bundle.unet, tome, 2, [1, 1], 16)
    free()
    step("34", phase_checkpoint, dev, bundle, init_s)
    free()
    step("35", phase_stages, dev)
    free()
    step("36", phase_tools, dev, bundle)
    free()
    step("38", phase_starts, h_frames)

    del bundle
    free()
    t0 = time.perf_counter()
    bundle = init_model("2.1", weight_dtype="bf16", device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[pnp] SD2.1 random weights on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    pnp, inverted, src = step("11", phase_pnp, dev, bundle)
    step("11 call", phase_pnp_call, dev, bundle)
    step("12", phase_reference_sd21, dev, bundle)
    ldm_pnp, tome = step("30", phase_ldm_pnp, dev, bundle, inverted, src)
    step("31", reference_steps, "ldm pnp", dev, bundle.unet, tome, 3, [1, 1],
         16, sublayer_mode="fused", attn_inject=True, conv_inject=True)

    del bundle, inverted, src
    free()
    with tempfile.TemporaryDirectory() as nets_dir:
        nets = write_control_nets(nets_dir)
        step("13", phase_control_models, dev, nets)
        t0 = time.perf_counter()
        bundle = init_model("1.5", weight_dtype="bf16", device=dev, seed=0,
                            control="softedge")
        torch.cuda.synchronize()
        print(f"[lora] SD1.5 and a softedge ControlNet, random weights, on "
              f"the card in {time.perf_counter() - t0:.1f} s")
        lora = step("14", phase_lora, dev, bundle)
        for env, _ in nets.values():
            os.environ.pop(env, None)

    del bundle
    free()
    t0 = time.perf_counter()
    bundle = init_model("depth", weight_dtype="bf16", device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[depth] SD2-depth random weights on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    depth = step("15", phase_depth, dev, bundle)
    step("16", phase_depth_reference, dev, bundle)

    del bundle
    free()
    t0 = time.perf_counter()
    bundle = init_model("xl", weight_dtype="bf16", device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[sdxl] SDXL random weights on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    sdxl, refiner, inverted = step("17", phase_sdxl, dev, bundle)
    step("17 calls", sdxl_call_times, dev, "sdxl",
         [("SDXL", bundle.unet, 8, {}), ("refiner", refiner.unet, 8, {})])
    step("18", phase_sdxl_reference, dev, bundle, refiner)
    del refiner
    free()
    sdxl_int8, refiner = step("19", phase_sdxl_int8, dev, bundle)
    step("20", phase_sdxl_int8_reference, dev, bundle, refiner)
    del refiner
    free()
    sdxl_pnp = step("21", phase_sdxl_pnp, dev, bundle)
    step("22", phase_sdxl_pnp_reference, dev, bundle)
    free()
    sdxl_serve = step("23", phase_sdxl_serving, dev, bundle, inverted)
    free()
    # before phase 24, which leaves its LoRA merged into the bundle
    sdxl_ldm, tome, refiner, refiner_tome = step(
        "32", phase_sdxl_ldm, dev, bundle, inverted)
    step("33", reference_steps, "sdxl ldm", dev, bundle.unet, tome, 1,
         [1, 1], 16, own=False)
    step("33 refiner", reference_steps, "sdxl ldm, refiner", dev,
         refiner.unet, refiner_tome, 1, [1, 1], 16, own=False)
    del refiner
    free()
    sdxl_lora = step("24", phase_sdxl_lora, dev, bundle, inverted)
    print(f"[main] chip_smoke.py's phases {time.perf_counter() - start:.1f} s "
          f"(the builds included); seconds by phase: {seconds}")
    for path in (exact, int8, controlnet, batch, ragged, ldm15, lora, pnp,
                 ldm_pnp, depth, sdxl, sdxl_int8, sdxl_pnp, sdxl_serve,
                 sdxl_lora, sdxl_ldm, mesh):
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
                       "vidtome_tpu/ops/matching.py:72"),
        "geglu": ("cuda", "vidtome_torch/csrc/geglu.cu",
                  "none (XLA fused it: vidtome_tpu/models/layers.py:446)")}
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
