"""Smoke run of the PyTorch/CUDA port (vidtome_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. device: the card's name and power limit;
  2. build: compile the CUDA libraries (flash attention, fused resnet, best
     match: one nvcc each, all started together, sm_90a) and the Triton
     GroupNorm kernels from this checkout's sources;
  3. kernel vs plain: each kernel in bf16 against its plain PyTorch version
     in fp32 on the same bf16 inputs, at the main paths' shapes, with both
     times (CUDA events);
  4. exact path: SD1.5 at full width with random weights (seeded), bf16,
     512x512, 8 frames made with numpy: CLIP + VAE encode, DDIM inversion,
     chunked CFG generation with local and global token merging (2 chunks:
     the bank is initialised on one and merged against on the other), VAE
     decode -- through the port's Inverter and Generator; the launch
     counters of the kernels it runs must rise during it;
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
     random weights the PSNR bounds nothing: printed only).
Then one JSON line with the kernels' numbers (launches: the serving
path's), and last:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
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
ATTN_TOL = 2e-2   # absolute, O(1) outputs: bf16 probabilities and output
GN_TOL = 3e-2     # relative to max(1, |y|): one bf16 ulp at |y| < 4 is 2^-6
RESNET_TOL = 2e-2  # relative to max |ref|: bf16 activations and h (2^-9 each)
MATCH_TOL = 1e-4  # absolute on max scores: fp32 sums in another order
MATCH_GAP = 1e-3  # argmax compared where the plain top-2 gap exceeds this
REF_TOL = 5e-2    # relative to max |ref|: bf16 path vs fp32 path, many layers

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


KERNELS = ("flash_attention", "group_norm", "fused_resnet", "best_match")


def counters() -> dict:
    """The launch counter of each kernel wrapper."""
    from vidtome_torch.ops import attention, groupnorm, matching, resnet

    return {"flash_attention": attention.flash_attention,
            "group_norm": groupnorm.group_norm,
            "fused_resnet": resnet.fused_resnet,
            "best_match": matching.best_match}


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
]
GN_SHAPES = [  # (B, rows, C, silu, eps)
    (8, 512 * 512, 128, True, 1e-5),   # VAE decoder at 512x512
    (8, 64 * 64, 320, True, 1e-5),     # UNet L0 resnet
    (8, 8 * 8, 2560, True, 1e-5),      # UNet skip-concat width
    (8, 64 * 64, 320, False, 1e-6),    # Transformer2D input norm
]
RESNET_SHAPES = [  # (B, H, W, Cin, Cout)
    (8, 64, 64, 320, 320),     # L0, identity shortcut
    (8, 32, 32, 640, 640),     # L1, identity shortcut
    (8, 64, 64, 640, 320),     # last up block, projection shortcut
    (8, 16, 16, 2560, 1280),   # up block 1, skip-concat width
    (4, 64, 64, 960, 320),     # ragged width (not a multiple of 64), cfg-skip batch
]
MATCH_SHAPES = [  # (B, S, D, C)
    (2, 12288, 4096, 320),     # L0 local round
    (2, 3072, 1024, 640),      # L1 local round
    None,                      # L0 global merge vs the bank: from the config
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
    from vidtome_torch.ops import attention, groupnorm, matching, resnet
    from vidtome_torch.ops.cuda_build import build_library

    t0 = time.perf_counter()
    libs = {"vidtome_flash": "flash_attention.cu",
            "vidtome_resnet": "resnet.cu", "vidtome_matching": "matching.cu"}
    logs = {name: [] for name in libs}
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(build_library, name, (src,), log=logs[name])
                    for name, src in libs.items()]:
            fut.result()
    attention._library(), resnet._library(), matching._library()
    t1 = time.perf_counter()
    x = torch.zeros(1, 64, 32, device=dev, dtype=torch.bfloat16)
    for silu in (False, True):
        groupnorm._launch(x, torch.ones(32, device=dev),
                          torch.zeros(32, device=dev), 32, 1e-5, silu)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for name, log in logs.items():
        for _name, secs, report in log:
            regs = [ln.split("Used")[1].split(",")[0].strip()
                    for ln in report.splitlines() if "Used" in ln]
            spills = [ln.strip() for ln in report.splitlines()
                      if "spill" in ln]
            print(f"[build] {name}: nvcc {secs:.1f} s; {len(spills)} "
                  f"kernels, registers {regs}, max spill line: "
                  f"{max(spills) if spills else 'n/a'}")
    print(f"[build] CUDA libraries ready in {t1 - t0:.1f} s (parallel nvcc);"
          f" Triton GroupNorm compiled in {t2 - t1:.1f} s")


def global_match_shape() -> tuple:
    """The L0 global merge of the serving profile: the locally merged chunk
    against a bank of the same length, both lanes (align_batch)."""
    from vidtome_torch.models.tome import ToMeConfig

    gene = serve_config()["generation"]
    n = ToMeConfig(frames=4, local_merge_ratio=gene["local_merge_ratio"],
                   len_quantum=gene["len_quantum"]).merged_local_len(64 * 64)
    return (2, n, n, 320)


def phase_kernels(dev) -> dict:
    from vidtome_torch.ops import attention, groupnorm, matching, resnet

    rng = np.random.default_rng(0)

    def bf16(shape, scale=1.0, shift=0.0):
        a = (rng.standard_normal(shape, np.float32) * scale + shift)
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    # per kernel: max |err| over its shapes, summed kernel ms, summed plain ms
    stats = {"flash_attention": [0.0, 0.0, 0.0],
             "group_norm": [0.0, 0.0, 0.0], "fused_resnet": [0.0, 0.0, 0.0],
             "best_match": [0.0, 0.0, 0.0]}
    for B, H, Sq, Skv, D in FLASH_SHAPES:
        q, k, v = bf16((B, H, Sq, D)), bf16((B, H, Skv, D)), bf16((B, H, Skv, D))
        qf, kf, vf = q.float(), k.float(), v.float()
        got = attention.flash_attention(q, k, v)
        want = attention.reference_attention(qf, kf, vf)
        err = (got.float() - want).abs().max().item()
        del want
        ms = cuda_time(lambda: attention.flash_attention(q, k, v), 10)
        plain = cuda_time(lambda: attention.reference_attention(qf, kf, vf), 3)
        print(f"[kernel] flash [{B},{H},{Sq}x{Skv},{D}] max|err| {err:.2e} "
              f"(tol {ATTN_TOL}) kernel {ms:.3f} ms, plain fp32 {plain:.3f} ms")
        if not err < ATTN_TOL:
            raise AssertionError(f"flash kernel disagrees at {(B, H, Sq, Skv, D)}")
        s = stats["flash_attention"]
        s[0], s[1], s[2] = max(s[0], err), s[1] + ms, s[2] + plain
        del q, k, v, qf, kf, vf, got
        torch.cuda.empty_cache()

    for B, rows, C, silu, eps in GN_SHAPES:
        x = bf16((B, rows, C), 2.0, 0.5)
        w = torch.from_numpy(rng.standard_normal(C, np.float32) + 1).to(dev)
        b = torch.from_numpy(rng.standard_normal(C, np.float32)).to(dev)
        xf = x.float()
        got = groupnorm.group_norm(x, w, b, 32, eps, silu)
        want = groupnorm.reference_group_norm(xf, w, b, 32, eps, silu)
        diff = (got.float() - want).abs()
        err = (diff / want.abs().clamp_min(1.0)).max().item()
        abs_err = diff.max().item()
        del want, diff
        ms = cuda_time(lambda: groupnorm.group_norm(x, w, b, 32, eps, silu), 10)
        plain = cuda_time(lambda: groupnorm.reference_group_norm(
            xf, w, b, 32, eps, silu), 3)
        print(f"[kernel] group_norm [{B},{rows},{C}] silu={silu} eps={eps} "
              f"max rel err {err:.2e} (tol {GN_TOL}), max|err| {abs_err:.2e}; "
              f"kernel {ms:.3f} ms, "
              f"plain fp32 {plain:.3f} ms")
        if not err < GN_TOL:
            raise AssertionError(f"GroupNorm kernel disagrees at {(B, rows, C)}")
        s = stats["group_norm"]
        s[0], s[1], s[2] = max(s[0], abs_err), s[1] + ms, s[2] + plain
        del x, xf, got
        torch.cuda.empty_cache()

    def f32(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * scale
                                + shift).to(dev)

    for B, H, W, Ci, Co in RESNET_SHAPES:
        args = [bf16((B, H, W, Ci)), f32(B, Co, scale=0.3),
                f32(Ci, scale=0.2, shift=1.0), f32(Ci, scale=0.1),
                f32(Co, Ci, 3, 3, scale=(9 * Ci) ** -0.5).bfloat16(),
                f32(Co, scale=0.1), f32(Co, scale=0.2, shift=1.0),
                f32(Co, scale=0.1),
                f32(Co, Co, 3, 3, scale=(9 * Co) ** -0.5).bfloat16(),
                f32(Co, scale=0.1)]
        if Ci != Co:
            args += [f32(Co, Ci, scale=Ci ** -0.5).bfloat16(),
                     f32(Co, scale=0.1)]
        args_f = [a.float() for a in args]
        got = resnet.fused_resnet(*args)
        want = resnet.reference_fused_resnet(*args_f)
        abs_err = (got.float() - want).abs().max().item()
        err = abs_err / want.abs().max().item()
        del want
        ms = cuda_time(lambda: resnet.fused_resnet(*args), 10)
        plain = cuda_time(lambda: resnet.reference_fused_resnet(*args_f), 3)
        print(f"[kernel] fused_resnet [{B},{H},{W},{Ci}]->{Co} max rel err "
              f"{err:.2e} (tol {RESNET_TOL}), max|err| {abs_err:.2e}; "
              f"kernel {ms:.3f} ms, plain fp32 {plain:.3f} ms")
        if not err < RESNET_TOL:
            raise AssertionError(f"fused resnet kernel disagrees at "
                                 f"{(B, H, W, Ci, Co)}")
        s = stats["fused_resnet"]
        s[0], s[1], s[2] = max(s[0], abs_err), s[1] + ms, s[2] + plain
        del args, args_f, got
        torch.cuda.empty_cache()

    for shape in MATCH_SHAPES:
        B, S, D, C = shape or global_match_shape()
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
        plain = cuda_time(lambda: matching.reference_best_match(srcf, dstf),
                          3)
        print(f"[kernel] best_match [{B},{S}x{D},{C}] max|err| {err:.2e} "
              f"(tol {MATCH_TOL}), argmax differs at {wrong} of "
              f"{int(clear.sum())} rows with a top-2 gap > {MATCH_GAP} "
              f"({B * S - int(clear.sum())} near-ties not compared); kernel "
              f"{ms:.3f} ms, plain fp32 {plain:.3f} ms")
        if not err < MATCH_TOL or wrong:
            raise AssertionError(f"best_match kernel disagrees at "
                                 f"{(B, S, D, C)}")
        s = stats["best_match"]
        s[0], s[1], s[2] = max(s[0], err), s[1] + ms, s[2] + plain
        del src, dst, srcf, dstf
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

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    reset_launches()
    latents, conds = stage("encode", lambda: inverter.encode(frames))
    inverted = stage("invert", lambda: inverter.ddim_inversion(latents, conds))
    generator.configure_frames(N_FRAMES)
    name, prompt = next(iter(generator.prompt.items()))
    context = stage("text", lambda: generator.text.embed_cfg(
        prompt, generator.negative_prompt))
    table = generator.fidx_table()
    clean = stage("generate", lambda: generator.ddim_sample(
        inverted[torch.as_tensor(generator.pad_src, device=dev)], context,
        fidx_table=table))
    out = stage("decode", lambda: generator.vae.decode(clean[:N_FRAMES]))
    launches = read_launches()

    if table.shape[1] != 2:
        raise AssertionError(f"expected 2 chunks, got {table.shape[1]}")
    if tuple(out.shape) != (N_FRAMES, SIZE, SIZE, 3):
        raise AssertionError(f"frames shape {tuple(out.shape)}")
    if not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        raise AssertionError("frames not finite or outside [0, 1]")
    if not torch.isfinite(inverted).all():
        raise AssertionError("inverted latents not finite")
    for k in ("flash_attention", "group_norm", "best_match"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} kernel never launched on the exact "
                                 f"path")
    print(f"[main] {N_FRAMES} frames {SIZE}x{SIZE}, {STEPS}+{STEPS} DDIM "
          f"steps, 2 chunks; frames mean {out.mean().item():.4f} std "
          f"{out.std().item():.4f}; stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
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

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

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
    for k in KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"{k} kernel never launched on the serving "
                                 f"path")

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
    phase_main_path(dev, bundle)
    torch.cuda.synchronize()
    phase_reference(dev, bundle)
    torch.cuda.synchronize()
    launches = phase_serving(dev, bundle)
    torch.cuda.synchronize()

    sources = {
        "flash_attention": ("cuda", "vidtome_torch/csrc/flash_attention.cu",
                            "vidtome_tpu/ops/attention.py:121"),
        "group_norm": ("triton", "vidtome_torch/ops/groupnorm.py",
                       "vidtome_tpu/ops/groupnorm.py:108"),
        "fused_resnet": ("cuda", "vidtome_torch/csrc/resnet.cu",
                         "vidtome_tpu/ops/resnet.py:232"),
        "best_match": ("cuda", "vidtome_torch/csrc/matching.cu",
                       "vidtome_tpu/ops/matching.py:72")}
    print(json.dumps({"kernels": [
        {"name": k, "route": sources[k][0], "source": sources[k][1],
         "replaces": sources[k][2], "launches": launches[k],
         "max_abs_err": stats[k][0], "ms": stats[k][1],
         "plain_ms": stats[k][2]} for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
