"""Time builds of one of the port's C entries against each other on one
CUDA card, in turns, at chip_smoke.py's shapes for that kernel, beside the
wrapper and the library call.

    python3 flash_ab.py [--kernel=flash|small_kv|resnet|resnet_w8a8|
                                  group_norm|best_match|sublayer|
                                  sublayer_phases|tma]
                        [--root=DIR ...] [--json=PATH] [NAME=DIR ...]

``--kernel`` picks the source, its C entry and the shapes (default
``flash``):
  flash     ``flash_attention.cu``, ``vidtome_flash_attention``,
            ``chip_smoke.FLASH_SHAPES``; the output contiguous;
  small_kv  ``small_kv_attention.cu``, ``vidtome_small_kv_attention``,
            ``chip_smoke.SMALL_KV_SHAPES``; the output in the [B, S, H, D]
            storage the wrapper writes;
  resnet    ``resnet_bf16.cu`` (or, in a tree that has none, the bf16
            instance of ``resnet.cu``), ``vidtome_resnet_conv3x3``,
            ``chip_smoke.RESNET_SHAPES`` plus a ragged-chunk row; each
            row's conv1 (GN1 prologue, +b1+tvec, GN2 partials) and conv2
            (GN2 prologue, +b2 +shortcut) are timed apart, each build with
            the tile argument of its own source (``resnet_bf16.cu``: this
            checkout's ``ops/resnet.conv_plan``, or that of a ``resnet.py``
            beside the source in DIR; ``resnet.cu``, an older tree's: the
            128-pixel tile of ``_tile_width``) and held against the plain
            conv in fp32; beside them the block through the wrapper and
            cuDNN's two ``F.conv2d`` calls (bf16, channels_last; the
            convolutions alone, not the block), each through the call and
            device-only, and the bound of each conv;
  resnet_w8a8  the same for the W8A8 conv: ``resnet_w8a8.cu`` (or an older
            tree's ``resnet.cu``), ``vidtome_resnet_conv3x3_w8a8``, the
            weights quantized per output channel as the int8 tables do, the
            activation scale of each norm (``static_act_scale``), held
            against the plain W8A8 conv in fp32 (``_conv3x3`` with the
            scales: the same int8 activations up to where a bf16 rounding
            of the activation moves); ``resnet_w8a8.cu`` with the launch
            of ``conv_plan_w8a8`` (or that of a ``resnet.py`` beside the
            source in DIR); beside them the W8A8 block and the bf16 block
            through their wrappers;
  group_norm  ``group_norm.cu``'s full entry (``vidtome_group_norm``, mode
            0, with this checkout's ``ops/groupnorm.plan``) at
            ``chip_smoke.GN_SHAPES``, beside the routes of the package
            under each ``--root``: a package with ``csrc/group_norm.cu``
            gives its full entry and its stats + apply entries, an earlier
            one (``git archive`` of a tree before it) its three Triton
            passes (``group_norm`` under ``VIDTOME_GN_MODE=auto``) and its
            cooperative single-launch kernel (``full_group_norm``); every
            build and route in turns, through the call and device-only,
            held against ``reference_group_norm`` (max |err| relative to
            max(1, |ref|)), beside ``F.group_norm`` and the bound;
  best_match  ``matching.cu``, ``vidtome_best_match`` (this checkout's
            ``ops/matching.match_plan`` for a build that takes a plan; an
            older tree's takes none) at ``chip_smoke.MATCH_SHAPES`` of
            unit-norm rows, then two probes: every score negative with a
            ragged D, and every src row's best an exact tie between dst
            copies (where a dropped column mask and a flipped tie rule
            show); each build's max |err| of the maxima and its argmax
            differences (where the plain top-2 gap passes ``MATCH_GAP``;
            at the duplicate probe every row), beside the wrapper, ``bmm``
            + ``amax``/``argmax`` (device-only), the bound, and at the
            unit rows the first build that takes a plan device-only at
            each block height (64, 128, 192 rows; the src tile resident
            where it fits); last the host's wall a call and time to
            return at [1, 64x128, 64] of each build's C entry and of each
            root's wrapper, three rounds of turns;
  sublayer  ``sublayer.cu``, ``vidtome_fused_cross_sublayer`` (this
            checkout's ``ops/sublayer`` plan and tensor maps for a build
            that takes them; an older tree's takes its block's row
            fragments and fp32 vectors) at ``chip_smoke.SUBLAYER_SHAPES``
            and SD1.5's widths at batch 8, 77 keys; each build's max |err|
            of x3 and y3 against the plain version in fp32 (a planted fault
            is a ``sed`` copy built beside the sound one), beside each
            root's wrapper through the call and device-only, the port's
            unfused bf16 chain device-only (``chip_smoke.unfused_sublayer``)
            and the bound;
  sublayer_phases  no build DIR: an instrumented copy of this checkout's
            ``sublayer.cu`` (``PHASE_STAMPS``: clock64 at each phase's
            ends, thread 0 of each consumer warpgroup) at the sublayer
            rows, the mean SM cycles a block spends in each phase;
  tma       no build: the rate at which one SM's TMA brings a 64-row
            tile of bf16 into shared memory, by box width (32 and 64
            columns swizzled, 160 and 256 not), alone and with every SM
            loading, from device memory and from L2 (``TMA_RATE_CU``).
Each build DIR holds that source (and the ``*.cuh`` it includes) with the
C signature of ``vidtome_torch/csrc``'s; ``new=vidtome_torch/csrc`` is this
checkout's kernel.  All are compiled at once (one nvcc each, the flags of
``vidtome_torch.ops.cuda_build``) into ``build/flash_ab/``, and their
registers and spills printed per kernel instance.  At each shape every
build runs in the order given and then in reverse (A, B, B, A),
``chip_smoke.cuda_time`` over 10 launches of the C entry alone each, on the
same seeded inputs, and device-only (``chip_smoke.graph_time``: 10
launches in a replayed CUDA graph, no host time between them).  Attention:
the output held against ``reference_attention`` in fp32 (max |err|, and
max |err| / max |ref|); beside them, on the same inputs, the wrapper of
the package under the first ``--root`` through its call (``cuda_time``)
and device-only (``chip_smoke.graph_time``: 10 calls in a replayed CUDA
graph), ``scaled_dot_product_attention`` both ways, chip_smoke.py's bound
and the exp floor (one exp2 a score).

Last, for attention, the wall microseconds of one call, where the host's
cost shows (at [1, 1, 128x128, 64] for flash, [1, 1, 128x77, 64] for
small-KV), in three rounds of turns: of each build's C entry, of the
wrapper of the package under each ``--root`` (default this checkout; give
it twice, with a ``git archive`` of another commit, to compare two
wrappers in one process, each with the kernels of its own package) and of
SDPA.  With no build only those are timed.  ``--json=PATH`` also writes
every reading there.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import importlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (EXP2_S, FLASH_SHAPES, GN_SHAPES, MATCH_GAP,
                        MATCH_SHAPES, MATCH_TOL, RESNET_SHAPES,
                        SMALL_KV_SHAPES, SUBLAYER_SHAPES, SUBLAYER_TOL,
                        bound_ms, cuda_time, graph_time, match_shape,
                        sublayer_bound, sublayer_inputs, unfused_sublayer)

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "flash_ab"
KERNELS = {
    "flash": dict(source="flash_attention.cu",
                  entry="vidtome_flash_attention", ints=5,
                  shapes=FLASH_SHAPES, wrapper="flash_attention",
                  host=(1, 1, 128, 128, 64)),
    "small_kv": dict(source="small_kv_attention.cu",
                     entry="vidtome_small_kv_attention", ints=7,
                     shapes=SMALL_KV_SHAPES, wrapper="small_kv_attention",
                     host=(1, 1, 128, 77, 64)),
    # the last row has a ragged last chunk (96 = 64 + 32 channels, or three
    # of an int8 chunk's four k32 steps) and Co past both N tiles, as the
    # card tests
    "resnet": dict(source=("resnet_bf16.cu", "resnet.cu"),
                   entry="vidtome_resnet_conv3x3",
                   shapes=RESNET_SHAPES + [(3, 16, 24, 96, 224)],
                   wrapper="fused_resnet", module="resnet", w8a8=False),
    "resnet_w8a8": dict(source=("resnet_w8a8.cu", "resnet.cu"),
                        entry="vidtome_resnet_conv3x3_w8a8",
                        shapes=RESNET_SHAPES + [(3, 16, 24, 96, 224)],
                        wrapper="fused_resnet_w8a8", module="resnet",
                        w8a8=True),
    "group_norm": dict(source="group_norm.cu", entry="vidtome_group_norm",
                       shapes=GN_SHAPES, module="groupnorm"),
    # chip_smoke's rows of unit-norm random src and dst, then two probes:
    # every score negative with a ragged D (4711 = 36 tiles + 103 rows),
    # and dst = 2104 rows twice over with every src row a copy of one of
    # them, so each row's best is an exact tie between copies 2104 apart:
    # in different dst tiles, in the same thread's columns (2104 a multiple
    # of 8), where only the order of the running compare picks the lower copy
    "best_match": dict(source="matching.cu", entry="vidtome_best_match",
                       shapes=[("unit", match_shape(r)) for r in MATCH_SHAPES]
                       + [("negative", (2, 4711, 4711, 320)),
                          ("duplicates", (2, 12288, 4208, 320))],
                       module="matching", wrapper="best_match"),
    # chip_smoke's SD2.1 PnP rows, then SD1.5's widths (8 heads: D = 40,
    # 80, 160) at batch 8
    "sublayer": dict(source="sublayer.cu",
                     entry="vidtome_fused_cross_sublayer",
                     shapes=SUBLAYER_SHAPES + [(8, 4096, 320, 8),
                                               (8, 1024, 640, 8),
                                               (8, 256, 1280, 8),
                                               (8, 64, 1280, 8)],
                     module="sublayer", wrapper="fused_cross_sublayer"),
}


def _tile_width(W: int) -> int:
    """Width of the 128-pixel tile of an older tree's ``resnet.cu`` (its
    ``ops/resnet._tile_width``) for an image W wide."""
    return 32 if W >= 32 else 16 if W >= 16 else 8


def build(kernel: dict, name: str, src: Path):
    from vidtome_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    out = OUT / f"lib{name}.so"
    source = kernel["source"]
    if not isinstance(source, str):  # the first of them the tree has
        source = next(f for f in source if (src / f).exists())
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src / source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    # per kernel instance (its template arguments): registers, spill bytes
    report, inst = {}, None
    for ln in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(1))
            inst = ",".join(args) or m.group(1)
        elif "Used" in ln and inst is not None:
            report[inst] = (ln.split("Used")[1].split(",")[0].strip()
                            + report.get(inst, ""))
        elif "spill" in ln and inst is not None:
            if any(int(x) for x in re.findall(r"(\d+) bytes spill", ln)):
                report[inst] = report.get(inst, "") + f"; {ln.strip()}"
    fn = getattr(ctypes.CDLL(str(out)), kernel["entry"])
    if kernel.get("module") == "resnet":
        fn.argtypes = [ctypes.c_void_p] * (14 if kernel["w8a8"] else 12) + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.source = source
        # a build DIR may bring the conv_plan of its own tile argument in a
        # resnet.py beside its source (an earlier design of resnet_bf16.cu)
        fn.plan = None
        if (src / "resnet.py").exists():
            spec = importlib.util.spec_from_file_location(
                f"plan_{name}", src / "resnet.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            fn.plan = getattr(module, "conv_plan_w8a8" if kernel["w8a8"]
                              else "conv_plan")
    elif kernel.get("module") == "matching":
        # a source whose entry takes a plan (the first version takes none)
        fn.planned = "int rows, int resident" in (src / source).read_text()
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (
            6 if fn.planned else 4) + [ctypes.c_void_p]
    elif kernel.get("module") == "sublayer":
        # a source whose entry takes the planner's plan and tensor maps (an
        # older tree's takes the block's row fragments and shared memory)
        fn.planned = "const int* plan" in (src / source).read_text()
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float,
                                                ctypes.c_void_p]
                       if fn.planned else [ctypes.c_void_p]
                       + [ctypes.c_int] * 9 + [ctypes.c_float,
                                               ctypes.c_longlong,
                                               ctypes.c_void_p])
    elif kernel.get("module") == "groupnorm":
        lib = ctypes.CDLL(str(out))
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.clusters = lib.vidtome_group_norm_clusters
        fn.clusters.argtypes = [ctypes.c_int] * 4
        # a build DIR may bring the planner of its own launch in a
        # groupnorm.py beside its source (then its clusters entry may take
        # other arguments, and is not asked)
        fn.plan = None
        if (src / "groupnorm.py").exists():
            fn.clusters = None
            spec = importlib.util.spec_from_file_location(
                f"plan_{name}", src / "groupnorm.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            fn.plan = module.plan
    else:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * kernel[
            "ints"] + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, report


def launcher(kernel: dict, fn, q, k, v, o):
    """One call of a build's C entry on [B, H, S, D] tensors."""
    from vidtome_torch.ops import attention

    B, H, Sq, D = q.shape
    st = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                  *v.stride()[:3], *o.stride()[:3])
    scale = math.log2(math.e) / math.sqrt(D)
    device = q.get_device()
    ints = [B, H, Sq, k.shape[2], D]
    if kernel["ints"] == 7:  # small-KV: D padded to 16, the padded keys
        ints += [-(-D // 16) * 16, next(n for n in attention._SMALL_KV_LENS
                                        if n >= k.shape[2])]

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 *ints, st, scale,
                 torch._C._cuda_getCurrentRawStream(device))
        if err:
            raise RuntimeError(f"launch failed: error {err}")
    return run


def output(kernel: dict, q):
    if kernel is KERNELS["flash"]:
        return torch.empty_like(q)
    B, H, Sq, D = q.shape
    return torch.empty(B, Sq, H, D, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def enqueue_us(run, iters: int = 200) -> float:
    """Host microseconds a call of ``run`` takes to return, over ``iters``
    calls in a row (too few to fill the launch queue), after warm-up: the
    host's own cost, where ``wall_us`` may read the card's."""
    for _ in range(20):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def wall_us(run, iters: int = 500) -> float:
    """Wall microseconds a call of ``run`` over ``iters`` calls in a row,
    after warm-up: the host's cost where it exceeds the kernel's."""
    for _ in range(20):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def wrappers(kernel: dict, roots: list[Path]) -> dict:
    """The wrapper of the package under each root, imported on its own, so
    that each builds and launches the kernels of its own package."""
    found = {}
    for root in roots:
        for mod in [m for m in sys.modules if m.split(".")[0] == "vidtome_torch"]:
            del sys.modules[mod]
        sys.path.insert(0, str(root))
        try:
            module = importlib.import_module(
                f"vidtome_torch.ops.{kernel.get('module', 'attention')}")
        finally:
            sys.path.remove(str(root))
        found[str(root)] = getattr(module, kernel["wrapper"])
    return found


def group_norm_routes(roots: list[Path]) -> dict:
    """The GroupNorm routes of the package under each root, each imported
    on its own (its kernels built into its own ``build/``): name ->
    fn(x, w, b, eps, silu)."""
    routes = {}
    for root in roots:
        for mod in [m for m in sys.modules if m.split(".")[0] == "vidtome_torch"]:
            del sys.modules[mod]
        sys.path.insert(0, str(root))
        try:
            m = importlib.import_module("vidtome_torch.ops.groupnorm")
        finally:
            sys.path.remove(str(root))
        tag = root.name if root != ROOT else "tree"
        if hasattr(m, "apply_group_norm"):  # csrc/group_norm.cu
            routes[f"{tag} full"] = (
                lambda x, w, b, eps, silu, m=m: m.full_group_norm(
                    x, w, b, 32, eps, silu))
            routes[f"{tag} stats+apply"] = (
                lambda x, w, b, eps, silu, m=m: m.apply_group_norm(
                    x, *m.group_stats(x, 32, eps), w, b, 32, silu))
        else:  # the Triton passes and the cooperative kernel
            routes[f"{tag} triton"] = (
                lambda x, w, b, eps, silu, m=m: m.group_norm(
                    x, w, b, 32, eps, silu))
            routes[f"{tag} cooperative"] = (
                lambda x, w, b, eps, silu, m=m: m.full_group_norm(
                    x, w, b, 32, eps, silu))
    return routes


def compare_group_norm(fns: dict, routes: dict, groupnorm) -> list:
    """Every build's full entry and every route at each GN_SHAPES row, in
    turns, against the plain GroupNorm (``groupnorm``: this checkout's
    ``ops/groupnorm``, its planner and plain version)."""
    F = torch.nn.functional
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows_out = []
    for B, rows, C, silu, eps, _ in GN_SHAPES:
        x = torch.from_numpy(rng.standard_normal((B, rows, C), np.float32)
                             * 2.0 + 0.5).to(dev, torch.bfloat16)
        w = torch.from_numpy(rng.standard_normal(C, np.float32) + 1).to(dev)
        b = torch.from_numpy(rng.standard_normal(C, np.float32)).to(dev)
        want = groupnorm.reference_group_norm(x.float(), w, b, 32, eps, silu)
        tree_plan = functools.partial(
            groupnorm.plan, clusters=groupnorm._card_clusters(0, 0))
        plan = tree_plan(B, rows, C, 32, 2, sms)
        runs, plans = {}, {}
        for name, fn in fns.items():
            y = torch.empty_like(x)
            p = (fn.plan or tree_plan)(B, rows, C, 32, 2, sms)
            ints = (ctypes.c_int * len(p))(*p)
            at_once = (fn.clusters(0, 0, p.cluster, p.smem)
                       if fn.clusters else "not asked")
            plans[name] = (f"{p.slices} x {p.sc} ch, clusters of {p.cluster}"
                           f", {p.blocks} blocks, {p.smem} B, "
                           f"{'resident' if p.resident else 'streaming'}, "
                           f"{at_once} clusters at once")

            def run(fn=fn, y=y, ints=ints):
                e = fn(0, 0, x.data_ptr(), y.data_ptr(), w.data_ptr(),
                       b.data_ptr(), None, None, ints, eps, int(silu), 0,
                       torch._C._cuda_getCurrentRawStream(0))
                if e:
                    raise RuntimeError(f"launch failed: error {e}")
                return y
            runs[name] = run
        for name, route in routes.items():
            runs[name] = functools.partial(route, x, w, b, eps, silu)
        ms, device_ms, err = {}, {}, {}
        for name in list(runs) + list(reversed(runs)):
            ms.setdefault(name, []).append(cuda_time(runs[name], 10))
            try:
                device_ms.setdefault(name, []).append(
                    graph_time(runs[name], 10))
            except RuntimeError as exc:  # a launch a graph cannot capture
                print(f"[{name}] device-only time not measured: {exc}")
            if name not in err:
                out = runs[name]()
                err[name] = ((out.float() - want).abs()
                             / want.abs().clamp_min(1.0)).max().item()
                del out
        side = int(round(rows ** 0.5))
        x4 = x.view(B, side, side, C).permute(0, 3, 1, 2)
        wb, bb = w.bfloat16(), b.bfloat16()

        def lib():
            return F.group_norm(x4, 32, wb, bb, eps)
        row = dict(shape=[B, rows, C], silu=silu, eps=eps,
                   plan=plan._asdict(), build_plans=plans, ms=ms,
                   device_ms=device_ms,
                   rel_err=err, library_ms=cuda_time(lib, 10),
                   library_device_ms=graph_time(lib, 10),
                   bound_ms=max(bound_ms(2 * 2 * B * rows * C + 8 * C,
                                         fp32=(5 + 4 * silu) * B * rows * C)))
        rows_out.append(row)
        print(f"[{B},{rows},{C}] silu={silu} ({plan.slices} x {plan.sc} ch, "
              f"clusters of {plan.cluster}, "
              f"{'resident' if plan.resident else 'streaming'}): "
              + "; ".join(f"{n} {ms[n]} ms (device only {device_ms.get(n)})"
                          f", max rel err {err[n]:.2e}" for n in runs)
              + "; build plans " + "; ".join(f"{n}: {v}"
                                             for n, v in plans.items())
              + f"; F.group_norm {row['library_ms']:.4f} ms (device only "
              f"{row['library_device_ms']:.4f}); bound {row['bound_ms']:.4f}")
        del x, want, x4, runs
        torch.cuda.empty_cache()
    return rows_out


def compare(kernel: dict, fns: dict, wrapper) -> list:
    order = list(fns) + list(reversed(fns))
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    from vidtome_torch.ops.attention import reference_attention

    rows = []
    for B, H, Sq, Skv, D in kernel["shapes"]:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, H, s, D), np.float32)).to(dev, torch.bfloat16)
            for s in (Sq, Skv, Skv))
        want = reference_attention(q.float(), k.float(), v.float())
        ref_max = want.abs().max().item()
        ms, device_ms, err = {}, {}, {}
        for name in order:
            o = output(kernel, q)
            run = launcher(kernel, fns[name], q, k, v, o)
            ms.setdefault(name, []).append(cuda_time(run, 10))
            try:
                device_ms.setdefault(name, []).append(graph_time(run, 10))
            except RuntimeError as exc:  # a C entry a graph cannot capture
                print(f"[{name}] device-only time not measured: {exc}")
            err[name] = (o.float() - want).abs().max().item()
        del want
        row = dict(shape=[B, H, Sq, Skv, D], ref_max=ref_max, ms=ms,
                   device_ms=device_ms,
                   rel_err={n: err[n] / ref_max for n in fns},
                   abs_err=err,
                   wrapper_ms=cuda_time(lambda: wrapper(q, k, v), 10),
                   wrapper_device_ms=graph_time(lambda: wrapper(q, k, v), 10),
                   sdpa_ms=cuda_time(lambda: sdpa(q, k, v), 10),
                   sdpa_device_ms=graph_time(lambda: sdpa(q, k, v), 10),
                   bound_ms=max(bound_ms(2 * 2 * B * H * (Sq + Skv) * D,
                                         bf16=4 * B * H * Sq * Skv * D)),
                   exp_floor_ms=B * H * Sq * Skv / EXP2_S * 1e3)
        rows.append(row)
        print(f"[{B},{H},{Sq}x{Skv},{D}] max|ref| {ref_max:.4f}; "
              + "; ".join(f"{n} {ms[n]} ms (device only {device_ms.get(n)}), "
                          f"max|err| {err[n]:.2e} "
                          f"({err[n] / ref_max:.2e} of max|ref|)"
                          for n in fns)
              + f"; wrapper {row['wrapper_ms']:.4f} ms (device only "
              f"{row['wrapper_device_ms']:.4f}); sdpa {row['sdpa_ms']:.4f} ms "
              f"(device only {row['sdpa_device_ms']:.4f}); bound "
              f"{row['bound_ms']:.4f}; exp floor {row['exp_floor_ms']:.4f}")
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def match_run(fn, src, dst, mx, ix, matching, rows=None):
    """One call of a best-match build's C entry (for a build that takes a
    plan: ``rows`` src rows a block, the src tile resident where it fits,
    or by default the plan of ``matching``, this checkout's
    ``ops/matching``)."""
    B, S, C = src.shape
    D = dst.shape[1]
    args = (src.data_ptr(), dst.data_ptr(), mx.data_ptr(), ix.data_ptr(),
            B, S, D, C)
    if fn.planned:
        plan = matching.match_plan(B, S, D, C, matching._sm_count(0))
        if rows is not None:
            resident = matching._smem(rows, -(-C // 64), True) <= \
                matching.SMEM_MAX
            plan = plan._replace(rows=rows, resident=resident)
        args += (plan.rows, int(plan.resident))

    def run():  # on the current stream (a graph's capture stream too)
        e = fn(*args, torch._C._cuda_getCurrentRawStream(0))
        if e:
            raise RuntimeError(f"launch failed: error {e}")
    return run


def match_inputs(kind: str, B: int, S: int, D: int, C: int, rng, dev):
    """(src, dst, the dst the plain answer is taken against) of a row."""
    F = torch.nn.functional

    def unit(*shape):
        return F.normalize(torch.from_numpy(rng.standard_normal(
            shape, np.float32)).to(dev), dim=-1).bfloat16()
    if kind == "unit":
        src, dst = unit(B, S, C), unit(B, D, C)
        return src, dst, dst
    if kind == "negative":
        src, dst = unit(B, S, C).abs(), -unit(B, D, C).abs()
        return src, dst, dst
    base = unit(B, D // 2, C)
    pick = torch.from_numpy(rng.integers(0, D // 2, (B, S))).to(dev)
    src = torch.stack([base[b, pick[b]] for b in range(B)])
    return src, torch.cat([base, base], dim=1), base


def compare_match(kernel: dict, fns: dict, wrapped: dict, matching) -> list:
    """Every build's C entry in turns at each row, through the call and
    device-only, held against the plain version (max |err| of the maxima,
    argmax differences where the plain top-2 gap passes MATCH_GAP, and at
    the duplicate probe every row, whose answer is the lower copy); beside
    them the wrapper (of the first root), ``torch.bmm`` + ``amax``/
    ``argmax`` (bf16 scores in memory between: a yardstick, not the same
    function) and the bound; ``matching``: this checkout's
    ``ops/matching``."""
    wrapper = next(iter(wrapped.values()))

    order = list(fns) + list(reversed(fns))
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    rows = []
    for kind, (B, S, D, C) in kernel["shapes"]:
        src, dst, ref_dst = match_inputs(kind, B, S, D, C, rng, dev)
        scores = torch.bmm(src.float(), ref_dst.float().transpose(1, 2))
        want_max, want_idx = scores.max(dim=-1)
        top2 = scores.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > MATCH_GAP
        if kind == "duplicates":  # every row's answer is the lower copy
            clear = torch.ones_like(clear)
        del scores, top2
        ms, device_ms, err, wrong = {}, {}, {}, {}
        for name in order:
            mx = torch.empty(B, S, device=dev)
            ix = torch.empty(B, S, dtype=torch.long, device=dev)
            run = match_run(fns[name], src, dst, mx, ix, matching)
            ms.setdefault(name, []).append(cuda_time(run, 10))
            device_ms.setdefault(name, []).append(graph_time(run, 10))
            err[name] = (mx - want_max).abs().max().item()
            wrong[name] = int((ix != want_idx)[clear].sum())

        # every block height of the first build that takes a plan,
        # device-only: what the planner chose among
        heights = {}
        planned = next((n for n, fn in fns.items() if fn.planned), None)
        if kind == "unit" and planned is not None:
            mx = torch.empty(B, S, device=dev)
            ix = torch.empty(B, S, dtype=torch.long, device=dev)
            for h in (64, 128, 192):
                heights[h] = graph_time(match_run(
                    fns[planned], src, dst, mx, ix, matching, h), 10)

        def yardstick():
            sc = torch.bmm(src, dst.transpose(1, 2))
            return sc.amax(dim=-1), sc.argmax(dim=-1)
        plan = matching.match_plan(B, S, D, C, matching._sm_count(0))
        row = dict(kind=kind, shape=[B, S, D, C], plan=plan._asdict(),
                   ms=ms, device_ms=device_ms, max_err=err,
                   argmax_wrong=wrong,
                   compared=int(clear.sum()), heights_device_ms=heights,
                   sound={n: err[n] < MATCH_TOL and not wrong[n] for n in fns},
                   wrapper_ms=cuda_time(lambda: wrapper(src, dst), 10),
                   wrapper_device_ms=graph_time(lambda: wrapper(src, dst), 10),
                   yardstick_device_ms=graph_time(yardstick, 10),
                   bound_ms=max(bound_ms(2 * B * (S + D) * C + 12 * B * S,
                                         bf16=2 * B * S * D * C)))
        rows.append(row)
        print(f"[{kind} {B},{S}x{D},{C}] plan {plan.rows} rows, "
              f"{'resident' if plan.resident else 'streamed'}, grid "
              f"{plan.grid}; "
              + "; ".join(f"{n} {ms[n]} ms (device only {device_ms[n]}), "
                          f"max|err| {err[n]:.2e}, argmax wrong at "
                          f"{wrong[n]} of {row['compared']}" for n in fns)
              + f"; wrapper {row['wrapper_ms']:.4f} ms (device only "
              f"{row['wrapper_device_ms']:.4f}); bmm + amax/argmax device "
              f"only {row['yardstick_device_ms']:.4f}; bound "
              f"{row['bound_ms']:.4f}"
              + (f"; {planned} device only by block rows {heights}"
                 if heights else ""))
        del src, dst, ref_dst
        torch.cuda.empty_cache()
    # the host's cost of a call where the kernel's is small, three rounds
    # of turns: the wall a call and the host's time to return, of each
    # build's C entry (one that takes a plan encodes two tensor maps every
    # call) and of each root's wrapper
    src = torch.zeros(1, 64, 64, dtype=torch.bfloat16, device=dev)
    dst = torch.zeros(1, 128, 64, dtype=torch.bfloat16, device=dev)
    mx = torch.empty(1, 64, device=dev)
    ix = torch.empty(1, 64, dtype=torch.long, device=dev)
    runs = {name: match_run(fn, src, dst, mx, ix, matching)
            for name, fn in fns.items()}
    for root, w in wrapped.items():
        runs[f"wrapper {root}"] = functools.partial(w, src, dst)
    host = {}
    for _ in range(3):
        for name in list(runs) + list(reversed(runs)):
            for measure in (wall_us, enqueue_us):
                host.setdefault(f"{name} {measure.__name__}", []).append(
                    round(measure(runs[name]), 2))
    print("[host] us a call at [1,64x128,64] (wall_us: wall; enqueue_us: "
          "until the call returns): "
          + "; ".join(f"{n} {v}" for n, v in host.items()))
    rows.append(dict(host_us=host))
    return rows


def sublayer_run(fn, args, heads: int, kv_len: int, out, sublayer):
    """One call of a sublayer build's C entry writing ``out`` (x3, y3): a
    build that takes a plan gets this checkout's (``sublayer``: its
    ``ops/sublayer``) plan and tensor maps; an older one its block's row
    fragments (128 rows up to C = 320, 64 up to 640, 32 above) and the
    fp32 vectors it reads."""
    x, a1, k, v, wq, wout, *vecs = args
    B, S, C = x.shape
    skv = k.shape[1]
    keep = [sublayer._scaled_wq(wq, heads, torch.bfloat16)]
    if fn.planned:
        launch = sublayer._signature(x.shape, skv, x.device, heads, kv_len)
        if launch.plan.cluster > 1:
            keep.append(torch.empty(2, B, S, C, dtype=x.dtype,
                                    device=x.device))
        ptrs = (ctypes.c_void_p * 14)(*(t.data_ptr() for t in (
            x, a1, k, v, keep[0], wout, *vecs, *out)),
            keep[1].data_ptr() if len(keep) > 1 else None)
        flags = sum(1 << i for i, t in enumerate(vecs)
                    if t.dtype == torch.bfloat16)

        def call(stream):
            return fn(ptrs, launch.ints, launch.maps, flags, 1e-5, stream)
    else:
        keep += [t.float().contiguous() for t in vecs]
        dp, kvp = -(-(C // heads) // 16) * 16, -(-skv // 16) * 16
        rows = 128 if C <= 320 else 64 if C <= 640 else 32
        smem = 2 * (2 * rows * (C + 8) + 2 * kvp * (dp + 8))
        ptrs = (ctypes.c_void_p * 13)(*(t.data_ptr() for t in (
            x, a1, k, v, keep[0], wout, *keep[1:], *out)))

        def call(stream):
            return fn(ptrs, B, S, C, heads, dp, rows // 16, skv, kvp, kv_len,
                      1e-5, smem, stream)

    def run():  # on the current stream (a graph's capture stream too)
        e = call(torch._C._cuda_getCurrentRawStream(0))
        if e:
            raise RuntimeError(f"launch failed: error {e}")
    run.keep = keep
    return run


def compare_sublayer(kernel: dict, fns: dict, wrapped: dict,
                     sublayer) -> list:
    """Every build's C entry in turns at each row (77 keys), through the
    call and device-only, held against the plain version in fp32 (max
    |err| of x3 and y3); beside them each root's wrapper through the call
    and device-only, the port's unfused bf16 chain device-only, the bound
    and this checkout's plan (``sublayer``: its ``ops/sublayer``)."""
    order = list(fns) + list(reversed(fns))
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    rows = []
    for B, S, C, heads in kernel["shapes"]:
        args = sublayer_inputs(rng, dev, B, S, C)
        kw = dict(heads=heads, kv_len=77)
        want = sublayer.reference_cross_sublayer(*[a.float() for a in args],
                                                 **kw)
        ms, device_ms, err = {}, {}, {}
        for name in order:
            out = (torch.empty_like(args[0]), torch.empty_like(args[0]))
            run = sublayer_run(fns[name], args, heads, 77, out, sublayer)
            ms.setdefault(name, []).append(cuda_time(run, 10))
            device_ms.setdefault(name, []).append(graph_time(run, 10))
            err[name] = max((o.float() - w).abs().max().item()
                            for o, w in zip(out, want))
        del want
        wrapper_ms, wrapper_device_ms = {}, {}
        for root, w in wrapped.items():
            def call(w=w):
                return w(*args, **kw)
            wrapper_ms[root] = cuda_time(call, 10)
            wrapper_device_ms[root] = graph_time(call, 10)
        p = sublayer.plan(B, S, C, heads, 77, 77, sublayer._sm_count(0),
                          sublayer._card_clusters(0))
        row = dict(shape=[B, S, C, heads], plan=p._asdict(), ms=ms,
                   device_ms=device_ms, max_err=err,
                   sound={n: err[n] < SUBLAYER_TOL for n in fns},
                   wrapper_ms=wrapper_ms, wrapper_device_ms=wrapper_device_ms,
                   chain_device_ms=graph_time(
                       unfused_sublayer(args, heads, 77), 10),
                   bound_ms=max(sublayer_bound(B, S, C)))
        rows.append(row)
        print(f"[{B},{S},{C}] heads {heads}: plan clusters of {p.cluster}, "
              f"{p.stages} stages, {p.kv_bufs} K/V buffers, grid {p.grid}; "
              + "; ".join(f"{n} {ms[n]} ms (device only {device_ms[n]}), "
                          f"max|err| {err[n]:.2e}" for n in fns)
              + "; " + "; ".join(
                  f"wrapper {r} {wrapper_ms[r]:.4f} ms (device only "
                  f"{wrapper_device_ms[r]:.4f})" for r in wrapped)
              + f"; unfused chain device only {row['chain_device_ms']:.4f}; "
              f"bound {row['bound_ms']:.4f}")
        del args
        torch.cuda.empty_cache()
    return rows


def resnet_tile(fn, B: int, H: int, W: int, Cin: int, Cout: int):
    """(tile argument, pixel tiles of an image) of a build's C entry."""
    from vidtome_torch.ops import resnet

    if fn.source == "resnet_bf16.cu":
        plan = (fn.plan or resnet.conv_plan)(B, H, W, Cin, Cout,
                                             resnet._sm_count(0))
        return plan.arg, plan.tiles
    if fn.source == "resnet_w8a8.cu":
        plan = (fn.plan or resnet.conv_plan_w8a8)(B, H, W, Cin, Cout,
                                                  resnet._sm_count(0))
        return plan.arg, plan.tiles
    tw = _tile_width(W)
    return tw, -(-H // (128 // tw)) * -(-W // tw)


def compare_resnet(kernel: dict, fns: dict, wrapper) -> list:
    """conv1 and conv2 of each row: every build in turns, the wrapper's
    block and cuDNN's two convolutions (W8A8: the bf16 block), against the
    plain conv."""
    from vidtome_torch.ops import quant, resnet

    F = torch.nn.functional
    w8a8 = kernel["w8a8"]
    order = list(fns) + list(reversed(fns))
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def stats(t):  # fp32 group mean and rstd [B, 32], as the plain version
        s = t.float().reshape(t.shape[0], -1, 32, t.shape[-1] // 32)
        mean = s.mean(dim=(1, 3))
        var = ((s * s).mean(dim=(1, 3)) - mean * mean).clamp_min(0)
        return mean.contiguous(), torch.rsqrt(var + 1e-5).contiguous()

    def f32(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * scale + shift).to(dev)

    rows = []
    for B, H, W, Ci, Co in kernel["shapes"]:
        x = f32(B, H, W, Ci).bfloat16()
        tvec, b1, b2 = f32(B, Co, scale=0.3), f32(Co, scale=0.1), f32(
            Co, scale=0.1)
        n1 = (f32(Ci, scale=0.2, shift=1.0), f32(Ci, scale=0.1))
        n2 = (f32(Co, scale=0.2, shift=1.0), f32(Co, scale=0.1))
        w1, w2 = (f32(Co, c, 3, 3, scale=(9 * c) ** -0.5).bfloat16()
                  .contiguous(memory_format=torch.channels_last)
                  for c in (Ci, Co))
        args = [x, tvec, *n1, w1, b1, *n2, w2, b2]
        if Ci != Co:
            args += [f32(Co, Ci, scale=Ci ** -0.5).bfloat16(),
                     f32(Co, scale=0.1)]
        bf16_args, kw = list(args), {}
        # W8A8: the weights as the int8 tables hold them (OIHW views of
        # packed int8 storage) with their scales, each conv's activation
        # scale from its norm; q1, q2 the plain conv's quantization
        q1 = q2 = ()
        if w8a8:
            for i, key in ((4, "w1_scale"), (8, "w2_scale")):
                w_q, kw[key] = quant.quantize_weight(args[i])
                args[i] = quant.packed_conv_weight(w_q).permute(0, 3, 1, 2)
            w1, w2 = args[4], args[8]
            sx1, sx2 = (quant.static_act_scale(*n) for n in (n1, n2))
            q1, q2 = (kw["w1_scale"], sx1), (kw["w2_scale"], sx2)
            kw["act_scales"] = (sx1, sx2)
        # conv1 and conv2 as the block runs them: conv2's input and
        # shortcut from the plain conv1
        mean1, rstd1 = stats(x)
        ref1 = (resnet._conv3x3(resnet._gn_silu(x, x, *n1, 32, 1e-5), w1,
                                *q1)
                + b1 + tvec[:, None, None, :])
        h = ref1.bfloat16()
        mean2, rstd2 = stats(ref1)
        resid = x if Ci == Co else torch.randn_like(h)
        ref2 = (resnet._conv3x3(resnet._gn_silu(h, ref1, *n2, 32, 1e-5), w2,
                                *q2)
                + b2 + resid.float())
        convs = {
            "conv1": (x, mean1, rstd1, n1, w1, b1, tvec, None, Ci,
                      ref1, True, q1),
            "conv2": (h, mean2, rstd2, n2, w2, b2, None, resid, Co, ref2,
                      False, q2)}
        row = dict(shape=[B, H, W, Ci, Co])
        for conv, (inp, mean, rstd, norm, w, bias, tv, res, cin, ref,
                   partials, q) in convs.items():
            wp = w.permute(0, 2, 3, 1)
            # the C entry's pointers before and after the weight's
            scales = (q[1].data_ptr(),) if q else ()
            wscale = (q[0].data_ptr(),) if q else ()
            ref_max = ref.abs().max().item()
            ms, device_ms, err = {}, {}, {}
            for name in order:
                tile, tiles = resnet_tile(fns[name], B, H, W, cin, Co)
                o = torch.empty(B, H, W, Co, dtype=torch.bfloat16, device=dev)
                ps = torch.empty(B, tiles, Co, device=dev) if partials else None
                pq = torch.empty_like(ps) if partials else None
                ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

                def run(fn=fns[name], o=o, ps=ps, pq=pq, tile=tile):
                    e = fn(inp.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                           norm[0].data_ptr(), norm[1].data_ptr(), *scales,
                           wp.data_ptr(), *wscale, bias.data_ptr(), ptr(tv),
                           ptr(res), o.data_ptr(), ptr(ps), ptr(pq), B, H, W,
                           cin, Co, 32, tile,
                           torch._C._cuda_getCurrentRawStream(0))
                    if e:
                        raise RuntimeError(f"launch failed: error {e}")
                ms.setdefault(name, []).append(cuda_time(run, 10))
                device_ms.setdefault(name, []).append(graph_time(run, 10))
                err[name] = (o.float() - ref).abs().max().item()
            # W8A8: int8 weights, bf16 activations in and out
            nbytes = (2 * B * H * W * (cin + Co * (2 if res is not None else 1))
                      + (1 if w8a8 else 2) * 9 * cin * Co)
            ops = {"int8" if w8a8 else "bf16": 2 * B * H * W * 9 * cin * Co}
            row[conv] = dict(ref_max=ref_max, ms=ms, device_ms=device_ms,
                             abs_err=err,
                             rel_err={n: err[n] / ref_max for n in fns},
                             bound_ms=max(bound_ms(nbytes, **ops)))
            print(f"[{B},{H},{W},{Ci}]->{Co} {conv}: max|ref| {ref_max:.3f}; "
                  + "; ".join(f"{n} {ms[n]} ms (device only {device_ms[n]})"
                              f", max|err| / max|ref| {err[n] / ref_max:.2e}"
                              for n in fns)
                  + f"; bound {row[conv]['bound_ms']:.4f}")
        row.update(wrapper_ms=cuda_time(lambda: wrapper(*args, **kw), 10),
                   wrapper_device_ms=graph_time(lambda: wrapper(*args, **kw),
                                                10))
        if w8a8:  # the bf16 block at the same row, this checkout's
            row.update(bf16_ms=cuda_time(
                lambda: resnet.fused_resnet(*bf16_args), 10),
                bf16_device_ms=graph_time(
                    lambda: resnet.fused_resnet(*bf16_args), 10))
            other = (f"the bf16 block {row['bf16_ms']:.4f} ms (device only "
                     f"{row['bf16_device_ms']:.4f})")
        else:
            xc = x.permute(0, 3, 1, 2)
            hc = h.permute(0, 3, 1, 2)

            def cudnn():
                F.conv2d(xc, w1, padding=1)
                F.conv2d(hc, w2, padding=1)
            row.update(cudnn_ms=cuda_time(cudnn, 10),
                       cudnn_device_ms=graph_time(cudnn, 10))
            other = (f"cuDNN's two convs {row['cudnn_ms']:.4f} ms (device "
                     f"only {row['cudnn_device_ms']:.4f})")
        print(f"[{B},{H},{W},{Ci}]->{Co} block: wrapper "
              f"{row['wrapper_ms']:.4f} ms (device only "
              f"{row['wrapper_device_ms']:.4f}); {other}")
        rows.append(row)
        del x, h, ref1, ref2, args, bf16_args
        torch.cuda.empty_cache()
    return rows


# One block an SM loads 80 KB (a 64-row tile of x and a1 at C = 320) by TMA
# boxes of one width, 20 times, and reads its clock: from device memory
# (tiles across a 125 MB tensor) or from L2 (4 tiles, all blocks alike)
TMA_RATE_CU = r"""
#include "hopper.cuh"
#include <cstdio>
#include <vector>
__global__ void __launch_bounds__(128, 1)
tma_rate(const __grid_constant__ CUtensorMap tm, int boxes, int cols, int tiles,
         long long* out, int reps) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + 200 * 1024;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, cols * 128 * boxes);
      const int tile = (blockIdx.x * reps + r) % tiles;
      for (int j = 0; j < boxes; ++j) {
        tma_load(base + j * cols * 128, &tm, bar, j * cols, tile * 64, 0, 0);
      }
    }
    mbar_wait(bar, r & 1);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}
int main() {
  const int C = 1280, S = 4096 * 12;
  void* x;
  long long* out;
  cudaMalloc(&x, (size_t)C * S * 2);
  cudaMemset(x, 0, (size_t)C * S * 2);
  cudaMalloc(&out, 132 * 8);
  cudaFuncSetAttribute(tma_rate, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       210 * 1024);
  const int cols[4] = {32, 64, 160, 256};
  const CUtensorMapSwizzle sw[4] = {CU_TENSOR_MAP_SWIZZLE_64B,
                                    CU_TENSOR_MAP_SWIZZLE_128B,
                                    CU_TENSOR_MAP_SWIZZLE_NONE,
                                    CU_TENSOR_MAP_SWIZZLE_NONE};
  for (int c = 0; c < 4; ++c) {
    CUtensorMap tm;
    const long long st[3] = {(long long)S * C, (long long)S * C, C};
    if (encode(&tm, x, C, S, 1, 1, st, 64, cols[c], sw[c])) return 1;
    const int boxes = 81920 / (cols[c] * 128);
    for (int tiles : {S / 64, 4}) {
      for (int grid : {1, 132}) {
        const int reps = 20;
        for (int k = 0; k < 2; ++k) {  // the first launch warms up
          tma_rate<<<grid, 128, 210 * 1024>>>(tm, boxes, cols[c], tiles, out,
                                              reps);
        }
        if (cudaDeviceSynchronize() != cudaSuccess) return 2;
        std::vector<long long> h(grid);
        cudaMemcpy(h.data(), out, grid * 8, cudaMemcpyDeviceToHost);
        double m = 0;
        for (long long v : h) m += v;
        m /= grid;
        printf("[tma] %d-column boxes (%d-byte rows%s), %s, %d blocks: %.0f "
               "cycles per 80 KB, %.1f bytes a cycle an SM\n", cols[c],
               cols[c] * 2, c < 2 ? ", swizzled" : "",
               tiles == 4 ? "L2 (4 tiles)" : "device memory", grid, m / reps,
               81920.0 * reps / m);
      }
    }
  }
  return 0;
}
"""


def tma_rate() -> int:
    """Builds and runs TMA_RATE_CU: the bytes a cycle one SM's TMA brings in
    for a 64-row tile in boxes of 32, 64, 160 and 256 columns, alone and
    with every SM loading, from device memory and from L2."""
    from vidtome_torch.ops.cuda_build import CSRC, nvcc_path

    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "tma_rate.cu", OUT / "tma_rate"
    src.write_text(TMA_RATE_CU)
    subprocess.run([nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(CSRC), "-o", str(exe),
                    str(src)], check=True)
    return subprocess.run([str(exe)]).returncode


# Clock stamps of an instrumented copy of csrc/sublayer.cu: (text of the
# source, where the stamp goes: before or after it, slot).  Thread 0 of each
# consumer warpgroup writes clock64() to vt_t[block][warpgroup][slot];
# slots 15-19 time the first head's attention.
PHASE_STAMPS = [
    ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));\n', "after", 0),
    ("  cluster_sync();  // A: every rank's LN2 partials are published\n", "before", 1),
    ("  cluster_sync();  // A: every rank's LN2 partials are published\n", "after", 2),
    ("  fence_proxy_async(n > 1);\n  cluster_sync();  // B", "before", 3),
    ("  cluster_sync();  // B: every rank's slice and y2 scratch are written\n", "after", 4),
    ("  // both consumers are done reading y2 from the slice\n", "before", 5),
    ("  consumers_sync<kConsumers>();  // a is whole in the slice, K / V are read\n", "before", 6),
    ("  cluster_sync();  // C: every rank's a is in the scratch\n", "after", 7),
    ("  consumers_sync<kConsumers>();  // the slice and the ring are read\n", "before", 8),
    ("  consumers_sync<kConsumers>();\n  mbar_wait(xa, 1);\n", "before", 9),
    ("  consumers_sync<kConsumers>();\n  mbar_wait(xa, 1);\n", "after", 10),
    ("  cluster_sync();  // D: every rank's LN3 partials are published\n", "before", 11),
    ("  cluster_sync();  // D: every rank's LN3 partials are published\n", "after", 12),
    ("  cluster_exit();  // E: no rank leaves while a peer reads its partials\n", "before", 13),
    ("  cluster_exit();  // E: no rank leaves while a peer reads its partials\n", "after", 14),
    ("    mbar_wait_warp(kv_full + 8 * (2 * WG + buf), use & 1);\n", "before", 15),
    ("    mbar_wait_warp(kv_full + 8 * (2 * WG + buf), use & 1);\n", "after", 16),
    ("    // softmax over the row (rows g and g + 8", "before", 17),
    ("    // O = P V_h: per 16-key step", "before", 18),
    ("    if (lane == 0) mbar_arrive(kv_empty + 8 * (2 * WG + buf));\n", "before", 19),
]
PHASES = [("LN2 loads", 0, 1), ("barrier A", 1, 2), ("stats + y2", 2, 3),
          ("fence + barrier B", 3, 4), ("q projection", 4, 5),
          ("attention", 5, 6), ("a out + barrier C", 6, 7),
          ("out projection", 7, 8), ("o staged", 8, 9),
          ("x, a1 wait", 9, 10), ("x3 row pass", 10, 11),
          ("barrier D", 11, 12), ("y3 + stores", 12, 13),
          ("barrier E", 13, 14), ("head 0: K/V wait", 15, 16),
          ("head 0: S", 16, 17), ("head 0: softmax", 17, 18),
          ("head 0: P V", 18, 19)]


def phases_source(text: str) -> str:
    """The instrumented copy of csrc/sublayer.cu (PHASE_STAMPS)."""
    text = text.replace("namespace cg = cooperative_groups;\n", """namespace cg = cooperative_groups;
__device__ long long vt_t[8192][2][20];
#define VT_STAMP(i) do { \\
    const int vb = blockIdx.y * gridDim.x + blockIdx.x; \\
    long long c; asm volatile("mov.u64 %0, %%clock64;" : "=l"(c)); \\
    if ((threadIdx.x & 127) == 0 && vb < 8192) vt_t[vb][threadIdx.x >> 7][i] = c; \\
  } while (0)
""", 1)
    for anchor, where, slot in PHASE_STAMPS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"sublayer.cu changed: stamp anchor {anchor!r}")
        stamp = (f"    if (j == 0) VT_STAMP({slot});\n" if slot >= 15
                 else f"  VT_STAMP({slot});\n")
        text = text.replace(anchor, stamp + anchor if where == "before"
                            else anchor + stamp)
    return text + ('\nextern "C" int vt_times(void* dst) { return (int)'
                   'cudaMemcpyFromSymbol(dst, vt_t, sizeof(vt_t)); }\n'
                   'extern "C" int vt_clear() { void* p = nullptr; '
                   'cudaGetSymbolAddress(&p, vt_t); '
                   'return (int)cudaMemset(p, 0, sizeof(vt_t)); }\n')


def sublayer_phases() -> int:
    """Per block, the mean SM cycles of each phase of the kernel (an
    instrumented copy of this checkout's csrc/sublayer.cu) for each
    consumer warpgroup, at chip_smoke's SUBLAYER_SHAPES and SD1.5's rows."""
    from vidtome_torch.ops import sublayer
    from vidtome_torch.ops.cuda_build import CSRC

    src = OUT / "phases"
    src.mkdir(parents=True, exist_ok=True)
    (src / "hopper.cuh").write_bytes((CSRC / "hopper.cuh").read_bytes())
    (src / "sublayer.cu").write_text(
        phases_source((CSRC / "sublayer.cu").read_text()))
    fn, _ = build(KERNELS["sublayer"], "phases", src)
    lib = ctypes.CDLL(str(OUT / "libphases.so"))
    rng = np.random.default_rng(0)
    for B, S, C, heads in KERNELS["sublayer"]["shapes"]:
        args = sublayer_inputs(rng, torch.device("cuda"), B, S, C)
        out = (torch.empty_like(args[0]), torch.empty_like(args[0]))
        run = sublayer_run(fn, args, heads, 77, out, sublayer)
        lib.vt_clear()  # a consumer without heads leaves its slots 0
        ms = cuda_time(run, 5)  # the stamps of its last launch
        torch.cuda.synchronize()
        p = sublayer.plan(B, S, C, heads, 77, 77, sublayer._sm_count(0),
                          sublayer._card_clusters(0))
        t = np.zeros((8192, 2, 20), np.int64)
        lib.vt_times(t.ctypes.data_as(ctypes.c_void_p))
        t = t[:p.grid[0] * p.grid[1]].astype(np.float64)
        for wg in (0, 1):
            seg = {name: round(float((t[:, wg, b] - t[:, wg, a]).mean()))
                   for name, a, b in PHASES if t[:, wg, a].any()}
            print(f"[phases] [{B},{S},{C}] heads {heads} (clusters of "
                  f"{p.cluster}, {p.grid[0] * p.grid[1]} blocks, {ms:.4f} "
                  f"ms a launch with the stamps), consumer {wg}: cycles "
                  f"{round(float((t[:, wg, 14] - t[:, wg, 0]).mean()))}; "
                  + ", ".join(f"{k} {v}" for k, v in seg.items()))
    return 0


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    if "--kernel=tma" in argv:
        return tma_rate()
    if "--kernel=sublayer_phases" in argv:
        return sublayer_phases()
    builds, kernel, json_path, roots = {}, KERNELS["flash"], None, []
    for arg in argv:
        if arg.startswith("--root="):
            roots.append((ROOT / arg.split("=", 1)[1]).resolve())
        elif arg.startswith("--kernel="):
            kernel = KERNELS[arg.split("=", 1)[1]]
        elif arg.startswith("--json="):
            json_path = ROOT / arg.split("=", 1)[1]
        else:
            name, path = arg.split("=", 1)
            builds[name] = (ROOT / path).resolve()
    # this checkout's module (planners, plain versions), before the roots'
    # packages are imported in its place
    tree = importlib.import_module(
        f"vidtome_torch.ops.{kernel.get('module', 'attention')}")
    if kernel.get("module") == "groupnorm":
        os.environ.pop("VIDTOME_GN_MODE", None)  # an earlier tree's auto
        os.environ.pop("VIDTOME_DISABLE_PALLAS_GN", None)
        routes = group_norm_routes(roots or [ROOT])
    else:
        wrapped = wrappers(kernel, roots or [ROOT])
        wrapper = next(iter(wrapped.values()))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    result = dict(card=card, kernel=kernel["entry"], builds={}, rows=[])
    fns = {}
    if builds:
        OUT.mkdir(parents=True, exist_ok=True)
        with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
            built = dict(zip(builds, pool.map(
                lambda n: build(kernel, n, builds[n]), builds)))
        for name, (fn, report) in built.items():
            fns[name] = fn
            result["builds"][name] = report
            print(f"[build] {name}: registers per instance {report}")
        if kernel.get("module") == "resnet":
            result["rows"] = compare_resnet(kernel, fns, wrapper)
        elif kernel.get("module") == "matching":
            result["rows"] = compare_match(kernel, fns, wrapped, tree)
        elif kernel.get("module") == "sublayer":
            result["rows"] = compare_sublayer(kernel, fns, wrapped, tree)
        elif kernel.get("module") != "groupnorm":
            result["rows"] = compare(kernel, fns, wrapper)
    if kernel.get("module") == "groupnorm":
        result["rows"] = compare_group_norm(fns, routes, tree)
    if kernel.get("module") in ("resnet", "groupnorm", "matching",
                                "sublayer"):
        if json_path is not None:
            json_path.parent.mkdir(parents=True, exist_ok=True)
            json_path.write_text(json.dumps(result, indent=1))
        return 0
    B, H, Sq, Skv, D = kernel["host"]
    q = torch.zeros(B, H, Sq, D, device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros(B, H, Skv, D, device="cuda", dtype=torch.bfloat16)
    runs = {name: launcher(kernel, fn, q, kv, kv, output(kernel, q))
            for name, fn in fns.items()}
    runs.update({f"wrapper {root}": functools.partial(w, q, kv, kv)
                 for root, w in wrapped.items()})
    runs["sdpa"] = functools.partial(
        torch.nn.functional.scaled_dot_product_attention, q, kv, kv)
    host = {}
    for _ in range(3):
        for name in list(runs) + list(reversed(runs)):
            host.setdefault(name, []).append(round(wall_us(runs[name]), 2))
    result["host_us"] = host
    print(f"[host] wall us a call at [{B},{H},{Sq}x{Skv},{D}]: "
          + "; ".join(f"{n} {v}" for n, v in host.items()))
    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
