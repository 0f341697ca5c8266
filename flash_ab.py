"""Time builds of one of the port's attention C entries against each other
on one CUDA card, in turns, at chip_smoke.py's shapes for that kernel, and
the host's cost of one call of the Python wrapper.

    python3 flash_ab.py [--kernel=flash|small_kv] [--root=DIR ...]
                        [--json=PATH] [NAME=DIR ...]

``--kernel`` picks the source, its C entry and the shapes (default
``flash``):
  flash     ``flash_attention.cu``, ``vidtome_flash_attention``,
            ``chip_smoke.FLASH_SHAPES``; the output contiguous;
  small_kv  ``small_kv_attention.cu``, ``vidtome_small_kv_attention``,
            ``chip_smoke.SMALL_KV_SHAPES``; the output in the [B, S, H, D]
            storage the wrapper writes.
Each build DIR holds that source (and the ``*.cuh`` it includes) with the
C signature of ``vidtome_torch/csrc``'s; ``new=vidtome_torch/csrc`` is this
checkout's kernel.  All are compiled at once (one nvcc each, the flags of
``vidtome_torch.ops.cuda_build``) into ``build/flash_ab/``, and their
registers and spills printed per kernel instance.  At each shape every
build runs in the order given and then in reverse (A, B, B, A),
``chip_smoke.cuda_time`` over 10 launches of the C entry alone each, on the
same seeded inputs, its output held against ``reference_attention`` in fp32
(max |err|, and max |err| / max |ref|), and device-only
(``chip_smoke.graph_time``: 10 launches in a replayed CUDA graph, no host
time between them).  Beside them, on the same inputs:
the wrapper of the package under the first ``--root`` through its call
(``cuda_time``) and device-only (``chip_smoke.graph_time``: 10 calls in a
replayed CUDA graph), ``scaled_dot_product_attention`` both ways,
chip_smoke.py's bound and the exp floor (one exp2 a score).

Last, the wall microseconds of one call, where the host's cost shows (at
[1, 1, 128x128, 64] for flash, [1, 1, 128x77, 64] for small-KV), in three
rounds of turns: of each build's C entry, of the wrapper of the package
under each ``--root`` (default this checkout; give it twice, with a ``git
archive`` of another commit, to compare two wrappers in one process, each
with the kernels of its own package) and of SDPA.  With no build only
those are timed.  ``--json=PATH`` also writes every reading there.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import importlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (EXP2_S, FLASH_SHAPES, SMALL_KV_SHAPES, bound_ms,
                        cuda_time, graph_time)

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
}


def build(kernel: dict, name: str, src: Path):
    from vidtome_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    out = OUT / f"lib{name}.so"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src / kernel["source"])],
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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * kernel["ints"] + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
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
            attention = importlib.import_module("vidtome_torch.ops.attention")
        finally:
            sys.path.remove(str(root))
        found[str(root)] = getattr(attention, kernel["wrapper"])
    return found


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


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
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
        result["rows"] = compare(kernel, fns, wrapper)
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
