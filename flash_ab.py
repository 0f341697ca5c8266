"""Time builds of the port's flash-attention C entry against each other on
one CUDA card, in turns, at chip_smoke.py's FLASH_SHAPES, and the host's
cost of one call of the Python wrapper.

    python3 flash_ab.py [--root=DIR] [NAME=DIR ...]

Each build DIR holds a ``flash_attention.cu`` (and the ``*.cuh`` it
includes) that exports ``vidtome_flash_attention`` with the C signature of
``vidtome_torch/csrc/flash_attention.cu``; ``new=vidtome_torch/csrc`` is
this checkout's kernel.  All are compiled at once (one nvcc each, the flags
of ``vidtome_torch.ops.cuda_build``) into ``build/flash_ab/``, and their
registers and spill lines printed.  At each shape every build runs in the
order given and then in reverse (A, B, B, A), ``chip_smoke.cuda_time`` over
10 launches each, on the same seeded inputs, its output held against
``reference_attention`` in fp32 (max |err|, and max |err| / max |ref|).
Beside them: the time of ``scaled_dot_product_attention`` on the same
inputs, chip_smoke.py's bound and the exp floor (one exp2 a score).

Last, the wall microseconds of one call at [1, 1, 128x128, 64], where the
host's cost shows: of each build's C entry, and of the ``flash_attention``
wrapper of the package under ``--root`` (default this checkout; a
``git archive`` of another commit compares two wrappers from two runs).
With no build only that wrapper is timed.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import EXP2_S, FLASH_SHAPES, bound_ms, cuda_time

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "flash_ab"


def build(name: str, src: Path):
    from vidtome_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    out = OUT / f"lib{name}.so"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
         str(src / "flash_attention.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    regs = [ln.split("Used")[1].split(",")[0].strip()
            for ln in proc.stderr.splitlines() if "Used" in ln]
    spills = sorted({ln.strip() for ln in proc.stderr.splitlines()
                     if "spill" in ln})
    fn = ctypes.CDLL(str(out)).vidtome_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, regs, spills


def launcher(fn, q, k, v, o):
    """One call of a build's C entry on [B, H, S, D] tensors."""
    B, H, Sq, D = q.shape
    st = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                  *v.stride()[:3], *o.stride()[:3])
    scale = math.log2(math.e) / math.sqrt(D)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                 H, Sq, k.shape[2], D, st, scale, stream)
        if err:
            raise RuntimeError(f"launch failed: error {err}")
    return run


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


def compare(fns: dict) -> None:
    order = list(fns) + list(reversed(fns))
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    from vidtome_torch.ops.attention import reference_attention

    for B, H, Sq, Skv, D in FLASH_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, H, s, D), np.float32)).to(dev, torch.bfloat16)
            for s in (Sq, Skv, Skv))
        want = reference_attention(q.float(), k.float(), v.float())
        ref_max = want.abs().max().item()
        ms, err = {}, {}
        for name in order:
            o = torch.empty_like(q)
            ms.setdefault(name, []).append(
                cuda_time(launcher(fns[name], q, k, v, o), 10))
            err[name] = (o.float() - want).abs().max().item()
        del want
        sdpa = cuda_time(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
            10)
        bound = max(bound_ms(2 * 2 * B * H * (Sq + Skv) * D,
                             bf16=4 * B * H * Sq * Skv * D))
        print(f"[{B},{H},{Sq}x{Skv},{D}] max|ref| {ref_max:.4f}; "
              + "; ".join(f"{n} {ms[n]} ms, max|err| {err[n]:.2e} "
                          f"({err[n] / ref_max:.2e} of max|ref|)"
                          for n in fns)
              + f"; sdpa {sdpa:.4f} ms; bound {bound:.4f}; exp floor "
              f"{B * H * Sq * Skv / EXP2_S * 1e3:.4f}")
        del q, k, v
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    builds = {}
    for arg in argv:
        if arg.startswith("--root="):
            sys.path.insert(0, str((ROOT / arg.split("=", 1)[1]).resolve()))
        else:
            name, path = arg.split("=", 1)
            builds[name] = (ROOT / path).resolve()
    from vidtome_torch.ops import attention

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    fns = {}
    if builds:
        OUT.mkdir(parents=True, exist_ok=True)
        with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
            built = dict(zip(builds, pool.map(build, builds,
                                              builds.values())))
        for name, (fn, regs, spills) in built.items():
            fns[name] = fn
            print(f"[build] {name}: registers {regs}; {spills}")
        compare(fns)
    q = torch.zeros(1, 1, 128, 64, device="cuda", dtype=torch.bfloat16)
    host = {}
    for name in list(fns) + list(reversed(fns)):
        run = launcher(fns[name], q, q, q, torch.empty_like(q))
        host.setdefault(name, []).append(wall_us(run))
    host["wrapper"] = [wall_us(lambda: attention.flash_attention(q, q, q))
                       for _ in range(2)]
    print(f"[host] wall us a call at [1,1,128x128,64]; wrapper of "
          f"{Path(attention.__file__).resolve().parents[2]}: "
          + "; ".join(f"{n} {v}" for n, v in host.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
