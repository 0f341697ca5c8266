"""Run one benchmark cell of vidtome_torch once, on the card.

    python3 benchmark/run.py --workload sd15-exact-cb-32f --seed 7 \\
        --seconds 45 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a model configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``); its limits are
``benchmark/limits/<workload>.json`` and each per-layer metric has its
reader ``benchmark/metrics/<metric>.py``.  One run:

1. set-up: imports, the port's modules filled with weights drawn from the
   seed on the card, the clips and prompts of the edits, a warm-up edit
   of two steps a stage that runs every call kind of the cell once at its
   real shapes (building the port's kernels under ``build/`` where a
   checkout has not yet built them);
2. the window: whole edits back to back, each ending in one
   ``torch.cuda.synchronize()``; a new edit starts only while ``--seconds``
   have not run out; nothing is written to disk or copied to the host;
   with ``--trace 1`` one edit under the profiler and the benchmark's hooks;
3. the check: one edit of the window, drawn from the seed, against the
   plain float32 reference (``benchmark/harness/check.py``).

The last line of standard output is the result (JSON); the numbers
compared, each beside its limit, end standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "vidtome_tpu")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``vidtome_torch`` is not ``vidtome_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(workload: str) -> tuple[dict, dict, dict, dict, list]:
    """(cell, model configuration, traffic, limits, per-layer metrics of
    the cell) from BENCHMARK.json and the files it names."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r} (BENCHMARK.json has "
                         f"{sorted(cells)})")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    model = json.loads((ROOT / config["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    return cell, model, traffic, limits, bench["per_layer"]


def smi() -> str:
    """The card's name, SM clock, temperature, power draw and limit."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,temperature.gpu,"
             "power.draw,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def warm_config(config: dict) -> dict:
    """The run's configuration cut to two steps a stage: every call kind
    of the cell (PnP: injected and not) at its real shapes."""
    cfg = copy.deepcopy(config)
    cfg["inversion"]["steps"] = cfg["inversion"]["save_steps"] = 2
    cfg["generation"]["n_timesteps"] = 2
    return cfg


def run_cell(model: dict, traffic: dict, limits: dict, metrics: list,
             seed: int, seconds: float, trace: bool, device,
             sync, control: bool = False, log=print) -> tuple[dict, dict]:
    """One run of a cell on ``device`` (the caller has checked it);
    returns the result line and every reading of the check
    (``check.compare``).  ``sync`` waits for the device; ``control`` runs
    the control in the program's place (``harness/check.py``)."""
    import torch

    from benchmark.harness import check, inputs
    from benchmark.harness.program import Program, stage_config

    setup = {"process_s": process_age()}
    t = time.perf_counter()
    importlib.import_module("vidtome_torch.pipeline.generator")
    setup["imports_s"] = time.perf_counter() - t
    config = stage_config(traffic, model, seed, control)
    t = time.perf_counter()
    torch.zeros(1, device=device)  # the device's context
    sync()
    setup["device_init_s"] = time.perf_counter() - t
    program = Program(model, config, seed, device, sync)
    setup.update(program.parts)
    n_frames = int(traffic["frames"])
    max_edits = int(traffic["max_edits"])
    t = time.perf_counter()
    clips = [inputs.clip(traffic, model["height"], model["width"], seed, k,
                         device) for k in range(max_edits)]
    texts = [inputs.prompts(traffic, seed, k) for k in range(max_edits)]
    sync()
    setup["inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    program.use(warm_config(config))
    program.edit(inputs.clip(traffic, model["height"], model["width"], seed,
                             max_edits, device), *texts[0])
    program.use(config)
    sync()
    setup["warmup_s"] = time.perf_counter() - t
    gc.collect()
    # the window's one sampled edit: edit 0 or 1, from the seed
    chosen = int(seed) % 2
    log(f"[bench] set-up parts {json.dumps(setup)}")
    log(f"[bench] card before {smi()}")
    tracer = prof = None
    if trace:
        from benchmark.harness import trace as tracing
        tracer = tracing.Tracer(program, sync)
        prof = tracing.profiler()
        prof.__enter__()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age()
    edit_s, kept = [], None
    t0 = time.perf_counter()
    while len(edit_s) < max_edits and (
            not edit_s or time.perf_counter() - t0 < seconds):
        k = len(edit_s)
        s = time.perf_counter()
        if tracer is not None:
            with torch.profiler.record_function("bench/edit"):
                out = program.edit(clips[k], *texts[k], stage=tracer.stage)
                sync()
        else:
            out = program.edit(clips[k], *texts[k])
            sync()
        edit_s.append(time.perf_counter() - s)
        if k == chosen or (kept is None and k == 0):
            kept = (k, out)
        del out
        if trace:
            break
    end = time.perf_counter()
    window_s = end - t0
    peak = torch.cuda.max_memory_allocated(device) if device != "cpu" else 0
    calls, gen_calls = program.unet_calls()
    log(f"[bench] edits {len(edit_s)} seconds {json.dumps(edit_s)}")
    log(f"[bench] card after {smi()}")
    records = None
    if trace:
        prof.__exit__(None, None, None)
        tracer.remove()
        t = time.perf_counter()
        records = tracing.reduce(prof, tracer)
        records.update(frames=n_frames * len(edit_s), unet_calls=calls,
                       gen_unet_calls=gen_calls, edits=len(edit_s))
        del prof
        log(f"[bench] trace read in {time.perf_counter() - t:.1f} s")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{found}")
    k, edited = kept
    del program, clips[k + 1:], clips[:k]
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.compare(model, traffic, config, seed, clips[0],
                            *texts[k], edited, device, control)
    log(f"[bench] reference check of edit {k} in "
        f"{time.perf_counter() - t:.1f} s")
    correct, rows = check.judge(numbers, limits)
    frames_done = n_frames * len(edit_s)
    result = {"correct": correct, "attempted": len(edit_s), "failed": 0}
    if trace:
        out = {}
        for m in metrics:
            reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
            value = reader.read(records)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = out
    else:
        result["metrics"] = {
            "frames_per_s": {"value": frames_done / window_s,
                             "unit": "frames/s"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["device"] = {"platform": "gpu" if device != "cpu" else "cpu",
                        "kind": (torch.cuda.get_device_name(device)
                                 if device != "cpu" else "cpu"),
                        "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=records["busy_s"],
                                window_s=records["window_s"])
        result["breakdown"] = {"device_ops": records["device_ops"],
                               "idle_gaps": records["idle_gaps"]}
    # the numbers compared, each beside its limit: the line's last key
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in rows}
    return result, numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, model, traffic, limits, metrics = load_cell(args.workload)
    # every cache the program and its libraries build, inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] needs {cell['chips']} CUDA device(s); found {found}:"
              " no result", file=sys.stderr)
        return 2
    device = "cuda"
    torch.cuda.set_device(0)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    # the port's own lines go to standard error: the result ends stdout
    with contextlib.redirect_stdout(sys.stderr):
        result, _ = run_cell(model, traffic, limits, metrics, args.seed,
                             args.seconds, bool(args.trace), device,
                             torch.cuda.synchronize, log=log)
    for name, row in result["compared"].items():
        log(f"[check] {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
