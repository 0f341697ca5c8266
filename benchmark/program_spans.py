"""A traced run of one cell, read through the program's own spans.

    python3 benchmark/program_spans.py --workload sd15-exact-cb-32f \\
        --seed 7 [--out build/spans.json]

Runs ``run.py --trace 1``'s run (one edit under the profiler and the
benchmark's hooks, then the check) and reduces the same trace a second
time through ``harness/spans.py``: the records gain ``program``, the
``vidtome/`` spans by name.  Standard error gets the idle seconds by the
innermost program span, each harness-hooked metric beside the same
quantity from the program spans, the program spans a UNet call holds and
the readers of ``metrics/`` that read ``program``; the last line of
standard output is the run's result with those readings under
``program_metrics``.  ``--out`` writes the program records there too.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

READERS = ("unet_python_ms", "unet_idle_ms_per_call", "gen_step_self_ms",
           "merge_plan_ms_per_unet_call", "merge_apply_ms_per_unet_call")


def reduce_both(reduce, prof, tracer) -> tuple[dict, list]:
    """``reduce(prof, tracer)`` (``trace.reduce``, which exports the
    profiler's Chrome trace once), and the events of the trace it read."""
    fd, kept = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    export = prof.export_chrome_trace

    def export_and_keep(path):
        export(path)
        shutil.copyfile(path, kept)

    prof.export_chrome_trace = export_and_keep
    try:
        rec = reduce(prof, tracer)
        with open(kept) as f:
            events = json.load(f)
    finally:
        os.unlink(kept)
    return rec, events.get("traceEvents", events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from benchmark import run
    from benchmark.harness import spans
    from benchmark.harness import trace as tracing

    _, model, traffic, limits, metrics = run.load_cell(args.workload)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch

    if not torch.cuda.is_available():
        print("[bench] needs a CUDA device: no result", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    kept = {}
    reduce = tracing.reduce

    def reduce_program(prof, tracer):
        rec, events = reduce_both(reduce, prof, tracer)
        rec["program"] = spans.reduce(events, *spans.window(events))
        kept.update(rec=rec, per_call=spans.spans_per_call(events),
                    runtime=spans.runtime_calls(events))
        return rec

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    tracing.reduce = reduce_program
    try:
        with contextlib.redirect_stdout(sys.stderr):
            result, _ = run.run_cell(model, traffic, limits, metrics,
                                     args.seed, 0.0, True, "cuda",
                                     torch.cuda.synchronize, log=log)
    finally:
        tracing.reduce = reduce
    rec = kept["rec"]
    idle = spans.idle_by_span(rec)
    log(f"[bench] idle by program span {json.dumps(idle)}")
    log(f"[bench] window idle {rec['window_s'] - rec['busy_s']!r} s, "
        f"none {rec['program'].get('none', {}).get('idle_s', 0.0)!r} s")
    log(f"[bench] beside the harness (harness, program spans) "
        f"{json.dumps(spans.beside(rec))}")
    log(f"[bench] program spans a UNet call (mean, most) "
        f"{kept['per_call']!r}")
    log(f"[bench] CUDA calls by program span (span, call, host s, calls) "
        f"{json.dumps(kept['runtime'])}")
    read = {}
    for name in READERS:
        value = importlib.import_module(f"benchmark.metrics.{name}").read(rec)
        if value is not None:
            read[name] = value
    log(f"[bench] program-span metrics {json.dumps(read)}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"program": rec["program"], "metrics": result["metrics"],
             "program_metrics": read, "idle_by_span": idle,
             "beside": spans.beside(rec), "spans_per_unet_call":
             kept["per_call"], "runtime_calls": kept["runtime"],
             "window_s": rec["window_s"],
             "busy_s": rec["busy_s"], "frames": rec["frames"],
             "gen_unet_calls": rec["gen_unet_calls"]}, indent=1))
    result["program_metrics"] = read
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
