"""The reduction of the program's ``vidtome/`` spans (``harness/spans.py``)
and the readers of ``metrics/`` that read it, on a Chrome trace of a few
events built by hand; the records ``trace.reduce`` gives are the same
bytes with and without program spans in the trace."""

from __future__ import annotations

import collections
import importlib
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import spans, trace  # noqa: E402

READERS = ("unet_python_ms", "unet_idle_ms_per_call", "gen_step_self_ms",
           "merge_plan_ms_per_unet_call", "merge_apply_ms_per_unet_call")


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


# One sampling step (100-600 us) holding one UNet call (150-450) with a
# merge-plan (200-250) and a merge-apply (260-300) span; five launches
# (us): 120 in the step, 210 in the plan, 270 in the apply, 400 in the
# call, 900 in no program span; a copy at 800-850 launched by nobody.
HARNESS = [
    _x("user_annotation", "bench/edit", 0, 1000),
    _x("user_annotation", "bench/unet", 140, 320),
]
PROGRAM = [
    _x("user_annotation", "vidtome/gen_step step=0 cache=off", 100, 500),
    _x("user_annotation", "vidtome/unet rows=8 cache=full bank=init", 150,
       300),
    _x("user_annotation", "vidtome/merge_plan tokens=64", 200, 50),
    _x("user_annotation", "vidtome/merge_apply", 260, 40),
]
DEVICE = [
    _x("cuda_runtime", "cudaLaunchKernel", 120, 5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 210, 10, corr=2),
    _x("cuda_driver", "cuLaunchKernel", 270, 4, corr=3),
    _x("cuda_runtime", "cudaLaunchKernel", 400, 6, corr=4),
    _x("cuda_runtime", "cudaLaunchKernel", 900, 3, corr=5),
    _x("kernel", "k1", 130, 50, tid=7, corr=1),
    _x("kernel", "k2", 220, 100, tid=7, corr=2),
    _x("kernel", "k3", 330, 20, tid=7, corr=3),
    _x("kernel", "k4", 500, 200, tid=7, corr=4),
    _x("gpu_memcpy", "Memcpy", 800, 50, tid=7),
    _x("kernel", "k5", 910, 10, tid=7, corr=5),
]
US = 1e-6


@pytest.fixture(scope="module")
def program():
    events = HARNESS + PROGRAM + DEVICE
    return spans.reduce(events, *spans.window(events))


def test_host_self_and_runtime_seconds(program):
    step, unet = program["gen_step"], program["unet"]
    assert step["calls"] == unet["calls"] == 1
    assert step["host_s"] == pytest.approx(500 * US)
    assert step["self_s"] == pytest.approx((500 - 300) * US)
    assert unet["self_s"] == pytest.approx((300 - 50 - 40) * US)
    # runtime and driver calls inside, children included
    assert step["runtime_s"] == pytest.approx((5 + 10 + 4 + 6) * US)
    assert unet["runtime_s"] == pytest.approx((10 + 4 + 6) * US)
    assert program["merge_apply"]["runtime_s"] == pytest.approx(4 * US)


def test_kernels_count_once_in_the_innermost_span(program):
    p = program
    assert (p["gen_step"]["device_s"], p["gen_step"]["launches"]) == (
        pytest.approx(50 * US), 1)
    assert p["unet"]["device_s"] == pytest.approx(200 * US)
    assert p["merge_plan"]["device_s"] == pytest.approx(100 * US)
    assert p["merge_apply"]["device_s"] == pytest.approx(20 * US)
    assert p["unet"]["device_all_s"] == pytest.approx(320 * US)
    assert (p["gen_step"]["launches_all"], p["unet"]["launches_all"]) == (
        4, 3)
    # to the end of the last kernel launched inside
    assert p["unet"]["wall_s"] == pytest.approx((700 - 150) * US)
    assert p["gen_step"]["wall_s"] == pytest.approx((700 - 100) * US)
    assert p["merge_plan"]["wall_s"] == pytest.approx((320 - 200) * US)


def test_idle_goes_to_the_innermost_span_at_the_gap(program):
    # busy 130-180, 220-320, 330-350, 500-700, 800-850, 910-920; the gaps
    # at 180, 320 and 350 start inside the UNet call, outside its merges
    assert program["unet"]["idle_s"] == pytest.approx((40 + 10 + 150) * US)
    assert program["gen_step"]["idle_s"] == 0
    assert program["gen_step"]["idle_all_s"] == pytest.approx(200 * US)
    assert program["merge_plan"]["idle_s"] == 0


def test_idle_in_no_program_span_is_none(program):
    # 0-130 before the step, 700-800, 850-910 and 920-1000 after it
    assert program["none"]["idle_s"] == pytest.approx(
        (130 + 100 + 60 + 80) * US)
    events = HARNESS + DEVICE
    bare = spans.reduce(events, *spans.window(events))
    assert set(bare) == {"none"}
    assert bare["none"]["idle_s"] == pytest.approx(
        (130 + 40 + 10 + 150 + 100 + 60 + 80) * US)


def test_spans_per_call_runtime_calls_and_names():
    assert spans.spans_per_call(HARNESS + PROGRAM + DEVICE) == (3, 3)
    assert spans.spans_per_call(HARNESS + DEVICE) is None
    got = spans.runtime_calls(HARNESS + PROGRAM + DEVICE)
    assert [g[:2] + [g[3]] for g in got] == [
        ["merge_plan", "cudaLaunchKernel", 1],
        ["unet", "cudaLaunchKernel", 1],
        ["gen_step", "cudaLaunchKernel", 1],
        ["merge_apply", "cuLaunchKernel", 1],
        ["none", "cudaLaunchKernel", 1]]
    assert got[0][2] == pytest.approx(10 * US)
    assert spans.span_name("vidtome/unet rows=8") == "unet"
    assert spans.span_name("bench/unet") is None


def test_readers(program):
    rec = {"program": program, "gen_unet_calls": 2}
    got = {n: importlib.import_module(f"benchmark.metrics.{n}").read(rec)
           for n in READERS}
    assert got == pytest.approx({
        "unet_python_ms": (300 - 20) * 1e-3,
        "unet_idle_ms_per_call": 200 * 1e-3,
        "gen_step_self_ms": 200 * 1e-3,
        "merge_plan_ms_per_unet_call": 100 * 1e-3 / 2,
        "merge_apply_ms_per_unet_call": 20 * 1e-3 / 2})


@pytest.mark.parametrize("rec", [
    {"gen_unet_calls": 2},  # records of a run without the reduction
    {"program": {"none": {"idle_s": 1.0}}, "gen_unet_calls": 2},  # no span
    {"program": {}, "gen_unet_calls": 0},
])
def test_readers_give_none_without_the_spans(rec):
    for n in READERS:
        assert importlib.import_module(f"benchmark.metrics.{n}").read(
            rec) is None


class _Prof:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


class _Tracer:
    def __init__(self):
        self.kinds = collections.defaultdict(trace.Kind)
        self.kinds["unet"].calls = 1
        self.kinds["unet"].host_s = 0.00032
        self.model_flops = 1e9
        self.stage_s = collections.Counter(generate=0.001)


def test_harness_records_ignore_program_spans():
    without = trace.reduce(_Prof(HARNESS + DEVICE), _Tracer())
    with_spans = trace.reduce(_Prof(HARNESS + PROGRAM + DEVICE), _Tracer())
    assert json.dumps(without, sort_keys=True) == json.dumps(
        with_spans, sort_keys=True)
    assert without["kinds"]["unet"]["launches"] == 3


def test_beside_reads_both_sides(program):
    rec = trace.reduce(_Prof(HARNESS + PROGRAM + DEVICE), _Tracer())
    rec.update(program=program, frames=1, gen_unet_calls=2, unet_calls=1,
               edits=1)
    both = spans.beside(rec)
    assert both["launches_per_unet_call"] == (3.0, 3.0)
    assert both["unet_enqueue_ms"] == pytest.approx((0.32, 0.3))
    assert both["merge_ms_per_unet_call"][1] == pytest.approx(0.06)
