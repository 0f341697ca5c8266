"""The program's own spans in a traced run, reduced to records.

``vidtome_torch`` opens a ``vidtome/<name>`` range
(``logging_utils.span``, a ``torch.profiler.record_function``) at each of
its layer boundaries while a profiler records; attributes follow the name
after a space.  They land in the same Chrome trace as the CUDA runtime
calls and the kernels, on one clock, and nest on the one host thread that
runs the program, so a span's parent is the innermost span around it.

:func:`reduce` gives, for each span name (the word after ``vidtome/``):

- ``calls``: its spans;
- ``host_s``: their host seconds (a span inside one of the same name is
  not counted again);
- ``self_s``: host seconds outside their child program spans;
- ``runtime_s``: host seconds inside ``cuda_runtime`` / ``cuda_driver``
  calls made inside them (children included);
- ``wall_s``: each span from its start to the later of its end and the
  end of the last kernel launched inside it, as a synchronize at its end
  would have ended it;
- ``device_s`` / ``launches``: the kernels whose launch falls inside them
  and in no child program span (each kernel counts once, in the
  innermost span); ``device_all_s`` / ``launches_all`` children
  included;
- ``idle_s``: the window's device-idle gaps whose start finds the host
  innermost in such a span; ``idle_all_s`` children included.

A gap that starts in no program span goes under ``none``.  Nothing here
is read by a metric of ``BENCHMARK.json`` yet; ``benchmark/program_spans.py``
prints it beside a traced run.
"""

from __future__ import annotations

import collections
import importlib

PREFIX = "vidtome/"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
FIELDS = ("calls", "host_s", "self_s", "runtime_s", "wall_s", "device_s",
          "launches", "device_all_s", "launches_all", "idle_s",
          "idle_all_s")


class Span:
    """One program span: its name, start and end (us), its parent."""

    __slots__ = ("name", "s", "e", "parent", "child_us", "last_us")

    def __init__(self, name: str, s: float, e: float):
        self.name, self.s, self.e = name, s, e
        self.parent = None
        self.child_us = 0.0
        self.last_us = e

    def chain(self):
        """This span and its ancestors, innermost first."""
        sp = self
        while sp is not None:
            yield sp
            sp = sp.parent

    def names(self) -> set[str]:
        return {sp.name for sp in self.chain()}


def span_name(event_name: str) -> str | None:
    """``unet`` of ``vidtome/unet rows=8 cache=full``; None for an event
    that is not a program span."""
    if not event_name.startswith(PREFIX):
        return None
    return event_name[len(PREFIX):].split(" ", 1)[0]


def _threads(events) -> dict:
    """The program spans of each host thread, nested: parents linked,
    ordered by start."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        name = span_name(e.get("name", ""))
        if name is not None:
            ts = float(e["ts"])
            by_tid[e.get("tid")].append(Span(name, ts,
                                             ts + float(e.get("dur", 0))))
    for spans in by_tid.values():
        spans.sort(key=lambda sp: (sp.s, -sp.e))
        stack = []
        for sp in spans:
            while stack and not (stack[-1].s <= sp.s and sp.e <= stack[-1].e):
                stack.pop()
            if stack:
                sp.parent = stack[-1]
                stack[-1].child_us += sp.e - sp.s
            stack.append(sp)
    return by_tid


def locate(spans: list[Span], times: list[float]) -> list[Span | None]:
    """The innermost span of ``spans`` (one thread's, nested, ordered by
    start) that holds each time of ``times`` (ordered)."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j].s <= t:
            sp = spans[j]
            while stack and stack[-1].e < sp.s:
                stack.pop()
            stack.append(sp)
            j += 1
        while stack and stack[-1].e < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def reduce(events, w0: float, w1: float, busy) -> dict:
    """Records of the program spans of a Chrome trace's ``events``: the
    fields of the module's docstring by span name, and ``none``'s idle
    seconds.  ``w0`` / ``w1`` bound the window (us), ``busy`` is the
    union of its device intervals, ordered (``trace.reduce``'s)."""
    threads = _threads(events)
    recs = collections.defaultdict(lambda: dict.fromkeys(FIELDS, 0))
    calls = collections.defaultdict(list)  # host thread -> runtime calls
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _LAUNCH_CATS:
            calls[e.get("tid")].append(
                (float(e["ts"]), float(e.get("dur", 0)),
                 e.get("args", {}).get("correlation")))
    launch = {}  # correlation -> the innermost span at the launch
    for tid, spans in threads.items():
        cs = sorted(calls[tid], key=lambda c: c[0])
        for (ts, dur, corr), sp in zip(cs, locate(spans, [c[0] for c in cs])):
            if sp is None:
                continue
            for name in sp.names():
                recs[name]["runtime_s"] += dur * 1e-6
            if corr is not None:
                launch[corr] = sp
        for sp in spans:
            r = recs[sp.name]
            r["calls"] += 1
            r["self_s"] += (sp.e - sp.s - sp.child_us) * 1e-6
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        sp = launch.get(e.get("args", {}).get("correlation"))
        if sp is None:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        recs[sp.name]["device_s"] += dur * 1e-6
        recs[sp.name]["launches"] += 1
        for name in sp.names():
            recs[name]["device_all_s"] += dur * 1e-6
            recs[name]["launches_all"] += 1
        for anc in sp.chain():
            anc.last_us = max(anc.last_us, ts + dur)
    for spans in threads.values():
        for sp in spans:
            if sp.name in {a.name for a in sp.chain() if a is not sp}:
                continue  # inside a span of its own name
            recs[sp.name]["host_s"] += (sp.e - sp.s) * 1e-6
            recs[sp.name]["wall_s"] += (sp.last_us - sp.s) * 1e-6
    # idle: the program's thread (the one with most spans) at each gap
    main = max(threads.values(), key=len) if threads else []
    gaps, prev = [], w0
    for s, e in list(busy) + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s - prev))
        prev = max(prev, e)
    none = 0.0
    for (t, length), sp in zip(gaps, locate(main, [g[0] for g in gaps])):
        if sp is None:
            none += length * 1e-6
            continue
        recs[sp.name]["idle_s"] += length * 1e-6
        for name in sp.names():
            recs[name]["idle_all_s"] += length * 1e-6
    out = {k: dict(v) for k, v in recs.items()}
    out["none"] = {"idle_s": none}
    return out


def window(events) -> tuple[float, float, list]:
    """(w0, w1, busy) of a traced run's events as ``trace.reduce`` takes
    them: the harness's ``bench/edit`` spans, and the union of the device
    intervals inside them."""
    from benchmark.harness.trace import _union

    edits = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") == "bench/edit"]
    w0, w1 = min(s for s, _ in edits), max(e for _, e in edits)
    device = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in events if e.get("ph") == "X"
              and e.get("cat") in _DEVICE_CATS]
    busy = _union([(max(s, w0), min(e, w1)) for s, e in device
                   if e > w0 and s < w1])
    return w0, w1, busy


def spans_per_call(events, call: str = "unet") -> tuple | None:
    """(mean, most) program spans a ``vidtome/<call>`` span holds, itself
    included; None without such a span."""
    held = []
    for spans in _threads(events).values():
        first = {}
        for sp in spans:
            outer = [a for a in sp.chain() if a.name == call]
            if outer:
                key = id(outer[-1])
                first[key] = first.get(key, 0) + 1
        held += first.values()
    return (sum(held) / len(held), max(held)) if held else None


def runtime_calls(events, top: int = 12) -> list[list]:
    """[innermost program span (or ``none``), CUDA runtime or driver call,
    host seconds, calls] of the ``top`` pairs that took most host time:
    which calls wait on the card (a synchronize, a blocking copy) and in
    which span."""
    threads = _threads(events)
    calls = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _LAUNCH_CATS:
            calls[e.get("tid")].append((float(e["ts"]),
                                        float(e.get("dur", 0)),
                                        e.get("name", "")))
    seconds, counts = collections.Counter(), collections.Counter()
    for tid, cs in calls.items():
        cs.sort()
        where = locate(threads.get(tid, []), [c[0] for c in cs])
        for (_, dur, name), sp in zip(cs, where):
            key = (sp.name if sp is not None else "none", name)
            seconds[key] += dur * 1e-6
            counts[key] += 1
    return [[k[0], k[1], v, counts[k]] for k, v in seconds.most_common(top)]


def beside(rec: dict) -> dict[str, tuple]:
    """Each harness-hooked metric of ``BENCHMARK.json`` next to the same
    quantity from the program's spans: {metric: (harness, program)}; a
    side the records cannot give is None."""
    p = rec.get("program", {})
    kinds = rec["kinds"]

    def get(name, field):
        return p.get(name, {}).get(field, 0)

    def ratio(a, b, scale=1.0):
        return scale * a / b if a and b else None

    unet_calls = get("unet", "calls")
    program = {
        "invert_ms_per_frame": ratio(get("invert", "wall_s"), rec["frames"],
                                     1e3),
        "generate_ms_per_frame": ratio(get("generate", "wall_s"),
                                       rec["frames"], 1e3),
        "vae_ms_per_frame": ratio(get("vae_encode", "device_all_s")
                                  + get("vae_decode", "device_all_s"),
                                  rec["frames"], 1e3),
        "launches_per_unet_call": ratio(get("unet", "launches_all"),
                                        unet_calls),
        "unet_enqueue_ms": ratio(get("unet", "host_s"), unet_calls, 1e3),
        "merge_ms_per_unet_call": ratio(
            get("merge_plan", "device_all_s")
            + get("merge_apply", "device_all_s"), rec["gen_unet_calls"],
            1e3),
        "attention_roofline": ratio(kinds.get("attn", {}).get("least_s"),
                                    get("attn", "device_all_s"), 100.0),
        "resnet_roofline": ratio(kinds.get("resnet", {}).get("least_s"),
                                 get("resnet", "device_all_s"), 100.0),
    }
    out = {}
    for name, value in program.items():
        reader = importlib.import_module(f"benchmark.metrics.{name}")
        out[name] = (reader.read(rec), value)
    return out


def idle_by_span(rec: dict) -> dict[str, float]:
    """Idle seconds by the innermost program span, ``none`` included,
    largest first."""
    p = rec.get("program", {})
    idle = {k: v["idle_s"] for k, v in p.items() if v.get("idle_s")}
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))
