"""The traced run: spans from the benchmark's own hooks, one profiler
window over whole edits, and the reduction of its trace to records.

Spans (``torch.profiler.record_function``, named ``bench/<kind>``) come
from forward pre / post hooks on the port's modules (the UNet, every
``CrossAttention`` and ``ResnetBlock2D``, the VAE ``Encoder`` and
``Decoder``, the text encoder), from wrappers around the entries through
which the transformer blocks reach ``core/merge.py``, and from the
harness's spans around each edit and stage.  The hooks also count each
call's operations and bytes from the shapes it is given
(``benchmark/counts``).  A kernel belongs to a span when the host call that
launched it (the CUDA runtime or driver event of the same correlation id)
falls inside it.  Nothing here runs in an untraced run.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time

import torch

from benchmark.counts import peaks, shapes

MERGE_ENTRIES = ("compute_local_merge", "two_set_matching", "merge",
                 "unmerge", "unmerge_all", "partition")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Kind:
    """Sums over one kind of span."""

    def __init__(self):
        self.calls = 0
        self.host_s = 0.0
        self.flops = 0.0
        self.least_s = 0.0


class Tracer:
    """Hooks and wrappers on one program; :meth:`remove` takes them off."""

    def __init__(self, program, sync):
        from vidtome_torch.core import merge as merge_ops
        from vidtome_torch.models.clip_text import CLIPAttention
        from vidtome_torch.models.layers import CrossAttention, ResnetBlock2D
        from vidtome_torch.models.vae import VAEAttentionBlock

        self.sync = sync
        self.kinds = collections.defaultdict(Kind)
        self.model_flops = 0.0
        self.stage_s = collections.Counter()
        self._stack = []
        self._handles = []
        self._merge_ops = merge_ops
        self._patched = {}
        b = program.bundle
        self._spans(b.unet, "unet")
        self._spans(b.vae.encoder, "vae_enc")
        self._spans(b.vae.decoder, "vae_dec")
        self._spans(b.text_encoder, "text")
        counted = set()
        for root in (b.unet, b.vae, b.text_encoder):
            for mod in root.modules():
                if isinstance(mod, CrossAttention):
                    self._spans(mod, "attn", self._attention)
                elif isinstance(mod, ResnetBlock2D):
                    self._spans(mod, "resnet", self._resnet)
                elif isinstance(mod, (VAEAttentionBlock, CLIPAttention)):
                    self._hook(mod, self._core)
                else:
                    continue
                if not isinstance(mod, (VAEAttentionBlock, CLIPAttention)):
                    counted.update(id(m) for m in mod.modules())
        for root in (b.unet, b.vae, b.text_encoder):
            for mod in root.modules():
                if (isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d))
                        and id(mod) not in counted):
                    self._hook(mod, self._leaf)
        for name in MERGE_ENTRIES:
            fn = getattr(merge_ops, name)
            self._patched[name] = fn
            setattr(merge_ops, name, self._wrap(fn, "merge"))

    # ---------------------------------------------------------- spans

    def _spans(self, mod, kind, count=None):
        def pre(m, args, kwargs):
            rf = torch.profiler.record_function(f"bench/{kind}")
            rf.__enter__()
            self._stack.append((rf, time.perf_counter()))
            if count is not None:
                count(m, args, kwargs)

        def post(m, args, kwargs, out):
            rf, t0 = self._stack.pop()
            k = self.kinds[kind]
            k.calls += 1
            k.host_s += time.perf_counter() - t0
            rf.__exit__(None, None, None)

        self._handles.append(mod.register_forward_pre_hook(
            pre, with_kwargs=True))
        self._handles.append(mod.register_forward_hook(post,
                                                       with_kwargs=True))

    def _hook(self, mod, count):
        def post(m, args, kwargs, out):
            count(m, args, kwargs, out)

        self._handles.append(mod.register_forward_hook(post,
                                                       with_kwargs=True))

    def _wrap(self, fn, kind):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(f"bench/{kind}"):
                return fn(*args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def stage(self, name):
        """A harness span around a stage, ended by a synchronize."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench/{name}"):
            yield
            self.sync()
        self.stage_s[name] += time.perf_counter() - t0

    # ---------------------------------------------------------- counts

    def _add(self, kind, flops, nbytes):
        k = self.kinds[kind]
        k.flops += flops
        k.least_s += peaks.least_seconds(flops, nbytes)
        self.model_flops += flops

    def _attention(self, m, args, kwargs):
        x = args[0]
        ctx = args[1] if len(args) > 1 else kwargs.get("context")
        share = kwargs.get("share_qk", args[2] if len(args) > 2 else False)
        lanes = kwargs.get("num_lanes", args[3] if len(args) > 3 else 1)
        shared = lanes if share and lanes > 1 else 1
        flops, nbytes = shapes.cross_attention(
            tuple(x.shape), None if ctx is None else tuple(ctx.shape),
            m.heads, m.head_dim, shared, x.element_size())
        self._add("attn", flops, nbytes)

    def _resnet(self, m, args, kwargs):
        x = args[0]
        temb = args[1] if len(args) > 1 else kwargs["temb"]
        flops, nbytes = shapes.resnet_block(
            tuple(x.shape), tuple(temb.shape), m.conv1.out_channels,
            x.element_size())
        self._add("resnet", flops, nbytes)

    def _core(self, m, args, kwargs, out):
        x = args[0]
        if x.dim() == 4:  # the VAE's one head over the spatial positions
            B, H, W, C = x.shape
            f = shapes.attention_core(B, 1, H * W, H * W, C)
        else:
            B, S, C = x.shape
            f = shapes.attention_core(B, m.heads, S, S, C // m.heads)
        self.model_flops += f

    def _leaf(self, m, args, kwargs, out):
        kind = "linear" if isinstance(m, torch.nn.Linear) else "conv"
        self.model_flops += shapes.layer(kind, tuple(args[0].shape),
                                         tuple(out.shape),
                                         tuple(m.weight.shape))

    def remove(self):
        for h in self._handles:
            h.remove()
        for name, fn in self._patched.items():
            setattr(self._merge_ops, name, fn)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(merged, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= merged[i][1]


def _innermost(merged, starts, kinds, t) -> str:
    """The kind of the shortest span that holds host time ``t``."""
    best, label = None, "host"
    for k in kinds:
        i = bisect.bisect_right(starts[k], t) - 1
        if i >= 0 and t <= merged[k][i][1]:
            length = merged[k][i][1] - merged[k][i][0]
            if best is None or length < best:
                best, label = length, k
    return label


def reduce(prof, tracer: Tracer) -> dict:
    """The traced window's records: window and busy seconds, and per kind
    of span its calls, host seconds, device seconds and launches of the
    kernels launched inside it, its operations and least seconds; the
    device operations that took most time and the longest idle gaps."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    events = events.get("traceEvents", events)
    spans = collections.defaultdict(list)
    launch_at, device = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0))
        name = e.get("name", "")
        if cat == "user_annotation" and name.startswith("bench/"):
            spans[name[6:]].append((ts, ts + dur))
        elif cat in _LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[corr] = ts
        elif cat in _DEVICE_CATS:
            device.append((ts, ts + dur, name, cat,
                           e.get("args", {}).get("correlation")))
    edits = spans.pop("edit")
    w0, w1 = min(s for s, _ in edits), max(e for _, e in edits)
    busy = _union([(max(s, w0), min(e, w1)) for s, e, *_ in device
                   if e > w0 and s < w1])
    merged = {k: _union(v) for k, v in spans.items()}
    starts = {k: [s for s, _ in v] for k, v in merged.items()}
    dev_us = collections.Counter()
    launches = collections.Counter()
    by_name = collections.Counter()
    for s, e, name, cat, corr in device:
        by_name[name[:96]] += (e - s) * 1e-6
        t = launch_at.get(corr)
        if t is None or cat != "kernel":
            continue
        for k in merged:
            if _inside(merged[k], starts[k], t):
                dev_us[k] += e - s
                launches[k] += 1
    gaps = collections.Counter()
    prev = w0
    inner = [k for k in merged if k not in ("invert", "generate")]
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps[_innermost(merged, starts, inner, prev)] += (s - prev) * 1e-6
        prev = max(prev, e)
    kinds = {}
    for k, v in tracer.kinds.items():
        kinds[k] = dict(calls=v.calls, host_s=v.host_s, flops=v.flops,
                        least_s=v.least_s, device_s=dev_us[k] * 1e-6,
                        launches=launches[k])
    for k in ("merge", "vae_enc", "vae_dec"):
        kinds.setdefault(k, {}).update(device_s=dev_us[k] * 1e-6,
                                       launches=launches[k])
    return dict(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        kinds=kinds,
        model_flops=tracer.model_flops,
        stage_s=dict(tracer.stage_s),
        device_ops=[[n, s] for n, s in by_name.most_common(10)],
        idle_gaps=[[n, s] for n, s in gaps.most_common(10)])
