"""Logging, stage timing, tracing and token-merging statistics.

Counterpart of ``vidtome_tpu/logging_utils.py``: a logger on the stdlib
``logging`` module with the reference's visible format (``[INFO] ...``), a
context that logs a stage's wall seconds (the CLI's model load, inversion
and generation, and its wall time), and the per-block merge statistics of
a UNet call (the counterpart of the reference's collect_from_patch,
patch.py:373-387), the ``tpu.profile_dir`` trace of a stage (the
counterpart of ``jax.profiler.start_trace`` / ``stop_trace``) and the
program's spans in any ``torch.profiler`` trace (:func:`span`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_configured = False
# the one context every span returns while no profiler records
_OFF = contextlib.nullcontext()


class _StdoutHandler(logging.StreamHandler):
    """A StreamHandler on the ``sys.stdout`` of the moment a record is
    emitted, not of the moment it was made: a stdout redirected (or
    captured) after the first log line still gets the next."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):
        pass


def get_logger(name: str = "vidtome") -> logging.Logger:
    global _configured
    if not _configured:
        handler = _StdoutHandler()
        handler.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
        root = logging.getLogger("vidtome")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger(name)


@contextlib.contextmanager
def timed(label: str, logger: logging.Logger | None = None):
    """Log the wall-clock seconds of a stage."""
    log = logger or get_logger()
    t0 = time.perf_counter()
    yield
    log.info("%s took %.2fs", label, time.perf_counter() - t0)


def span(name: str, args=None):
    """A ``vidtome/<name>`` range in the trace of a recording profiler
    (``torch.profiler.record_function``: on the clock of the CUDA runtime
    calls and kernels the range launches), around one layer's work.

    While no profiler records it returns one shared null context: no
    string is formatted and no operator is called, about half a
    microsecond a span.  ``args`` is the range's attributes as a string,
    or a callable giving it, called only while a profiler records; they
    follow the name after a space (``vidtome/unet rows=8 cache=full
    bank=init``), since a Chrome trace does not carry a range's own
    arguments.  The program keeps no time of its own: a span exists only
    in the trace (``tpu.profile_dir``, or the profiler of whoever runs
    the program)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if callable(args):
        args = args()
    return _autograd_profiler.record_function(
        f"vidtome/{name} {args}" if args else f"vidtome/{name}")


@contextlib.contextmanager
def profile_trace(profile_dir: str, device, label: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity on a CUDA ``device``) and write a Chrome trace
    ``<profile_dir>/<label>_<pid>_<ns>.json``, also when the block raises;
    prints where, with the traced block's wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        prof.stop()
        path = os.path.join(profile_dir, f"{label}_{os.getpid()}_"
                                         f"{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        print(f"[INFO] profiler trace written to {path} ({seconds:.3f} s "
              f"traced)")


def collect_tome_stats(stats: dict, model=None) -> dict[str, dict]:
    """One UNet call's merge statistics (``ToMeCall.stats``: block ->
    {seq_len, merged_len}) as {block path: {seq_len, merged_len,
    compression}}, compression = merged_len / seq_len.  A block is named
    by its module path in ``model`` (for example
    ``down_blocks.0.attentions.0.transformer_blocks.0``); without a model,
    or for a block outside it, by ``str`` of its key."""
    names = {}
    if model is not None:
        names = {id(m): n for n, m in model.named_modules()}
    out: dict[str, dict] = {}
    for block, vals in stats.items():
        vals = {k: int(v) for k, v in vals.items()}
        if vals.get("seq_len"):
            vals["compression"] = vals["merged_len"] / vals["seq_len"]
        out[names.get(id(block), str(block))] = vals
    return out
