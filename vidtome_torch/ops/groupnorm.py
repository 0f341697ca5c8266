"""GroupNorm(+SiLU): a hand-written Hopper kernel and its plain versions.

Counterpart of ``vidtome_tpu/ops/groupnorm.py``.  One CUDA source,
``csrc/group_norm.cu``, serves every GroupNorm of the port on the card, in
four entries (its source note says what bounds them and how the design
answers):

* full (:func:`full_group_norm`): statistics and normalize in one launch;
  replaces the Pallas ``full_group_norm`` and is the route of every plain
  GroupNorm;
* stats (:func:`group_stats`): group mean and rstd [B, G]; replaces the
  Pallas ``group_norm_stats``; the fused resnet block takes its GN1
  statistics from here;
* apply (:func:`apply_group_norm`): normalize with a given mean and rstd,
  the normalize of ``fused_group_norm``;
* finalize (:func:`stats_from_partials`): per-tile channel partials
  [B, tiles, C] -> mean and rstd, the fused resnet's GN2 statistics.

A CUDA tensor launches the entry (anything it cannot take raises); a CPU
tensor runs the plain version beside it.  Each launch of full adds one to
``full_group_norm.launches``, each launch of stats, apply or finalize one
to ``group_norm.launches``.

The work unit is one (batch element, slice of whole groups), owned by one
thread-block cluster; :func:`plan` (pure Python, tested on the CPU) picks
the slice width, the cluster size and the TMA boxes per shape, and whether
a block's rows stay resident in shared memory or stream.
``VIDTOME_GN_MODE`` picks the route of :func:`group_norm` on a CUDA tensor,
as in the JAX package (``groupnorm.py:293-301``): ``auto`` and ``full``
take the full entry (the card's times put it ahead of stats + apply at
every UNet and VAE shape), ``stats`` the stats and apply entries.  ``xla``
(and ``VIDTOME_DISABLE_PALLAS_GN``) would run the plain version on the
card, which hides the kernel, so a CUDA tensor raises under it.  The TPU's
row, channel and element thresholds are not carried over.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from vidtome_torch.ops.cuda_build import build_library

GN_MODES = ("auto", "stats", "full")
ENTRIES = {"full": 0, "stats": 1, "apply": 2}
THREADS = 256            # a block (csrc/group_norm.cu kThreads)
FINALIZE_CHANNELS = 256  # channels a finalize block (kFinalizeChannels)
SMEM_LIMIT = 232448      # opt-in shared memory a block on the H100
SLAB_BYTES = 196608      # a block's resident rows at most (192 KiB)
STAGE_BYTES = 16384      # aimed bytes of one TMA box
STREAM_STAGES = 4        # ring slots of the streaming regime
MAX_BOX = 256            # TMA box extent (elements of a row, rows)
CLUSTERS = (1, 2, 4, 8)  # portable cluster sizes
BLOCK_BYTES = 16384      # a block's fixed cost in the planner's estimate
H100_SMS = 132
# clusters of each size an H100 SXM holds at once for each block an SM can
# hold (its GPCs; cudaOccupancyMaxActiveClusters on the card gives 15
# eight-block clusters where 132 SMs would suggest 16)
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}
H100_SM_SMEM = 233472    # shared memory of an SM, 1 KiB of it kept a block
H100_SM_BLOCKS = 2       # blocks an SM holds by registers (<= 128 a thread)


def h100_clusters(cluster: int, smem: int) -> int:
    """Clusters of ``cluster`` blocks of ``smem`` bytes of shared memory an
    H100 SXM holds at once: the planner's model of the card, which gives
    its own count on a CUDA device (:func:`_card_clusters`)."""
    per_sm = min(H100_SM_BLOCKS, H100_SM_SMEM // (smem + 1024))
    return per_sm * H100_CLUSTERS[cluster]


def reference_group_norm(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """Plain GroupNorm over x [B, ..., C] (channels last), statistics in
    fp32 with var = max(E[x^2] - mean^2, 0) as flax computes it."""
    mean, rstd = reference_group_stats(x, num_groups, eps)
    return reference_apply(x, mean, rstd, weight, bias, num_groups, silu)


def reference_group_stats(x: torch.Tensor, num_groups: int,
                          eps: float = 1e-5) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Plain group mean and rstd [B, G] (fp32) of x [B, ..., C]."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.reshape(B, -1, num_groups, C // num_groups).float()
    mean = xf.mean(dim=(1, 3))
    var = ((xf * xf).mean(dim=(1, 3)) - mean * mean).clamp_min(0)
    return mean, torch.rsqrt(var + eps)


def reference_apply(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, silu: bool = False) -> torch.Tensor:
    """Plain normalize of x [B, ..., C] with group mean and rstd [B, G]:
    silu?((x - mean) * rstd * weight + bias), rounded to x's dtype."""
    B, C = x.shape[0], x.shape[-1]
    xf = x.reshape(B, -1, num_groups, C // num_groups).float()
    y = (xf - mean[:, None, :, None]) * rstd[:, None, :, None]
    y = y.reshape(B, -1, C) * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)


def reference_stats_from_partials(sums: torch.Tensor, sqs: torch.Tensor,
                                  num_groups: int, count: int,
                                  eps: float) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Plain group mean and rstd [B, G] from per-tile channel sums and sums
    of squares [B, tiles, C] (fp32) over ``count`` rows."""
    B, _, C = sums.shape
    n = count * (C // num_groups)
    s = sums.float().sum(1).reshape(B, num_groups, -1).sum(-1) / n
    q = sqs.float().sum(1).reshape(B, num_groups, -1).sum(-1) / n
    return s, torch.rsqrt((q - s * s).clamp_min(0) + eps)


class Plan(NamedTuple):
    """A launch of ``csrc/group_norm.cu``: x [B, rows, C] in G groups, cut
    into C / sc slices of whole groups, each owned by a cluster of
    ``cluster`` blocks; block rank k owns rows [k * span, (k + 1) * span),
    read as ``boxes`` TMA boxes of ``box_rows`` rows through a ring of
    ``stages`` slots of ``stage_bytes``; ``smem`` bytes of shared memory a
    block."""

    B: int
    rows: int
    C: int
    G: int
    sc: int
    cluster: int
    span: int
    box_rows: int
    boxes: int
    stages: int
    stage_bytes: int
    smem: int

    @property
    def resident(self) -> bool:
        """A block's rows stay in shared memory between the statistics and
        the normalize (one read of x); else they stream twice."""
        return self.stages == self.boxes

    @property
    def slices(self) -> int:
        return self.C // self.sc

    @property
    def blocks(self) -> int:
        return self.B * self.slices * self.cluster


def smem_bytes(elem: int, sc: int, stages: int, stage_bytes: int) -> int:
    """Shared memory a block: the ring, the per-thread sums (an fp32 value
    a channel of each thread's 16-byte vector), the published partials,
    k_c and s_c (fp32 [sc] each), a barrier a slot (as
    ``csrc/group_norm.cu`` smem_bytes)."""
    return (stages * stage_bytes + 4 * THREADS * (16 // elem) + 16 * sc
            + 8 * stages)


def _geometry(span: int, row_bytes: int) -> tuple[int, int, int]:
    """(box_rows, boxes, stage_bytes) for ``span`` rows: boxes of about
    STAGE_BYTES, as even as the rows allow, each slot 128-byte aligned."""
    n = max(1, -(-span * row_bytes // STAGE_BYTES))
    box_rows = min(MAX_BOX, -(-span // n))
    boxes = -(-span // box_rows)
    return box_rows, boxes, -(-box_rows * row_bytes // 128) * 128


@functools.cache
def plan(B: int, rows: int, C: int, G: int, elem: int,
         sms: int = H100_SMS, clusters=h100_clusters) -> Plan:
    """The launch of x [B, rows, C] in G groups, ``elem`` bytes an element;
    ``clusters(cluster, smem)`` is the number of clusters the card holds at
    once.

    Candidates: slices of whole groups whose rows are a multiple of 16
    bytes (TMA), at least 32 (a DRAM sector) unless the slice is the whole
    row, and at most MAX_BOX elements (one box wide); clusters of 1, 2, 4
    or 8 blocks.  A block's span is resident when its boxes fit SLAB_BYTES,
    else it streams through STREAM_STAGES slots (and is read twice).  The
    plan taken moves the fewest bytes through the busiest SM: waves of
    clusters the card holds at once, times the blocks an SM runs in a wave,
    times a block's bytes read (plus BLOCK_BYTES for its fixed cost); ties
    go to rows of whole 32-byte sectors, then wider slices, then fewer
    blocks a cluster."""
    if C % G:
        raise ValueError(f"{C} channels do not split into {G} groups")
    gsize = C // G
    best = None
    for sg in (d for d in range(1, G + 1) if G % d == 0):
        sc = sg * gsize
        row_bytes = sc * elem
        if row_bytes % 16 or sc > MAX_BOX or (row_bytes < 32 and sc != C):
            continue
        for cluster in CLUSTERS:
            span = -(-rows // cluster)
            box_rows, boxes, stage_bytes = _geometry(span, row_bytes)
            resident = boxes * stage_bytes <= SLAB_BYTES
            stages = boxes if resident else min(boxes, STREAM_STAGES)
            p = Plan(B, rows, C, G, sc, cluster, span, box_rows, boxes,
                     stages, stage_bytes,
                     smem_bytes(elem, sc, stages, stage_bytes))
            at_once = clusters(cluster, p.smem)
            if at_once > 0:
                units = B * p.slices
                per_sm = -(-min(units, at_once) * cluster // sms)
                moved = span * row_bytes * (1 if resident else 2)
                cost = -(-units // at_once) * per_sm * (moved + BLOCK_BYTES)
                key = (cost, row_bytes % 32 != 0, -sc, cluster)
                if best is None or key < best[0]:
                    best = (key, p)
            if span == 1:
                break
    if best is None:
        raise ValueError(f"GroupNorm kernel cannot take {C} channels in {G} "
                         f"groups of {elem}-byte elements: no slice of whole "
                         f"groups is a multiple of 16 bytes and at most "
                         f"{MAX_BOX} channels")
    return best[1]


def finalize_groups(C: int, G: int) -> int:
    """Groups a block of the finalize entry reduces: the most that divide G
    and fit FINALIZE_CHANNELS channels."""
    gsize = C // G
    fits = [d for d in range(1, G + 1)
            if G % d == 0 and d * gsize <= FINALIZE_CHANNELS]
    if C % G or not fits:
        raise ValueError(f"finalize cannot take {C} channels in {G} groups")
    return max(fits)


def route(mode: str) -> tuple[str, ...]:
    """The entries a CUDA GroupNorm launches under ``VIDTOME_GN_MODE``."""
    if mode in ("auto", "full"):
        return ("full",)
    if mode == "stats":
        return ("stats", "apply")
    raise ValueError(f"GroupNorm mode {mode!r} (VIDTOME_GN_MODE / "
                     f"VIDTOME_DISABLE_PALLAS_GN) would run the plain "
                     f"version on the card; the port takes {GN_MODES}")


@functools.cache
def _library():
    lib = build_library("vidtome_group_norm", ("group_norm.cu",))
    fn = lib.vidtome_group_norm
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    clusters = lib.vidtome_group_norm_clusters
    clusters.argtypes = [ctypes.c_int] * 4
    fin = lib.vidtome_group_norm_finalize
    fin.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    for f in (fn, clusters, fin):
        f.restype = ctypes.c_int
    return fn, clusters, fin


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _card_clusters(index: int, dtype: int):
    """The planner's ``clusters`` on CUDA device ``index``: clusters of
    the full entry for x of ``dtype`` (0 bf16, 1 fp32) the card holds at
    once (cudaOccupancyMaxActiveClusters)."""
    @functools.cache
    def clusters(cluster: int, smem: int) -> int:
        with torch.cuda.device(index):
            return _library()[1](ENTRIES["full"], dtype, cluster, smem)
    return clusters


class _Launch(NamedTuple):
    plan: Plan
    ints: ctypes.Array
    dtype: int        # 0 bf16, 1 fp32
    affine_bf16: int


@functools.cache
def _signature(entry: str, shape: torch.Size, dtype: torch.dtype,
               device: torch.device, num_groups: int,
               affine: tuple | None) -> _Launch:
    """The checks that depend only on the call's signature, and its plan
    (its clusters checked against what the card can hold at once)."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"GroupNorm kernel takes bf16 or fp32, got {dtype}")
    B, C = shape[0], shape[-1]
    rows = 1
    for n in shape[1:-1]:
        rows *= n
    affine_bf16 = 0
    if affine is not None:
        dtypes = {t[1] for t in affine}
        for name, (w_shape, w_dtype, w_device, w_stride) in zip(
                ("weight", "bias"), affine):
            if (w_shape != (C,) or w_device != device or w_stride != (1,)
                    or w_dtype not in (torch.bfloat16, torch.float32)):
                raise ValueError(f"{name}: expected a contiguous bf16 or fp32 "
                                 f"[{C}] on {device}, got {tuple(w_shape)} "
                                 f"{w_dtype} on {w_device}")
        if len(dtypes) != 1:
            raise TypeError(f"weight and bias of one dtype, got {dtypes}")
        affine_bf16 = int(dtypes == {torch.bfloat16})
    elem = 2 if dtype == torch.bfloat16 else 4
    code = 0 if elem == 2 else 1
    p = plan(B, rows, C, num_groups, elem, _sm_count(device.index),
             _card_clusters(device.index, code))
    with torch.cuda.device(device):
        at_once = _library()[1](ENTRIES[entry], code, p.cluster, p.smem)
    if at_once <= 0:
        raise RuntimeError(f"GroupNorm {entry} cannot launch {p} on {device} "
                           f"(clusters the card holds at once: {at_once})")
    return _Launch(p, (ctypes.c_int * len(p))(*p), code, affine_bf16)


def _affine(weight, bias) -> tuple:
    return tuple((t.shape, t.dtype, t.device, t.stride())
                 for t in (weight, bias))


def _launch(entry: str, x: torch.Tensor, num_groups: int, eps: float,
            weight=None, bias=None, mean=None, rstd=None,
            silu: bool = False):
    """One launch of a slab entry; returns y (full, apply) or (mean, rstd)
    (stats)."""
    sig = _signature(entry, x.shape, x.dtype, x.device, num_groups,
                     None if weight is None else _affine(weight, bias))
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"GroupNorm kernel needs x 16-byte aligned, got "
                         f"address {x.data_ptr()}")
    y = w = b = None
    if entry == "stats":
        mean = torch.empty(x.shape[0], num_groups, dtype=torch.float32,
                           device=x.device)
        rstd = torch.empty_like(mean)
    else:
        y = torch.empty_like(x)
        w, b = weight.data_ptr(), bias.data_ptr()
    err = _library()[0](
        ENTRIES[entry], sig.dtype, x.data_ptr(),
        None if y is None else y.data_ptr(), w, b,
        None if mean is None else mean.data_ptr(),
        None if rstd is None else rstd.data_ptr(), sig.ints, eps, int(silu),
        sig.affine_bf16, torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"GroupNorm {entry} launch failed: error {err} "
                           f"(x{tuple(x.shape)}, {sig.plan})")
    return (mean, rstd) if entry == "stats" else y


def _gn_mode() -> str:
    """The GroupNorm route of CUDA tensors, from the environment as the
    JAX package reads it."""
    if os.environ.get("VIDTOME_DISABLE_PALLAS_GN"):
        return "xla"
    return os.environ.get("VIDTOME_GN_MODE", "auto").lower()


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over x [B, ..., C] (channels last) with fp32
    statistics; returns x's dtype.  CUDA tensors take the entries of
    :func:`route` (``VIDTOME_GN_MODE``); CPU tensors run
    :func:`reference_group_norm`."""
    if not x.is_cuda:
        return reference_group_norm(x, weight, bias, num_groups, eps, silu)
    if route(_gn_mode()) == ("full",):
        return full_group_norm(x, weight, bias, num_groups, eps, silu)
    mean, rstd = group_stats(x, num_groups, eps)
    return apply_group_norm(x, mean, rstd, weight, bias, num_groups, silu)


def full_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float = 1e-5,
                    silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over x [B, ..., C] in one launch of the full entry;
    replaces Pallas ``full_group_norm``.  CPU tensors run
    :func:`reference_group_norm`."""
    if not x.is_cuda:
        return reference_group_norm(x, weight, bias, num_groups, eps, silu)
    y = _launch("full", x, num_groups, eps, weight, bias, silu=silu)
    full_group_norm.launches += 1
    return y


def group_stats(x: torch.Tensor, num_groups: int,
                eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Group mean and rstd [B, G] (fp32) of x [B, ..., C] in one launch of
    the stats entry; replaces Pallas ``group_norm_stats`` (which gives them
    per channel).  CPU tensors run :func:`reference_group_stats`."""
    if not x.is_cuda:
        return reference_group_stats(x, num_groups, eps)
    out = _launch("stats", x, num_groups, eps)
    group_norm.launches += 1
    return out


def apply_group_norm(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, silu: bool = False) -> torch.Tensor:
    """Normalize x [B, ..., C] with group mean and rstd [B, G] (fp32) in one
    launch of the apply entry.  CPU tensors run :func:`reference_apply`."""
    if not x.is_cuda:
        return reference_apply(x, mean, rstd, weight, bias, num_groups, silu)
    want = (x.shape[0], num_groups)
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous fp32 {list(want)} "
                             f"on {x.device}")
    y = _launch("apply", x, num_groups, 0.0, weight, bias, mean, rstd, silu)
    group_norm.launches += 1
    return y


def stats_from_partials(sums: torch.Tensor, sqs: torch.Tensor,
                        num_groups: int, count: int,
                        eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Group mean and rstd [B, G] from per-tile channel sums and sums of
    squares [B, tiles, C] (fp32) over ``count`` rows, reduced in a fixed
    order by one launch of the finalize entry.  CPU tensors run
    :func:`reference_stats_from_partials`."""
    if not sums.is_cuda:
        return reference_stats_from_partials(sums, sqs, num_groups, count,
                                             eps)
    B, tiles, C = sums.shape
    for name, t in (("sums", sums), ("sqs", sqs)):
        if (t.shape != sums.shape or t.dtype != torch.float32
                or t.device != sums.device or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous fp32 "
                             f"{list(sums.shape)} on {sums.device}")
    gpb = finalize_groups(C, num_groups)
    mean = torch.empty(B, num_groups, dtype=torch.float32,
                       device=sums.device)
    rstd = torch.empty_like(mean)
    err = _library()[2](
        sums.data_ptr(), sqs.data_ptr(), mean.data_ptr(), rstd.data_ptr(), B,
        tiles, C, num_groups, gpb, count, eps,
        torch._C._cuda_getCurrentRawStream(sums.get_device()))
    if err != 0:
        raise RuntimeError(f"GroupNorm finalize launch failed: error {err} "
                           f"(partials {tuple(sums.shape)})")
    group_norm.launches += 1
    return mean, rstd


group_norm.launches = 0
full_group_norm.launches = 0
