"""Fused cross-attention sublayer: a hand-written Hopper kernel and its
plain version.

Counterpart of ``vidtome_tpu/ops/sublayer.py``.  :func:`fused_cross_sublayer`
replaces the Pallas ``fused_cross_sublayer`` (``_sublayer_kernel``): one
call per transformer block computes

    h  = x + a1                    (attn1 residual)
    y2 = LayerNorm(h; g2, b2)      (norm2)
    q  = y2 Wq                     (to_q; softmax scale * log2(e) folded in)
    a  = softmax_per_head(q k^T) v (cross-attention over the text tokens)
    x3 = h + a Wout + bout         (to_out, attn2 residual)
    y3 = LayerNorm(x3; g3, b3)     (norm3, of the bf16-rounded x3)

and returns (x3, y3).  On a CUDA tensor it launches ``csrc/sublayer.cu``
(see the source note there for what bounds it and how the design
answers) with the launch of :func:`plan` and the TMA views of
:func:`tensor_maps`; on a CPU tensor it runs :func:`reference_cross_sublayer`.
K and V come precomputed from the text context, as in the JAX package.

The work unit is a 64-row tile of one batch element split by whole heads
over a thread-block cluster of ``cluster`` blocks; :func:`plan` (pure
Python, tested on the CPU) picks the cluster size by the grid's waves.
The wrapper launches nothing before the kernel: the scaled Wq is built once
per weight (:func:`scaled_wq`), and the kernel reads bout and the LayerNorm
affines as the module holds them, bf16 or fp32.

Contract details kept from the JAX kernel: LayerNorm statistics in fp32
with the one-pass variance ``max(E[h^2] - mu^2, 0)``; the softmax scale
times log2(e) folded into Wq and rounded to the working dtype, the softmax
in base 2; keys at or past ``kv_len`` masked; p normalised before the
product with v; norm3 reads the rounded x3.  Weights are in the port's
``torch.nn.Linear`` layout, [out, in].
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from vidtome_torch.ops.cuda_build import build_library
from vidtome_torch.ops.groupnorm import H100_CLUSTERS
from vidtome_torch.ops.resnet import H100_SMS, _sm_count, _stream

_LOG2E = math.log2(math.e)
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may take
ROWS = 64            # rows of a tile (the wgmma's M)
KEY_PADS = (80, 128)  # padded keys of the instances (16-key slabs: 5, 8)
MAX_WIDTH = 320      # columns a cluster rank owns at most
MAX_STAGES = 4
CLUSTERS = (1, 2, 4, 8)
# (head dim, heads a cluster rank) of the kernel's instances (csrc/
# sublayer.cu VT_SUBLAYER_INSTANCES): D = 64 at five heads a rank (SD2.1,
# SDXL's 10 and 20 heads) and at three (12 and 24 heads of 64 at 768 and
# 1536 channels, over clusters of 4 and 8), D = 96 at two (the SDXL
# refiner as configured here: 8 and 16 heads of 96, clusters of 4 and 8),
# SD1.5's 40 / 80 / 160 at 8 / 4 / 2 (320 columns), narrower ranks for the
# planner, and the test widths
INSTANCES = ((16, 4), (40, 4), (40, 8), (64, 2), (64, 3), (64, 5), (80, 2),
             (80, 4), (96, 2), (160, 1), (160, 2))
# columns of C a ring item takes (64: rows of 128 bytes, which TMA reads
# from L2 at about twice the rate of 64-byte rows); 32 where a rank's
# columns are not whole 64-column chunks or 64 does not fit
CHUNKS = {(40, 4): 32, (80, 2): 32, (160, 1): 32, (160, 2): 32}
# the planner's model of one H100 SM: its share of the dense bf16 rate and
# of HBM
_SM_OPS_S = 989e12 / H100_SMS
_SM_BYTES_S = 3.35e12 / H100_SMS


def _layer_norm(h: torch.Tensor, gamma, beta, eps: float) -> torch.Tensor:
    """Row LayerNorm in fp32 with the one-pass variance."""
    mu = h.mean(-1, keepdim=True)
    var = ((h * h).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (h - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def _scaled_wq(wq: torch.Tensor, heads: int, dtype: torch.dtype):
    """Wq with the softmax scale * log2(e) folded in, in ``dtype``."""
    scale = _LOG2E / math.sqrt(wq.shape[0] // heads)
    return (wq.float() * scale).to(dtype)


def scaled_wq(wq: torch.Tensor, heads: int) -> torch.Tensor:
    """:func:`_scaled_wq` in bf16, kept on the weight tensor and built anew
    only when the weight changes: an in-place edit moves its ``_version``,
    an assignment to ``.data`` its ``data_ptr``.  An inference tensor keeps
    no version counter, so it is scaled on every call."""
    try:
        version = wq._version
    except RuntimeError:
        return _scaled_wq(wq, heads, torch.bfloat16)
    key = (wq.data_ptr(), version, wq.dtype, wq.device, tuple(wq.shape),
           heads)
    hit = wq.__dict__.get("_vidtome_scaled_wq")
    if hit is None or hit[0] != key:
        hit = (key, _scaled_wq(wq, heads, torch.bfloat16))
        wq._vidtome_scaled_wq = hit
    return hit[1]


def reference_cross_sublayer(x, a1, k, v, wq, wout, bout, g2, b2, g3, b3,
                             heads: int, kv_len: int, eps: float = 1e-5):
    """Plain version of the kernel's arithmetic in x's dtype: products of
    values in that dtype summed in fp32, results rounded to it where the
    kernel rounds (y2, q, p, a, x3, y3).  In fp32 it is the JAX package's
    ``reference_cross_sublayer``.  x, a1: [B, S, C]; k, v: [B, Skv, C]
    (the first ``kv_len`` rows valid); wq, wout: [C, C] as nn.Linear
    weights; bout, g2, b2, g3, b3: [C]."""
    dt = x.dtype
    B, S, C = x.shape
    D = C // heads
    h = x.float() + a1.float()
    y2 = _layer_norm(h, g2, b2, eps).to(dt)
    q = (y2.float() @ _scaled_wq(wq, heads, dt).float().t()).to(dt)

    def split(t, s):  # [B, s, C] -> [B, heads, s, D] fp32
        return t.float().reshape(B, s, heads, D).transpose(1, 2)

    s = split(q, S) @ split(k[:, :kv_len], kv_len).transpose(-1, -2)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(dt)
    att = (p.float() @ split(v[:, :kv_len], kv_len)).to(dt)
    att = att.transpose(1, 2).reshape(B, S, C)
    x3 = (h + att.float() @ wout.float().t() + bout.float()).to(dt)
    return x3, _layer_norm(x3.float(), g3, b3, eps).to(dt)


class Instance(NamedTuple):
    """The compile-time shape of one kernel instance (``Inst`` of the
    source): head dim D (DP padded to 16), HR heads a rank over W columns,
    consumer 0's HW0 heads and consumer 1's HW1 (NQ0 / NQ1 q columns), NO
    out columns a consumer, K / V atoms of SW swizzle bytes (COLS columns,
    NA of them across DP), KCH columns of C a ring item, KVP padded
    keys."""
    D: int
    HR: int
    DP: int
    W: int
    HW0: int
    HW1: int
    NQ0: int
    NQ1: int
    NO: int
    SW: int
    COLS: int
    NA: int
    KCH: int
    KVP: int


def instance(D: int, HR: int, kvp: int) -> Instance:
    dp = -(-D // 16) * 16
    hw0, hw1 = (HR + 1) // 2, HR // 2
    sw = 128 if dp <= 64 else 64
    cols = sw // 2
    return Instance(D, HR, dp, D * HR, hw0, hw1, hw0 * dp, hw1 * dp,
                    D * HR // 2, sw, cols, -(-dp // cols),
                    CHUNKS.get((D, HR), 64), kvp)


class Layout(NamedTuple):
    """A block's shared memory (``make_layout`` of the source), byte
    offsets from the 1024-aligned base: the slice, the ring of ``stages``
    stages (an A box at a cluster of more than one block, then both
    consumers' weight boxes), the K / V buffers (K and V of one head each;
    at least two slices' bytes, where x and a1 are staged for LN2 and again
    for the epilogue), the row partials of LN2 and LN3, the five vectors
    (bout and the LayerNorm affines of the rank's columns, fp32), the
    barriers; ``total`` includes the alignment slack.  The epilogue lays
    the out projection's fp32 tile [64, W + 8] from the base over the slice
    and the ring."""
    a_bytes: int
    stage: int
    ring: int
    kv: int
    kv_head: int
    part: int
    vec: int
    bars: int
    total: int


def layout(inst: Instance, cluster: int, stages: int,
           kv_bufs: int) -> Layout:
    a_bytes = inst.KCH * 128 if cluster > 1 else 0
    wrows = max(inst.NQ0 + inst.NQ1, 2 * inst.NO)
    stage = -(-(a_bytes + wrows * inst.KCH * 2) // 1024) * 1024
    ring = inst.W * 128
    kv = ring + stages * stage
    kv_head = 2 * inst.NA * inst.KVP * inst.SW
    kv_bytes = (2 if inst.HW1 > 0 else 1) * kv_bufs * kv_head
    part = kv + max(kv_bytes, 2 * inst.W * 128)
    vec = part + 1024
    bars = vec + 5 * inst.W * 4
    return Layout(a_bytes, stage, ring, kv, kv_head, part, vec, bars,
                  bars + 8 * (2 * MAX_STAGES + 9) + 1024)


class SublayerPlan(NamedTuple):
    """One launch, its ints in the C entry's order: the call's shape, the
    instance (head dim, heads a rank), blocks a cluster, the padded keys,
    the valid keys, the ring's stages, K / V buffers a consumer, a block's
    dynamic shared memory."""
    B: int
    S: int
    C: int
    heads: int
    head_dim: int
    heads_rank: int
    cluster: int
    kvp: int
    kv_len: int
    stages: int
    kv_bufs: int
    smem: int

    @property
    def width(self) -> int:
        """Columns a cluster rank owns."""
        return self.C // self.cluster

    @property
    def grid(self) -> tuple[int, int]:
        """(row tiles x cluster, batch)."""
        return (-(-self.S // ROWS) * self.cluster, self.B)

    @property
    def instance(self) -> Instance:
        return instance(self.head_dim, self.heads_rank, self.kvp)


def h100_clusters(D: int, HR: int, kvp: int, cluster: int, smem: int) -> int:
    """Clusters of ``cluster`` blocks an H100 SXM holds at once, one block
    an SM (384 threads take all its registers): the planner's model of the
    card, which gives its own count on a CUDA device."""
    return H100_CLUSTERS[cluster] if 0 < smem <= SMEM_LIMIT else 0


def _fit(inst: Instance, cluster: int) -> tuple[int, int] | None:
    """(stages, K / V buffers a consumer): two buffers where a consumer
    has two heads or more and the memory allows, then the most stages
    (at least 2; the epilogue's fp32 tile needs the slice and the ring);
    None where nothing fits."""
    for kv_bufs in ((2, 1) if inst.HW0 > 1 else (1,)):
        for stages in range(MAX_STAGES, 1, -1):
            lay = layout(inst, cluster, stages, kv_bufs)
            if (lay.total <= SMEM_LIMIT
                    and ROWS * (inst.W + 8) * 4 <= lay.kv):
                return stages, kv_bufs
    return None


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, C: int, heads: int, skv: int, kv_len: int,
         sms: int = H100_SMS, clusters=h100_clusters) -> SublayerPlan:
    """The launch of the kernel for x [B, S, C] in ``heads`` heads against
    ``skv`` keys (the first ``kv_len`` valid; padded to 80 or 128);
    ``clusters(D, HR, kvp, cluster, smem)`` is the number of clusters the
    card holds at once.

    Candidates: clusters of 1, 2, 4 or 8 blocks splitting the heads into
    whole heads of at most MAX_WIDTH columns a rank, for which an instance
    is built and whose shared memory fits.  A block takes 64 rows.  The
    plan taken has the least estimated time: waves of clusters the card
    holds at once, times a block's time as its operations at one SM's
    share of the bf16 rate plus its bytes (x and a1 in, x3 and y3 out, the
    scratch of a cluster) at one SM's share of HBM, the phases taken one
    after another; ties to fewer blocks a cluster."""
    if C <= 0 or heads <= 0 or C % heads:
        raise ValueError(f"fused sublayer kernel: C={C} does not split into "
                         f"{heads} heads")
    D = C // heads
    kvp = next((k for k in KEY_PADS if k >= skv), 0)
    if D % 8 or D > 160:
        raise ValueError(f"fused sublayer kernel: head dim {D} (a multiple "
                         f"of 8 up to 160)")
    if not kvp or not 0 < kv_len <= skv:
        raise ValueError(f"fused sublayer kernel: {skv} keys, kv_len "
                         f"{kv_len} (at most {KEY_PADS[-1]} keys)")
    if B <= 0 or B > 65535 or S <= 0:
        raise ValueError(f"fused sublayer kernel: B={B}, S={S}")
    units = B * -(-S // ROWS)
    best = None
    for cluster in CLUSTERS:
        if heads % cluster or (D, heads // cluster) not in INSTANCES:
            continue
        inst = instance(D, heads // cluster, kvp)
        fit = _fit(inst, cluster)
        if fit is None:
            continue
        stages, kv_bufs = fit
        smem = layout(inst, cluster, stages, kv_bufs).total
        at_once = clusters(D, inst.HR, kvp, cluster, smem)
        if at_once <= 0:
            continue
        ops = 4 * ROWS * inst.W * (C + kvp)
        moved = 8 * ROWS * inst.W + (4 * ROWS * inst.W if cluster > 1 else 0)
        block_s = ops / _SM_OPS_S + moved / _SM_BYTES_S
        cost = -(-units // at_once) * block_s
        p = SublayerPlan(B, S, C, heads, D, inst.HR, cluster, kvp, kv_len,
                         stages, kv_bufs, smem)
        if best is None or (cost, cluster) < best[0]:
            best = ((cost, cluster), p)
    if best is None:
        raise ValueError(f"fused sublayer kernel: no instance takes C={C} "
                         f"in {heads} heads with {skv} keys (instances "
                         f"(head dim, heads a rank) {INSTANCES}, at most "
                         f"{MAX_WIDTH} columns a rank)")
    return best[1]


class TensorMap(NamedTuple):
    """One TMA view as the kernel encodes it: dims (innermost first), byte
    strides of dims 1..3, box, swizzle bytes (0: none)."""
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    box: tuple[int, int, int, int]
    swizzle: int


def tensor_maps(p: SublayerPlan, skv: int) -> tuple[TensorMap, ...]:
    """The kernel's eight views, in the C entry's order:

    * wq0, wq1: the scaled Wq [C, C] seen as [heads, D, C]; a box is
      consumer 0's (1's) heads x DP rows x KCH columns, so the rows past D
      of a padded head read as zeros;
    * wout: Wout [C, C]; a box is a consumer's NO output rows x KCH
      columns;
    * k, v: [B, Skv, C] seen as [B, Skv, heads, D] with ``kv_len`` rows (the
      keys past it read as zeros); a box is one atom (COLS columns) of one
      head's padded keys;
    * scratch: [2, B, S, C] (y2, then a) seen as [B, 2, S, C]; a box is a
      64-row, 32-column chunk (rows past S read as zeros);
    * x, a1: [B, S, C] seen as [B, 1, S, C]; a box is 64 rows of half the
      rank's columns, unswizzled (rows past S read as zeros).
    """
    inst = p.instance
    B, S, C, D, heads = p.B, p.S, p.C, p.head_dim, p.heads
    wq = (C, D, heads, 1), (2 * C, 2 * D * C, 2 * C * C)
    kv = TensorMap((D, p.kv_len, heads, B), (2 * C, 2 * D, 2 * skv * C),
                   (inst.COLS, p.kvp, 1, 1), inst.SW)
    act = TensorMap((C, S, 1, B), (2 * C, 2 * S * C, 2 * S * C),
                    (p.width // 2, ROWS, 1, 1), 0)
    kch = inst.KCH
    return (TensorMap(*wq, (kch, inst.DP, inst.HW0, 1), 2 * kch),
            TensorMap(*wq, (kch, inst.DP, max(inst.HW1, 1), 1), 2 * kch),
            TensorMap((C, C, 1, 1), (2 * C, 2 * C * C, 2 * C * C),
                      (kch, inst.NO, 1, 1), 2 * kch),
            kv, kv,
            TensorMap((C, S, 2, B), (2 * C, 2 * B * S * C, 2 * S * C),
                      (32, ROWS, 1, 1), 64),
            act, act)


@functools.cache
def _library():
    lib = build_library("vidtome_sublayer", ("sublayer.cu",))
    fn = lib.vidtome_fused_cross_sublayer
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    clusters = lib.vidtome_sublayer_clusters
    clusters.argtypes = [ctypes.c_int] * 5
    for f in (fn, clusters):
        f.restype = ctypes.c_int
    return fn, clusters


@functools.cache
def _card_clusters(index: int):
    """The planner's ``clusters`` on CUDA device ``index``
    (cudaOccupancyMaxActiveClusters of the instance)."""
    @functools.cache
    def clusters(D: int, HR: int, kvp: int, cluster: int, smem: int) -> int:
        with torch.cuda.device(index):
            return _library()[1](D, HR, kvp, cluster, smem)
    return clusters


class _Launch(NamedTuple):
    plan: SublayerPlan
    ints: ctypes.Array
    maps: ctypes.Array


@functools.cache
def _signature(shape: torch.Size, skv: int, device: torch.device,
               heads: int, kv_len: int) -> _Launch:
    """The plan of a call's signature and its ints and maps for the C
    entry; the plan's clusters checked against what the card holds."""
    B, S, C = shape
    p = plan(B, S, C, heads, skv, kv_len, _sm_count(device.index),
             _card_clusters(device.index))
    maps = [n for m in tensor_maps(p, skv)
            for n in (*m.dims, *m.strides, *m.box, m.swizzle)]
    return _Launch(p, (ctypes.c_int * len(p))(*p),
                   (ctypes.c_longlong * len(maps))(*maps))


def _check(x, a1, k, v, wq, wout, vecs) -> None:
    """Raises on what a launch cannot take: dtypes, shapes, devices, and
    the layout TMA and the 16-byte loads read."""
    B, S, C = x.shape
    Skv = k.shape[1]
    for name, t, shape in (("x", x, (B, S, C)), ("a1", a1, (B, S, C)),
                           ("k", k, (B, Skv, C)), ("v", v, (B, Skv, C)),
                           ("wq", wq, (C, C)), ("wout", wout, (C, C))):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused sublayer kernel takes bf16, got "
                            f"{name}.dtype={t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
        if t.device != x.device or t.data_ptr() % 16:
            raise ValueError(f"{name}: not on {x.device} or not 16-byte "
                             f"aligned")
    for name, t in zip(("bout", "g2", "b2", "g3", "b3"), vecs):
        if (tuple(t.shape) != (C,) or not t.is_contiguous()
                or t.dtype not in (torch.bfloat16, torch.float32)
                or t.device != x.device or t.data_ptr() % 16):
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned "
                             f"bf16 or fp32 [{C}] on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _launch(x, a1, k, v, wq, wout, bout, g2, b2, g3, b3, heads: int,
            kv_len: int, eps: float):
    vecs = (bout, g2, b2, g3, b3)
    _check(x, a1, k, v, wq, wout, vecs)
    launch = _signature(x.shape, k.shape[1], x.device, heads, kv_len)
    B, S, C = x.shape
    x3, y3 = torch.empty_like(x), torch.empty_like(x)
    scratch = (torch.empty(2, B, S, C, dtype=x.dtype, device=x.device)
               if launch.plan.cluster > 1 else None)
    ptrs = (ctypes.c_void_p * 14)(*(t.data_ptr() for t in (
        x, a1, k, v, scaled_wq(wq, heads), wout, *vecs, x3, y3)),
        None if scratch is None else scratch.data_ptr())
    vec_bf16 = sum(1 << i for i, t in enumerate(vecs)
                   if t.dtype == torch.bfloat16)
    err = _library()[0](ptrs, launch.ints, launch.maps, vec_bf16, eps,
                        _stream(x))
    if err != 0:
        raise RuntimeError(f"fused sublayer launch failed: error {err} "
                           f"(x{tuple(x.shape)}, heads={heads}, "
                           f"{launch.plan})")
    return x3, y3


def fused_cross_sublayer(x, a1, k, v, wq, wout, bout, g2, b2, g3, b3,
                         heads: int, kv_len: int, eps: float = 1e-5):
    """(x3, y3), each [B, S, C] in x's dtype; see the module docstring.

    CUDA tensors launch the Hopper kernel (bf16 activations and weights;
    anything it cannot take raises); CPU tensors run
    :func:`reference_cross_sublayer`."""
    if not x.is_cuda:
        return reference_cross_sublayer(x, a1, k, v, wq, wout, bout, g2, b2,
                                        g3, b3, heads, kv_len, eps)
    out = _launch(x, a1, k, v, wq, wout, bout, g2, b2, g3, b3, heads, kv_len,
                  eps)
    fused_cross_sublayer.launches += 1
    return out


fused_cross_sublayer.launches = 0
