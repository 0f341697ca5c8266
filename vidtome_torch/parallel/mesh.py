"""The device mesh: data parallelism over rows, tensor parallelism over heads.

Counterpart of ``vidtome_tpu/parallel/mesh.py``.  JAX drives every device
of a mesh from one process and GSPMD inserts the collectives; here each
rank of the mesh is a process with one device (``torch.distributed``,
NCCL on the cards, gloo on the CPU or where ranks share a card), and the
collectives are written out, all of them in :class:`Mesh`.  The axes:

  * ``data`` -- the rows of every UNet call are split over the data ranks
    (:class:`Rows`: contiguous rows a rank, padded by copies of the last
    row and dropped again at every gather).  Work across rows gathers the
    rows it joins: token merging (a lane's frames, the bank, the shared
    matching of ``align_batch``) and PnP's lane 0.
  * ``model`` -- tensor parallelism in the attention and the GEGLU
    feed-forward (:func:`shard_params`): column-parallel q / k / v and the
    GEGLU projection (by whole heads, the value and gate halves each
    split), row-parallel out projections, whose partial products are
    summed over the model ranks in fp32 before the bias is added once.

A rank's place is ``rank = data_rank * model + model_rank``, JAX's
``devices.reshape(data, model)``.  Every rank holds the same replicated
weights, latents, draws and schedules, and runs the same loop.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import re
import time
from typing import Any

import torch
import torch.distributed as dist

from vidtome_torch.parallel.distributed import local_card


def split_sizes(n: int, parts: int) -> list[int]:
    """``n`` split into ``parts`` contiguous runs, the first ``n % parts``
    one longer (``numpy.array_split``'s sizes)."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def shard_range(n: int, parts: int, i: int) -> tuple[int, int]:
    """[start, stop) of run ``i`` of :func:`split_sizes`."""
    sizes = split_sizes(n, parts)
    start = sum(sizes[:i])
    return start, start + sizes[i]


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a ``data`` x ``model`` mesh, its device, the
    process groups of its axes and the collectives over them.

    ``groups`` maps "data", "model" and "mesh" (every rank of the mesh) to
    this rank's process group on that axis; an axis of one rank needs
    none.  A mesh built without groups (``Mesh(2, 1, rank=1,
    device="meta")``) runs every collective on meta tensors as shapes
    only, so a meta-device forward shows the shapes a rank gives the
    kernels.  ``stats`` counts the collectives' calls, bytes and host
    seconds (with NCCL the seconds are the enqueue's; gloo returns when the
    collective is done)."""

    data: int
    model: int
    rank: int = 0
    device: torch.device | str = "cpu"
    groups: dict = dataclasses.field(default_factory=dict)
    stats: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def __post_init__(self):
        self.device = torch.device(self.device)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def axis_size(self, axis: str) -> int:
        return self.size if axis == "mesh" else getattr(self, axis)

    def _collective(self, what: str, t: torch.Tensor, axis: str, run,
                    meta):
        """``run(tensor, group)`` over ``axis``: nothing on one rank, the
        shape (``meta(t)``) on a meta tensor, through host memory for a
        CUDA tensor on a gloo group."""
        if self.axis_size(axis) == 1:
            return t
        if t.is_meta:
            return meta(t)
        group = self.groups.get(axis)
        if group is None:
            raise RuntimeError(f"{what} over the {axis} axis of {self.shape}:"
                               f" this mesh has no process group for it")
        host = t.is_cuda and dist.get_backend(group) == "gloo"
        x = t.cpu() if host else t.contiguous()
        t0 = time.perf_counter()
        out = run(x, group)
        if host:
            out = out.to(t.device)
        self.stats["calls"] += 1
        self.stats["bytes"] += x.numel() * x.element_size()
        self.stats["seconds"] += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """The sum (or ``op="max"``) of ``t`` over the ranks of ``axis``."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def run(x, group):
            x = x.clone() if x is t else x
            dist.all_reduce(x, op=red, group=group)
            return x
        return self._collective("all_reduce", t, axis, run, lambda x: x)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0,
                   sizes: list[int] | None = None) -> torch.Tensor:
        """Every rank's ``t`` of ``axis`` concatenated along ``dim`` in
        rank order; ``sizes`` gives each rank's extent along ``dim`` where
        they differ (sent padded to the largest, trimmed on arrival)."""
        n = self.axis_size(axis)

        def run(x, group):
            width = max(sizes) if sizes else x.shape[dim]
            if x.shape[dim] < width:
                pad = list(x.shape)
                pad[dim] = width - x.shape[dim]
                x = torch.cat([x, x.new_zeros(pad)], dim)
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            if sizes:
                parts = [p.narrow(dim, 0, s) for p, s in zip(parts, sizes)]
            return torch.cat(parts, dim)

        def meta(x):
            shape = list(x.shape)
            shape[dim] = sum(sizes) if sizes else n * shape[dim]
            return x.new_empty(shape)
        return self._collective("all_gather", t, axis, run, meta)

    def barrier(self) -> None:
        if self.size > 1 and "mesh" in self.groups:
            dist.barrier(group=self.groups["mesh"])


def default_devices(world: int) -> list[torch.device]:
    """One device a rank on one host: the visible cards in order, else the
    CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * world


def make_mesh(data: int = 1, model: int = 1,
              devices: list | None = None) -> Mesh | None:
    """The mesh of the first ``data * model`` ranks of the process group
    (JAX's ``devices[:n].reshape(data, model)``), rank ``r`` on
    ``devices[r]`` (a card named more than once is shared by those ranks,
    which only gloo allows); without ``devices`` each rank takes the card
    of ``distributed.local_card`` (its start's local rank, else its rank
    modulo the visible cards: the card ``initialize_multihost`` set), or
    the CPU where there is none.  Every rank of the group must call it, in the
    same order as its other group calls; a rank outside the mesh gets None.
    Refuses a mesh larger than the ranks or the devices, and a rank whose
    card is not on its host."""
    n = data * model
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    what = f"need {n} devices for mesh (data={data}, model={model}), have"
    if devices is None:
        if world < n:
            raise ValueError(f"{what} {world} ranks")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        device = torch.device("cpu")
        if cards and rank < n:
            device = torch.device("cuda", local_card(rank, world, cards))
    else:
        devices = [torch.device(d) for d in devices]
        if min(len(devices), world) < n:
            raise ValueError(f"{what} {len(devices)} devices and {world} "
                             f"ranks")
        device = devices[rank] if rank < n else None
    groups = {}
    if world > 1:
        # every rank creates every group, in this order
        sets = {"mesh": [list(range(n))],
                "model": [[d * model + m for m in range(model)]
                          for d in range(data)],
                "data": [[d * model + m for d in range(data)]
                         for m in range(model)]}
        for axis, members in sets.items():
            for ranks in members:
                if len(ranks) > 1:
                    group = dist.new_group(ranks)
                    if rank in ranks:
                        groups[axis] = group
    if rank >= n:
        return None
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(data, model, rank, device, groups)


def mesh_size(tpu_cfg: Any) -> int:
    """The ranks ``tpu.mesh`` asks for (1 without a mesh)."""
    spec = (tpu_cfg or {}).get("mesh") or {}
    return int(spec.get("data", 1)) * int(spec.get("model", 1))


def mesh_from_config(tpu_cfg: Any, device=None) -> Mesh | None:
    """The mesh of the ``tpu.mesh`` section (``{data: 4, model: 2}``) over
    the process group, every rank on ``device``'s type (the visible cards,
    one a rank, unless ``device`` is the CPU); None without a mesh.  A
    process group whose size is not the mesh's is refused."""
    spec = (tpu_cfg or {}).get("mesh") or {}
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = mesh_size(tpu_cfg)
    if world != n:
        raise ValueError(
            f"tpu.mesh {dict(spec) or None} spans {n} ranks; this process "
            f"group has {world}.  Start the ranks through an entry point "
            f"(python -m vidtome_torch.cli, which starts them) or torchrun "
            f"with --nproc-per-node {n}")
    if not spec:
        return None
    devices = None
    if device is not None and torch.device(device).type != "cuda":
        devices = [torch.device(device)] * world
    return make_mesh(int(spec.get("data", 1)), int(spec.get("model", 1)),
                     devices)


# ---------------------------------------------------------------------------
# Tensor-parallel parameter layouts.
# ---------------------------------------------------------------------------

# (name regex, the weight's layout) on the port's parameter names (PyTorch's
# [out, in]): column-parallel layers shard the output dim (0), the
# row-parallel layer closing each block the input dim (1), leaving partial
# sums that Linear adds up over the model axis.  The timestep-embedding MLP
# is never sharded (the JAX package's note: negligible compute, and GSPMD
# corrupted results with it sharded).
_TP_RULES: list[tuple[str, tuple]] = [
    (r"attn\d\.to_(q|k|v)\.weight$", ("model", None)),
    (r"attn\d\.to_out\.0\.weight$", (None, "model")),
    (r"ff\.net\.0\.proj\.weight$", ("model", None)),
    (r"ff\.net\.2\.weight$", (None, "model")),
]

# Bias rules: biases of column-parallel layers are sharded on their only dim.
_TP_BIAS_RULES: list[tuple[str, tuple]] = [
    (r"attn\d\.to_(q|k|v)\.bias$", ("model",)),
    (r"ff\.net\.0\.proj\.bias$", ("model",)),
]


def param_spec(name: str) -> tuple:
    """The layout of a parameter: per dim "model" (sharded) or None; ()
    for a replicated one."""
    for pattern, spec in _TP_RULES + _TP_BIAS_RULES:
        if re.search(pattern, name):
            return spec
    return ()


@dataclasses.dataclass(eq=False)
class TPShard:
    """What a sharded Linear holds: ``index`` of the full weight along
    ``dim`` (0: column-parallel, 1: row-parallel) and every model rank's
    extent there (``sizes``)."""

    mesh: Mesh
    dim: int
    index: torch.Tensor
    sizes: list[int]

    @property
    def row_parallel(self) -> bool:
        return self.dim == 1

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.mesh.all_reduce(t, "model", op)

    def gather(self, w: torch.Tensor) -> torch.Tensor:
        """The full weight from every model rank's shard (plain head
        splits: the shards are contiguous in rank order)."""
        return self.mesh.all_gather(w, "model", self.dim, self.sizes)


def shard_like(module, full: torch.Tensor) -> torch.Tensor:
    """This rank's part of a tensor of ``module.weight``'s full shape (a
    LoRA delta), or ``full`` where the module is not sharded."""
    tp = getattr(module, "tp", None)
    if tp is None:
        return full
    return full.index_select(tp.dim, tp.index.to(full.device))


def _shard_linear(lin, mesh: Mesh, dim: int, index: torch.Tensor,
                  sizes: list[int]) -> None:
    index = index.to(lin.weight.device)
    with torch.no_grad():
        lin.weight.data = lin.weight.data.index_select(dim, index)
        if lin.bias is not None and dim == 0:
            lin.bias.data = lin.bias.data.index_select(0, index)
    if dim == 0:
        lin.out_features = len(index)
    else:
        lin.in_features = len(index)
    lin.tp = TPShard(mesh, dim, index, sizes)


def shard_params(mesh: Mesh, module):
    """Shard ``module``'s attention and feed-forward layers in place by the
    TP rules over the model axis (nothing at ``model == 1``): every
    ``attn<i>`` keeps its heads ``shard_range(heads, model, model_rank)``
    (its ``heads`` becomes that count; an uneven split is uneven, never
    inside a head), every ``ff`` its run of the GEGLU width, in both the
    value and the gate half of ``net.0.proj``.  A layer already sharded
    is left as it is."""
    M, m = mesh.model, mesh.model_rank
    if M == 1:
        return module
    for name, unit in list(module.named_modules()):
        leaf = name.rpartition(".")[2]
        if re.fullmatch(r"attn\d", leaf):
            if unit.to_q.tp is not None:
                continue
            hd = unit.head_dim
            h0, h1 = shard_range(unit.heads, M, m)
            sizes = [s * hd for s in split_sizes(unit.heads, M)]
            idx = torch.arange(h0 * hd, h1 * hd)
            layers = {"to_q": (unit.to_q, idx), "to_k": (unit.to_k, idx),
                      "to_v": (unit.to_v, idx),
                      "to_out.0": (unit.to_out[0], idx)}
            unit.heads = h1 - h0
        elif leaf == "ff":
            proj, out = unit.net[0].proj, unit.net[2]
            if out.tp is not None:
                continue
            inner = out.in_features
            a, b = shard_range(inner, M, m)
            sizes = split_sizes(inner, M)
            idx = torch.arange(a, b)
            # [value | gate]: this rank's run of each half
            layers = {"net.0.proj": (proj, torch.cat([idx, inner + idx])),
                      "net.2": (out, idx)}
        else:
            continue
        for sub, (lin, index) in layers.items():
            dim = param_spec(f"{name}.{sub}.weight").index("model")
            _shard_linear(lin, mesh, dim, index, sizes)
    return module


def param_checksums(module) -> torch.Tensor:
    """One float64 sum of every parameter and buffer of ``module``."""
    with torch.no_grad():
        return torch.stack([t.detach().double().sum() for t in
                            list(module.parameters())
                            + list(module.buffers())])


def check_replicated(mesh: Mesh, module, what: str) -> None:
    """Raise unless every rank holds the same weights in ``module`` (its
    checksums all-gathered over the mesh)."""
    own = param_checksums(module)
    every = mesh.all_gather(own[None], "mesh").cpu()
    if not torch.equal(every, every[:1].expand_as(every)):
        bad = [r for r in range(every.shape[0])
               if not torch.equal(every[r], every[0])]
        raise RuntimeError(f"{what}: the weights of ranks {bad} differ from "
                           f"rank 0's")


def shard_bundle(bundle, mesh: Mesh) -> None:
    """Put a model bundle on ``mesh``, once: every rank's weights checked
    equal (random weights are seeded alike, checkpoints read alike), then
    the UNet's and the ControlNet's attention and feed-forward sharded by
    the TP rules; ``bundle.mesh`` records it.  A bundle on another mesh
    raises."""
    if bundle.mesh is mesh:
        return
    if bundle.mesh is not None:
        raise ValueError(f"the bundle is on the mesh {bundle.mesh.shape}; "
                         f"it cannot move to another")
    mods = {"unet": bundle.unet, "controlnet": bundle.controlnet,
            "vae": bundle.vae, "text_encoder": bundle.text_encoder,
            "text_encoder_2": bundle.text_encoder_2}
    for what, mod in mods.items():
        if mod is not None:
            check_replicated(mesh, mod, what)
    for mod in (bundle.unet, bundle.controlnet):
        if mod is not None:
            shard_params(mesh, mod)
    bundle.mesh = mesh


# ---------------------------------------------------------------------------
# Rows over the data axis.
# ---------------------------------------------------------------------------


def take_rows(x: torch.Tensor, index: list[int]) -> torch.Tensor:
    """The rows ``index`` of ``x`` (a view where they are a run)."""
    if index == list(range(index[0], index[0] + len(index))):
        return x[index[0]:index[0] + len(index)]
    return x[torch.tensor(index, device=x.device)]


@dataclasses.dataclass(frozen=True)
class Rows:
    """The rows of one batch of ``n`` that this rank runs on the data axis:
    ``per = ceil(n / data)`` rows from ``data_rank * per`` on, indices past
    ``n - 1`` clamped to it.  The data axis need not divide the rows: the
    last ranks pad with copies of the last row, which every gather drops
    (pad and drop; a rank whose rows are all padding still runs them)."""

    mesh: Mesh
    n: int

    @property
    def per(self) -> int:
        return -(-self.n // self.mesh.data)

    @functools.cached_property
    def index(self) -> list[int]:
        start = self.mesh.data_rank * self.per
        return [min(i, self.n - 1) for i in range(start, start + self.per)]

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor of the whole batch."""
        return take_rows(x, self.index)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch from every rank's rows."""
        return self.mesh.all_gather(x, "data")[:self.n]

    def joined(self, frames: int) -> tuple[slice, list[int]]:
        """The joined rows (``frames`` rows each, core/merge.join_frames)
        that hold this rank's rows, and the place of each of its rows among
        theirs."""
        j0 = self.index[0] // frames
        j1 = self.index[-1] // frames + 1
        return slice(j0, j1), [i - j0 * frames for i in self.index]

    def lane0(self, lanes: int) -> list[int]:
        """For each of this rank's rows, its row in lane 0 (the batch is
        ``lanes`` lane-major blocks)."""
        n0 = self.n // lanes
        return [i % n0 for i in self.index]
