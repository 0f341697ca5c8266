"""The launch plan of GEGLU's gate kernel (``vidtome_torch.ops.geglu``) and
the wrapper's checks, on the CPU: the kernel runs only on the card
(``tests/test_torch_kernels.py``), so its block shapes at the widths the
main paths run, that the grid covers every output element once (the
kernel's index arithmetic replayed in numpy), and what a launch refuses are
pinned here."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vidtome_torch.models.layers import GEGLU
from vidtome_torch.ops import geglu as t_geglu

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "vidtome_torch" / "csrc" / "geglu.cu").read_text()

# inner -> (vec, threads_x, threads_y, col_blocks) in bf16: SD1.5 and
# SD2.x (1280 / 2560 / 5120, SDXL's 2560 / 5120 too), the refiner's 3072 /
# 6144, a {model: 2} share of SD1.5's level 0 and SD2.1's 3 of 5 heads
BF16_SHAPES = {
    1280: (8, 160, 3, 1),
    2560: (8, 160, 3, 2),
    5120: (8, 160, 3, 4),
    3072: (8, 192, 2, 2),
    6144: (8, 256, 2, 3),
    640: (8, 96, 5, 1),
    768: (8, 96, 5, 1),
}
WIDTHS = sorted(BF16_SHAPES) + [1, 3, 4, 8, 12, 37, 40, 160, 1279, 5119,
                                6152, 20480]


@pytest.mark.parametrize("inner", sorted(BF16_SHAPES))
def test_thread_shape_at_the_main_paths_widths(inner):
    assert tuple(t_geglu.thread_shape(inner, 2)) == BF16_SHAPES[inner]


@pytest.mark.parametrize("element_size", [2, 4])
@pytest.mark.parametrize("inner", WIDTHS)
def test_thread_shape_covers_a_row_with_whole_warps(inner, element_size):
    """16-byte accesses where a row's halves start on 16 bytes, else one
    element an access; whole warps of at most 256 accesses, no column block
    without work, at most 512 threads a block."""
    s = t_geglu.thread_shape(inner, element_size)
    aligned = inner * element_size % 16 == 0
    assert s.vec == (16 // element_size if aligned else 1)
    accesses = inner // s.vec
    assert s.threads_x % 32 == 0 and 32 <= s.threads_x <= 256
    assert s.col_blocks * s.threads_x >= accesses
    assert (s.col_blocks - 1) * s.threads_x < accesses
    assert s.threads_x * s.threads_y <= t_geglu._MAX_THREADS
    assert s.threads_x * (s.threads_y + 1) > t_geglu._MAX_THREADS


def _covered(rows: int, inner: int, element_size: int) -> np.ndarray:
    """How often the kernel's threads write each output element, from its
    index arithmetic (``geglu_kernel``) over the grid the C entry launches."""
    s = t_geglu.thread_shape(inner, element_size)
    per_block = s.threads_y * t_geglu._ROWS
    row_blocks = -(-rows // per_block)
    bx, by, ty, tx, k = np.meshgrid(
        np.arange(row_blocks), np.arange(s.col_blocks),
        np.arange(s.threads_y), np.arange(s.threads_x),
        np.arange(t_geglu._ROWS), indexing="ij")
    col = (by * s.threads_x + tx) * s.vec
    row = bx * per_block + ty + k * s.threads_y
    live = (col < inner) & (row < rows)
    hits = np.zeros((rows, inner), np.int64)
    for e in range(s.vec):
        np.add.at(hits, (row[live], col[live] + e), 1)
    return hits


@pytest.mark.parametrize("rows,inner,element_size", [
    (1, 1, 2), (7, 3, 2), (13, 40, 2), (13, 40, 4), (25, 12, 2),
    (25, 12, 4), (64, 1280, 2), (5, 640, 4), (3, 5120, 2), (11, 6144, 2),
    (2, 1279, 2), (37, 768, 2)])
def test_grid_writes_every_element_once(rows, inner, element_size):
    assert (_covered(rows, inner, element_size) == 1).all()


def test_plan_constants_match_the_source():
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE))
    assert int(const["kRows"]) == t_geglu._ROWS
    assert int(const["kMaxThreads"]) == t_geglu._MAX_THREADS
    code = "\n".join(ln.split("//")[0] for ln in SOURCE.splitlines())
    # the eager path's arithmetic: exact erf, fp32, rounded twice
    assert "erff(x * kAlpha)" in code and "x * 0.5f * (1.0f +" in code
    assert "__ldcs(" in code and "tanh" not in code
    assert "__float2bfloat16_rn" in code


@pytest.mark.parametrize("shape,dtype,ints", [
    ((56, 4096, 2560), torch.bfloat16,
     (56 * 4096, 1280, 0, 8, 160, 3, 1)),
    ((84, 64, 10240), torch.bfloat16, (84 * 64, 5120, 0, 8, 160, 3, 4)),
    ((3, 77, 74), torch.float32, (3 * 77, 37, 1, 1, 64, 8, 1)),
    ((5, 24), torch.float32, (5, 12, 1, 4, 32, 16, 1)),
])
def test_launch_plan(shape, dtype, ints):
    y = torch.empty(shape, dtype=dtype, device="meta")
    plan = t_geglu.launch_plan(y)
    assert plan.out_shape == (*shape[:-1], shape[-1] // 2)
    assert plan.ints == ints
    assert t_geglu.launch_plan(y) is plan  # looked up, not made again


def test_second_call_skips_the_checks(monkeypatch):
    y = torch.empty(2, 9, 48, dtype=torch.bfloat16, device="meta")
    t_geglu.launch_plan(y)
    monkeypatch.setattr(t_geglu, "check_input", lambda y: 1 / 0)
    t_geglu.launch_plan(torch.empty(2, 9, 48, dtype=torch.bfloat16,
                                    device="meta"))
    with pytest.raises(ZeroDivisionError):  # a new signature checks again
        t_geglu.launch_plan(torch.empty(2, 10, 48, dtype=torch.bfloat16,
                                        device="meta"))


@pytest.mark.parametrize("make,error", [
    (lambda: torch.zeros(4, 64, dtype=torch.float16), TypeError),
    (lambda: torch.zeros(4, 64, dtype=torch.float64), TypeError),
    (lambda: torch.zeros(64, 4, dtype=torch.bfloat16).t(), ValueError),
    (lambda: torch.zeros(4, 128, dtype=torch.bfloat16)[:, :64], ValueError),
    (lambda: torch.zeros(4, 63, dtype=torch.bfloat16), ValueError),
    (lambda: torch.zeros(0, 64, dtype=torch.bfloat16), ValueError),
    (lambda: torch.zeros(4, 0, dtype=torch.bfloat16), ValueError),
])
def test_check_input_refuses(make, error):
    with pytest.raises(error):
        t_geglu.check_input(make())


def test_check_pointer_refuses_a_misaligned_base():
    base = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    assert t_geglu.check_pointer(base) == base.data_ptr()
    y = base[1:1 + 4 * 64].view(4, 64)
    assert y.is_contiguous()
    with pytest.raises(ValueError, match="16 bytes"):
        t_geglu.check_pointer(y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(dtype):
    """On the CPU, geglu is h * F.gelu(gate) to the bit and launches
    nothing; GEGLU's output is unchanged by routing through it."""
    torch.manual_seed(0)
    y = torch.randn(3, 17, 2 * 40).to(dtype)
    before = t_geglu.geglu.launches
    got = t_geglu.geglu(y)
    h, gate = y.chunk(2, dim=-1)
    assert torch.equal(got, h * F.gelu(gate))
    assert torch.equal(got, t_geglu.geglu_plain(y))
    mod = GEGLU(24, 40).to(dtype)
    x = torch.randn(3, 17, 24).to(dtype)
    with torch.no_grad():
        h, gate = mod.proj(x).chunk(2, dim=-1)
        assert torch.equal(mod(x), h * F.gelu(gate))
    assert t_geglu.geglu.launches == before
