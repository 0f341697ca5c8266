"""The operation and byte counts of ``benchmark/counts`` against shapes
worked by hand, and a whole UNet call's count against PyTorch's own flop
counter."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.counts import peaks, shapes  # noqa: E402
from benchmark.tests import tiny  # noqa: E402


def test_self_attention_at_merged_length():
    # SD1.5 level 0 under chunk merging: 2 joined rows of 5120 merged
    # tokens, 320 wide, 8 heads of 40
    flops, nbytes = shapes.cross_attention((2, 5120, 320), None, 8, 40, 1, 2)
    proj = 2 * (2 * 5120) * 320 * 320
    core = 2 * 2 * 8 * 5120 * 5120 * 40 * 2
    assert flops == 4 * proj + core
    weights = 4 * 320 * 320 + 320
    assert nbytes == 2 * (weights + 2 * 2 * 5120 * 320)


def test_cross_attention_and_shared_qk():
    # attn2: 77 context tokens 768 wide
    flops, nbytes = shapes.cross_attention((8, 4096, 320), (8, 77, 768), 8,
                                           40, 1, 2)
    expect = (2 * 8 * 4096 * 320 * 320 + 2 * 2 * 8 * 77 * 768 * 320
              + 2 * 8 * 4096 * 320 * 320 + 4 * 8 * 8 * 4096 * 77 * 40)
    assert flops == expect
    assert nbytes == 2 * (320 * 320 * 2 + 2 * 768 * 320 + 320
                          + 2 * 8 * 4096 * 320 + 8 * 77 * 768)
    # PnP: q and k of lane 0 only, out of 3 lanes
    f3, _ = shapes.cross_attention((3, 100, 64), None, 1, 64, 3, 2)
    assert f3 == (2 * 2 * 100 * 64 * 64 + 2 * 2 * 3 * 100 * 64 * 64
                  + 4 * 3 * 100 * 100 * 64)


def test_resnet_block():
    flops, nbytes = shapes.resnet_block((4, 32, 32, 640), (4, 1280), 320, 2)
    expect = (2 * 4 * 32 * 32 * 9 * (640 * 320 + 320 * 320)
              + 2 * 4 * 1280 * 320 + 2 * 4 * 32 * 32 * 640 * 320)
    assert flops == expect
    weights = (9 * 640 * 320 + 9 * 320 * 320 + 1280 * 320 + 3 * 320
               + 2 * 640 + 2 * 320 + 640 * 320 + 320)
    acts = 4 * 32 * 32 * (640 + 320) + 4 * 1280
    assert nbytes == 2 * (weights + acts)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(989e12, 2 * 3.35e12) == pytest.approx(2.0)


@pytest.mark.parametrize("linear", [False, True], ids=["sd15", "sd21"])
def test_unet_call_flops_match_pytorch_counter(linear):
    """The tracer's count of one tiny UNet call equals the products
    PyTorch's flop counter sees (the port's plain path on the CPU)."""
    from benchmark.harness.program import modules
    from benchmark.harness.trace import Tracer

    model = tiny.model(linear)
    unet, _, _ = modules(model)
    unet = unet.to_empty(device="cpu").float()
    for p in unet.parameters():
        torch.nn.init.normal_(p, std=0.02)

    class _Bundle:  # what the tracer hooks
        pass

    b = _Bundle()
    b.unet = unet
    _, b.vae, b.text_encoder = modules(model)

    class _Prog:
        bundle = b
        generator = type("G", (), {"sample": lambda self: None})()

    tracer = Tracer(_Prog(), lambda: None)
    x = torch.randn(2, 8, 8, 4)
    ctx = torch.randn(2, 16, 32)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        unet(x, 501, ctx)
    tracer.remove()
    assert tracer.model_flops == fc.get_total_flops()
