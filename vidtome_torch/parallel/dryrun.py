"""The serving generation on a mesh of the tiny bundle: the counterpart of
``__graft_entry__.py:dryrun_multichip``.

    python -m vidtome_torch.parallel.dryrun [N] [--device cpu]

runs ``Generator.ddim_sample`` of the tiny bundle (``testing.
make_tiny_bundle``: the full model code at toy widths, random seeded
weights) with the full serving profile (deep-feature cache, CFG delta
cache and eps-reuse step skip with extrapolation, local 0.9 / global 0.8
merging against the bank) for 8 steps on N ranks (default 4; ``model = 2``
when N is even, the rest on ``data``) on the cards (``launch.
rank_devices``: a card each over NCCL, else card 0 shared over gloo), or
on the CPU over gloo when ``--device cpu`` asks for it; without a card and
without ``--device cpu`` it refuses.  It asserts what the JAX dry run
asserts: the deep and CFG-delta caches refresh and change between the
first and the last four steps, and the latents move and stay finite; and
that every rank ends with the same latents, bit for bit.
"""

from __future__ import annotations

import sys

import torch

from vidtome_torch.config import Config
from vidtome_torch.parallel.launch import rank_devices, spawn
from vidtome_torch.parallel.mesh import make_mesh

STEPS = 8


def dryrun_config() -> Config:
    return Config({
        "sd_version": "1.5", "height": 64, "width": 64, "seed": 7,
        "float_precision": "fp32",
        "generation": {
            "control": "none", "guidance_scale": 7.5, "n_timesteps": STEPS,
            "negative_prompt": "bad", "prompt": {"edit": "dry run"},
            "chunk_size": 4, "chunk_ord": "mix-4",
            "local_merge_ratio": 0.9, "merge_global": True,
            "global_merge_ratio": 0.8, "global_rand": 0.5,
            "align_batch": False,
            # the full serving profile: steps 3, 5 and 7 run no UNet
            "cache_schedule": "full:2,uniform:2",
            "cfg_schedule": "full:2,uniform:2",
            "eps_schedule": "full:2,uniform:2",
            "eps_extrapolate": True}})


def mesh_axes(n: int) -> tuple[int, int]:
    """(data, model) of an n-rank dry run."""
    model = 2 if n % 2 == 0 else 1
    return n // model, model


def rank_main(n: int, devices: list[str]) -> None:
    """One rank of the dry run (the process group exists), rank r on
    ``devices[r]``."""
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.testing import make_tiny_bundle

    data, model = mesh_axes(n)
    mesh = make_mesh(data, model, devices)
    gen = Generator(make_tiny_bundle(device=mesh.device), dryrun_config(),
                    mesh=mesh)
    gen.configure_frames(max(8, 2 * data))
    x = torch.randn(gen.n_padded, 8, 8, 4,
                    generator=torch.Generator().manual_seed(0)).to(
                        mesh.device)
    context = gen.context("dry run")
    table = gen.fidx_table()
    draws = gen.draw_source(table.shape[1])
    x1 = gen.ddim_sample(x, context, table, draws, stop=STEPS // 2)
    deep1, u1 = (gen.caches[k].float().clone() for k in ("deep", "ucond"))
    x2 = gen.ddim_sample(x1, context, table, draws, start=STEPS // 2)
    deep2 = gen.caches["deep"].float()
    if not deep1.abs().sum() > 0:
        raise AssertionError("deep cache never refreshed")
    if torch.equal(deep1, deep2):
        raise AssertionError("deep cache static across blocks")
    if not u1.abs().sum() > 0:
        raise AssertionError("CFG delta cache never refreshed")
    if not torch.isfinite(x2).all() or torch.equal(x1, x2):
        raise AssertionError("latents not finite or not moving")
    out = gen.ddim_sample(x, context, table, draws)
    if out.shape != x.shape or not torch.isfinite(out).all():
        raise AssertionError(f"latents {tuple(out.shape)} not finite")
    every = mesh.all_gather(out[None], "mesh")
    if not all(torch.equal(every[r], every[0]) for r in range(mesh.size)):
        raise AssertionError("the ranks' latents differ")
    if mesh.rank == 0:
        print(f"[dryrun] OK: the serving generation ran {STEPS} steps on "
              f"{n} ranks, mesh {mesh.shape}, {mesh.device} (deep cache "
              f"delta {(deep2 - deep1).abs().mean().item():.2e}, |out| "
              f"{out.abs().mean().item():.4f}; calls {dict(gen.unet_calls)})")


def dryrun(n: int = 4, device: str = "cuda",
           timeout: float | None = None) -> None:
    """The dry run on ``n`` ranks on ``device``'s kind ("cuda" or "cpu")."""
    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("the dry run runs on the cards; none found (pass "
                         "--device cpu for gloo ranks on the CPU)")
    devices = [str(d) for d in rank_devices(n, device)]
    data, model = mesh_axes(n)
    print(f"[dryrun] mesh: data={data} x model={model} on {devices}")
    spawn(rank_main, n, (n, devices), devices, timeout=timeout,
          collective_timeout=timeout)


def main(argv: list[str]) -> int:
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    dryrun(int(argv[0]) if argv else 4, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
