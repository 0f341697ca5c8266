"""Rank functions of the port's multi-process tests (``parallel/``).

Imported by the ranks that ``vidtome_torch.parallel.launch.spawn`` starts,
so it imports no JAX: the JAX results are computed in the test process.
:func:`scenarios` runs in every rank of one 4-rank gloo group on the CPU,
builds each scenario's mesh over it (``make_mesh``, a collective: every
rank builds every mesh in the same order; ranks outside a 2-rank mesh wait
at the next one), runs the scenario unsharded and on the mesh from the same
weights and inputs, and has the mesh's rank 0 save both (``<name>.pt``) for
the tests to compare.
"""

from __future__ import annotations

import copy
import dataclasses
import os

import torch

from vidtome_torch.config import Config
from vidtome_torch.models.tome import DrawSource, ToMeCall, ToMeConfig
from vidtome_torch.models.unet import TINY_UNET, UNet2DConditionModel
from vidtome_torch.parallel.mesh import (Rows, check_replicated, make_mesh,
                                         param_checksums, shard_bundle,
                                         shard_params)
from vidtome_torch.testing import make_tiny_bundle


def _save(mesh, out_dir: str, name: str, result: dict) -> None:
    if mesh.rank == 0:
        torch.save(result, os.path.join(out_dir, f"{name}.pt"))


def _unet(weights: dict) -> UNet2DConditionModel:
    unet = UNet2DConditionModel(TINY_UNET).eval()
    unet.load_state_dict(weights["unet"])
    return unet


def _bundle(weights: dict):
    bundle = make_tiny_bundle()
    for name in ("unet", "vae", "text_encoder"):
        getattr(bundle, name).load_state_dict(weights[name])
    return bundle


def _plan_tensors(calls) -> list[torch.Tensor]:
    """Every index tensor of the calls' share_match plan caches."""
    out = []
    for call in calls:
        for key in sorted(call.plan_cache, key=str):
            entry = call.plan_cache[key]
            plans = list(entry.get("plans", []))
            if "global_plan" in entry:
                plans.append(entry["global_plan"])
            for p in plans:
                out += [p.merge_gather, p.unmerge_gather, p.unm_idx]
    return out


def _run_calls(unet, specs, tome, mesh=None, **kw):
    """Run ``specs`` [(x, ctx, t, bank_mode, draws)] as one chunk sequence
    (the banks carried from call to call); under ``mesh`` each call on
    this rank's rows, its output gathered.  Returns (outputs, calls)."""
    banks: dict = {}
    outs, calls = [], []
    with torch.no_grad():
        for x, ctx, t, mode, draws, extra in specs:
            call = ToMeCall(cfg=tome, local_draws=list(draws[:-1]),
                            coin=float(draws[-1]), bank_mode=mode,
                            banks=banks)
            if extra.get("repeat_banks"):
                call.banks = banks = {
                    k: b.repeat_interleave(extra["repeat_banks"], dim=0)
                    for k, b in banks.items()}
            kwargs = {**kw, **{k: v for k, v in extra.items()
                               if k != "repeat_banks"}}
            rows = None if mesh is None or mesh.data == 1 else Rows(
                mesh, x.shape[0])
            own = (lambda a: a) if rows is None else rows.take
            out = unet(own(x), t, own(ctx), tome_call=call, rows=rows,
                       **kwargs)
            outs.append(out if rows is None else rows.gather(out))
            calls.append(call)
            banks = call.banks
    return outs, calls


def _forward_scenario(mesh, weights, inputs, out_dir, name, tome=None,
                      quant=False, **kw):
    """The scenario's calls unsharded, then on the mesh (a copy of the
    UNet, sharded), each with the same draws; saves outputs and plans."""
    from vidtome_torch.ops.quant import quantize_unet

    base = _unet(weights)
    single_qt = quantize_unet(base) if quant else None
    single, s_calls = _run_calls(base, inputs, tome, qt=single_qt, **kw)
    sharded = shard_params(mesh, copy.deepcopy(base))
    qt = quantize_unet(sharded) if quant else None
    meshed, m_calls = _run_calls(sharded, inputs, tome, mesh, qt=qt, **kw)
    result = {"single": single, "meshed": meshed,
              "single_plans": _plan_tensors(s_calls),
              "meshed_plans": _plan_tensors(m_calls)}
    if quant:
        result.update(_int8_layers(base, single_qt, sharded, qt))
    _save(mesh, out_dir, name, result)


def _int8_layers(base, single_qt, sharded, qt) -> dict:
    """The sharded int8 table against the whole one's (each entry's int8
    weight and scale the whole entry's, sliced as the layer is), and every
    row-parallel int8 layer on one input (its slice of the input row on
    this rank) against the whole layer: the names that differ."""
    table, layers = [], []
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, e in qt.entries.items():
            whole = single_qt.entries[name]
            tp = getattr(sharded.get_submodule(name), "tp", None)
            w, s = whole.weight, whole.scale
            if tp is not None:
                w = w.index_select(tp.dim, tp.index)
                if not tp.row_parallel:
                    s = s.index_select(0, tp.index)
            if not (torch.equal(e.weight, w) and torch.equal(e.scale, s)):
                table.append(name)
            if tp is not None and tp.row_parallel:
                full = base.get_submodule(name)
                x = torch.randn(2, 24, full.in_features, generator=gen)
                got = sharded.get_submodule(name)(
                    x.index_select(-1, tp.index), qt)
                if not torch.equal(got, full(x, single_qt)):
                    layers.append(name)
    return {"table_differs": table, "row_layers_differ": layers,
            "row_layers": sum(getattr(sharded.get_submodule(n), "tp", None)
                              is not None and sharded.get_submodule(
                                  n).tp.row_parallel for n in qt.entries)}


def _pipeline(bundle, cfg, frames, draws_table, mesh=None):
    """The tiny invert -> generate of ``cfg`` (merging as configured; a
    ControlNet's control images made from ``frames`` in both stages) with
    the JAX key chain's draws; the decoded frames."""
    from vidtome_torch.pipeline.generator import Generator
    from vidtome_torch.pipeline.inverter import Inverter

    inverter = Inverter(bundle, cfg, mesh=mesh)
    inverted, _ = inverter(frames)
    gen = Generator(bundle, cfg, mesh=mesh)
    gen.configure_frames(frames.shape[0])
    table = gen.fidx_table()
    pad = torch.as_tensor(gen.pad_src)
    control = inverter.control_images(frames)
    clean = gen.ddim_sample(
        inverted[pad],
        gen.text.embed_cfg(cfg["generation"]["prompt"]["edit"], "blurry"),
        fidx_table=table, draws=DrawSource(draws_table),
        control=None if control is None else control[pad])
    return inverted, gen.vae.decode(clean[:frames.shape[0]])


def _controlnet_bundle():
    """The tiny stack with a canny ControlNet whose zero-initialised convs
    are moved off zero (at zero it adds nothing), seeded alike in every
    rank."""
    from vidtome_torch.models.registry import init_model

    bundle = init_model("tiny", weight_dtype="fp32", device="cpu",
                        control="canny")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for module in bundle.controlnet.zero_init_modules():
            for p in module.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return bundle


def _xl_bundle():
    """The tiny SDXL stack (the tiny XL UNet with a 48-wide context, two
    text encoders, VAE scaling 0.13025; random, seeds 0, 1 and 3)."""
    from vidtome_torch.models.clip_text import TINY_TEXT_2, CLIPTextModel
    from vidtome_torch.models.registry import init_model, init_random_
    from vidtome_torch.models.unet import TINY_SDXL_UNET
    from vidtome_torch.models.vae import AutoencoderKL

    def seeded(module, seed):
        init_random_(module, torch.Generator().manual_seed(seed))
        return module.eval()

    bundle = init_model("tiny", weight_dtype="fp32", device="cpu")
    bundle.unet = seeded(UNet2DConditionModel(dataclasses.replace(
        TINY_SDXL_UNET, cross_attention_dim=48)), 0)
    bundle.vae = seeded(AutoencoderKL((8, 8, 8, 8), 1,
                                      scaling_factor=0.13025), 1)
    bundle.text_encoder_2 = seeded(CLIPTextModel(TINY_TEXT_2), 3)
    bundle.sd_version, bundle.model_key = "xl", "tiny-xl"
    return bundle


def _xl_generation(cfg, x0, mesh=None):
    """The two-stage SDXL generation (the base, then the tiny refiner) of
    ``x0`` under ``cfg`` on a fresh tiny XL bundle; the decoded frames."""
    from vidtome_torch.pipeline.generator import Generator

    gen = Generator(_xl_bundle(), cfg, mesh=mesh)
    gen.configure_frames(x0.shape[0])
    pad = torch.as_tensor(gen.pad_src)
    clean = gen.sample(x0[pad], cfg["generation"]["prompt"]["edit"])
    return gen.vae.decode(clean[:x0.shape[0]])


def scenarios(out_dir: str) -> None:
    """Every scenario of ``tests/test_torch_parallel.py`` in this rank of
    a 4-rank group (``payload.pt`` in ``out_dir`` holds the weights, the
    inputs and the draws)."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    payload = torch.load(os.path.join(out_dir, "payload.pt"),
                         weights_only=False)
    w = payload["weights"]
    fwd = payload["forward"]

    # DP x TP, unmerged: one call of 2 lanes x 4 frames
    mesh = make_mesh(2, 2)
    _forward_scenario(mesh, w, [(fwd["x"], fwd["ctx"], 10, "off",
                                 [0.0], {})], out_dir, "dp_tp")

    # token merging with the bank (init, then merge) at {data: 4}
    tome = ToMeConfig(frames=4, local_merge_ratio=0.9, merge_global=True,
                      global_merge_ratio=0.8, align_batch=False,
                      share_match=True, len_quantum=1024)
    mesh = make_mesh(4, 1)
    merged = [(fwd["xa"], fwd["ctx"], 301, "init", fwd["draws_a"], {}),
              (fwd["xb"], fwd["ctx"], 301, "merge", fwd["draws_b"], {})]
    _forward_scenario(mesh, w, merged, out_dir, "merged", tome, num_lanes=2)

    # the LDM variant (cross-attention and feed-forward merged too)
    mesh = make_mesh(4, 1)
    ldm = dataclasses.replace(tome, merge_crossattn=True, merge_ff=True)
    _forward_scenario(mesh, w, merged, out_dir, "ldm", ldm, num_lanes=2)

    # PnP: 3 lanes (12 rows, lane 1 split over ranks), align_batch, both
    # injections, at {data: 4}
    pnp_tome = ToMeConfig(frames=4, local_merge_ratio=0.9, merge_global=True,
                          global_merge_ratio=0.8, align_batch=True,
                          share_match=True, len_quantum=1024)
    mesh = make_mesh(4, 1)
    pnp = [(fwd["x3a"], fwd["ctx3"], 301, "init", fwd["draws_a"], {}),
           (fwd["x3b"], fwd["ctx3"], 301, "merge", fwd["draws_b"], {})]
    _forward_scenario(mesh, w, pnp, out_dir, "pnp", pnp_tome, num_lanes=3,
                      attn_inject=True, conv_inject=True)

    # chunk_batch: a first chunk's call, then two chunks in one call of 16
    # rows against its banks repeated per chunk, at {data: 4}
    mesh = make_mesh(4, 1)
    batch = [(fwd["xa"], fwd["ctx"], 301, "init", fwd["draws_a"], {}),
             (fwd["x16"], fwd["ctx16"], 301, "merge", fwd["draws_b"],
              {"repeat_banks": 2})]
    _forward_scenario(mesh, w, batch, out_dir, "chunk_batch", tome,
                      num_lanes=2)

    # rows the data axis does not divide: chunk 3, 2 lanes (6 rows) on 4
    tome3 = ToMeConfig(frames=3, local_merge_ratio=0.9, merge_global=True,
                       global_merge_ratio=0.8, share_match=True,
                       len_quantum=1024)
    mesh = make_mesh(4, 1)
    uneven = [(fwd["x6a"], fwd["ctx6"], 301, "init", fwd["draws3"], {}),
              (fwd["x6b"], fwd["ctx6"], 301, "merge", fwd["draws3"], {})]
    _forward_scenario(mesh, w, uneven, out_dir, "uneven", tome3,
                      num_lanes=2)

    # int8 (W8A8) at {model: 2}: ranks 2 and 3 are outside the mesh
    mesh = make_mesh(1, 2)
    if mesh is not None:
        _forward_scenario(mesh, w, [(fwd["x"], fwd["ctx"], 10, "off",
                                     [0.0], {})], out_dir, "int8",
                          quant=True)

    # the tiny pipeline (inversion and generation, merging with the bank)
    cfg = Config(payload["pipeline_config"])
    for data, model in ((4, 1), (2, 2)):
        mesh = make_mesh(data, model)
        bundle = _bundle(w)
        inverted, frames = _pipeline(bundle, cfg, payload["frames"],
                                     payload["draws_table"], mesh)
        _save(mesh, out_dir, f"pipeline_{data}x{model}",
              {"inverted": inverted, "frames": frames})

    # a ControlNet in both stages, the ControlNet and the UNet sharded
    cn_cfg = Config(payload["controlnet_config"])
    mesh = make_mesh(2, 2)
    single = _pipeline(_controlnet_bundle(), cn_cfg, payload["frames"],
                       payload["draws_table"])
    meshed = _pipeline(_controlnet_bundle(), cn_cfg, payload["frames"],
                       payload["draws_table"], mesh)
    _save(mesh, out_dir, "controlnet_2x2", {"single": single,
                                            "meshed": meshed})

    # SDXL and its refiner at {data: 2}: ranks 2 and 3 are outside the mesh
    xl_cfg = Config(payload["xl_config"])
    mesh = make_mesh(2, 1)
    if mesh is not None:
        _save(mesh, out_dir, "xl_2x1", {
            "single": _xl_generation(xl_cfg, payload["xl_latents"]),
            "meshed": _xl_generation(xl_cfg, payload["xl_latents"], mesh)})

    # identical random weights on every rank, and a rank that differs
    mesh = make_mesh(4, 1)
    bundle = make_tiny_bundle()
    every = mesh.all_gather(param_checksums(bundle.unet)[None], "mesh")
    _save(mesh, out_dir, "weights", {"checksums": every})
    if rank == 3:
        with torch.no_grad():
            bundle.unet.conv_in.bias.add_(1.0)
    try:
        check_replicated(mesh, bundle.unet, "unet")
        refused = ""
    except RuntimeError as exc:
        refused = str(exc)
    try:
        shard_bundle(make_tiny_bundle(), make_mesh(8, 1))
        too_big = ""
    except ValueError as exc:
        too_big = str(exc)
    _save(mesh, out_dir, "refusals", {"differ": refused, "too_big": too_big})


def setup_rank(argv: list[str], out_dir: str) -> None:
    """``cli.setup_from_argv`` in this rank: its mesh, world size, backend
    and the bundle's state, saved as ``<rank>.pt``."""
    import torch.distributed as dist

    from vidtome_torch import cli

    _, bundle = cli.setup_from_argv(argv, device="cpu")
    mesh = bundle.mesh
    attn = bundle.unet.down_blocks[0].attentions[0].transformer_blocks[
        0].attn1
    torch.save({"shape": mesh.shape, "rank": mesh.rank,
                "world": dist.get_world_size(),
                "backend": dist.get_backend(), "device": str(mesh.device),
                "bundle_mesh": bundle.mesh is mesh, "heads": attn.heads},
               os.path.join(out_dir, f"{dist.get_rank()}.pt"))


def local_rank_rank(out_dir: str) -> None:
    """This rank's ``LOCAL_RANK`` as its process sees it, saved as
    ``<rank>.txt``."""
    import torch.distributed as dist

    with open(os.path.join(out_dir, f"{dist.get_rank()}.txt"), "w") as f:
        f.write(os.environ.get("LOCAL_RANK", ""))
