"""The port's mesh (``vidtome_torch/parallel/``) against the one-process run
and the JAX package, on the CPU.

The TP layout, the row split and the collectives' shapes are checked in
this process (a mesh without process groups).  Everything else runs in one
group of 4 gloo ranks (``launch.spawn``, bounded by its own timeout, with a
collective timeout, so a hung collective fails): ``tests/torch_ranks.
scenarios`` runs each scenario unsharded and on its mesh from the same
weights (the JAX tiny bundle's, carried into the port) and inputs (numpy,
seeded), while this process computes the JAX side.  Bars, those of the JAX
package's own mesh tests (``tests/test_parallel.py``,
``tests/test_pipeline_mesh.py``) where it has them:
  * DP x TP forward at {data: 2, model: 2}: 2e-4 of the one-process forward
    (the TP sums add the partial products in another order), and the slice
    tests' rtol = atol = 1e-4 against JAX's unsharded ``model.apply``;
  * merged forwards (the bank, the LDM variant, PnP with ``align_batch``,
    ``chunk_batch``, rows the data axis does not divide) at {data: 4}:
    1e-5 of the
    one-process outputs, the merge plans equal index for index;
  * int8 at {model: 2}: the sharded table is the whole one sliced, and a
    row-parallel int8 layer gives the whole layer's output bit for bit (the
    whole row's activation scale, the int32 sums summed exact); a UNet call
    within INT8_UNET_TOL of the one-process call: the sharded fp32 layers
    (attention by heads, ``ff.net.2``'s partial sums) differ in the last
    bits, which can move an activation across an int8 rounding step, one
    step being 1/127 of its row's amax;
  * the tiny pipeline (inversion and generation, 8 frames, merging with the
    bank) at {data: 4} and {data: 2, model: 2}: mean |diff| < 2e-3 and <
    0.02 of the one-process frames, inverted latents 1e-4, and >= 35 dB
    against the JAX package's one-device frames;
  * a canny ControlNet in both stages at {data: 2, model: 2}, and SDXL
    with its refiner at {data: 2}: inverted latents 1e-4, frames within
    the same mean |diff| bars (0.02 with a model axis, 2e-3 without) of
    the one-process run in the same ranks;
  * identical random weights on every rank; a rank whose weights differ is
    refused, and so is a mesh larger than the ranks;
  * ``parallel/dryrun.py`` at 4 ranks on the CPU (``--device cpu``), and
    its refusal without a card when the CPU was not asked for.
"""

from __future__ import annotations

import copy
import os
import threading

import numpy as np
import pytest
import torch

from tests.torch_parity import (jax_block_draws, jax_draw_table,
                                port_bundle_from_jax, psnr, to_np)
from vidtome_torch.models.layers import GEGLUFeedForward, TransformerBlock
from vidtome_torch.parallel import dryrun
from vidtome_torch.parallel.launch import spawn
from vidtome_torch.parallel.mesh import (Mesh, Rows, param_spec,
                                         shard_params, split_sizes)

torch.set_num_threads(2)

RANKS = 4
INT8_UNET_TOL = 2e-2  # of max |ref|: about 2.5 int8 steps of the output's max
TIMEOUT = 240  # seconds for the whole group; a hung collective fails too
N_FRAMES = 8
STEPS = 2


def _pipeline_config() -> dict:
    return {
        "sd_version": "1.5", "height": 64, "width": 64, "seed": 123,
        "work_dir": "unused", "float_precision": "fp32",
        "inversion": {"prompt": "a colorful gradient", "steps": STEPS,
                      "save_steps": STEPS, "batch_size": 4},
        "generation": {
            "control": "none", "guidance_scale": 7.5,
            "n_timesteps": STEPS, "negative_prompt": "blurry",
            "prompt": {"edit": "a colorful gradient, oil painting"},
            "chunk_size": 4, "chunk_ord": "mix-4", "local_merge_ratio": 0.9,
            "merge_global": True, "global_merge_ratio": 0.8,
            "align_batch": True, "share_match": True, "len_quantum": 1024}}


def _controlnet_config() -> dict:
    """The pipeline's config with a canny ControlNet in both stages."""
    cfg = _pipeline_config()
    cfg["inversion"].update(control="canny", control_scale=0.7)
    cfg["generation"].update(control="canny", control_scale=0.7)
    return cfg


def _xl_config() -> dict:
    """The pipeline's config on SDXL, the tiny refiner from step 2 of 4."""
    cfg = _pipeline_config()
    cfg["sd_version"] = "xl"
    cfg["generation"].update(n_timesteps=4, align_batch=False, refiner={
        "sd_version": "tiny-refiner", "denoising_start": 0.5})
    return cfg


def _frames() -> np.ndarray:
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64
    out = []
    for i in range(N_FRAMES):
        ph = i / N_FRAMES
        out.append(np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (xx + ph)),
                             0.5 + 0.5 * np.cos(2 * np.pi * (yy + ph / 2)),
                             np.full_like(xx, 0.3 + 0.2 * ph)], -1))
    return np.stack(out).astype(np.float32)


def _inputs(rng) -> dict:
    def x(n):
        return torch.from_numpy(rng.normal(size=(n, 16, 16, 4)).astype(
            np.float32))

    def ctx(lanes, frames):
        return torch.from_numpy(np.repeat(rng.normal(
            size=(lanes, 16, 32)).astype(np.float32), frames, 0))

    import jax

    out = {"x": x(8), "ctx": ctx(2, 4), "xa": x(8), "xb": x(8),
           "x3a": x(12), "x3b": x(12), "ctx3": ctx(3, 4), "x16": x(16),
           "x6a": x(6), "x6b": x(6), "ctx6": ctx(2, 3)}
    out["ctx16"] = out["ctx"].repeat_interleave(2, 0)
    local_a, coin_a = jax_block_draws(jax.random.key(40), 4, 4)
    local_b, coin_b = jax_block_draws(jax.random.key(41), 4, 4)
    local_3, coin_3 = jax_block_draws(jax.random.key(42), 3, 4)
    out.update(draws_a=local_a + [coin_a], draws_b=local_b + [coin_b],
               draws3=local_3 + [coin_3])
    return out


def _jax_side(jb, fwd, work: str) -> dict:
    """JAX's unsharded forward of the dp_tp input and its one-device
    pipeline frames (its inversion writes under ``work``)."""
    import jax.numpy as jnp

    from vidtome_tpu.config import Config
    from vidtome_tpu.models.unet import TINY_UNET, UNet2DConditionModel
    from vidtome_tpu.pipeline.generator import Generator as JGen
    from vidtome_tpu.pipeline.inverter import Inverter as JInv

    model = UNet2DConditionModel(config=TINY_UNET, dtype=jnp.float32,
                                 use_pallas=False)
    forward = np.asarray(model.apply(
        {"params": jb.unet_params}, jnp.asarray(fwd["x"].numpy()),
        jnp.asarray(10), jnp.asarray(fwd["ctx"].numpy())))
    cfg = Config(_pipeline_config())
    frames = _frames()
    jinv = JInv(jb, cfg)
    lat = jinv.vae.encode(frames)
    conds = jinv.text([cfg.inversion.prompt] * N_FRAMES)
    inv = np.asarray(jinv.ddim_inversion(lat, conds, None, None, work))
    jgen = JGen(jb, cfg)
    jgen.configure_frames(N_FRAMES)
    jgen.depth = jgen.control_images = None
    clean = jgen.ddim_sample(inv[jgen.pad_src], jgen._build_context(
        cfg.generation.prompt["edit"]))
    return {"forward": forward,
            "frames": np.asarray(jgen.vae.decode(clean[:N_FRAMES]))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The scenarios' results ({name: saved dict}), the JAX side and the
    one-process pipeline of the port."""
    from tests.helpers import make_tiny_bundle
    from tests.torch_ranks import _pipeline, scenarios
    from vidtome_torch.config import Config
    from vidtome_torch.pipeline.generator import Generator

    out = str(tmp_path_factory.mktemp("ranks"))
    jb = make_tiny_bundle()
    tb = port_bundle_from_jax(jb)
    fwd = _inputs(np.random.default_rng(0))
    cfg = Config(_pipeline_config())
    gen = Generator(tb, cfg)
    gen.configure_frames(N_FRAMES)
    table = jax_draw_table(123, STEPS, gen.fidx_table().shape[1], 4, 4)
    torch.save({"weights": {k: getattr(tb, k).state_dict() for k in
                            ("unet", "vae", "text_encoder")},
                "forward": fwd, "pipeline_config": _pipeline_config(),
                "frames": _frames(), "draws_table": table,
                "controlnet_config": _controlnet_config(),
                "xl_config": _xl_config(),
                "xl_latents": torch.from_numpy(np.random.default_rng(
                    1).standard_normal((N_FRAMES, 8, 8, 4), np.float32))},
               os.path.join(out, "payload.pt"))
    failed = []

    def run():
        try:
            spawn(scenarios, RANKS, (out,), ["cpu"] * RANKS,
                  timeout=TIMEOUT, collective_timeout=TIMEOUT)
        except BaseException as exc:  # re-raised in the test process
            failed.append(exc)

    thread = threading.Thread(target=run)
    thread.start()
    try:
        jax_side = _jax_side(jb, fwd, str(tmp_path_factory.mktemp("jax")))
        with torch.no_grad():
            inverted, frames = _pipeline(tb, cfg, _frames(), table)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    results = {name[:-3]: torch.load(os.path.join(out, name),
                                     weights_only=False)
               for name in os.listdir(out) if name != "payload.pt"}
    return results, jax_side, {"inverted": inverted, "frames": frames}


def test_param_spec_rules():
    """``tests/test_parallel.py::test_param_spec_rules`` on the port's
    names ([out, in] weights: column-parallel shards dim 0)."""
    blk = "down_blocks.0.attentions.0.transformer_blocks.0"
    assert param_spec(f"{blk}.attn1.to_q.weight") == ("model", None)
    assert param_spec(f"{blk}.attn2.to_v.weight") == ("model", None)
    assert param_spec(f"{blk}.attn1.to_out.0.weight") == (None, "model")
    assert param_spec(f"{blk}.attn1.to_out.0.bias") == ()
    assert param_spec(f"{blk}.ff.net.0.proj.weight") == ("model", None)
    assert param_spec(f"{blk}.ff.net.0.proj.bias") == ("model",)
    assert param_spec(f"{blk}.ff.net.2.weight") == (None, "model")
    assert param_spec("mid_block.attentions.0.transformer_blocks.0.attn1."
                      "to_q.bias") == ("model",)
    assert param_spec("conv_in.weight") == ()
    assert param_spec("time_embedding.linear_1.weight") == ()


@pytest.mark.parametrize("rank", [0, 1])
def test_geglu_column_shard_keeps_value_and_gate(rank):
    """Each model rank holds its run of the value half and the same run of
    the gate half of ``ff.net.0.proj``: its GEGLU output is that run of the
    whole layer's."""
    torch.manual_seed(0)
    ff = GEGLUFeedForward(16)
    x = torch.randn(3, 5, 16)
    with torch.no_grad():
        whole = ff.net[0](x)
        proj = ff.net[0].proj.weight.clone()
        mesh = Mesh(1, 2, rank=rank)
        shard_params(mesh, torch.nn.ModuleDict({"ff": ff}))
        a, b = (0, 32) if rank == 0 else (32, 64)
        want = torch.cat([proj[a:b], proj[64 + a:64 + b]])
        assert torch.equal(ff.net[0].proj.weight, want)
        torch.testing.assert_close(ff.net[0](x), whole[..., a:b])
        assert ff.net[2].weight.shape == (16, 32)
        assert ff.net[2].tp.row_parallel and not ff.net[0].proj.tp.row_parallel


def test_heads_split_whole_and_uneven():
    """5 heads on 2 model ranks: 3 and 2 whole heads (SD2.1's level 0),
    never a split inside a head; the out projection's columns follow."""
    for rank, (h0, h1) in enumerate([(0, 3), (3, 5)]):
        torch.manual_seed(0)
        blk = TransformerBlock(40, 5, 8, 12, downsample=1)
        q = blk.attn1.to_q.weight.clone()
        out = blk.attn1.to_out[0].weight.clone()
        shard_params(Mesh(1, 2, rank=rank), blk)
        assert blk.attn1.heads == h1 - h0 and blk.attn1.total_heads == 5
        assert torch.equal(blk.attn1.to_q.weight, q[h0 * 8:h1 * 8])
        assert torch.equal(blk.attn1.to_out[0].weight, out[:, h0 * 8:h1 * 8])
        assert blk.attn1.to_q.tp.sizes == [24, 16]


@pytest.mark.parametrize("rank", [0, 1])
def test_lora_merges_into_a_sharded_unet(rank):
    """A LoRA merged after the UNet is sharded (the CLI shards the bundle
    at set-up, the Generator merges its LoRA later) leaves every layer
    with its part of the whole layer's merged weight."""
    from tests.test_torch_lora import kohya_lora
    from vidtome_torch.models.lora import merge_lora_state
    from vidtome_torch.models.unet import TINY_UNET, UNet2DConditionModel

    torch.manual_seed(0)
    whole = UNet2DConditionModel(TINY_UNET)
    sharded = shard_params(Mesh(1, 2, rank=rank), copy.deepcopy(whole))
    state = kohya_lora(whole, torch.nn.Module())
    assert merge_lora_state(whole, state) == merge_lora_state(sharded, state)
    every = dict(whole.named_parameters())
    for name, p in sharded.named_parameters():
        tp = getattr(sharded.get_submodule(name.rpartition(".")[0]), "tp",
                     None)
        want = every[name]
        if tp is not None and (p.ndim > 1 or not tp.row_parallel):
            want = want.index_select(tp.dim if p.ndim > 1 else 0, tp.index)
        torch.testing.assert_close(p, want, rtol=0, atol=0)


def test_rows_pad_and_drop():
    """6 rows on 4 data ranks: 2 a rank, the last rank's padded with a copy
    of the last row; the joined rows and lane-0 rows each rank needs."""
    index = [Rows(Mesh(4, 1, rank=r), 6).index for r in range(4)]
    assert index == [[0, 1], [2, 3], [4, 5], [5, 5]]
    x = torch.arange(6)
    assert Rows(Mesh(4, 1, rank=3), 6).take(x).tolist() == [5, 5]
    assert Rows(Mesh(4, 1, rank=1), 6).take(x).tolist() == [2, 3]
    rows = Rows(Mesh(2, 2, rank=2), 12)  # data rank 1 of 2: rows 6..11
    assert rows.index == list(range(6, 12))
    assert rows.joined(4) == (slice(1, 3), [2, 3, 4, 5, 6, 7])
    assert rows.lane0(3) == [2, 3, 0, 1, 2, 3]
    assert split_sizes(5, 2) == [3, 2]


def test_collectives_on_meta_give_shapes():
    """A mesh without process groups runs collectives on meta tensors as
    shapes (what a meta-device forward of one rank needs), and refuses
    them on real tensors."""
    mesh = Mesh(4, 2, rank=5, device="meta")
    t = torch.empty(3, 7, device="meta")
    assert mesh.all_gather(t, "data").shape == (12, 7)
    assert mesh.all_gather(t, "model", 1, [7, 6]).shape == (3, 13)
    assert mesh.all_reduce(t, "model").shape == (3, 7)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.all_reduce(torch.ones(2), "model")
    assert torch.equal(Mesh(1, 1).all_reduce(torch.ones(2), "model"),
                       torch.ones(2))


def test_dp_tp_forward_matches_one_process_and_jax(ranks):
    res, jax_side, _ = ranks
    got = res["dp_tp"]["meshed"][0]
    torch.testing.assert_close(got, res["dp_tp"]["single"][0], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(to_np(got), jax_side["forward"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["merged", "ldm", "pnp", "chunk_batch",
                                  "uneven"])
def test_merged_forwards_on_the_data_axis(ranks, name):
    """Every call of the scenario within 1e-5 of the one-process call, and
    the merge plans (local rounds and the global merge, every level) the
    same index for index."""
    r = ranks[0][name]
    assert len(r["meshed"]) == len(r["single"]) == 2
    for got, want in zip(r["meshed"], r["single"]):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert r["single_plans"] and len(r["meshed_plans"]) == len(
        r["single_plans"])
    for got, want in zip(r["meshed_plans"], r["single_plans"]):
        assert torch.equal(got, want)


def test_int8_on_the_model_axis(ranks):
    """The sharded int8 table is the whole table sliced with its layers; a
    row-parallel int8 layer (the whole row's activation scale, the int32
    sums summed exact) gives the whole layer's output bit for bit; the
    UNet call within INT8_UNET_TOL of the one-process call."""
    r = ranks[0]["int8"]
    assert r["row_layers"] > 0
    assert r["table_differs"] == [] and r["row_layers_differ"] == []
    got, want = r["meshed"][0], r["single"][0]
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= INT8_UNET_TOL, err


@pytest.mark.parametrize("shape,bar", [("4x1", 2e-3), ("2x2", 0.02)])
def test_pipeline_on_a_mesh(ranks, shape, bar):
    """The tiny invert -> generate on the mesh against the one-process run
    (``tests/test_pipeline_mesh.py``'s bars) and the JAX package's frames
    (the repo's 35 dB floor)."""
    res, jax_side, single = ranks
    r = res[f"pipeline_{shape}"]
    torch.testing.assert_close(r["inverted"], single["inverted"], rtol=0,
                               atol=1e-4)
    frames = to_np(r["frames"])
    assert frames.shape == (N_FRAMES, 64, 64, 3) and np.isfinite(
        frames).all()
    diff = np.abs(frames - to_np(single["frames"])).mean()
    assert diff < bar, diff
    assert psnr(frames, jax_side["frames"]) >= 35.0


def test_controlnet_on_a_mesh(ranks):
    """A canny ControlNet in both stages at {data: 2, model: 2} (the
    ControlNet sharded with the UNet, its rows split with the UNet's):
    the inverted latents within 1e-4 of the one-process run's, the frames
    within the model axis' bar of test_pipeline_on_a_mesh."""
    r = ranks[0]["controlnet_2x2"]
    (inv_s, frames_s), (inv_m, frames_m) = r["single"], r["meshed"]
    torch.testing.assert_close(inv_m, inv_s, rtol=0, atol=1e-4)
    assert frames_m.shape == (N_FRAMES, 64, 64, 3)
    assert torch.isfinite(frames_m).all()
    diff = (frames_m - frames_s).abs().mean().item()
    assert diff < 0.02, diff


def test_sdxl_and_refiner_on_the_data_axis(ranks):
    """SDXL's two-stage generation (the base's pooled embeds and time ids
    split with the rows; the refiner's Generator on the same mesh) at
    {data: 2}: the frames within the data axis' bar of
    test_pipeline_on_a_mesh."""
    r = ranks[0]["xl_2x1"]
    assert r["meshed"].shape == (N_FRAMES, 64, 64, 3)
    assert torch.isfinite(r["meshed"]).all()
    diff = (r["meshed"] - r["single"]).abs().mean().item()
    assert diff < 2e-3, diff


def test_identical_random_weights_on_every_rank(ranks):
    every = ranks[0]["weights"]["checksums"]
    assert every.shape[0] == RANKS
    assert all(torch.equal(every[r], every[0]) for r in range(RANKS))


def test_differing_weights_and_oversized_mesh_are_refused(ranks):
    r = ranks[0]["refusals"]
    assert "the weights of ranks [3] differ" in r["differ"]
    assert "need 8 devices" in r["too_big"]


def test_process_group_markers(monkeypatch):
    """``initialize_multihost``: an implicit call without a launcher's
    markers does nothing; ``multihost: true`` with nothing to say where
    the ranks are raises, and so does one whose keys leave the rank unset
    with no start to give it; torchrun's RANK / WORLD_SIZE (and
    MASTER_ADDR / PORT) are joined, a second call finds the group
    (idempotent)."""
    import torch.distributed as dist

    from vidtome_torch.parallel import distributed as pd
    from vidtome_torch.parallel.launch import free_port

    for var in pd.LAUNCHER_MARKERS + ("LOCAL_RANK",):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert pd.initialize_multihost() is False
    assert pd.initialize_from_config({"mesh": {"data": 1}}) is False
    with pytest.raises(RuntimeError, match="say where the ranks are"):
        pd.initialize_from_config({"multihost": True})
    with pytest.raises(ValueError, match="process id"):
        pd.initialize_multihost("localhost:1", num_processes=1, force=True)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    try:
        assert pd.initialize_from_config(None) is True
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert pd.initialize_multihost() is True
    finally:
        dist.destroy_process_group()


def test_dryrun_four_ranks(capfd):
    dryrun.dryrun(RANKS, "cpu", timeout=TIMEOUT)
    out = capfd.readouterr().out
    assert "[dryrun] OK: the serving generation ran 8 steps on 4 ranks" in out


def test_dryrun_runs_on_the_cards_unless_asked():
    """Without ``--device cpu`` the dry run is the cards': where there is
    none it refuses before it starts a rank."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="--device cpu"):
        dryrun.main(["2"])
