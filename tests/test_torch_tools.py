"""The port's tools (``vidtome_torch/tools/``) against the repo's JAX tools.

- ``tools/profiles.py`` holds ``bench.py``'s serving-profile tables, and
  ``tools/quality_gate.py`` the JAX gate tool's ``GATES`` / ``INV_GATES``
  and its clip, equal (both JAX files loaded with ``importlib``, as
  ``tests/test_quality_gate.py`` does; the gate tool's compilation-cache
  setting is undone after loading).
- ``run_parity`` on the tiny stack writes ``parity.json`` with the keys the
  JAX tool's record has and passes its ``--ref-frames`` self-check (the
  edit against itself: inf dB); its synthetic clip is the JAX tool's.
- ``run_gen_gate`` and ``run_inv_gate`` each run one gate (2 frames, 2
  steps), and ``main`` writes its record under ``--out``, with the
  device it ran on as the backend.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import types

import numpy as np
import pytest
import torch

from tests.helpers import make_tiny_video
from vidtome_torch.testing import make_tiny_bundle
from vidtome_torch.tools import parity_run, profiles, quality_gate

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_TABLES = ("SERVE_PROFILES", "INV_SERVE_PROFILES",
                  "DEFAULT_SERVE_PROFILE", "DEFAULT_INV_SERVE_PROFILE")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _load("bench", "bench.py")


@pytest.fixture(scope="module")
def jax_qgate(tmp_path_factory):
    """tools/quality_gate.py; it turns on JAX's persistent compilation
    cache when loaded, which is put back as it was."""
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    env = os.environ.get("VIDTOME_CACHE_DIR")
    os.environ["VIDTOME_CACHE_DIR"] = str(tmp_path_factory.mktemp("xla"))
    try:
        return _load("quality_gate", "tools/quality_gate.py")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if env is None:
            os.environ.pop("VIDTOME_CACHE_DIR")
        else:
            os.environ["VIDTOME_CACHE_DIR"] = env


@pytest.mark.parametrize("name", PROFILE_TABLES)
def test_profiles_equal_bench(bench, name):
    assert getattr(profiles, name) == getattr(bench, name)


@pytest.mark.parametrize("name", ["GATES", "INV_GATES"])
def test_gate_tables_equal_jax(jax_qgate, name):
    assert getattr(quality_gate, name) == getattr(jax_qgate, name)


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_make_clip_equals_jax(jax_qgate, seed):
    np.testing.assert_array_equal(quality_gate.make_clip(4, 32, seed),
                                  jax_qgate.make_clip(4, 32, seed))


def test_make_configs_carry_the_jax_keys(jax_qgate, tmp_path):
    for fn, kw in (("make_config", dict(local_merge_ratio=0.95)),
                   ("make_inv_config", dict(quant="int8"))):
        got = getattr(quality_gate, fn)(2, 3, 64, 5, work_dir=str(tmp_path),
                                        **kw)
        want = getattr(jax_qgate, fn)(2, 3, 64, 5, **kw)
        stage = "generation" if "generation" in want else "inversion"
        assert set(got) == set(want) and set(got[stage]) == set(want[stage])
        for k, v in want[stage].items():
            if "path" not in k:
                assert got[stage][k] == v, k


def _jax_record_keys(profiles_checked) -> set[str]:
    """The keys tools/parity_run.py writes into its record, read from its
    source: the literal keys, and the profile keys for each profile."""
    with open(os.path.join(ROOT, "tools", "parity_run.py")) as f:
        src = f.read()
    keys = set(re.findall(r'record\["([a-z_0-9]+)"\]', src))
    head = src[src.index("record: dict = {"):]
    keys |= set(re.findall(r'"([a-z_]+)":', head[:head.index("}")]))
    for name in profiles_checked:
        keys |= {f"profile_{name}_psnr_db", f"profile_{name}_gate_35db"}
    return keys


def test_run_parity_tiny(tmp_path):
    clip = make_tiny_video(str(tmp_path / "clip"), n_frames=4, size=64)
    work = str(tmp_path / "work")
    checked = ("int8", f"serve_{profiles.DEFAULT_SERVE_PROFILE}")
    record = parity_run.run_parity(
        make_tiny_bundle(), work, clip, frames=4, steps=2, size=64,
        edit_prompt="an oil painting", inv_prompt="a colorful gradient",
        check_profiles=checked)
    want = _jax_record_keys(checked) - {"vs_reference", "baseline_gate_35db"}
    assert set(record) == want
    assert np.isfinite(record["inversion_recon_psnr_db"])
    assert record["edit_frames"] == 4 and record["random_weights"] is True
    for name in checked:
        assert np.isfinite(record[f"profile_{name}_psnr_db"])
    with open(os.path.join(work, "parity.json")) as f:
        assert json.load(f) == record
    # the --ref-frames path: the edit scored against itself
    again = parity_run.run_parity(
        make_tiny_bundle(), work, clip, frames=4, steps=2, size=64,
        edit_prompt="an oil painting", inv_prompt="a colorful gradient",
        ref_frames=record["edit_output_dir"])
    assert set(again) == _jax_record_keys(())
    assert again["baseline_gate_35db"] is True
    assert again["vs_reference"]["psnr_mean"] == float("inf")


def test_ensure_clip_equals_jax(tmp_path):
    jax_parity = _load("parity_run", "tools/parity_run.py")
    got = parity_run._ensure_clip(None, str(tmp_path / "port"), 4, 32)
    want = jax_parity._ensure_clip(None, str(tmp_path / "jax"), 4, 32)
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name in os.listdir(want):
        with open(os.path.join(got, name), "rb") as a, \
                open(os.path.join(want, name), "rb") as b:
            assert a.read() == b.read()
    assert parity_run._ensure_clip("given.mp4", str(tmp_path), 4, 32) == \
        "given.mp4"


@pytest.mark.parametrize("gate", ["int8", "chunk_ragged_pad", "inv_int8"])
def test_one_gate_runs(tmp_path, gate):
    args = types.SimpleNamespace(frames=2, steps=2, size=64, seeds=1,
                                 sd="1.5", work=str(tmp_path))
    bundle = make_tiny_bundle()
    if gate in quality_gate.INV_GATES:
        vals = quality_gate.run_inv_gate(bundle, gate, args, {})
    else:
        n_frames, vals = quality_gate.run_gen_gate(bundle, gate, args, {})
        assert n_frames == 2
    assert len(vals) == 1 and np.isfinite(vals[0])


def test_gate_main_writes_records(tmp_path):
    out = tmp_path / "records"
    records = quality_gate.main([
        "--gate", "int8,share_match", "--seeds", "1", "--frames", "2",
        "--steps", "2", "--size", "64", "--sd", "tiny", "--device", "cpu",
        "--work", str(tmp_path), "--out", str(out)])
    assert [r["gate"] for r in records] == ["int8_tiny", "share_match_tiny"]
    for rec in records:
        with open(out / f"{rec['gate']}.json") as f:
            saved = json.load(f)
        assert saved["backend"] == "cpu" and saved["psnr_mean_db"] == \
            rec["psnr_mean_db"]
    assert 0.0 < quality_gate.share_match_plan_overlap(
        make_tiny_bundle(), 2, 64, 0) <= 1.0
