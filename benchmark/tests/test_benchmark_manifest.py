"""BENCHMARK.json and the files it names: present, well formed, in the
characters and ranges the benchmark's contract allows."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"expansion|_dim$|_rank$|channels|experts_per_tok)")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_plain(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_entries():
    end = {m["name"] for m in SPEC["end_to_end"]}
    assert {"frames_per_s", "peak_mem_gib", "setup_s"} <= end
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in end
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_exist(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and 0 < len(cell["why"]) <= 200
    assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    cfg = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    assert (ROOT / cfg["file"]).is_file()
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    limits = json.loads(
        (BENCH / "limits" / f"{cell['name']}.json").read_text())
    assert set(limits) == {"enc_err", "inv_eps_err", "inv_step_err",
                           "gen_out_err", "gen_step_err", "dec_err"}
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("benchmark/configs/")
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])
    model = json.loads((ROOT / cfg["file"]).read_text())
    assert model["reduced"] == cfg["reduced"]
    assert not [k for k in cfg["reduced"] if WIDTH.search(k)]
    assert model["source"] == cfg["source"]
    assert model["dtype"] == "bf16"


@pytest.mark.parametrize("mix", sorted(p.stem for p in
                                       (BENCH / "traffic").glob("*.json")))
def test_traffic_is_data(mix):
    t = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    assert t["frames"] >= 1 and t["max_edits"] >= 2
    assert set(t["config"]) >= {"inversion", "generation"}
    # every edit's prompts fill from the words given
    for key in re.findall(r"{(\w+)}", t["source"] + t["edit"]):
        assert t["words"][key]


@pytest.mark.parametrize("mix", sorted(p.stem for p in
                                       (BENCH / "traffic").glob("*.json")))
def test_harness_and_reference_drive_every_key(mix):
    from benchmark.harness import program
    from benchmark.reference import pipeline

    cfg = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    cfg = dict(cfg["config"], sd_version="1.5")
    assert program.unsupported(cfg) == []
    assert pipeline.unsupported(cfg) == []


@pytest.mark.parametrize("stage,key,value", [
    ("generation", "cache_schedule", "full:6,uniform:12"),
    ("generation", "cfg_interval", 2),
    ("inversion", "eps_schedule", "full:6,uniform:3"),
    ("generation", "control", "canny"),
    ("generation", "refiner", {"denoising_start": 0.8}),
])
def test_keys_the_harness_cannot_check_are_refused(stage, key, value):
    """A mix that turns on what the reference does not implement is
    refused, not measured under another path's name."""
    from benchmark.reference import pipeline

    cfg = json.loads((BENCH / "traffic" / "exact-cb-32f.json").read_text())
    cfg = dict(cfg["config"], sd_version="1.5", seed=1)
    cfg[stage] = dict(cfg[stage], **{key: value})
    assert pipeline.unsupported(cfg)
    with pytest.raises(NotImplementedError):
        pipeline.Edit(torch.nn.Linear(1, 1), None, None, cfg)
