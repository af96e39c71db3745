"""BENCHMARK.json and the harness's data files: every cell, configuration
and metric parses and has its file; a cell, a configuration or a metric
added as a file (with its BENCHMARK.json entry) is found with no code
edited."""

import json
import os
import re
import shutil

import pytest

from bench_port.lib import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "bench_port/run.py"]
    assert b["paths"] == ["bench_port"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_parse(cell):
    spec = harness.cell_spec(cell)
    w = spec["workload"]
    entry = next(x for x in spec["bench"]["workloads"] if x["name"] == cell)
    assert w["traffic"]["name"] == entry["traffic"]
    assert w["why"] == entry["why"] and len(w["why"]) <= 200
    assert os.path.exists(os.path.join(ROOT, "bench_port", "entries",
                                       f"{w['entry']}.py"))
    assert spec["config"]["yaml"].startswith("configs/")
    assert entry["chips"] == 1
    b = spec["bench"]
    moved = {m["name"] for m in harness.metrics_for(b, cell, "end_to_end")}
    assert "setup_s" in moved and len(moved) >= 2
    layer = harness.metrics_for(b, cell, "per_layer")
    assert layer and all(m["moves"] in moved for m in layer)


@pytest.mark.parametrize("conf", bench()["configs"],
                         ids=lambda c: c["name"])
def test_config_files_parse(conf):
    data = harness.load_json(os.path.join(ROOT, conf["file"]))
    assert conf["file"].startswith("bench_port/configs/")
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    assert os.path.exists(os.path.join(ROOT, data["yaml"]))


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    bench()["end_to_end"]
                                    + bench()["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric).read)


def test_an_added_cell_config_and_metric_are_found(tmp_path):
    """A copy of the benchmark with one more configuration, one more cell
    (its workload file and entry) and one more per-layer metric (its
    reader and entry): the harness finds each by name, no harness file
    edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench_port"), root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    work = harness.load_json(os.path.join(ROOT, "bench_port", "workloads",
                                          "gan.train.json"))
    work["traffic"]["name"] = "patches_b8_more_views"
    work["traffic"]["fixture"]["n_train"] = 32
    (root / "bench_port" / "workloads" / "gan.train32.json").write_text(
        json.dumps(work))
    conf = harness.load_json(os.path.join(ROOT, "bench_port", "configs",
                                          "texture_gan.json"))
    conf["set"]["batch_size"] = 16
    (root / "bench_port" / "configs" / "texture_gan_b16.json").write_text(
        json.dumps(conf))
    b["configs"].append({"name": "texture_gan_b16", "source": conf["source"],
                         "file": "bench_port/configs/texture_gan_b16.json",
                         "reduced": [], "why": "a larger batch"})
    b["workloads"].append({"name": "gan.train32", "config": "texture_gan_b16",
                           "traffic": "patches_b8_more_views", "chips": 1,
                           "why": work["why"]})
    (root / "bench_port" / "metrics" / "busy_ms.train.py").write_text(
        "def read(run):\n    return 1.5\n")
    b["per_layer"].append({"name": "busy_ms.train", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "train_rays_per_s",
                           "workloads": ["gan.train32"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "gan.train" in m["workloads"]:
            m["workloads"].append("gan.train32")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    spec = harness.cell_spec("gan.train32", root=str(root))
    assert spec["workload"]["traffic"]["fixture"]["n_train"] == 32
    assert spec["config"]["set"]["batch_size"] == 16
    names = [m["name"] for m in harness.metrics_for(spec["bench"],
                                                     "gan.train32",
                                                     "per_layer")]
    assert names == ["busy_ms.train"]
    assert harness.reader("busy_ms.train", root=str(root)).read(None) == 1.5
    with pytest.raises(KeyError):
        harness.cell_spec("gan.train64", root=str(root))
