"""BENCHMARK.json and the files agree, and a new cell is new files and
entries only."""
import json
import shutil

import pytest
import torch

import _portbench_support as sup
from portbench import harness, registry

torch.set_num_threads(1)
BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_file_matches_its_entry(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = registry.cell(name)
    assert cell["name"] == name
    assert (cell["config"], cell["traffic"]["name"], cell["chips"],
            cell["why"]) == (entry["config"], entry["traffic"],
                             entry["chips"], entry["why"])
    assert registry.driver_class(cell["traffic"]["kind"]) is not None
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert config["file"] == f"portbench/configs/{entry['config']}.json"
    on_disk = registry.config(entry["config"])
    assert (on_disk["source"], on_disk["reduced"]) == (config["source"],
                                                       config["reduced"])


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_what_the_contract_asks(name):
    e2e = [m["name"] for m in registry.metrics_for(BENCH, name, False)]
    layer = registry.metrics_for(BENCH, name, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e          # the metric it moves is here too
        registry.reader(m["name"])


def test_names_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in layer and len(layer) <= 200 for layer in layers)
    for name in names + CELLS:
        assert registry.NAME.match(name), name


def _copy(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(registry.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return here


def test_a_new_cell_is_found_without_an_edit(tmp_path, monkeypatch):
    """A later change adds a cell: a cell file, a configuration file and a
    metric reader, and entries in BENCHMARK.json. The harness finds all of
    them by name, and a tiny copy of the new cell runs on the CPU."""
    from cometbft_tpu_torch.blocksync import pipeline

    here = _copy(tmp_path)
    config = registry.config("ed25519-1k-chain")
    config.update(name="ed25519-500-chain", validators=500)
    (here / "configs" / "ed25519-500-chain.json").write_text(
        json.dumps(config))
    cell = registry.cell("stream1k-powershift")
    cell.update(name="stream500-powershift", config="ed25519-500-chain",
                why="a test")
    cell["traffic"].update(name="runs32-powershift", run=32)
    (here / "cells" / "stream500-powershift.json").write_text(
        json.dumps(cell))
    (here / "metrics" / "calls.stream.py").write_text(
        "def read(rec):\n    return float(len(rec.op_ms))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "stream500-powershift",
                               "config": "ed25519-500-chain",
                               "traffic": "runs32-powershift", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "blocks_per_s":
            m["workloads"].append("stream500-powershift")
    bench["per_layer"].append({
        "name": "calls.stream", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "stream loop",
        "moves": "blocks_per_s", "workloads": ["stream500-powershift"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    got = registry.cell("stream500-powershift", here)
    assert registry.config(got["config"], here)["validators"] == 500
    assert registry.driver_class(got["traffic"]["kind"], here)
    found = registry.benchmark(tmp_path)
    assert [m["name"] for m in registry.metrics_for(
        found, "stream500-powershift", False)] == ["blocks_per_s", "setup_s"]
    assert [m["name"] for m in registry.metrics_for(
        found, "stream500-powershift", True)] == ["calls.stream"]

    # the harness, pointed at the copy, runs it (tiny, on the CPU)
    monkeypatch.setattr(registry, "HERE", here)
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    for fn in (registry.cell, registry.config, registry.driver_class,
               registry.reader):
        monkeypatch.setattr(fn, "__defaults__", (here,))
    monkeypatch.setattr(registry.benchmark, "__defaults__", (tmp_path,))
    monkeypatch.setattr(pipeline, "MAX_COMMITS_PER_CHUNK", 4)
    cell, config = registry.cell("stream500-powershift"), registry.config(
        "ed25519-500-chain")
    config.update(validators=40, heights=8)
    cell["traffic"].update(run=4, ref_rows=4, profile_ops=1)
    for trace, want in ((0, {"blocks_per_s", "setup_s"}),
                        (1, {"calls.stream"})):
        out = harness.measure(sup.args("stream500-powershift", 1.0, trace),
                              cell, config, torch.device("cpu"))
        assert out["correct"] and set(out["metrics"]) == want
