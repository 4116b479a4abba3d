"""The run's last line and its exits: no card, no cell, no program."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import torch

import _portbench_support as sup
from portbench import harness, registry

ROOT = registry.ROOT
CELL = "stream1k-powershift"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _null(monkeypatch):
    monkeypatch.setattr(registry, "driver_class",
                        lambda kind, here=None: sup.NullDriver)


def test_last_line_shape(monkeypatch):
    _null(monkeypatch)
    cell, config = sup.tiny(CELL)
    out = harness.measure(sup.args(CELL, 0.3), cell, config,
                          torch.device("cpu"))
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == len(line["window"]["op_ms"])
    assert set(line["metrics"]) == {"blocks_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"] == {"things_wrong": {"value": 0, "limit": 0}}


def test_traced_line_has_the_layers_and_a_breakdown(monkeypatch):
    _null(monkeypatch)
    cell, config = sup.tiny(CELL)
    out = harness.measure(sup.args(CELL, 0.3, trace=1), cell, config,
                          torch.device("cpu"))
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())
    assert out["breakdown"]["idle_gaps"][0][0] == "null.op"
    # the null driver keeps no layer readings and the CPU no kernels:
    # the idle share is what is read
    assert set(out["metrics"]) == {"idle_pct.stream"}
    assert list(out)[-1] == "checks"


def _run(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL,
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=env)


def test_no_card_exits_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(ROOT, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_unknown_cell_exits_without_a_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "../BENCHMARK", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_a_checkout_without_the_program_exits_without_a_result(tmp_path):
    """Only BENCHMARK.json and portbench/: no result, whether or not a
    card is present."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    # with a card present, the harness stops at the missing program
    code = ("import sys, torch, importlib.util;"
            "torch.cuda.is_available = lambda: True;"
            "torch.cuda.device_count = lambda: 1;"
            "sys.path[0] = '.';"
            "from portbench import harness;"
            f"sys.exit(harness.main(['--workload', '{CELL}',"
            " '--seed', '1', '--seconds', '1']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 4 and p.stdout.strip() == ""
    assert importlib.util.find_spec("cometbft_tpu_torch") is not None


def test_seed_past_32_bits_and_zero():
    for seed in (0, 2**31 + 5, 2**40 + 1):
        assert harness.parse(["--workload", "x", "--seed", str(seed),
                              "--seconds", "1"]).seed == seed

