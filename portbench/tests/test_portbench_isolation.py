"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program: a test here and a check at run time."""
import ast
import json
import subprocess
import sys

import pytest
import torch

import _portbench_support as sup
from portbench import harness, isolation, registry

ROOT = registry.ROOT
REFERENCE = ["portbench.reference.ed25519", "portbench.reference.canonical",
             "portbench.reference.verdicts", "portbench.fixtures",
             "portbench.frozen.opcounts", "portbench.stats"]


def _loaded(code: str) -> set:
    """The top-level names of every module a fresh interpreter holds
    after running `code` from the checkout's root."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_names_are_compared():
    assert isolation.loaded_forbidden(["cometbft_tpu_torch.ops", "jaxtyping",
                                       "flaxen", "numpy"]) == []
    assert isolation.loaded_forbidden(["cometbft_tpu.types", "jax.numpy",
                                       "jaxlib", "flax.linen"]) == \
        ["cometbft_tpu", "flax", "jax", "jaxlib"]


def test_harness_drivers_readers_and_program_load_no_jax():
    """Every module of the harness, each driver with the program modules
    it drives, and every metric reader."""
    kinds = sorted({registry.cell(w["name"])["traffic"]["kind"]
                    for w in registry.benchmark()["workloads"]})
    metrics = [m["name"] for m in registry.benchmark()["end_to_end"]
               + registry.benchmark()["per_layer"]]
    code = "\n".join(
        ["from portbench import harness, registry, program"]
        + [f"registry.driver_class({k!r})" for k in kinds]
        + [f"registry.reader({m!r})" for m in metrics]
        + ["import cometbft_tpu_torch.types.validation",
           "import cometbft_tpu_torch.blocksync.pipeline",
           "import cometbft_tpu_torch.verifyplane",
           "import cometbft_tpu_torch.config.config",
           "program.kernel_wrappers()"])
    loaded = _loaded(code)
    assert "cometbft_tpu_torch" in loaded
    assert isolation.loaded_forbidden(loaded) == []


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("\n".join(f"import {m}" for m in REFERENCE))
    assert "cometbft_tpu_torch" not in loaded
    assert isolation.loaded_forbidden(loaded) == []


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench" / "reference").glob("*.py")))
def test_reference_sources_import_no_program(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if n.split(".")[0] in (
        "cometbft_tpu_torch", "cometbft_tpu", "jax", "torch")]


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    """The run-time check: a forbidden module in sys.modules once the
    window has closed stops the run before its line."""
    monkeypatch.setattr(registry, "driver_class",
                        lambda kind, here=None: sup.NullDriver)
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    cell, config = sup.tiny("commit10k-light")
    with pytest.raises(isolation.IsolationError, match="jax"):
        harness.measure(sup.args("commit10k-light", 0.1), cell, config,
                        torch.device("cpu"))
