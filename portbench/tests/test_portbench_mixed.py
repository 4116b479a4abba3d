"""The mixed ed25519/sr25519 cell on the CPU: a tiny copy of
`mixed10k-commit` runs through the harness and comes out correct, with
the program's stage readings as metrics; its control, and the program
broken underneath the timed path, come out not correct; and a program
that records no stages (an older one) leaves those metrics out.

The faults: an answer altered where it is produced, half of the sr25519
group's rows left out (taken as valid unverified), and the sr25519 group
answered without verifying. A pass is one call here (a pool of one), and
the tampered key type alternates pass by pass, so a window of a few calls
tampers rows of both types. Takes a few minutes: the plain PyTorch
kernels verify on one CPU core.
"""
import argparse
import copy

import numpy as np
import pytest
import torch

from portbench import harness, registry
from portbench.driver import Record

torch.set_num_threads(1)
CELL = "mixed10k-commit"
SEED = 2**31 + 77
STAGE_METRICS = ("collect_ms.mixed", "ed25519_group_ms.mixed",
                 "sr25519_group_ms.mixed", "sr25519_challenges_ms.mixed")


def run_tiny(seconds: float, trace: int = 0, control: bool = False) -> dict:
    """One run of a tiny copy of the cell on the CPU, through the harness
    (its card check skipped): 8 keys of each type, a pool of one."""
    cell = copy.deepcopy(registry.cell(CELL))
    config = copy.deepcopy(registry.config(cell["config"]))
    config.update({"validators": 16,
                   "key_types": {"ed25519": 8, "sr25519": 8}})
    cell["traffic"].update({"pool": 1, "ref_rows": 4, "profile_ops": 1})
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=seconds,
                              trace=trace, control=control)
    return harness.measure(args, cell, config, torch.device("cpu"))


def test_a_tiny_mixed_cell_is_correct_and_reads_its_stages():
    out = run_tiny(6.0, trace=1)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    for name in STAGE_METRICS + ("idle_pct.mixed",):
        assert out["metrics"][name]["value"] > 0, name
    rows = out["trace"]["rows"]
    assert rows["ed25519_verify"] > 0 and rows["sr25519_verify"] > 0
    assert out["trace"]["spans"]["batch.group"] == 2
    assert out["trace"]["spans"]["batch.challenges"] == 1


def test_the_control_is_not_correct():
    out = run_tiny(6.0, control=True)
    assert not out["correct"], out["checks"]


def _fault(monkeypatch, fault):
    from cometbft_tpu_torch.crypto import batch

    orig = batch.verify_batch

    def sr_half(pubs, msgs, sigs, device=None):
        from cometbft_tpu_torch.ops import sr25519_kernel

        k = len(pubs) // 2
        out = sr25519_kernel.verify_batch(pubs[:k], msgs[:k], sigs[:k],
                                          device=device)
        return np.concatenate([out, np.ones(len(pubs) - k, bool)])

    def unverified(pubs, msgs, sigs, device=None):
        return np.ones(len(pubs), bool)

    def broken(pubs, msgs, sigs, **kw):
        if fault == "altered":
            out = orig(pubs, msgs, sigs, **kw).copy()
            out[len(pubs) - 1] = not out[len(pubs) - 1]
            return out
        kernel = sr_half if fault == "half" else unverified
        return orig(pubs, msgs, sigs, kernels={"sr25519": kernel}, **kw)

    monkeypatch.setattr(batch, "verify_batch", broken)


@pytest.mark.parametrize("fault", ["altered", "half", "sr25519_unverified"])
def test_a_broken_program_is_not_correct(fault, monkeypatch):
    _fault(monkeypatch, fault)
    out = run_tiny(10.0)
    assert not out["correct"], out["checks"]


def test_an_older_program_leaves_the_stage_metrics_out(monkeypatch):
    """A program with no call_stats: the driver keeps no records, and
    every stage reader finds nothing; the card's metrics still read."""
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.types import validation

    monkeypatch.delattr(batch, "call_stats")
    monkeypatch.delattr(validation, "call_stats")
    cell = registry.cell(CELL)
    config = dict(registry.config(cell["config"]), validators=16,
                  key_types={"ed25519": 8, "sr25519": 8})
    cell = dict(cell, traffic=dict(cell["traffic"], pool=1))
    drv = registry.driver_class("commit_mixed")(cell, config, SEED,
                                                torch.device("cpu"))
    drv.setup()
    assert drv.vring is None and drv.bring is None
    drv.op(drv.ops)
    assert drv.ops[0].vrec is None and drv.ops[0].brec is None
    rec = Record(setup_s=1.0, window_s=1.0, items=1, layer=drv.layer())
    for name in STAGE_METRICS:
        assert registry.reader(name)(rec) is None, name
    assert registry.reader("blocks_per_s")(rec) == 1.0
