"""Shared helpers of the benchmark's CPU tests: tiny copies of the cells,
a run of one through the harness on the CPU, and a driver with no
program behind it."""
from __future__ import annotations

import argparse
import copy
import time
from dataclasses import dataclass

from portbench import registry
from portbench.driver import Driver

# sizes at which the plain PyTorch kernels answer on the CPU in seconds
TINY = {"commit_light": ({"validators": 16}, {"pool": 2, "ref_rows": 4,
                                               "profile_ops": 1}),
        "stream": ({"validators": 40, "heights": 8},
                   {"run": 4, "ref_rows": 4, "profile_ops": 1}),
        "plane": ({"validators": 24}, {"pool": 2, "threads": 2,
                                       "tamper": 2, "ref_rows": 4,
                                       "profile_ops": 1})}
SEED = 2**31 + 77


def tiny(cell_name: str):
    """(cell, config) of a cell, cut to the CPU's size."""
    cell = copy.deepcopy(registry.cell(cell_name))
    config = copy.deepcopy(registry.config(cell["config"]))
    cfg_over, traffic_over = TINY[cell["traffic"]["kind"]]
    config.update(cfg_over)
    cell["traffic"].update(traffic_over)
    return cell, config


def args(cell_name: str, seconds: float, trace: int = 0,
         control: bool = False, seed: int = SEED):
    return argparse.Namespace(workload=cell_name, seed=seed,
                              seconds=seconds, trace=trace, control=control)


def run_tiny(cell_name: str, seconds: float = 2.0, trace: int = 0,
             control: bool = False, seed: int = SEED) -> dict:
    """One run of a tiny copy of the cell on the CPU, through the
    harness (its card check skipped); the result line as a dict."""
    import torch

    from cometbft_tpu_torch.blocksync import pipeline
    from portbench import harness

    cell, config = tiny(cell_name)
    saved = pipeline.MAX_COMMITS_PER_CHUNK
    pipeline.MAX_COMMITS_PER_CHUNK = 4   # 4 x 128 columns a chunk
    try:
        return harness.measure(args(cell_name, seconds, trace, control,
                                    seed), cell, config,
                               torch.device("cpu"))
    finally:
        pipeline.MAX_COMMITS_PER_CHUNK = saved


@dataclass
class Op:
    t0: float
    t1: float
    attempted: int = 1
    items: int = 1
    failed: int = 0


class NullDriver(Driver):
    """A driver whose operations sleep 10 ms and always check out: the
    harness's own flow, with no program behind it."""

    span_names = ("null.op",)

    def setup(self):
        self.mark("inputs")
        self.mark("program")

    def op(self, sink):
        with self.spans("null.op"):
            t0 = time.perf_counter()
            time.sleep(0.01)
            sink.append(Op(t0, time.perf_counter()))

    def rows(self, ops):
        return {}

    def check(self):
        return [("things_wrong", 0, 0)]
