"""What every traffic driver shares: host spans, the measured window, the
profiled slice, and the record that metric readers read.

A driver (portbench/traffic/<kind>.py) makes its inputs and the
program's objects in `setup`, runs one closed-loop operation in `op`,
gives the live rows each kernel verified in some operations in `rows`,
the host-clock readings of the window in `layer`, frees the program's
state in `release`, and compares every operation with the reference in
`check`.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from portbench.frozen import devtime


class Spans:
    """Host spans around the calls into each layer. While `annotate` is
    on (the profiled slice) each span is a profiler annotation, so the
    device's idle gaps can be named by what the host was doing; in the
    window a span costs nothing."""

    def __init__(self):
        self.annotate = False

    @contextmanager
    def __call__(self, name: str):
        if not self.annotate:
            yield
            return
        from torch.profiler import record_function

        with record_function(name):
            yield


@dataclass
class Record:
    """A run's readings, as metric readers see them."""

    setup_s: float
    window_s: float = 0.0
    items: int = 0                       # blocks, calls or heights done
    op_ms: List[float] = field(default_factory=list)
    layer: Dict[str, list] = field(default_factory=dict)
    profile: Optional[devtime.Profile] = None


class Driver:
    """One cell's traffic over the program; see the module docstring."""

    span_names: tuple = ()

    def __init__(self, cell: dict, config: dict, seed: int, device,
                 control: bool = False):
        self.cell = cell
        self.config = config
        self.p = cell["traffic"]
        self.seed = seed
        self.device = device
        self.control = control
        self.spans = Spans()
        self.ops: List = []        # the window's operations
        self.later: List = []      # operations after it (the profiled slice)
        self.window_s = 0.0
        self.op_cpu_ms: List[float] = []    # the thread's CPU time an op
        self.marks: Dict[str, float] = {}   # set-up's steps, perf_counter

    def mark(self, step: str) -> None:
        self.marks[step] = time.perf_counter()

    # -- what a driver implements ------------------------------------------

    def setup(self) -> None:
        raise NotImplementedError

    def op(self, sink: list) -> None:
        raise NotImplementedError

    def rows(self, ops) -> Dict[str, int]:
        raise NotImplementedError

    def layer(self) -> Dict[str, list]:
        return {}

    def quiesce(self) -> None:
        """Let the program finish recording what earlier operations did."""

    def release(self) -> None:
        pass

    def check(self) -> List[tuple]:
        """[(name, value, limit)] for every number compared."""
        raise NotImplementedError

    # -- shared --------------------------------------------------------------

    def window(self, seconds: float) -> None:
        """Closed loop: the next operation starts when the last returns,
        until `seconds` have passed; the window ends with the last."""
        self.quiesce()
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            c0 = time.thread_time()
            self.op(self.ops)
            self.op_cpu_ms.append((time.thread_time() - c0) * 1e3)
            if time.perf_counter() >= end:
                break
        self.window_s = self.ops[-1].t1 - t0

    def profile(self, n: int, launches, kernel_key):
        def run():
            ops: list = []
            for _ in range(n):
                self.op(ops)
            self.later += ops
            return ops

        self.spans.annotate = True
        try:
            return devtime.trace_slice(run, self.rows, self.span_names,
                                       launches, kernel_key, self.quiesce)
        finally:
            self.spans.annotate = False

    def totals(self) -> tuple:
        """(attempted, failed) over every operation checked."""
        ops = self.ops + self.later
        return (sum(o.attempted for o in ops), sum(o.failed for o in ops))


def outcome(err) -> Optional[tuple]:
    """A verdict as the reference spells it (reference/verdicts.py)."""
    if err is None or isinstance(err, tuple):
        return err
    name = type(err).__name__
    return (name, err.idx) if hasattr(err, "idx") else (name,)
