"""How the harness's own thread fared on the host during the window: the
share of the window in which it ran on a CPU, the times the kernel took
the CPU from it, and the process's threads. None of it is a metric: it
goes into the result line under `host`, so that a reader can tell a
thread that waited to run from one that ran slower. A reading that
cannot be taken is left out; the probe never stops a run. (The card's
machine shows no steal or other load in /proc/stat, so none is read.)
"""
from __future__ import annotations

import resource
import time


def _threads() -> int:
    with open("/proc/self/status") as f:
        return int(f.read().split("Threads:")[1].split()[0])


def snapshot() -> dict:
    snap = {"wall": time.perf_counter(), "thread_cpu": time.thread_time(),
            "nivcsw": resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw}
    try:
        snap["threads"] = _threads()
    except (OSError, ValueError, IndexError):
        pass
    return snap


def delta(a: dict, b: dict) -> dict:
    wall = b["wall"] - a["wall"] or 1e-9
    return {"thread_cpu_pct":
            100 * (b["thread_cpu"] - a["thread_cpu"]) / wall,
            "involuntary_switches": b["nivcsw"] - a["nivcsw"],
            "threads": b.get("threads")}
