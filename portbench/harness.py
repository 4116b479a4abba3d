"""One run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--control]

Set-up (inputs from the seed, the program's objects, a warm-up of every
shape the cell uses), then the measured window, then, with `--trace 1`,
a short profiled slice of the same operations. Then the device's peak
memory is read, the program's state freed, the loaded modules checked
(nothing of JAX or of the JAX package), and every operation compared
with the reference. The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the last key of that object. `--control` puts the
cell's control in the program's place; its run has to come out not
correct.

A run needs a CUDA card (as many as the cell's `chips`); without one it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

from portbench import hoststat, isolation, program, registry
from portbench.driver import Record


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start time in
    clock ticks after boot); since the harness's first line elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - T_IMPORT


T_IMPORT = time.perf_counter()


def card_readings() -> dict:
    """The card's name, power limit and SM clocks from nvidia-smi."""
    keys = ("name", "power.limit", "clocks.sm", "clocks.max.sm")
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    vals = [v.strip() for v in out.splitlines()[0].split(",")] if out else []
    return dict(zip(keys, vals))


class _CollectorPauses:
    """The collector's passes in the window and their milliseconds, by
    generation."""

    def __init__(self):
        self.ms, self.passes, self._t = [0.0] * 3, [0] * 3, 0.0
        gc.callbacks.append(self.note)

    def note(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.passes[g] += 1
            self.ms[g] += (time.perf_counter() - self._t) * 1e3


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(args, cell: dict, config: dict, device) -> dict:
    """Set up, run the window (and the slice), check: the result line.
    The tests drive it on the CPU (`device` cpu), which no run does."""
    import torch

    on_card = device.type == "cuda"
    bench = registry.benchmark()
    drv = registry.driver_class(cell["traffic"]["kind"])(
        cell, config, args.seed, device, args.control)
    t_setup = time.perf_counter()
    drv.setup()
    # the inputs and the program's objects are long-lived: keep them out
    # of the collector's passes in the window
    gc.collect()
    gc.freeze()
    _sync(device)
    rec = Record(setup_s=process_age_s())
    t_end = time.perf_counter()
    pauses = _CollectorPauses()
    steps, last = {}, t_setup
    for step, t in list(drv.marks.items()) + [("warm_up", t_end)]:
        steps[step], last = t - last, t
    split = {"to_setup": rec.setup_s - (t_end - t_setup), **steps}
    host0 = hoststat.snapshot()
    drv.window(args.seconds)
    try:
        host = hoststat.delta(host0, hoststat.snapshot())
    except Exception:  # noqa: BLE001 - a diagnostic never stops a run
        host = {}
    rec.window_s = drv.window_s
    gc.callbacks.remove(pauses.note)
    if args.trace:
        rec.profile = drv.profile(cell["traffic"]["profile_ops"],
                                  program.launches, program.kernel_key)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    card = card_readings() if on_card else {}
    rec.items = sum(o.items for o in drv.ops)
    rec.op_ms = [(o.t1 - o.t0) * 1e3 for o in drv.ops]
    rec.layer = drv.layer()
    drv.release()
    found = isolation.loaded_forbidden()
    if found:
        raise isolation.IsolationError(
            f"modules of {', '.join(found)} are loaded")
    checks = drv.check()
    attempted, failed = drv.totals()
    metrics = {}
    for m in registry.metrics_for(bench, args.workload, args.trace):
        value = registry.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    prof = rec.profile
    if prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        out["breakdown"] = {"device_ops": prof.device_ops,
                            "idle_gaps": prof.idle_gaps}
        out["trace"] = {"kernel_events": prof.events,
                        "launches": prof.launches, "tries": prof.tries,
                        "rows": prof.rows, "spans": prof.spans}
    out["card"] = card
    out["setup_split_s"] = split
    out["host"] = host
    out["window"] = {"op_ms": rec.op_ms, "op_cpu_ms": drv.op_cpu_ms,
                     "quorum_ms": rec.layer.get("quorum_ms", []),
                     "gc_ms": pauses.ms, "gc_passes": pauses.passes}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out


def main(argv) -> int:
    args = parse(argv)
    try:
        cell = registry.cell(args.workload)
        config = registry.config(cell["config"])
    except (OSError, ValueError, KeyError) as e:
        return fail(2, f"no cell {args.workload!r}: {e}")
    import torch

    if not torch.cuda.is_available():
        return fail(3, "no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < int(cell["chips"]):
        return fail(3, f"the cell asks for {cell['chips']} cards, "
                       f"{torch.cuda.device_count()} present")
    if importlib.util.find_spec("cometbft_tpu_torch") is None:
        return fail(4, "the program under test (cometbft_tpu_torch) is not "
                       "in the checkout")
    try:
        out = measure(args, cell, config, torch.device("cuda", 0))
    except isolation.IsolationError as e:
        return fail(5, str(e))
    except Exception:  # noqa: BLE001 - a run that broke prints no result
        traceback.print_exc()
        return fail(1, "the run broke; no result")
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
