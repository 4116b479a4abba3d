"""Device time from a profiler trace of a short slice of operations.

After chip_smoke.py's `_traced` and `device_ms` at commit
11dbd9c1db08fa78cfd421f2794b4ad265f950b7: a trace may miss kernel
events (on the card, a first trace after a pause has missed up to two
thirds of them), so a trace that holds fewer of the program's kernel
events than the program counted launches is taken again, up to TRACES
times; the last one is kept with both counts beside it.

From the trace: the slice's length (its own annotation), the time in
which any kernel, copy or memset ran on the card, each program kernel's
device time and event count, the device operations that took the most
time, and the longest gaps in which the card ran nothing, each named by
the innermost benchmark span the host was in at the gap's middle.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

TRACES = 3
SLICE = "portbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class Profile:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)
    kernel_n: Dict[str, int] = field(default_factory=dict)
    events: int = 0          # program kernel events in the trace
    launches: int = 0        # program kernel launches counted meanwhile
    tries: int = 1
    rows: Dict[str, int] = field(default_factory=dict)
    spans: Dict[str, int] = field(default_factory=dict)  # annotations seen
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)

    def kernel_seconds(self, key: str) -> Optional[float]:
        """A kernel's device time in the slice; where the trace lost some
        of its events, its mean event times the launches counted."""
        n = self.kernel_n.get(key, 0)
        if not n:
            return None
        s = self.kernel_s[key]
        if self.events < self.launches:
            s *= self.launches / self.events
        return s


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespace
    and argument or template lists."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name.strip() or "?"


def _union(intervals: Sequence[tuple]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def analyse(events: List[dict], span_names, kernel_key: Callable
            ) -> Optional[Profile]:
    """A Profile of a chrome trace's events, or None without the slice's
    annotation."""
    win = [e for e in events if e.get("name") == SLICE
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], {}
    prof = Profile(window_s=(w1 - w0) / 1e6, busy_s=0.0)
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        full = str(e.get("name", "?"))
        name = short_name(full)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        key = kernel_key(full) if e["cat"] == "kernel" else None
        if key is not None:
            prof.kernel_s[key] = prof.kernel_s.get(key, 0.0) + (b - a) / 1e6
            prof.kernel_n[key] = prof.kernel_n.get(key, 0) + 1
            prof.events += 1
    busy = _union(dev)
    prof.busy_s = sum(b - a for a, b in busy) / 1e6
    prof.device_ops = sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:TOP]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in span_names and "dur" in e]
    for s in spans:
        prof.spans[s[2]] = prof.spans.get(s[2], 0) + 1
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inside = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(inside, key=lambda s: s[1] - s[0])[2] if inside \
            else "host"
        gaps.append([name, (b - a) / 1e6])
    prof.idle_gaps = sorted(gaps, key=lambda x: -x[1])[:TOP]
    return prof


def trace_slice(run: Callable, rows_of: Callable[..., Dict[str, int]],
                span_names, launches: Callable[[], int],
                kernel_key: Callable, prepare: Callable = lambda: None,
                tries: int = TRACES) -> Optional[Profile]:
    """Profile `run()`, which runs the slice's operations; `rows_of` of
    what it returns gives the live rows each kernel verified in them.
    `prepare()` runs before each try, outside the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync = torch.cuda.synchronize if card else (lambda: None)
    prof = None
    for attempt in range(1, tries + 1):
        prepare()
        sync()
        before = launches()
        with profile(activities=acts) as p:
            with record_function(SLICE):
                done = run()
                sync()
        launched = launches() - before
        rows = rows_of(done)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            p.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        prof = analyse(events, span_names, kernel_key)
        if prof is None:
            continue
        prof.launches, prof.tries, prof.rows = launched, attempt, rows
        if prof.events >= launched:
            break
    return prof
