"""The verify plane: a continuous-batching scheduler for the device.

Before this subsystem, only bulk callers (blocksync StreamVerifier,
commit verification) reached the device in batches; each gossiped vote
and each vote-extension signature still single-verified serially on the
host — exactly the hot path under consensus load. EdDSA committee-
consensus measurements (arXiv:2302.00418) put the win in batch
verification, and FPGA verification engines for permissioned chains
(arXiv:2112.02229) use the same shape: one shared hardware queue that
coalesces independent requests into a single device pass.

Architecture (inference-style continuous batching):

  callers ──submit(pub,msg,sig[,power,group])──► pending queue
                                                    │
                 dispatcher thread: flush when the oldest submission is
                 window_ms old OR max_batch rows are pending
                                                    │
                                    one padded bucket-shaped pass
                         (device kernels under the CircuitBreaker;
                          the inline host ed25519_ref path only on a
                          plane built with use_device=False)
                                                    │
              per-item verdict futures  +  per-group power tallies
              (a QuorumGroup's quorum event fires inside the flush —
               VoteSet learns "2/3 reached" directly from the plane)

Knobs ([verify_plane] config): window_ms bounds added latency,
max_batch bounds device batch size (bucket padding reuses the compiled
kernel shapes from ops/), max_queue bounds memory and provides
backpressure — a full queue blocks submitters (or raises PlaneQueueFull
for non-blocking callers, who then verify inline on the host). The
mesh knobs (mesh_devices / mesh_min_rows) shard eligible fused flushes
over the device's slots (parallel/mesh.py): per-slot device-resident
valset tables, the tally reduced on the device, the quorum still a
kernel output (fused.py "Sharded flushes").

Flight deck (pipeline_flights > 1): the dispatcher keeps up to K
flushes airborne at once instead of a single in-flight slot. With a
>=4-slot mesh the flush mesh splits into two DISJOINT halves
(fused.half_meshes) and alternating flushes fly on alternating halves —
while flush k verifies on one half, flush k+1 packs on the host and
dispatches on the other. Landing is out-of-order (fused.plan_ready
probes the flush's CUDA event; flight k+1 finishing first never blocks
behind k), and the size-aware policy in fused.plan_fused sends a flush
past one half's budget (or the half_mesh_rows knob) to the full mesh
after draining the deck. The private staging pool is flights+1 deep per
shape so pack(k+2) never waits on a buffer still in use under flight
k.

QoS lanes (overload resilience): every submission rides one of three
priority classes.  CONSENSUS (the default: gossiped votes, commits,
the node's own light-client headers) owns the flush window — its
oldest submission's age is what triggers a flush, and its rows drain
first.  GATEWAY (the light-client gateway's header verifies on behalf
of RPC clients — the JAX package's lightgate/) drains after CONSENSUS and
ahead of BULK: client-serving traffic must never delay the node's own
liveness, but it outranks mempool throughput.  BULK (today mempool
CheckTx; blocksync backfill keeps its own pinned pipeline and does not
ride the plane) fills whatever capacity a flush has left.  Each
non-consensus lane gets a small guaranteed anti-starvation quantum and
coalesces under its own longer window when no higher-priority traffic
is pending.  GATEWAY and BULK queues are separately bounded and
deadline-aware: a submission that cannot be served before its lane
deadline is SHED with an explicit PlaneOverloaded verdict (never a
silent drop) carrying a retry-after hint, so a CheckTx flood — or a
thundering herd of light clients — degrades into fast, honest
rejections instead of an unbounded queue that starves vote
verification.  CONSENSUS submissions are never shed.

Failure injection: the `verifyplane.dispatch` failpoint fires at the
top of every flush; a raised fault degrades that flush to the inline
host path on a host plane and fails its futures with DeviceError on a
device plane — futures always resolve, submitters never hang.

The port's copy of the JAX package's verifyplane/plane.py. The seams that
differ: the plane runs on a torch device (``device=None`` is the CUDA
card and raises without a Hopper card; ``device="cpu"`` runs the same
fused path on the kernels' plain versions; ``use_device=False`` is the
inline host path), fused flushes go through this package's CUDA
verifyplane/fused.py, whose per-flush ``dev_ms`` is read from CUDA events
around its kernel launches, and the compile ledger records the kernel
builds (libs/deviceledger.py). A device plane never verifies on the host:
where the JAX plane re-verifies a faulting flush there (an in-flight
fault, a faulting key-type group, an open breaker), the port's fails the
flush's futures with DeviceError, counts the fault on the breaker and
records the flush as PATH_DEVICE_FAULT; the caller decides what to do.
A device plane's future that times out raises DeviceError too (a wedged
device pass), where a host plane's raises PlaneError. The host oracle
runs only on a plane built with use_device=False.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from cometbft_tpu_torch.device import DeviceError
from cometbft_tpu_torch.libs import controller as controlplane
from cometbft_tpu_torch.libs import deviceledger
from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.libs import tracing

_log = logging.getLogger(__name__)

fp.register("verifyplane.dispatch",
            "top of a verify-plane flush (raise = dispatch fault; a host "
            "plane degrades the flush to the inline host path, a device "
            "plane fails it with DeviceError; futures must still "
            "resolve)")

DISPATCH_LOG_MAX = 64       # flush-composition ring kept for tests/ops

# -- QoS lanes --------------------------------------------------------------
# CONSENSUS: liveness-critical verification (votes, commits, the node's
# own light headers) — owns the flush window, drains first, never shed.
# GATEWAY: light-client-gateway header verifies on behalf of RPC
# clients (the JAX package's lightgate/) — drains after CONSENSUS, ahead of
# BULK; separately bounded, shed past its deadline.
# BULK: throughput traffic (today: mempool CheckTx) — fills leftover
# flush capacity, separately bounded, shed past its deadline.
LANE_CONSENSUS = "consensus"
LANE_GATEWAY = "gateway"
LANE_BULK = "bulk"
LANES = (LANE_CONSENSUS, LANE_GATEWAY, LANE_BULK)
# lanes that may be answered with an explicit Overloaded shed verdict
# (CONSENSUS is never shed by construction)
SHEDDABLE_LANES = (LANE_GATEWAY, LANE_BULK)
# the tenant submissions fall to when no chain_id is given — a
# single-chain node never needs to know the tenancy layer exists
# (verifyplane/tenants.py owns the registry; the constant lives here
# so the hot submit path and the registry share one spelling without
# a circular import)
DEFAULT_TENANT = "default"
# anti-starvation: even a flush filled to max_batch with CONSENSUS rows
# carries up to max_batch // BULK_QUANTUM_DIV extra rows PER lower
# lane, so a sustained consensus storm degrades GATEWAY/BULK to a
# guaranteed slice of capacity instead of zero (weighted priority, not
# absolute)
BULK_QUANTUM_DIV = 8
LANE_WAIT_WINDOW = 4096     # per-lane submit-to-result samples kept

# Process-global flush ids: flight b/e trace events pair by (name, cat,
# id), so two planes alive in one process (multi-node tests, simnet)
# must never reuse an id — perfetto and trace_report would pair plane
# A's begin with plane B's end. next() on itertools.count is atomic.
_FLUSH_IDS = itertools.count()

# -- flush ledger ----------------------------------------------------------
# The trace plane can reconstruct one run in full detail, but it
# is OFF by default — so the r05-style question "what did the last few
# hundred flushes actually cost" had no answer on a production node.
# The ledger is the always-on counterpart: one compact tuple per flush
# in a bounded ring, cheap enough to never turn off. The ring slot is
# the only per-flush allocation; every stamp rides
# tracing.monotonic_ns(), which the simnet swaps for its virtual clock
# — same (seed, schedule) => identical ledger.

LEDGER_CAPACITY = 256

# flush dispatch paths (interned module constants — the ledger must not
# build strings per flush)
PATH_FUSED = "fused"                # cached-table device pass, airborne
PATH_FUSED_SHARDED = "fused_sharded"  # sharded mesh pass, airborne
PATH_GROUPED = "grouped"            # generic device pass (sync)
PATH_HOST = "host"                  # no accelerator: inline host verify
PATH_FAILPOINT = "failpoint_host"   # dispatch failpoint degraded flush
PATH_DEVICE_FAULT = "device_fault"  # device pass faulted: DeviceError
PATH_STOP_DRAIN = "stop_drain"      # settled by stop()'s drain budget
PATH_SHED_ONLY = "shed_only"        # drain cycle that only shed (no flush)

# row-assembly attribution for the fused paths (the ledger's `stamp`
# column): device = the stamping prologue expanded per-row deltas next
# to a resident template; host = full rows packed host-side
# (the legacy path, still bit-live as the differential oracle and the
# fallback for non-template-eligible flushes). Non-fused paths record
# STAMP_HOST — their rows are host-assembled by definition.
STAMP_DEVICE = "device"
STAMP_HOST = "host"

# per-flush tenant split rule (the ledger's ``split`` column): how the
# flush's device-time columns (comp_ms/h2d_ms/dev_ms/delta_bytes) were
# charged to its ``tenants`` — "exact" when one tenant owned every row
# (the sub-flush boundary case: the fair-share drain's per-tenant row
# slices make the charge exact by construction), "rows" when a fused
# batch coalesced several tenants and the charge is row-proportional
# (the only defensible split inside ONE device pass). Recorded per
# flush so an operator reading /dump_tenants device columns knows
# which rule produced each number.
SPLIT_EXACT = "exact"
SPLIT_ROWS = "rows"

# Record-field indices. A flush's record is ONE list allocated at stage
# time in FIELDS order (plus two trailing internal ns stamps the readers
# never see); the dispatcher mutates it in place as stages land and the
# very same list becomes the ring slot — "no allocation per flush beyond
# the ring slot" is literal, not approximate.
(_L_SEQ, _L_TS, _L_ROWS, _L_SUBS, _L_QUEUED, _L_PACK, _L_FLIGHT,
 _L_COLLECT, _L_SETTLE, _L_AIR, _L_PATH, _L_STAMP, _L_BRK, _L_SMISS,
 _L_DEPTH, _L_CROWS, _L_GROWS, _L_BROWS, _L_SHED, _L_NDEV,
 _L_NHOST, _L_DEV0, _L_WARM, _L_COMP, _L_H2D, _L_DBYTES, _L_DEV,
 _L_UTIL, _L_TEN, _L_SPLIT) = range(30)
# internal slots past the FIELDS window: ns stamps + the clock
# generation they were taken under + the first-ready probe stamp
# (readers never see these)
_L_T0NS, _L_TPACKED, _L_GEN, _L_READY = 30, 31, 32, 33
# the CUDA-event device ms of a collected fused flush (None elsewhere)
_L_DEVEV = 34


def ms_to_us(ms) -> int:
    """Ledger-ms (rounded to 3 decimals) -> exact integer microseconds.

    The per-tenant device accounting and its conservation cross-check
    (tenants.reconcile_device) run on INTEGER microseconds so the
    exact-accounting contract holds with no float tolerance band — a
    3-decimal ms value is a whole number of us by construction."""
    return int(round(float(ms) * 1000.0))


def split_device_columns(tenants: tuple, rows: int, comp_ms, h2d_ms,
                         dev_ms, delta_bytes: int):
    """Split one flush's device-time columns across its tenant pairs.

    Returns (rule, [(chain, comp_us, h2d_us, dev_us, delta_bytes)]):
    one tenant (or an empty/rowless flush) is charged EXACTLY; a fused
    multi-tenant batch splits row-proportionally with the LAST tenant
    taking the integer residual, so the shares always sum back to the
    flush totals with zero drift (the HBM _split_exact discipline
    applied to time). Pure arithmetic."""
    comp_us = ms_to_us(comp_ms)
    h2d_us = ms_to_us(h2d_ms)
    dev_us = ms_to_us(dev_ms)
    dbytes = int(delta_bytes)
    if not tenants:
        return SPLIT_EXACT, []
    if len(tenants) == 1 or rows <= 0:
        chain = tenants[0][0]
        return SPLIT_EXACT, [(chain, comp_us, h2d_us, dev_us, dbytes)]
    # unrolled columns (no per-share tuple comprehensions): this runs
    # inside the per-flush hook budget bench.cost_hooks_bookkeeping_us
    # asserts, so the constant factor matters
    out = []
    c_acc = h_acc = d_acc = b_acc = 0
    last = len(tenants) - 1
    for i, (chain, t_rows) in enumerate(tenants):
        if i == last:
            out.append((chain, comp_us - c_acc, h2d_us - h_acc,
                        dev_us - d_acc, dbytes - b_acc))
        else:
            c = comp_us * t_rows // rows
            h = h2d_us * t_rows // rows
            d = dev_us * t_rows // rows
            b = dbytes * t_rows // rows
            c_acc += c
            h_acc += h
            d_acc += d
            b_acc += b
            out.append((chain, c, h, d, b))
    return SPLIT_ROWS, out


def _tenant_rows(col) -> dict:
    """Aggregate the ledger's per-flush tenant splits into {chain_id:
    rows} over the window (summary/read time only)."""
    out: dict = {}
    for pairs in col:
        for chain, rows in pairs:
            out[chain] = out.get(chain, 0) + rows
    return out


def _tenant_split(batch) -> tuple:
    """The ledger's per-tenant row attribution for one flush: sorted
    ((chain_id, rows), ...) pairs summing to the flush total. A sorted
    tuple of pairs, not a dict — the record is a flat list mutated in
    place, and replay comparisons need a deterministic, hashable
    value."""
    d: dict = {}
    for s in batch:
        d[s.tenant] = d.get(s.tenant, 0) + len(s.rows)
    return tuple(sorted(d.items()))


def _device_block(cols: dict) -> dict:
    """The summary's device-time attribution over the ring's columns:
    compile ms total (and which flushes paid it), plus h2d/dev/util
    percentiles over the FUSED flushes that actually measured them
    (host-path zeros would drown the signal)."""
    from cometbft_tpu_torch.libs.quantiles import nearest_rank

    fused = [i for i, p in enumerate(cols["path"])
             if p in (PATH_FUSED, PATH_FUSED_SHARDED)]

    def pcts(name):
        xs = sorted(cols[name][i] for i in fused)
        if not xs:
            return {"p50": 0.0, "p90": 0.0, "max": 0.0}
        return {"p50": nearest_rank(xs, 0.5),
                "p90": nearest_rank(xs, 0.9), "max": xs[-1]}

    return {
        "comp_ms": round(sum(cols["comp_ms"]), 3),
        "comp_flushes": sum(1 for c in cols["comp_ms"] if c),
        "fused_flushes": len(fused),
        "h2d_ms": pcts("h2d_ms"),
        "dev_ms": pcts("dev_ms"),
        "util": pcts("util"),
    }


class FlushLedger:
    """Bounded ring of per-flush records.

    Record fields (see ``FIELDS``): per-plane sequence number, flush
    timestamp (ms on the ledger clock), row/submission counts, the
    per-stage costs (queued/pack/flight/collect/settle ms), how many
    OTHER flights were airborne when this flush dispatched (``airborne``
    — the flight-deck generalization of the old boolean overlap flag;
    records() still derives the legacy ``overlapped`` bool from it),
    the dispatch path taken, the breaker state observed at stage time,
    staging-pool misses charged to this flush, the queue depth left
    behind, the per-lane row split (c_rows CONSENSUS / g_rows GATEWAY /
    b_rows BULK), how many sheddable-lane submissions were shed at
    this drain, the flush's device attribution: n_dev (1 = one device
    or the host, >1 = the sharded mesh pass), n_host (always 1) and dev0
    (the first slot index of the flush's sub-mesh, so two deck flights
    on disjoint halves are visibly disjoint in /dump_flushes)
    — and ``warm``: 1 when a fused flush found its valset window table
    already cached (LRU hit), 0 when it paid the build/patch inline
    (the cold first-commit-after-rotation stall the next-epoch table
    warmer exists to kill; non-table paths record 0) — and the
    DEVICE-TIME split (the device observatory, libs/deviceledger):
    ``comp_ms`` = kernel-build ms attributed to THIS flush
    (cold post-rotation compiles become visible on the flush that
    paid them; a nonzero value on a steady flush is the round-5
    regression class), ``h2d_ms`` = the host-side dispatch wall
    (table fetch, uploads + kernel enqueue) net of comp_ms, ``dev_ms``
    = the device-clock span of a fused flush's launches on the card,
    between CUDA events recorded just before its first launch and after
    its last: its kernels and the stream's waits for the host to
    enqueue them, not the table fetch or the uploads (elsewhere the
    estimate dispatch -> first true readiness probe when the deck
    observed one, else dispatch -> fetch complete, an upper bound
    including d2h), and ``util`` = real rows
    / padded device slots staged (the rows-x-cost utilization of the
    pass; 0 on non-fused paths). comp_ms and h2d_ms decompose part
    of pack_ms (dispatch runs inside the pack span); dev_ms overlaps
    flight+collect. ``stamp`` attributes the flush's row assembly:
    STAMP_DEVICE when the fused path shipped per-row deltas and the
    device stamping prologue rebuilt the rows, STAMP_HOST when full
    rows were packed host-side (legacy fused fallback and every
    non-fused path). ``delta_bytes`` is the staged delta footprint of
    a device-stamped flush (0 on host-packed flushes) — read next to
    h2d_ms to see the shipped-bytes shrink the stamp bought.
    ``tenants`` is the multi-tenant row attribution:
    sorted ((chain_id, rows), ...) pairs summing to the flush total —
    the ledger evidence that ONE flush coalesced rows from MANY
    chains (verifyplane/tenants.py; empty on shed-only cycles).
    ``split`` is the tenant split RULE this flush's device-time
    columns were charged under (SPLIT_EXACT = one tenant owned every
    row, the charge is exact; SPLIT_ROWS = a fused multi-tenant batch,
    charged row-proportionally with the integer residual on the last
    tenant — see split_device_columns); the per-tenant accumulators
    /dump_tenants serves are fed from exactly this rule, so the
    conservation cross-check (tenants.reconcile_device) is an
    identity, not an estimate. Written by the dispatcher even when
    tracing is off; read by /dump_flushes, the scrape-time /metrics
    percentiles, and simnet replay blobs."""

    FIELDS = ("seq", "ts_ms", "rows", "subs", "queued_ms", "pack_ms",
              "flight_ms", "collect_ms", "settle_ms", "airborne",
              "path", "stamp", "breaker", "staging_miss", "depth",
              "c_rows", "g_rows", "b_rows", "shed", "n_dev",
              "n_host", "dev0", "warm", "comp_ms", "h2d_ms",
              "delta_bytes", "dev_ms", "util", "tenants", "split")

    __slots__ = ("_ring",)

    def __init__(self, capacity: int = LEDGER_CAPACITY):
        self._ring = deque(maxlen=max(16, int(capacity)))

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, rec: list) -> None:
        self._ring.append(rec)

    def records(self) -> List[dict]:
        """The ring as dicts, oldest first (dict construction happens
        at READ time — dump/scrape — never on the flush path)."""
        # list(deque) snapshots atomically under the GIL (one C call);
        # zip(FIELDS, r) stops at the FIELDS window, so the two internal
        # ns stamps trailing each record never leak into a dump
        out = []
        for r in list(self._ring):
            d = dict(zip(self.FIELDS, r))
            # legacy key: "overlapped" was a bool before the deck
            # widened it to the airborne count — derived at READ time
            # so /dump_flushes consumers keep working
            d["overlapped"] = bool(d["airborne"])
            out.append(d)
        return out

    def tail(self, n: int = 8) -> List[str]:
        """The last n flushes as compact strings — small enough to ride
        a simnet replay blob."""
        out = []
        for r in list(self._ring)[-n:]:
            out.append(
                f"#{r[_L_SEQ]} rows={r[_L_ROWS]} {r[_L_PATH]} "
                f"queued={r[_L_QUEUED]}ms pack={r[_L_PACK]}ms "
                f"flight={r[_L_FLIGHT]}ms collect={r[_L_COLLECT]}ms "
                f"settle={r[_L_SETTLE]}ms"
                + (f" x{r[_L_NDEV]}dev" if r[_L_NDEV] > 1 else "")
                + (f" air={r[_L_AIR]}" if r[_L_AIR] else "")
                + (" cold" if r[_L_PATH] in (PATH_FUSED,
                                             PATH_FUSED_SHARDED)
                   and not r[_L_WARM] else "")
                + (f" comp={r[_L_COMP]}ms" if r[_L_COMP] else "")
            )
        return out

    def summary(self) -> dict:
        """Percentile summary over the ring (computed at read time)."""
        recs = list(self._ring)
        if not recs:
            return {"flushes": 0}
        cols = {name: [r[i] for r in recs]
                for i, name in enumerate(self.FIELDS)}

        from cometbft_tpu_torch.libs.quantiles import nearest_rank

        def pcts(xs):
            s = sorted(xs)
            return {"p50": nearest_rank(s, 0.5),
                    "p90": nearest_rank(s, 0.9), "max": s[-1]}

        pack_total = sum(cols["pack_ms"])
        pack_over = sum(p for p, o in zip(cols["pack_ms"],
                                          cols["airborne"]) if o)
        paths: dict = {}
        for p in cols["path"]:
            paths[p] = paths.get(p, 0) + 1
        return {
            "flushes": len(recs),
            "rows": int(sum(cols["rows"])),
            "stage_ms": {k: pcts(cols[f"{k}_ms"])
                         for k in ("queued", "pack", "flight", "collect",
                                   "settle")},
            "rows_per_flush": pcts(cols["rows"]),
            "overlap_frac": round(pack_over / pack_total, 3)
            if pack_total else 0.0,
            "paths": paths,
            "staging_miss": int(sum(cols["staging_miss"])),
            "host_fallback": paths.get(PATH_FAILPOINT, 0),
            "device_faults": paths.get(PATH_DEVICE_FAULT, 0),
            "lanes": {LANE_CONSENSUS: int(sum(cols["c_rows"])),
                      LANE_GATEWAY: int(sum(cols["g_rows"])),
                      LANE_BULK: int(sum(cols["b_rows"]))},
            "shed": int(sum(cols["shed"])),
            # multi-tenant attribution: per-chain rows over the window
            # plus the coalescing evidence — flushes whose tenant
            # split names >1 chain (one device pass, many chains)
            "tenants": _tenant_rows(cols["tenants"]),
            "coalesced_flushes": sum(
                1 for t in cols["tenants"] if len(t) > 1),
            # cross-chip attribution: flushes/rows that rode the
            # sharded mesh pass, and the widest fan-out seen
            "shard": {
                "flushes": sum(1 for d in cols["n_dev"] if d > 1),
                "rows": int(sum(r for r, d in zip(cols["rows"],
                                                  cols["n_dev"])
                                if d > 1)),
                "n_dev_max": int(max(cols["n_dev"], default=0)),
            },
            # flight-deck attribution: how deep the deck actually got
            # (airborne = flights already in the air at dispatch time,
            # so airborne_max == 1 means two flights flew at once)
            "deck": {
                "airborne_max": int(max(cols["airborne"], default=0)),
                "overlapped_flushes": sum(
                    1 for a in cols["airborne"] if a),
            },
            # device-time attribution (the device observatory,
            # /dump_devices): total backend-compile ms charged to
            # flushes in the window (nonzero on a steady stream = the
            # round-5 class), and the h2d/on-device/utilization
            # figures over the fused flushes that measured them
            "device": _device_block(cols),
            # row-assembly attribution: device-stamped vs host-packed
            # flushes over the window, plus the staged delta bytes the
            # stamped flushes shipped instead of full rows
            "stamp": {
                "device": sum(1 for s in cols["stamp"]
                              if s == STAMP_DEVICE),
                "host": sum(1 for s in cols["stamp"]
                            if s == STAMP_HOST),
                "delta_bytes": int(sum(cols["delta_bytes"])),
            },
            # valset-table attribution over the fused paths: cold = a
            # flush that paid the table build/patch inline (the
            # post-rotation stall /dump_flushes localizes; the warmer
            # exists to keep this 0 across epochs)
            "tables": {
                "warm": sum(1 for p, w in zip(cols["path"], cols["warm"])
                            if w and p in (PATH_FUSED,
                                           PATH_FUSED_SHARDED)),
                "cold": sum(1 for p, w in zip(cols["path"], cols["warm"])
                            if not w and p in (PATH_FUSED,
                                               PATH_FUSED_SHARDED)),
            },
        }
DEFAULT_RESULT_TIMEOUT = 30.0
# stop()-time leftover drain budget: rows host-verified synchronously
# before remaining futures fail fast (a few seconds worst-case on the
# pure-Python path, not minutes)
STOP_DRAIN_MAX_ROWS = 2048


class PlaneError(Exception):
    """Base for plane-side failures: a host plane's callers fall back to
    host verify, a device plane's verify directly on its device."""


class PlaneQueueFull(PlaneError):
    """Backpressure: the pending queue is at max_queue."""


class PlaneOverloaded(PlaneError):
    """Explicit BULK-lane shed verdict: the plane cannot serve this
    submission inside its deadline (queue past its bound, or the
    submission aged out before a flush reached it). Never raised for
    CONSENSUS-lane submissions. Carries a retry-after hint so RPC
    callers can surface honest backoff to clients."""

    def __init__(self, msg: str, retry_after_ms: float = 0.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


class PlaneStopped(PlaneError):
    """Submitted to a plane that is not running."""


class VerifyFuture:
    """Resolves to a tuple of per-item bool verdicts (one submission may
    carry several signatures, e.g. a vote + its extension).

    ``flush_seq`` is the flush-ledger seq of the flush that served this
    submission (stamped at stage time, before the future resolves) —
    None until staged, and forever None for shed/failed submissions.
    The consensus height ledger joins it against /dump_flushes to
    attribute per-height verify-plane milliseconds."""

    __slots__ = ("_ev", "_verdicts", "_err", "flush_seq", "_on_device")

    def __init__(self, on_device: bool = False):
        self.flush_seq: Optional[int] = None
        # a device plane's future: a verdict that never comes is a
        # wedged device pass, so its timeout is a DeviceError
        self._on_device = on_device
        self._ev = threading.Event()
        self._verdicts: Optional[Tuple[bool, ...]] = None
        self._err: Optional[BaseException] = None

    def _resolve(self, verdicts: Sequence[bool]) -> None:
        self._verdicts = tuple(bool(v) for v in verdicts)
        self._ev.set()

    def _fail(self, err: BaseException) -> None:
        self._err = err
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Tuple[bool, ...]:
        if not self._ev.wait(DEFAULT_RESULT_TIMEOUT
                             if timeout is None else timeout):
            if self._on_device:
                raise DeviceError("verify plane result timed out on the "
                                  "device")
            raise PlaneError("verify plane result timed out")
        if self._err is not None:
            if isinstance(self._err, (PlaneError, DeviceError)):
                # preserve the concrete type: a dispatcher deadline
                # shed stores PlaneOverloaded (+ retry hint), and the
                # mempool's explicit-verdict arm dispatches on it —
                # flattening to PlaneError would silently re-route shed
                # txs into the inline host-verify fallback. A device
                # fault stays a DeviceError for the same reason: no
                # caller may take it for a plane-side failure and
                # verify on the host instead
                raise self._err
            raise PlaneError(str(self._err)) from self._err
        return self._verdicts


class QuorumGroup:
    """A fused voting-power tally target.

    Counted submissions tagged with a group add their power to the
    group's tally inside the dispatch pass (all signatures of the
    submission must verify). The quorum event fires the moment the
    tally crosses the threshold — the caller (VoteSet) learns quorum
    from the plane instead of re-tallying verdicts itself."""

    def __init__(self, threshold: int, name: str = "",
                 valset_pubs: Optional[tuple] = None,
                 valset_powers: Optional[tuple] = None):
        self.threshold = int(threshold)
        self.name = name
        # optional valset backing (pubkey bytes + powers, index-aligned):
        # lets the device flush reuse the cached window table and fuse
        # this group's tally into the verify kernel (fused.try_fused)
        self.valset_pubs = valset_pubs
        self.valset_powers = valset_powers
        self._lock = threading.Lock()
        self._tally = 0
        self._quorum = threading.Event()

    @property
    def tally(self) -> int:
        with self._lock:
            return self._tally

    @property
    def quorum_reached(self) -> bool:
        return self._quorum.is_set()

    def wait_quorum(self, timeout: Optional[float] = None) -> bool:
        return self._quorum.wait(timeout)

    def add(self, power: int) -> bool:
        """Add verified power; returns True when this add crossed the
        threshold."""
        with self._lock:
            old = self._tally
            self._tally += int(power)
            crossed = old < self.threshold <= self._tally
        if crossed:
            self._quorum.set()
        return crossed

    def retract(self, power: int) -> None:
        """Undo a tallied contribution (the caller's admission step
        found the vote inadmissible after all — duplicate race or
        equivocation). A retraction that drops the tally back below
        the threshold also clears the quorum event: the crossing was
        a transient double-count, not a real 2/3 (maj23 itself only
        flips on a genuine bv.sum crossing, so consensus never acted
        on the phantom signal)."""
        with self._lock:
            self._tally -= int(power)
            if self._tally < self.threshold:
                self._quorum.clear()


class _Submission:
    __slots__ = ("rows", "future", "group", "power", "counted",
                 "vidx", "t_submit", "t_submit_led", "clock_gen", "tid",
                 "lane", "tenant", "stamp")

    def __init__(self, rows, group, power, counted, vidx=None,
                 lane=LANE_CONSENSUS, tenant=None, stamp=None,
                 on_device=False):
        self.rows = rows                      # [(PubKey, msg, sig), ...]
        self.future = VerifyFuture(on_device)
        self.group = group
        self.power = int(power)
        self.counted = bool(counted)
        self.vidx = tuple(vidx) if vidx is not None else None
        self.lane = lane
        # device-stamp metadata: per-row (VoteRowTemplate, secs, nanos)
        # tuples aligned with rows (None entries — e.g. extension rows
        # — make the flush fall back to host packing). Attached by the
        # vote-set submitter when the msg was built from the template,
        # so metadata and bytes agree by construction.
        self.stamp = stamp
        # tenancy key: which chain this work belongs to (DEFAULT_TENANT
        # when the caller predates the multi-tenant plane) — drives the
        # ledger's per-tenant attribution, the fair-share drain, and
        # the quota gates (verifyplane/tenants.py)
        self.tenant = tenant if tenant else DEFAULT_TENANT
        self.t_submit = time.perf_counter()
        # ledger/trace-clock stamp for queued_ms: rides the ledger
        # clock (== the trace clock when tracing is on; virtual under
        # simnet) so ledgers AND traces of the same (seed, schedule)
        # stay byte-identical. Always stamped — the flush ledger needs
        # it with tracing off too.
        self.t_submit_led = tracing.monotonic_ns()
        # the stamp is only comparable to a flush-time reading taken
        # under the same clock generation (simnet clock install/restore
        # between submit and flush would difference two domains)
        self.clock_gen = tracing.clock_gen()
        self.tid = threading.get_ident()


class _Flight:
    """One staged flush on the dispatcher's deck: the submissions, the
    deferred finish() that blocks for verdicts, whether a device pass
    is genuinely airborne, the flush id, the ledger scratch record,
    the slot indices the pass occupies (None = one device or the host:
    the deck's disjoint-halves bookkeeping), and an optional
    non-blocking readiness probe for out-of-order landing."""

    __slots__ = ("batch", "finish", "airborne", "fid", "led", "devs",
                 "ready", "pack_idx")

    def __init__(self, batch, finish, airborne, fid, led, devs=None,
                 ready=None, pack_idx=0):
        self.batch = batch
        self.finish = finish
        self.airborne = airborne
        self.fid = fid
        self.led = led
        self.devs = devs
        self.ready = ready
        # per-plane pack ordinal: the staging pool rotates flights+1
        # slots round-robin, so pack m reuses pack m-(flights+1)'s
        # buffers — the dispatcher force-lands any flight that old
        # before packing (the rotation-window safety bound on
        # out-of-order landing)
        self.pack_idx = pack_idx


def _ready_index(deck) -> Optional[int]:
    """Index of the first deck flight whose readiness probe says its
    results are fetchable without blocking, or None. The probe is how
    the deck lands out of order: when flight k+1 finishes first, it
    settles first — no head-of-line blocking behind flight k."""
    for i, f in enumerate(deck):
        if f.ready is not None and f.ready():
            return i
    return None


def _host_verdicts(rows) -> List[bool]:
    """Inline host path: per-row single verify via the reference-path
    PubKey.verify_signature (ed25519_ref and friends)."""
    out = []
    for pub, msg, sig in rows:
        try:
            out.append(bool(pub.verify_signature(msg, sig)))
        except ValueError:
            out.append(False)
    return out


def verify_off_plane(plane: Optional["VerifyPlane"], pubs, msgs,
                     sigs, device=None) -> np.ndarray:
    """(n,) bool verdicts of rows that `plane` could not take (it raised
    a PlaneError), verified where the plane would have verified them: a
    device plane's on its device (crypto/batch.verify_batch_direct; a
    DeviceError propagates), a host plane's with the host reference;
    with no plane, on `device` (None: the card; ROADMAP C1)."""
    if plane is not None and plane.device is None:
        return np.asarray(_host_verdicts(list(zip(pubs, msgs, sigs))),
                          np.bool_)
    from cometbft_tpu_torch.crypto import batch as cbatch

    return cbatch.verify_batch_direct(
        pubs, msgs, sigs, device=device if plane is None else plane.device)


def consensus_batch_fn(device=None) -> Callable:
    """batch_fn(pubs, msgs, sigs) -> (n,) bool for a caller given no
    batch_fn (commit and evidence verification): the rows ride the
    running global plane's CONSENSUS lane, resolved at each call; rows
    the plane cannot take (a PlaneError) and every row when no plane runs
    go to verify_off_plane (the plane's device, a host plane's host, else
    `device`, None being the card). A DeviceError propagates (ROADMAP
    C1)."""

    def fn(pubs, msgs, sigs):
        p = global_plane()
        if p is not None:
            try:
                return p.submit_and_wait(pubs, msgs, sigs)
            except PlaneError:
                pass
        return verify_off_plane(p, pubs, msgs, sigs, device=device)

    return fn


def _device_fault(led, exc: BaseException):
    """A device plane's flush whose device pass faulted: record it on
    the flush's ledger record and raise the DeviceError its futures
    fail with."""
    led[_L_PATH] = PATH_DEVICE_FAULT
    raise _as_device_error(exc)


def _as_device_error(exc: BaseException) -> DeviceError:
    if isinstance(exc, DeviceError):
        return exc
    err = DeviceError(f"verify plane flush faulted on the device: {exc!r}")
    err.__cause__ = exc
    return err


class VerifyPlane:
    """Always-on background scheduler turning the device into a shared
    verification service. Start/stop with the node lifecycle."""

    def __init__(self, window_ms: float = 1.5, max_batch: int = 1024,
                 max_queue: int = 8192, metrics=None,
                 kernels: Optional[dict] = None, breaker=None,
                 use_device: Optional[bool] = None,
                 bulk_window_ms: Optional[float] = None,
                 bulk_max_queue: Optional[int] = None,
                 bulk_deadline_ms: float = 250.0,
                 gateway_window_ms: Optional[float] = None,
                 gateway_max_queue: Optional[int] = None,
                 gateway_deadline_ms: float = 500.0,
                 mesh_devices: Optional[int] = None,
                 mesh_min_rows: int = 256,
                 pipeline_flights: int = 1,
                 pipeline_flights_max: Optional[int] = None,
                 half_mesh_rows: int = 0,
                 tenants=None, device=None):
        from cometbft_tpu_torch.crypto import batch as cbatch
        from cometbft_tpu_torch.device import resolve
        from cometbft_tpu_torch.libs.staging import StagingPool

        self.window = max(0.0, window_ms) / 1000.0
        self.max_batch = max(1, int(max_batch))
        self.max_queue = max(1, int(max_queue))
        # BULK lane QoS knobs: a longer coalescing window (bulk cares
        # about batch fullness, not latency), its own queue bound, and
        # the shed deadline (0 disables deadline shedding)
        self.bulk_window = (self.window * 4 if bulk_window_ms is None
                            else max(0.0, bulk_window_ms) / 1000.0)
        self.bulk_max_queue = (self.max_queue if bulk_max_queue is None
                               else max(1, int(bulk_max_queue)))
        self.bulk_deadline = max(0.0, bulk_deadline_ms) / 1000.0
        # GATEWAY lane QoS knobs: client-facing header verifies — a
        # shorter window than BULK (an RPC caller is waiting) but still
        # coalescing-friendly, its own bound, and a more generous shed
        # deadline (a light-client sync tolerates more latency than a
        # CheckTx; 0 disables deadline shedding)
        self.gateway_window = (self.window * 2
                               if gateway_window_ms is None
                               else max(0.0, gateway_window_ms) / 1000.0)
        self.gateway_max_queue = (
            self.max_queue if gateway_max_queue is None
            else max(1, int(gateway_max_queue)))
        self.gateway_deadline = max(0.0, gateway_deadline_ms) / 1000.0
        # per-lane views the dispatcher and submit path index by lane
        self.lane_window = {LANE_CONSENSUS: self.window,
                            LANE_GATEWAY: self.gateway_window,
                            LANE_BULK: self.bulk_window}
        self.lane_limit = {LANE_CONSENSUS: self.max_queue,
                           LANE_GATEWAY: self.gateway_max_queue,
                           LANE_BULK: self.bulk_max_queue}
        self.lane_deadline = {LANE_GATEWAY: self.gateway_deadline,
                              LANE_BULK: self.bulk_deadline}
        self.metrics = metrics
        self._kernels = kernels
        self._breaker = breaker if breaker is not None \
            else cbatch.device_breaker()
        # device dispatch unless the caller asks for the inline host
        # path (use_device=False). The device is resolved here: None is
        # the CUDA card and raises DeviceError without a Hopper card —
        # there is no silent host fallback; device="cpu" runs the same
        # fused path on the kernels' plain versions (the CPU tests)
        self._use_device = True if use_device is None else bool(use_device)
        self.device = resolve(device) if self._use_device else None
        self._cv = threading.Condition()
        # per-lane pending queues + row counts (QoS: CONSENSUS drains
        # first; BULK is separately bounded and sheddable)
        self._pending: dict = {lane: deque() for lane in LANES}
        self._pending_rows: dict = {lane: 0 for lane in LANES}
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # observability (also mirrored into NodeMetrics when attached)
        self.dispatch_log: deque = deque(maxlen=DISPATCH_LOG_MAX)
        self.batches = 0
        self.rows_verified = 0
        self.padding_waste = 0
        self.pack_seconds = 0.0   # host staging time (template pack etc.)
        self.h2d_bytes = 0        # bytes staged to the device
        self.overlapped = 0       # flushes packed while another flew
        # QoS accounting: per-lane verified rows, sheds (CONSENSUS is
        # structurally always 0 — the soak harness asserts it), and a
        # bounded window of recent per-lane submit-to-result wall
        # latencies (real clock, powers the p99-under-flood assertions)
        self.lane_rows = {lane: 0 for lane in LANES}
        self.sheds = {lane: 0 for lane in LANES}
        self._shed_lock = threading.Lock()
        self.lane_waits = {lane: deque(maxlen=LANE_WAIT_WINDOW)
                           for lane in LANES}
        # multi-tenant plane (verifyplane/tenants.py): the registry
        # owning quotas, the fair-share rotation cursor, and the
        # per-tenant accounting /dump_tenants serves. Injected for
        # tests; every plane gets one — a single-chain node just never
        # registers a second tenant. _pending_tenant_rows is the O(1)
        # per-(lane, tenant) pending-row split the quota gate and the
        # fair-share fast path read under _cv (a dict per lane:
        # tenant -> rows, entries removed at zero so the common
        # single-tenant case stays a one-key dict).
        if tenants is None:
            from cometbft_tpu_torch.verifyplane.tenants import TenantRegistry

            tenants = TenantRegistry()
        self.tenants = tenants
        self._pending_tenant_rows: dict = {lane: {} for lane in LANES}
        # sharded dispatch ([verify_plane] mesh knobs): mesh_devices None
        # = one device; 0 = shard fused flushes over ALL the device's
        # slots (parallel/mesh.local_devices); N = cap at N.
        # mesh_min_rows keeps tiny flushes on one device — a sharded
        # pass only pays off once each slot's slice is worth its reduce.
        self._mesh_devices = (None if mesh_devices is None
                              else max(0, int(mesh_devices)))
        self.mesh_min_rows = max(0, int(mesh_min_rows))
        self._mesh = None          # resolved lazily, once
        self._mesh_resolved = False
        self.shard_flushes = 0     # flushes dispatched over a mesh
        self.shard_rows = 0        # rows those flushes carried
        self.mesh_ndev = 0         # resolved fan-out (0 = one device)
        # flight deck (pipelined mesh halves): up to `flights` flushes
        # airborne at once; with a >=4-slot mesh they alternate over
        # disjoint halves (resolved with the mesh). half_mesh_rows is
        # the policy knob: a flush over it takes the full mesh.
        self.flights = max(1, int(pipeline_flights))
        # controller ceiling: the deck may GROW to flights_max at
        # runtime (libs/controller), so everything sized at
        # construction (staging pool, mesh halves) must be sized for
        # the ceiling, not the starting value — a live grow must never
        # alias staging buffers
        self.flights_max = max(self.flights,
                               int(pipeline_flights_max or 0))
        self.half_mesh_rows = max(0, int(half_mesh_rows))
        self._halves: list = []    # resolved with the mesh
        self.deck_airborne = 0     # flights airborne right now
        self.deck_peak = 0         # deepest the deck ever got
        self._packs = 0            # pack ordinal (rotation-window bound)
        # device observatory: successful fused collects before this
        # plane declares the process steady (deviceledger.mark_steady),
        # and whether the compile listener armed yet (start() arms it;
        # the dispatch seam re-arms lazily)
        self._steady_flushes = 0
        self._listener_armed = False
        # always-on flush ledger (bounded ring; survives stop() — it is
        # read-only history, never cleared by the lifecycle)
        self.ledger = FlushLedger()
        self._flush_seq = itertools.count()  # per-plane, deterministic
        # PRIVATE staging pool: the rotation contract (one writer per
        # key) only holds per dispatcher thread — two planes in one
        # process (multi-node tests, simnet) must never share slots.
        # Depth tracks the deck: up to `flights` flushes pin their
        # buffers under airborne flights while the next one packs, so
        # flights+1 slots keep pack(k+2) off flight k's memory (the
        # old hardcoded 2 silently aliased the third pack's buffers).
        # Sized at the CEILING: the controller may grow flights live,
        # and the pool depth cannot change under airborne flights.
        self._staging = StagingPool(slots=self.flights_max + 1)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
        if self._use_device:
            # device observatory: arm the process-global compile
            # listener so every kernel build this plane's flushes
            # trigger lands in /dump_devices
            self._listener_armed = deviceledger.arm_compile_listener()
        self._thread = threading.Thread(
            target=self._run, name="verify-plane", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            if not self._running:
                return
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # resolve anything the dispatcher didn't drain (dispatcher died,
        # or the join timed out mid-flush) so no submitter ever hangs on
        # a stopped plane — and resolve with REAL verdicts, not an
        # error: callers that already passed submit() successfully treat
        # the future as authoritative. A device plane verifies them on
        # the device (a fault fails them with DeviceError), a host plane
        # on the inline host path. The drain pass is BUDGETED
        # (pure-Python ed25519 costs ms/row on wheel-less hosts): past
        # the budget, remaining futures fail fast with PlaneStopped
        # rather than pinning shutdown for minutes.
        leftovers = []
        with self._cv:
            # CONSENSUS first: the drain budget must favor the lane
            # that is never shed
            for lane in LANES:
                q = self._pending[lane]
                while q:
                    leftovers.append(q.popleft())
                self._pending_rows[lane] = 0
                self._pending_tenant_rows[lane].clear()
        budget = STOP_DRAIN_MAX_ROWS
        settle, fail = [], []
        for sub in leftovers:
            if budget >= len(sub.rows):
                budget -= len(sub.rows)
                settle.append(sub)
            else:
                fail.append(sub)
        if settle:
            rows = [r for sub in settle for r in sub.rows]
            t0 = tracing.monotonic_ns()
            drain_seq = next(self._flush_seq)
            for sub in settle:
                sub.future.flush_seq = drain_seq
            err = None
            if self._use_device:
                try:
                    verdicts = self._verify_rows(rows)
                except Exception as exc:  # noqa: BLE001 - device fault
                    err = _as_device_error(exc)
            else:
                verdicts = _host_verdicts(rows)
            t1 = tracing.monotonic_ns()
            if err is None:
                self._settle(settle, verdicts)
            else:
                for sub in settle:
                    sub.future._fail(err)
            # the drain is a flush too: the ledger must explain where
            # shutdown time went (and survive into post-stop dumps)
            c_rows = sum(len(s.rows) for s in settle
                         if s.lane == LANE_CONSENSUS)
            g_rows = sum(len(s.rows) for s in settle
                         if s.lane == LANE_GATEWAY)
            drain_tens = _tenant_split(settle)
            self.ledger.record([
                drain_seq, round(t0 / 1e6, 3), len(rows),
                len(settle), 0.0, 0.0, 0.0,
                round((t1 - t0) / 1e6, 3),
                round((tracing.monotonic_ns() - t1) / 1e6, 3),
                0, PATH_STOP_DRAIN if err is None else PATH_DEVICE_FAULT,
                STAMP_HOST, self._breaker.state,
                0, 0,
                c_rows, g_rows, len(rows) - c_rows - g_rows, 0, 1,
                1, 0, 0, 0.0, 0.0, 0, 0.0, 0.0, drain_tens,
                SPLIT_EXACT if len(drain_tens) <= 1 else SPLIT_ROWS,
            ])
        for sub in fail:
            sub.future._fail(PlaneStopped(
                "verify plane stopped with queue over the drain budget"
            ))

    def is_running(self) -> bool:
        return self._running

    def in_dispatcher(self) -> bool:
        """True on the dispatcher thread (recursion guard: the
        dispatcher's own verify calls must not re-enter the plane)."""
        return threading.current_thread() is self._thread

    # -- submission --------------------------------------------------------

    def submit(self, pub, msg: bytes, sig: bytes, power: int = 0,
               group: Optional[QuorumGroup] = None, counted: bool = False,
               vidx: Optional[int] = None,
               block: bool = True, lane: str = LANE_CONSENSUS,
               chain_id: Optional[str] = None) -> VerifyFuture:
        """Submit one (pubkey, msg, sig); the future resolves to a
        1-tuple verdict."""
        return self.submit_many(
            [(pub, msg, sig)], power=power, group=group, counted=counted,
            vidx=None if vidx is None else (vidx,), block=block,
            lane=lane, chain_id=chain_id,
        )

    def submit_many(self, rows, power: int = 0,
                    group: Optional[QuorumGroup] = None,
                    counted: bool = False,
                    vidx: Optional[Sequence[int]] = None,
                    block: bool = True,
                    lane: str = LANE_CONSENSUS,
                    chain_id: Optional[str] = None,
                    stamp=None) -> VerifyFuture:
        """Submit several signatures as ONE unit (e.g. a vote and its
        extension): one future, per-row verdicts, and — when counted —
        the group tally credits `power` only if EVERY row verifies.
        vidx (one validator index per row) enables the fused cached-
        table device path for valset-backed groups; row 0 must be the
        power-bearing signature (the vote; extensions follow).

        `lane` picks the QoS class. GATEWAY/BULK submissions over the
        lane's queue bound raise PlaneOverloaded immediately when
        non-blocking (the explicit shed verdict, with a retry-after
        hint) instead of PlaneQueueFull, and may later be shed by the
        dispatcher if they age past the lane's deadline before a flush
        can take them. A blocking sheddable-lane submission whose
        backpressure wait times out is shed the same explicit way.

        `chain_id` keys the submission to its tenant
        (verifyplane/tenants.py): the ledger attributes the rows, the
        fair-share drain rotates between queued tenants, and a tenant
        past its pending-row quota on a sheddable lane is shed
        immediately with a TenantOverloaded verdict — a hard quota,
        not backpressure, so waiting is never offered. CONSENSUS is
        structurally outside every tenant gate.

        `stamp` (optional, aligned with rows) carries per-row
        (VoteRowTemplate, secs, nanos) metadata so the fused path can
        stage only deltas and stamp sign-bytes on device; None entries
        (extensions, non-votes) force host packing for the flush."""
        if lane not in LANES:
            raise ValueError(f"unknown verify-plane lane {lane!r}")
        rows = list(rows)
        if not rows:
            raise ValueError("empty submission")
        if not self._running or self.in_dispatcher():
            raise PlaneStopped("verify plane not accepting submissions")
        sub = _Submission(rows, group, power, counted, vidx, lane=lane,
                          tenant=chain_id, stamp=stamp,
                          on_device=self.device is not None)
        limit = self.lane_limit[lane]
        quota = (self.tenants.row_quota(sub.tenant)
                 if lane in SHEDDABLE_LANES else 0)
        deadline = time.monotonic() + DEFAULT_RESULT_TIMEOUT
        with self._cv:
            if quota:
                pend = self._pending_tenant_rows[lane].get(sub.tenant, 0)
                if pend and pend + len(rows) > quota:
                    self._shed_count(1, lane)
                    self.tenants.note_shed(sub.tenant, lane)
                    from cometbft_tpu_torch.verifyplane.tenants import \
                        TenantOverloaded

                    raise TenantOverloaded(
                        f"tenant {sub.tenant!r} past its {quota}-row "
                        f"{lane} quota",
                        retry_after_ms=self._retry_hint_ms(lane),
                        tenant=sub.tenant,
                    )
            # backpressure gates on what is already queued in THIS lane
            # — a lone submission larger than the bound still enters an
            # empty queue (it dispatches alone) instead of deadlocking
            while self._running and self._pending_rows[lane] and \
                    self._pending_rows[lane] + len(rows) > limit:
                if not block:
                    if lane in SHEDDABLE_LANES:
                        self._shed_count(1, lane)
                        raise PlaneOverloaded(
                            f"verify plane {lane} lane full "
                            f"({limit} rows)",
                            retry_after_ms=self._retry_hint_ms(lane),
                        )
                    raise PlaneQueueFull(
                        f"verify plane queue full ({limit} rows)"
                    )
                if not self._cv.wait(timeout=deadline - time.monotonic()) \
                        and time.monotonic() >= deadline:
                    if lane in SHEDDABLE_LANES:
                        self._shed_count(1, lane)
                        raise PlaneOverloaded(
                            f"verify plane {lane} backpressure wait "
                            f"timed out",
                            retry_after_ms=self._retry_hint_ms(lane),
                        )
                    raise PlaneQueueFull(
                        "verify plane backpressure wait timed out"
                    )
            if not self._running:
                raise PlaneStopped("verify plane stopped")
            self._pending[lane].append(sub)
            self._pending_rows[lane] += len(rows)
            tpend = self._pending_tenant_rows[lane]
            tpend[sub.tenant] = tpend.get(sub.tenant, 0) + len(rows)
            depth = self._depth_locked()
            if self.metrics is not None:
                self.metrics.plane_queue_depth.set(depth)
            self._cv.notify_all()
        if tracing.enabled():
            tracing.instant("plane.submit", cat="verifyplane",
                            rows=len(rows), depth=depth, lane=lane)
        return sub.future

    def _depth_locked(self) -> int:
        return sum(self._pending_rows[lane] for lane in LANES)

    def _tenant_unpend(self, lane: str, sub: "_Submission") -> None:
        """_cv held: release a dequeued submission's rows from the
        per-(lane, tenant) pending split (entries drop at zero so the
        dict never grows with retired tenants)."""
        tpend = self._pending_tenant_rows[lane]
        n = tpend.get(sub.tenant, 0) - len(sub.rows)
        if n > 0:
            tpend[sub.tenant] = n
        else:
            tpend.pop(sub.tenant, None)

    def _retry_hint_ms(self, lane: str = LANE_BULK) -> float:
        """Honest backoff hint for shed callers: the lane's deadline is
        the time scale on which its backlog either clears or sheds, so
        retrying sooner than that is guaranteed wasted work."""
        return round(max(self.lane_deadline.get(lane, 0.0),
                         self.lane_window[lane]) * 1000, 1)

    def _shed_count(self, n: int, lane: str = LANE_BULK) -> None:
        # dedicated lock: the submit path sheds while HOLDING _cv and
        # the dispatcher sheds outside it — an unguarded += would lose
        # increments exactly during the overload bursts this counts
        with self._shed_lock:
            self.sheds[lane] += n
        if self.metrics is not None:
            self.metrics.plane_shed.inc(n, lane=lane)
        # incident watchdog: sheds feed the storm window (counted here,
        # evaluated at the next deterministic poke — libs/incidents)
        from cometbft_tpu_torch.libs import incidents

        incidents.note_shed(n)

    def submit_and_wait(self, pubs, msgs, sigs,
                        timeout: Optional[float] = None,
                        lane: str = LANE_CONSENSUS,
                        chain_id: Optional[str] = None) -> np.ndarray:
        """crypto.batch.verify_batch shape: (n,) bool validity through
        the plane (one submission, one flush slot)."""
        fut = self.submit_many(list(zip(pubs, msgs, sigs)), lane=lane,
                               chain_id=chain_id)
        if timeout is None:
            # scale with batch size: a 10k-row host-path flush on a
            # 1-core box legitimately outlives the default window
            timeout = max(DEFAULT_RESULT_TIMEOUT, 0.05 * len(pubs))
        return np.asarray(fut.result(timeout), np.bool_)

    # -- dispatcher --------------------------------------------------------

    def _run(self) -> None:
        """Flight-deck dispatch loop: while up to `flights` flushes fly
        on the device, the dispatcher drains and PACKS the next flush
        into the rotated staging buffers (libs/staging.py) and
        dispatches it behind them — the blocksync pipeline's overlap
        (pipeline.py "host packs chunk k+1 while the device works"),
        generalized to every caller.
        Airborne flights land out of order via the readiness probe, so
        flight k+1 finishing early never waits behind k. With any
        flight airborne the window wait is skipped: the in-flight pass
        IS the coalescing amortization the window exists to provide.
        pipeline_flights=1 is exactly the classic single-slot double
        buffer."""
        deck: List[_Flight] = []  # airborne flights, dispatch order
        while True:
            # self-tuning seam: one controller poke per drain cycle,
            # OUTSIDE the cv (the controller may call actuator setters
            # that take it). No-op when no controller is mounted.
            controlplane.poke_drain()
            batch: List[_Submission] = []
            shed: List[_Submission] = []
            depth = 0
            with self._cv:
                while self._running:
                    cq = self._pending[LANE_CONSENSUS]
                    waitq = wait_lane = None
                    if not cq:
                        # highest-priority sheddable lane with traffic
                        # coalesces under its own longer window
                        for lane in SHEDDABLE_LANES:
                            if self._pending[lane]:
                                waitq, wait_lane = \
                                    self._pending[lane], lane
                                break
                    if cq:
                        # CONSENSUS owns the flush window: full GATEWAY
                        # or BULK queues can never delay a consensus
                        # flush past its deadline — their rows only
                        # ride along
                        age = time.perf_counter() - cq[0].t_submit
                        if (deck
                                or age >= self.window
                                or self._pending_rows[LANE_CONSENSUS]
                                >= self.max_batch):
                            break
                        self._cv.wait(timeout=self.window - age)
                    elif waitq is not None:
                        win = self.lane_window[wait_lane]
                        age = time.perf_counter() - waitq[0].t_submit
                        if (deck
                                or age >= win
                                or self._pending_rows[wait_lane]
                                >= self.max_batch):
                            break
                        self._cv.wait(timeout=win - age)
                    elif deck:
                        break  # nothing to pack: land a flight
                    else:
                        self._cv.wait(timeout=0.25)
                if not self._running \
                        and not any(self._pending[lane]
                                    for lane in LANES):
                    break
                # deadline sheds first: an aged-out GATEWAY/BULK
                # submission is past the point where verifying it helps
                # anyone (its RPC caller has backed off) — it must not
                # consume flush capacity. Resolved below with an
                # EXPLICIT PlaneOverloaded verdict, never silently
                # dropped. Ages ride the LEDGER clock (virtual under
                # simnet), not perf_counter: a shed is a VERDICT, and
                # the soak harness asserts the verdict stream replays
                # byte-identically — a real-clock cutoff would make it
                # host-load-dependent. In production the ledger clock
                # IS the monotonic real clock, so behavior there is
                # unchanged. Cross-generation stamps (clock swapped
                # mid-queue) are treated as fresh.
                gen = tracing.clock_gen()
                now_ns = tracing.monotonic_ns()
                for lane in SHEDDABLE_LANES:
                    if not self.lane_deadline[lane]:
                        continue
                    q = self._pending[lane]
                    cutoff = now_ns - int(self.lane_deadline[lane] * 1e9)
                    while q and q[0].clock_gen == gen \
                            and q[0].t_submit_led < cutoff:
                        sub = q.popleft()
                        self._pending_rows[lane] -= len(sub.rows)
                        self._tenant_unpend(lane, sub)
                        shed.append(sub)
                # weighted drain: whole CONSENSUS submissions first up
                # to max_batch rows (a lone oversized submission still
                # dispatches alone), then GATEWAY and finally BULK fill
                # the remaining capacity — each with its guaranteed
                # anti-starvation quantum, so every lane makes progress
                # even under a sustained higher-priority storm.
                # CONSENSUS drains whole with NO tenant gate in the
                # loop — per-tenant unsheddability is structural here,
                # exactly like the lane wall: no quota, no rotation,
                # no code path that could skip one tenant's votes.
                rows = 0
                cq = self._pending[LANE_CONSENSUS]
                while cq:
                    nxt = len(cq[0].rows)
                    if batch and rows + nxt > self.max_batch:
                        break
                    sub = cq.popleft()
                    self._pending_rows[LANE_CONSENSUS] -= nxt
                    self._tenant_unpend(LANE_CONSENSUS, sub)
                    rows += nxt
                    batch.append(sub)
                quantum = max(1, self.max_batch // BULK_QUANTUM_DIV)
                for lane in SHEDDABLE_LANES:
                    q = self._pending[lane]
                    budget = max(self.max_batch - rows, quantum)
                    rows += self._drain_sheddable(lane, q, budget, batch)
                depth = self._depth_locked()
                if self.metrics is not None:
                    self.metrics.plane_queue_depth.set(depth)
                self._cv.notify_all()  # wake backpressured submitters
            if shed:
                for sub in shed:
                    self._shed_count(1, sub.lane)
                    self.tenants.note_shed(sub.tenant, sub.lane)
                    sub.future._fail(PlaneOverloaded(
                        f"verify plane shed {sub.lane} submission past "
                        f"its "
                        f"{round(self.lane_deadline[sub.lane] * 1000, 1)}"
                        f"ms deadline",
                        retry_after_ms=self._retry_hint_ms(sub.lane),
                    ))
                if not batch:
                    # a drain cycle can shed everything and cut no
                    # flush — the ledger must still say so, or
                    # /dump_flushes' shed column disagrees with the
                    # sheds counter exactly when an operator is
                    # debugging overload
                    t = tracing.monotonic_ns()
                    self.ledger.record([
                        next(self._flush_seq), round(t / 1e6, 3), 0, 0,
                        0.0, 0.0, 0.0, 0.0, 0.0, 0, PATH_SHED_ONLY,
                        STAMP_HOST,
                        self._breaker.state, 0, depth, 0, 0, 0,
                        len(shed), 0, 0, 0, 0, 0.0, 0.0, 0, 0.0, 0.0, (),
                        SPLIT_EXACT,
                    ])
            if not batch:
                # nothing to pack: land a flight (the first READY one,
                # else wait briefly for new work or readiness — landing
                # the oldest blind would block the dispatcher exactly
                # when a new flush could be packed)
                if deck:
                    self._land_or_wait(deck)
                continue
            # staging-rotation safety: the pool hands pack m the very
            # buffers pack m-(flights+1) filled, so a flight that old
            # must LAND (FIFO, blocking) before this pack may touch
            # its memory — out-of-order landing is free only within
            # the pool's rotation window, never across it
            while deck and deck[0].pack_idx <= self._packs - self.flights:
                self._finish_flight(deck.pop(0))
                self._deck_update(deck)
            flight = self._stage(batch, depth, shed_n=len(shed),
                                 deck=deck)
            # flights in the air at dispatch time (after any drain the
            # fan-out policy forced): the ledger's airborne column and
            # the overlap counter — a real overlap means this flush
            # packed on the host while >=1 flight flew on the device
            air = len(deck)
            flight.led[_L_AIR] = air
            if air:
                self.overlapped += 1
            if flight.airborne:
                deck.append(flight)
                self._deck_update(deck)
                while len(deck) > self.flights:
                    self._land_one(deck)
            else:
                # synchronous flush (host path / grouped device):
                # verdicts are already final — land the airborne deck
                # first (its flights dispatched earlier), then settle
                # NOW; deferring would add a whole flush of latency
                # for no overlap
                while deck:
                    self._land_one(deck)
                self._finish_flight(flight)
        while deck:
            self._land_one(deck)

    def _drain_sheddable(self, lane: str, q, budget: int,
                         batch: List[_Submission]) -> int:
        """_cv held: fill up to `budget` rows from one sheddable lane
        into `batch`; returns the rows taken. With ONE tenant queued
        this is the original FIFO loop (O(1) dict probe, no extra
        work on the single-chain plane). With several, the fair-share
        drain: submissions bucket per tenant (FIFO within each), the
        registry's rotation cursor picks the cycle's order, and each
        tenant gets an equal share of the budget before a second pass
        hands unused capacity back out in the same rotation order —
        so a flooding tenant can fill leftover capacity but can never
        crowd a quieter tenant out of its slice, and the head-of-line
        position rotates instead of favoring one chain forever."""
        if len(self._pending_tenant_rows[lane]) <= 1:
            lrows = 0
            while q:
                nxt = len(q[0].rows)
                if batch and lrows + nxt > budget:
                    break
                sub = q.popleft()
                self._pending_rows[lane] -= nxt
                self._tenant_unpend(lane, sub)
                lrows += nxt
                batch.append(sub)
            return lrows
        buckets: dict = {}
        for sub in q:
            buckets.setdefault(sub.tenant, []).append(sub)
        order = self.tenants.drain_order(buckets)
        share = max(1, budget // len(order))
        taken_ids = set()
        lrows = 0
        # pass 1: each tenant up to its equal share (oldest first)
        for name in order:
            b = buckets[name]
            trows = 0
            while b:
                nxt = len(b[0].rows)
                if batch and (trows + nxt > share
                              or lrows + nxt > budget):
                    break
                sub = b.pop(0)
                trows += nxt
                lrows += nxt
                taken_ids.add(id(sub))
                batch.append(sub)
        # pass 2: leftover capacity (tenants under their share left
        # some) goes back out greedily in the same rotation order
        for name in order:
            b = buckets[name]
            while b:
                nxt = len(b[0].rows)
                if batch and lrows + nxt > budget:
                    break
                sub = b.pop(0)
                lrows += nxt
                taken_ids.add(id(sub))
                batch.append(sub)
            if batch and b:
                break  # budget exhausted mid-bucket
        if taken_ids:
            remaining = [s for s in q if id(s) not in taken_ids]
            q.clear()
            q.extend(remaining)
            for sub in batch:
                if id(sub) in taken_ids:
                    self._pending_rows[lane] -= len(sub.rows)
                    self._tenant_unpend(lane, sub)
        return lrows

    def _land_one(self, deck: List[_Flight]) -> None:
        """Land one deck flight: the first READY one (out-of-order —
        flight k+1 landing first never blocks behind k), else the
        oldest (FIFO; its collect blocks until the device finishes)."""
        idx = _ready_index(deck)
        self._finish_flight(deck.pop(0 if idx is None else idx))
        self._deck_update(deck)

    def _land_or_wait(self, deck: List[_Flight]) -> None:
        """Idle-deck landing: settle a READY flight immediately; with
        none ready, poll in short slices for readiness or new work for
        up to one window (new work wins — it can be packed while the
        deck stays airborne), then land FIFO regardless: futures
        must resolve even when the runtime offers no readiness probe.
        Only ever called with device flights airborne, so the simnet
        host path (and its ledger determinism) never touches the
        real-clock polling here."""
        idx = _ready_index(deck)
        if idx is None:
            deadline = time.perf_counter() + max(self.window, 0.1)
            while True:
                with self._cv:
                    if self._running and not self._depth_locked():
                        self._cv.wait(timeout=0.005)
                    if self._depth_locked():
                        return  # pack the new flush first
                idx = _ready_index(deck)
                if idx is not None or not self._running \
                        or time.perf_counter() >= deadline:
                    break
            if idx is None:
                idx = 0  # probe can't tell: land FIFO, collect blocks
        self._finish_flight(deck.pop(idx))
        self._deck_update(deck)

    def _deck_update(self, deck: List[_Flight]) -> None:
        n = len(deck)
        self.deck_airborne = n
        if n > self.deck_peak:
            self.deck_peak = n
        if self.metrics is not None:
            self.metrics.plane_deck_airborne.set(float(n))

    def _pick_half(self, deck: List[_Flight]):
        """The sub-mesh half the next fused flush should prefer: a half
        with NO airborne flight (disjoint slots — both halves fly at
        once), else the OLDEST flight's half (it lands soonest; the new
        flush queues behind it on that half, as the classic single slot
        queued behind the one in-flight pass). Disjointness is by slot
        index: two halves of slots of one card share its device."""
        halves = self._halves
        if not halves or self.flights < 2:
            return None
        busy = set()
        for f in deck:
            busy.update(f.devs or ())
        for h in halves:
            if busy.isdisjoint(h.indices):
                return h
        old = deck[0].devs or ()
        for h in halves:
            if old and old[0] in h.indices:
                return h
        return halves[0]

    def _finish_flight(self, flight: _Flight) -> None:
        # hook audit (r05 post-mortem suspect #1): every tracing span
        # here sits behind an `enabled()` check so the DISABLED path
        # constructs no span object and no kwargs dict — the only
        # per-flush bookkeeping is the ledger stamps (plain int clock
        # reads) and the ring tuple.
        batch, finish, airborne, fid, led = (
            flight.batch, flight.finish, flight.airborne, flight.fid,
            flight.led)
        traced = tracing.enabled()
        t_exec = tracing.monotonic_ns()
        # collect-time builds (the first grouped-path kernel build)
        # attribute to this flush too — comp_ms must name every build
        # the flush paid
        attr = deviceledger.attr_begin("plane.collect", led[_L_SEQ])
        # an airborne flush is fetched here; a synchronous one's
        # deferred host/grouped verification happens here, attributed
        # to its own stage. A device fault fails the flush's futures.
        err = None
        try:
            if traced:
                with tracing.span("plane.collect" if airborne
                                  else "plane.verify", cat="verifyplane",
                                  flush=fid):
                    verdicts, fused_tallies = finish()
            else:
                verdicts, fused_tallies = finish()
        except DeviceError as exc:
            err = exc
        if airborne and traced:
            tracing.flight_end("plane.flight", fid, cat="verifyplane")
        deviceledger.attr_end(attr)
        if attr.ms:
            led[_L_COMP] = round(led[_L_COMP] + attr.ms, 3)
        t_settle = tracing.monotonic_ns()
        if err is not None:
            for sub in batch:
                sub.future._fail(err)
        elif traced:
            with tracing.span("plane.settle", cat="verifyplane",
                              flush=fid):
                self._settle(batch, verdicts, fused_tallies=fused_tallies)
        else:
            self._settle(batch, verdicts, fused_tallies=fused_tallies)
        t_done = tracing.monotonic_ns()
        # flight_ms: time the pass was airborne before the dispatcher
        # came back for it (the overlap window the double buffer wins);
        # collect_ms: the blocking fetch (or the sync verify itself).
        # The scratch list mutates in place and becomes the ring slot.
        # Differencing needs every stamp from one clock domain: a
        # tracing enable/disable or simnet clock install/restore while
        # the flush was airborne (test/bench teardown) would difference
        # a virtual-epoch ns against a perf_counter ns — same hazard
        # queued_ms guards with clock_gen at pack time. The stage
        # timings are recorded as 0.0 then; the record itself stays.
        if tracing.clock_gen() == led[_L_GEN]:
            if airborne:
                led[_L_FLIGHT] = round((t_exec - led[_L_TPACKED]) / 1e6, 3)
                # on-device time estimate: dispatch -> the first TRUE
                # readiness probe when the deck observed one (the
                # kernel-flight figure), else dispatch -> fetch done
                # (an upper bound that includes the d2h copy)
                ready_ns = led[_L_READY]
                led[_L_DEV] = round(
                    ((ready_ns if ready_ns else t_settle)
                     - led[_L_TPACKED]) / 1e6, 3) \
                    if led[_L_DEVEV] is None else round(led[_L_DEVEV], 3)
            led[_L_COLLECT] = round((t_settle - t_exec) / 1e6, 3)
            led[_L_SETTLE] = round((t_done - t_settle) / 1e6, 3)
        self._charge_flush(led)
        self.ledger.record(led)

    def _charge_flush(self, led) -> None:
        """The cost observatory's per-flush hook, run once with every
        column final (just before the record becomes a ring slot):
        charge the flush's device-time columns to its tenants under
        the recorded split rule, and feed the device ledger's cost
        surfaces one observation. Always on — the whole hook stays
        under the 10 us budget (bench.cost_hooks_bookkeeping_us,
        asserted in tier-1), so there is no enable knob to forget."""
        tens = led[_L_TEN]
        if tens:
            rule, shares = split_device_columns(
                tens, led[_L_ROWS], led[_L_COMP], led[_L_H2D],
                led[_L_DEV], led[_L_DBYTES])
            led[_L_SPLIT] = rule
            self.tenants.note_device_shares(shares)
        # kernel cost surfaces: the on-device estimate when this flush
        # flew, else the collect wall (the host/grouped verify runs
        # inside the collect span — still the marginal cost of rows)
        deviceledger.observe_flush(
            led[_L_PATH], led[_L_STAMP], led[_L_ROWS], led[_L_NDEV],
            led[_L_COMP], led[_L_H2D],
            led[_L_DEV] if led[_L_DEV] else led[_L_COLLECT])

    def _observe_pack(self, seconds: float, h2d_bytes: int = 0,
                      stamp: str = STAMP_HOST) -> None:
        self.pack_seconds += seconds
        self.h2d_bytes += h2d_bytes
        if self.metrics is not None:
            self.metrics.plane_pack_seconds.observe(seconds)
            if h2d_bytes:
                # split by staging path so a dashboard can watch the
                # device-stamp rollout shrink the bus bill directly
                self.metrics.plane_h2d_bytes.inc(h2d_bytes, path=stamp)

    def _stage(self, batch: List[_Submission], depth: int = 0,
               shed_n: int = 0, deck: List[_Flight] = ()):
        """Pack one flush and (when eligible) launch it on the device
        WITHOUT waiting for results. Returns a _Flight whose finish()
        blocks for the verdicts — the seam that lets the dispatcher
        pack the next flush while this one (and the rest of the deck)
        flies. The whole host-side staging is one "plane.pack" trace
        span keyed by flush id, so pack(k+1) visibly overlaps
        device-flight(k) in the exported timeline.

        Ledger accounting happens on BOTH paths: the disabled-tracing
        fast path still stamps the clock and fills the scratch list
        (ints and interned strings only — no dict/span construction,
        the r05 post-mortem's suspect #1)."""
        fid = next(_FLUSH_IDS)
        self._packs += 1
        t0 = tracing.monotonic_ns()
        gen = tracing.clock_gen()
        t_min = None
        rows = 0
        c_rows = 0
        g_rows = 0
        tens: dict = {}
        for s in batch:
            rows += len(s.rows)
            tens[s.tenant] = tens.get(s.tenant, 0) + len(s.rows)
            if s.lane == LANE_CONSENSUS:
                c_rows += len(s.rows)
            elif s.lane == LANE_GATEWAY:
                g_rows += len(s.rows)
            if s.clock_gen != gen:
                # stamped under a different clock domain (simnet clock
                # swapped between submit and flush): unusable for a wait
                continue
            ts = s.t_submit_led
            if t_min is None or ts < t_min:
                t_min = ts
        queued_ms = round((t0 - t_min) / 1e6, 3) if t_min is not None \
            else 0.0
        # FIELDS-ordered record + internal slots (t0, t_packed, clock
        # gen, first-ready stamp); this list IS the eventual ring slot
        led = [next(self._flush_seq), round(t0 / 1e6, 3), rows,
               len(batch), queued_ms, 0.0, 0.0, 0.0, 0.0, 0,
               PATH_HOST, STAMP_HOST, self._breaker.state, 0, depth,
               c_rows, g_rows, rows - c_rows - g_rows, shed_n, 1, 1,
               0, 0, 0.0, 0.0, 0, 0.0, 0.0, tuple(sorted(tens.items())),
               SPLIT_EXACT if len(tens) <= 1 else SPLIT_ROWS,
               t0, t0, gen, 0, None]
        for s in batch:
            # the join key consumers read AFTER the future resolves
            # (height ledger -> /dump_flushes attribution)
            s.future.flush_seq = led[_L_SEQ]
        if not tracing.enabled():
            # disabled fast path: no O(batch) span-arg computation on
            # the dispatcher hot path
            finish, airborne, devs, ready = self._stage_inner(
                batch, fid, led, deck)
        else:
            with tracing.span("plane.pack", cat="verifyplane", flush=fid,
                              rows=rows, subs=len(batch),
                              queued_ms=queued_ms):
                finish, airborne, devs, ready = self._stage_inner(
                    batch, fid, led, deck)
        t1 = tracing.monotonic_ns()
        led[_L_PACK] = round((t1 - t0) / 1e6, 3)
        led[_L_TPACKED] = t1
        if ready is not None:
            # wrap the readiness probe to stamp the FIRST true reading
            # (dispatcher thread only): dev_ms = dispatch -> kernel
            # done, the observatory's on-device time estimate
            def probe(inner=ready, led=led):
                ok = inner()
                if ok and not led[_L_READY] \
                        and tracing.clock_gen() == led[_L_GEN]:
                    led[_L_READY] = tracing.monotonic_ns()
                return ok

            ready = probe
        return _Flight(batch, finish, airborne, fid, led, devs, ready,
                       pack_idx=self._packs)

    def _flush_mesh(self, rows: int):
        """The mesh a fused flush of `rows` rows should shard over, or
        None for one device. Resolution is lazy and cached (mesh
        identity feeds every downstream memo); flushes under
        mesh_min_rows stay on one device — the reduce isn't free and
        tiny flushes fit one device's columns anyway."""
        if self._mesh_devices is None or rows < self.mesh_min_rows:
            return None
        if not self._mesh_resolved:
            from cometbft_tpu_torch.verifyplane import fused as fz

            try:
                self._mesh = fz.plane_mesh(self._mesh_devices, self.device)
            except Exception:  # noqa: BLE001 - no slots: stay single
                _log.exception("verify plane mesh did not resolve; one "
                               "device")
                self._mesh = None
            self.mesh_ndev = 0 if self._mesh is None else self._mesh.size
            if self.flights_max > 1 and self._mesh is not None:
                # the deck's disjoint halves ride the same memoized
                # sub-mesh seam effective_mesh clamps through; meshes
                # under 4 slots have none (single-flight dispatch).
                # Gated on the CEILING, not the live value: the
                # controller may grow flights after the mesh resolved
                self._halves = fz.half_meshes(self._mesh)
            # published LAST: the warmer's _mesh_targets reads
            # (_mesh_resolved, _mesh, _halves) from its own thread —
            # seeing resolved=True with the halves still unassigned
            # would warm the full mesh instead of the halves flushes
            # actually look tables up under
            self._mesh_resolved = True
            if self.metrics is not None:
                self.metrics.plane_shard_ndev.set(float(self.mesh_ndev))
        return self._mesh

    def _stage_inner(self, batch: List[_Submission], fid: int, led,
                     deck: List[_Flight] = ()):
        """The breaker's allow() — which consumes the single half-open
        probe slot when the breaker is open — is only asked once a
        fused plan exists, i.e. when a device attempt will actually
        happen; an ineligible flush must not burn the probe the
        generic path needs to recover. Returns (finish, airborne, devs,
        ready): finish() gives (verdicts, fused tallies or None), or
        raises DeviceError for a device plane's flush that faulted;
        devs are the slot indices a sharded flush occupies."""
        rows = [r for sub in batch for r in sub.rows]
        t0 = time.perf_counter()
        miss0 = self._staging.misses
        try:
            fp.fail_point("verifyplane.dispatch")
        except Exception as exc:  # noqa: BLE001 - dispatch fault, not verdicts
            # verdict work is deferred into finish() so the pack span
            # measures staging only (the finish runs immediately for
            # synchronous flushes — same thread, same ordering)
            if self._use_device:
                _log.exception(
                    "verify plane dispatch fault (%d rows); failing this "
                    "flush with DeviceError", len(rows))
                return (lambda e=exc: _device_fault(led, e)), False, \
                    None, None
            _log.exception(
                "verify plane dispatch fault (%d rows); degrading this "
                "flush to the inline host path", len(rows),
            )
            led[_L_PATH] = PATH_FAILPOINT
            return (lambda: (_host_verdicts(rows), None)), False, None, \
                None
        plan = None
        if self._use_device:
            # lazy re-arm (a plane whose start() did not arm it): a
            # plane-level flag keeps the steady-state cost at one
            # attribute check
            if not self._listener_armed:
                self._listener_armed = \
                    deviceledger.arm_compile_listener()
        if self._use_device and self._kernels is None:
            from cometbft_tpu_torch.verifyplane import fused as fz

            try:
                mesh = self._flush_mesh(len(rows))
                half = self._pick_half(deck) if mesh is not None \
                    else None
                plan = fz.plan_fused(batch, pool=self._staging,
                                     device=self.device, mesh=mesh,
                                     half=half,
                                     half_max_rows=self.half_mesh_rows)
            except Exception:  # noqa: BLE001 - staging bug, not device
                _log.exception("fused flush staging failed; grouped path")
                plan = None
            if plan is not None and not self._breaker.allow():
                plan = None
        if plan is not None:
            if plan.drain_first and deck:
                # the policy sent this flush to the FULL mesh while
                # half-flights are airborne: land the deck before the
                # dispatch so the giant flush owns every slot at once
                # instead of queueing piecemeal behind the halves
                while deck:
                    self._land_one(deck)
            # device observatory attribution: every kernel build
            # landing during THIS dispatch (the first flush of a
            # process on an empty build cache) is charged to this
            # flush — comp_ms in the ledger, site/flush_seq in
            # /dump_devices
            attr = deviceledger.attr_begin("plane.flush", led[_L_SEQ])
            try:
                # [tracing] profile_dir: bracket the device flight with
                # a torch.profiler capture so device traces line up with
                # the host spans (no-op unless configured)
                prof = tracing.profiler_stop if tracing.profiler_start() \
                    else None
                t_d0 = tracing.monotonic_ns()
                fz.dispatch_fused(plan)
                t_d1 = tracing.monotonic_ns()
                deviceledger.attr_end(attr)
                tracing.flight_begin("plane.flight", fid,
                                     cat="verifyplane", rows=len(rows))
                stamped = bool(getattr(plan, "stamped", False))
                led[_L_STAMP] = STAMP_DEVICE if stamped else STAMP_HOST
                led[_L_DBYTES] = getattr(plan, "delta_bytes", 0)
                self._observe_pack(
                    time.perf_counter() - t0, fz.plan_h2d_bytes(plan),
                    stamp=led[_L_STAMP])
                led[_L_COMP] = round(attr.ms, 3)
                led[_L_UTIL] = plan.util
                if tracing.clock_gen() == led[_L_GEN]:
                    # h2d estimate: the synchronous dispatch wall
                    # (table fetch, uploads + kernel enqueue) net of
                    # the build time attributed above
                    led[_L_H2D] = round(
                        max((t_d1 - t_d0) / 1e6 - attr.ms, 0.0), 3)
                if plan.mesh is not None:
                    led[_L_PATH] = PATH_FUSED_SHARDED
                    led[_L_NDEV] = plan.n_dev
                    led[_L_DEV0] = plan.devs[0]
                else:
                    led[_L_PATH] = PATH_FUSED
                # warm: did this flush find its valset table cached,
                # or pay the build inline (the post-rotation stall)?
                led[_L_WARM] = 1 if plan.warm else 0
                if not plan.warm and tracing.enabled():
                    tracing.instant("plane.cold_table",
                                    cat="verifyplane", flush=fid,
                                    rows=len(rows))
                led[_L_SMISS] = self._staging.misses - miss0

                def finish():
                    try:
                        out = fz.collect_fused(plan)
                    except Exception as exc:  # noqa: BLE001 - device fault
                        self._breaker.record_failure()
                        _log.exception(
                            "fused verify-plane flush failed in flight; "
                            "its futures fail with DeviceError")
                        # a sharded flight that faulted must not keep
                        # claiming a sharded pass (the ledger's n_dev
                        # and the shard counters would disagree)
                        led[_L_NDEV] = 1
                        led[_L_DEV0] = 0
                        _device_fault(led, exc)
                    finally:
                        if prof is not None:
                            prof()
                    self._breaker.record_success()
                    # the span of the flush's launches from its CUDA events
                    led[_L_DEVEV] = fz.plan_device_ms(plan)
                    if plan.mesh is not None:
                        # counted on COLLECT success: only completed
                        # sharded passes are attributed sharded
                        self.shard_flushes += 1
                        self.shard_rows += len(rows)
                        if self.metrics is not None:
                            self.metrics.plane_shard_flushes.inc()
                            self.metrics.plane_shard_rows.inc(len(rows))
                    # device observatory steady declaration: after two
                    # successful fused collects the flush shapes are
                    # built — any further kernel build is the
                    # round-5 regression class (compile_storm watches)
                    self._steady_flushes += 1
                    if self._steady_flushes == 2:
                        deviceledger.mark_steady()
                    return out

                # the module-attr lookup keeps the probe patchable
                return finish, True, plan.devs, \
                    (lambda: fz.plan_ready(plan))
            except Exception:  # noqa: BLE001 - device fault at dispatch
                deviceledger.attr_end(attr)
                # builds a FAILED dispatch paid still belong to this
                # flush (the grouped path below records it)
                led[_L_COMP] = round(attr.ms, 3)
                if prof is not None:
                    prof()  # un-bracket a failed dispatch
                self._breaker.record_failure()
                _log.exception(
                    "fused verify-plane dispatch failed; falling back "
                    "to the grouped path"
                )
        self._observe_pack(time.perf_counter() - t0)
        led[_L_SMISS] = self._staging.misses - miss0
        # deferred like the failpoint arm: pack_seconds (and the
        # plane.pack span) cover staging; the host/grouped verify runs
        # inside finish() under its own plane.verify span
        if not self._use_device:
            led[_L_PATH] = PATH_HOST
            return (lambda: (_host_verdicts(rows), None)), False, None, \
                None
        led[_L_PATH] = PATH_GROUPED

        def grouped():
            try:
                return self._verify_rows(rows), None
            except Exception as exc:  # noqa: BLE001 - device fault
                _device_fault(led, exc)

        return grouped, False, None, None

    def _verify_rows(self, rows) -> List[bool]:
        """One padded device pass per key type under the circuit
        breaker. A key-type group whose device pass faults (recorded on
        the breaker), or that the open breaker refuses, raises: a device
        plane never verifies on the host, where the JAX package's
        verify_batch_direct would."""
        from cometbft_tpu_torch.crypto import batch as cbatch
        from cometbft_tpu_torch.ops import ed25519_kernel as ek

        n = len(rows)
        try:
            waste = ek.bucket_size(n) - n
        except ValueError:
            waste = 0
        self.padding_waste += waste
        if self.metrics is not None:
            self.metrics.plane_padding_waste.inc(waste)
        groups: dict = {}
        for i, r in enumerate(rows):
            groups.setdefault(r[0].key_type, []).append(i)
        out = [False] * n
        for idxs in groups.values():
            grp = [rows[i] for i in idxs]
            valid = cbatch.verify_batch_direct(
                [r[0] for r in grp], [r[1] for r in grp],
                [r[2] for r in grp], device=self.device,
                breaker=self._breaker, kernels=self._kernels)
            for i, v in zip(idxs, np.asarray(valid)[:len(grp)]):
                out[i] = bool(v)
        return out

    def _settle(self, batch: List[_Submission], verdicts,
                fused_tallies=None) -> None:
        """Scatter verdicts to futures + fuse the per-group tallies —
        one pass over the flush, so a VoteSet's quorum event fires
        before any submitter even wakes. With fused_tallies (the device
        pass computed the per-group sums) the host adds those instead
        of re-reducing verdicts."""
        now = time.perf_counter()
        if fused_tallies is not None:
            for g, t in fused_tallies.items():
                if t:
                    g.add(t)
        off = 0
        tids = set()
        for sub in batch:
            sl = verdicts[off:off + len(sub.rows)]
            off += len(sub.rows)
            tids.add(sub.tid)
            if fused_tallies is None and sub.counted \
                    and sub.group is not None and all(sl):
                sub.group.add(sub.power)
            self.lane_rows[sub.lane] += len(sub.rows)
            wait_ms = (now - sub.t_submit) * 1000.0
            self.lane_waits[sub.lane].append(wait_ms)
            self.tenants.note_served(sub.tenant, sub.lane,
                                     len(sub.rows), wait_ms)
            if self.metrics is not None:
                self.metrics.plane_wait_seconds.observe(now - sub.t_submit)
                self.metrics.plane_lane_rows.inc(len(sub.rows),
                                                 lane=sub.lane)
            sub.future._resolve(sl)
        self.batches += 1
        self.rows_verified += off
        if self.metrics is not None:
            self.metrics.plane_batch_size.observe(off)
            # breaker_open is sampled at scrape time by
            # NodeMetrics.expose_text (it must stay fresh with the
            # plane idle too), so no push here
        self.dispatch_log.append({
            "rows": off,
            "submissions": len(batch),
            "tids": tids,
        })

    # -- controller actuators (libs/controller) ----------------------------
    # Clamped live setters over the knobs the dispatcher already
    # re-reads every drain cycle (lane_window / lane_deadline /
    # flights) — no dispatcher restart, no queue disturbance. The
    # CONSENSUS lane is structurally off-limits: its window and bounds
    # have no setter path, and the lane is rejected outright, so no
    # control loop can ever create a path that sheds CONSENSUS.

    def set_lane_window_ms(self, lane: str, ms: float) -> float:
        """Retune a SHEDDABLE lane's coalescing window. Returns the
        applied value (ms)."""
        if lane not in SHEDDABLE_LANES:
            raise ValueError(
                f"lane {lane!r} window is not controller-adjustable "
                f"(CONSENSUS bounds are structurally off-limits)")
        w = max(0.0, float(ms)) / 1000.0
        with self._cv:
            self.lane_window[lane] = w
            if lane == LANE_BULK:
                self.bulk_window = w
            else:
                self.gateway_window = w
            self._cv.notify_all()
        return w * 1000.0

    def set_lane_deadline_ms(self, lane: str, ms: float) -> float:
        """Retune a SHEDDABLE lane's shed deadline. A lane configured
        with deadline 0 (shedding disabled) stays disabled — enabling
        shedding is an operator decision, not a controller move."""
        if lane not in self.lane_deadline:
            raise ValueError(
                f"lane {lane!r} has no shed deadline (CONSENSUS is "
                f"never shed)")
        d = max(0.0, float(ms)) / 1000.0
        with self._cv:
            if not self.lane_deadline[lane]:
                return 0.0
            self.lane_deadline[lane] = d
            if lane == LANE_BULK:
                self.bulk_deadline = d
            else:
                self.gateway_deadline = d
        return d * 1000.0

    def set_flights(self, n: int) -> int:
        """Grow/shrink the flight deck within [1, flights_max]. The
        staging pool and mesh halves were sized for flights_max at
        construction, so a live grow never aliases staging buffers;
        a shrink drains excess airborne flights on the next cycle."""
        with self._cv:
            self.flights = min(self.flights_max, max(1, int(n)))
            self._cv.notify_all()
            return self.flights

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._cv:
            depth = self._depth_locked()
            lane_depths = dict(self._pending_rows)
        return {
            "running": self._running,
            "queue_depth": depth,
            "lane_depths": lane_depths,
            "lane_rows": dict(self.lane_rows),
            "sheds": dict(self.sheds),
            "batches": self.batches,
            "rows_verified": self.rows_verified,
            "padding_waste": self.padding_waste,
            "breaker_state": self._breaker.state,
            "use_device": self._use_device,
            "pack_seconds": self.pack_seconds,
            "h2d_bytes": self.h2d_bytes,
            "overlapped": self.overlapped,
            "flushes_logged": len(self.ledger),
            "mesh_ndev": self.mesh_ndev,
            "shard_flushes": self.shard_flushes,
            "shard_rows": self.shard_rows,
            "flights": self.flights,
            "flights_max": self.flights_max,
            "halves": len(self._halves),
            "deck_airborne": self.deck_airborne,
            "deck_peak": self.deck_peak,
            "tenants": len(self.tenants.tenants()),
        }

    def tenant_depths(self) -> dict:
        """Per-(lane, tenant) pending rows (the quota gate's view)."""
        with self._cv:
            return {lane: dict(t)
                    for lane, t in self._pending_tenant_rows.items()}

    def lane_depths(self) -> dict:
        """Per-lane pending rows (scrape-time gauge source)."""
        with self._cv:
            return dict(self._pending_rows)

    def lane_wait_stats(self) -> dict:
        """Per-lane submit-to-result wall latency percentiles over the
        recent bounded window (real clock — powers the soak harness's
        p99-under-flood assertion and cfg9's report)."""
        from cometbft_tpu_torch.libs.quantiles import wait_summary_ms

        return {lane: wait_summary_ms(waits)
                for lane, waits in self.lane_waits.items()}

    def dump_flushes(self) -> dict:
        """The always-on flush ledger: per-flush records + percentile
        summary (served by /dump_flushes; works after stop() too)."""
        return {
            "running": self._running,
            "summary": self.ledger.summary(),
            "flushes": self.ledger.records(),
        }


# --------------------------------------------------------------------------
# the process-global plane (node lifecycle owns it)
# --------------------------------------------------------------------------

_GLOBAL: Optional[VerifyPlane] = None
# the last plane that was ever global: /dump_flushes and simnet replay
# blobs read its ledger even after the node stopped the plane (the
# ledger is history, and post-mortems happen after shutdown)
_LAST: Optional[VerifyPlane] = None
_GLOBAL_LOCK = threading.Lock()


def set_global_plane(plane: Optional[VerifyPlane]) -> None:
    global _GLOBAL, _LAST
    with _GLOBAL_LOCK:
        _GLOBAL = plane
        if plane is not None:
            _LAST = plane
    # the tenancy registry mirrors the plane (one registry per plane):
    # /dump_tenants and the /metrics tenant families follow whichever
    # plane is mounted, with the same _LAST survival contract
    from cometbft_tpu_torch.verifyplane import tenants as vtenants

    vtenants.set_global_registry(None if plane is None
                                 else plane.tenants)


def clear_global_plane(plane: VerifyPlane) -> None:
    """Unregister `plane` if (and only if) it is the current global —
    a stopping node must not tear down another node's plane."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is plane:
            _GLOBAL = None
    from cometbft_tpu_torch.verifyplane import tenants as vtenants

    vtenants.clear_global_registry(plane.tenants)


def global_plane() -> Optional[VerifyPlane]:
    """The running global plane, or None. Returns None on the plane's
    own dispatcher thread (callers there must verify directly)."""
    p = _GLOBAL
    if p is None or not p.is_running() or p.in_dispatcher():
        return None
    return p


def dump_flushes() -> dict:
    """The flush ledger of the current global plane — or, after a
    stop, of the LAST plane that was global (the ledger survives
    stop(): a post-mortem reads history, not liveness)."""
    p = _GLOBAL or _LAST
    if p is None:
        return {"running": False, "summary": {"flushes": 0},
                "flushes": []}
    return p.dump_flushes()


def ledger_tail(n: int = 8) -> List[str]:
    """Compact tail of the most recent flushes (rides simnet replay
    blobs next to the trace tail)."""
    p = _GLOBAL or _LAST
    return [] if p is None else p.ledger.tail(n)


def flush_stats_for_seqs(seqs) -> dict:
    """Join a set of flush-ledger seqs against the ledger ring: the
    summed WORK milliseconds (pack+flight+collect+settle — queued_ms is
    coalescing wait, not verify-plane work), how many flushes matched,
    and how many of the matched fused flushes paid a COLD table build
    inline. The consensus height ledger calls this once per height to
    attribute verify-plane time; a seq already rotated out of the
    bounded ring simply doesn't contribute (honest undercount, never a
    guess)."""
    p = _GLOBAL or _LAST
    out = {"ms": 0.0, "flushes": 0, "cold": 0}
    if p is None or not seqs:
        return out
    for r in list(p.ledger._ring):
        if r[_L_SEQ] in seqs:
            out["ms"] += (r[_L_PACK] + r[_L_FLIGHT] + r[_L_COLLECT]
                          + r[_L_SETTLE])
            out["flushes"] += 1
            if r[_L_PATH] in (PATH_FUSED, PATH_FUSED_SHARDED) \
                    and not r[_L_WARM]:
                out["cold"] += 1
    out["ms"] = round(out["ms"], 3)
    return out


def ledger_mark() -> tuple:
    """Opaque position marker for :func:`ledger_advanced`: which plane
    the module-level ledger readers currently resolve to, and how far
    its ring has been written. ``_LAST`` is process-global and never
    cleared, so a consumer that only wants flushes from ITS OWN window
    of activity (the simnet replay blob) marks at start and attaches
    the tail only when the ledger moved past the mark."""
    p = _GLOBAL or _LAST
    if p is None:
        return (None, -1)
    ring = p.ledger._ring
    return (id(p), ring[-1][_L_SEQ] if ring else -1)


def ledger_advanced(mark: tuple) -> bool:
    """True when any flush was recorded after ``mark`` (a new plane
    became global, or the marked plane's ring grew)."""
    return ledger_mark() != mark


def plane_batch_fn(lane: str = LANE_CONSENSUS) -> Optional[Callable]:
    """A batch_fn(pubs, msgs, sigs) -> (n,) bool routed through the
    running global plane, or None when no plane is running — callers
    keep their existing direct path in that case. `lane` picks the QoS
    class the rows ride (light-client headers are CONSENSUS; bulk
    callers pass LANE_BULK)."""
    if global_plane() is None:
        return None

    def fn(pubs, msgs, sigs):
        p = global_plane()
        if p is not None:
            try:
                return p.submit_and_wait(pubs, msgs, sigs, lane=lane)
            except PlaneError:
                pass  # stopped/overflowed/shed mid-call: verify directly
        from cometbft_tpu_torch.crypto import batch as cbatch

        return cbatch.verify_batch_direct(pubs, msgs, sigs)

    return fn
