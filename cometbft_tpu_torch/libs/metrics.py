"""Prometheus-compatible metrics: counters, gauges, histograms.

Reference: the metricsgen-generated per-package metrics structs
(consensus/metrics.go:24-91, blocksync/metrics.go, p2p, mempool, state)
exported via the prometheus server (node/node.go:846). This module is
the registry + text-exposition core; per-subsystem metric sets live
next to their components and the node serves /metrics over HTTP.

The port's copy of the JAX package's libs/metrics.py: the same metric
names, so a scrape of either package reads alike. The scrape samples the
port's modules, each only once something imported it (the p2p peer
ledger and the statesync counters have no port module yet, so their
families stay at zero). The device families describe the port's
counterparts: a compile is an nvcc build of a kernel (ops/_build.py),
recorded by the port's device ledger.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


def _esc_label(v) -> str:
    """Prometheus text-format label-value escaping (backslash, quote,
    newline) — exposition spec 0.0.4."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(v)}"' for k, v in labels)
    return "{" + inner + "}"


class Metric:
    def __init__(self, name: str, help_: str, typ: str):
        self.name = name
        self.help = help_
        self.type = typ
        self._values: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def labels(self, **labels) -> "_Bound":
        return _Bound(self, tuple(sorted(labels.items())))

    def _add(self, key: tuple, v: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + v

    def _set(self, key: tuple, v: float) -> None:
        with self._lock:
            self._values[key] = v

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.type}"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items or [((), 0.0)]:
            out.append(f"{self.name}{_fmt_labels(key)} {v:g}")
        return out


class _Bound:
    def __init__(self, metric: Metric, key: tuple):
        self.metric = metric
        self.key = key

    def inc(self, v: float = 1.0) -> None:
        self.metric._add(self.key, v)

    def set(self, v: float) -> None:
        self.metric._set(self.key, v)

    def observe(self, v: float) -> None:  # histogram-backed
        self.metric._observe(self.key, v)  # type: ignore[attr-defined]


class Counter(Metric):
    def __init__(self, name, help_=""):
        super().__init__(name, help_, "counter")

    def inc(self, v: float = 1.0, **labels) -> None:
        self._add(tuple(sorted(labels.items())), v)


class Gauge(Metric):
    def __init__(self, name, help_=""):
        super().__init__(name, help_, "gauge")

    def set(self, v: float, **labels) -> None:
        self._set(tuple(sorted(labels.items())), v)

    def inc(self, v: float = 1.0, **labels) -> None:
        self._add(tuple(sorted(labels.items())), v)


class Histogram(Metric):
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10)

    def __init__(self, name, help_="", buckets=None, labeled=False):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        # labeled=True: every observation carries labels, so no bare
        # zero series is synthesized while idle — a bare series that
        # appears at startup and goes stale after the first labeled
        # observation would confuse absent()-style alerts
        self.labeled = bool(labeled)
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}

    def observe(self, v: float, **labels) -> None:
        self._observe(tuple(sorted(labels.items())), v)

    def _observe(self, key: tuple, v: float) -> None:
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1)
            )
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
        if not items and not self.labeled:
            # registered-but-never-observed histograms must still scrape
            # (zero bucket rows + _sum 0 / _count 0), matching the
            # zero-value base row Metric.expose emits — an idle plane's
            # histograms must not vanish from /metrics. Label-only
            # histograms (labeled=True) stay empty until their first
            # child series exists, like standard client libraries.
            items = [((), [0] * (len(self.buckets) + 1))]
        for key, counts in items:
            cum = 0
            for i, ub in enumerate(self.buckets):
                cum += counts[i]
                lk = key + (("le", f"{ub:g}"),)
                out.append(f"{self.name}_bucket{_fmt_labels(lk)} {cum}")
            cum += counts[-1]
            lk = key + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_fmt_labels(lk)} {cum}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} "
                       f"{sums.get(key, 0.0):g}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {cum}")
        return out


class Registry:
    def __init__(self, namespace: str = "cometbft"):
        self.namespace = namespace
        self._metrics: List[Metric] = []
        self._lock = threading.Lock()

    def _full(self, subsystem: str, name: str) -> str:
        return f"{self.namespace}_{subsystem}_{name}"

    def counter(self, subsystem, name, help_="") -> Counter:
        m = Counter(self._full(subsystem, name), help_)
        with self._lock:
            self._metrics.append(m)
        return m

    def gauge(self, subsystem, name, help_="") -> Gauge:
        m = Gauge(self._full(subsystem, name), help_)
        with self._lock:
            self._metrics.append(m)
        return m

    def histogram(self, subsystem, name, help_="", buckets=None,
                  labeled=False) -> Histogram:
        m = Histogram(self._full(subsystem, name), help_, buckets,
                      labeled=labeled)
        with self._lock:
            self._metrics.append(m)
        return m

    def expose_text(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


class NodeMetrics:
    """The metric set the node wires into its components — the union of
    the reference's consensus/p2p/mempool/blocksync metricsgen structs
    (consensus/metrics.go:24-91 etc.), prometheus-text compatible names."""

    def __init__(self, registry: Optional[Registry] = None):
        r = self.registry = registry or Registry()
        # consensus
        self.height = r.gauge("consensus", "height",
                              "Height of the chain")
        self.rounds = r.gauge("consensus", "rounds",
                              "Round of the current height")
        self.validators = r.gauge("consensus", "validators",
                                  "Number of validators")
        self.block_interval = r.histogram(
            "consensus", "block_interval_seconds",
            "Time between this and the last block",
            buckets=(0.1, 0.25, 0.5, 1, 2, 5, 10, 30),
        )
        self.num_txs = r.gauge("consensus", "num_txs",
                               "Number of transactions in the latest block")
        # renamed from total_txs (PR 5): counters end _total
        # (tools/metrics_lint.py enforces the convention)
        self.total_txs = r.counter("consensus", "txs_total",
                                   "Total transactions committed")
        self.block_size = r.gauge("consensus", "block_size_bytes",
                                  "Size of the latest block")
        self.invalid_votes = r.counter(
            "consensus", "invalid_votes_total",
            "Votes dropped by the cheap pre-WAL admission filter "
            "(unknown validator, address mismatch, wrong height) — "
            "the garbage-flood shield")
        self.step_duration = r.histogram(
            "consensus", "step_duration_seconds",
            "Wall time spent in each consensus step (labeled by the "
            "step being LEFT)",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 3, 10),
            labeled=True,  # step=... only; no bare idle series
        )
        # height ledger (consensus/heightledger.py): stage-timeline
        # percentiles over the bounded per-height ring, sampled at
        # scrape time (stage=proposal|prevote_quorum|precommit_quorum|
        # commit|apply, q=p50|p90|p99|max — cumulative ms from height
        # entry; apply IS the commit latency)
        self.height_stage = r.gauge(
            "consensus", "height_stage_ms",
            "Per-height commit-latency stage percentiles over the "
            "height-ledger window (labels: stage, q)")
        self.height_ledger_size = r.gauge(
            "consensus", "height_ledger_records",
            "Height records currently held by the bounded height "
            "ledger ring")
        # late-signer attribution: sampled at scrape time from the
        # height ledger's bounded chronic table — TOP-K offenders only,
        # so a 10k-validator set can never explode the label
        # cardinality (the full table is in /dump_heights)
        self.late_signers = r.counter(
            "consensus", "late_signer_heights_total",
            "Heights on which a validator's precommit arrived after "
            "the quorum instant (kind=late) or was absent from the "
            "commit (kind=absent), labeled val=<validator index>; "
            "top-K chronic offenders sampled at scrape time")
        # incident flight recorder (libs/incidents.py), sampled at
        # scrape time from the process-global recorder
        self.incidents_fired = r.counter(
            "incidents", "fired_total",
            "Incident snapshots frozen by the watchdog, labeled by "
            "trigger (commit_stall|round_escalation|breaker_flap|"
            "shed_storm|forced)")
        self.incidents_ring = r.gauge(
            "incidents", "ring_records",
            "Incident snapshots currently held by the bounded ring")
        # device verifier (accelerator-native addition)
        self.verify_batches = r.counter(
            "crypto", "verify_batches_total",
            "Device batch-verification dispatches")
        self.verify_sigs = r.counter(
            "crypto", "verify_sigs_total",
            "Signatures verified on device")
        self.verify_seconds = r.histogram(
            "crypto", "verify_seconds",
            "Device batch verification wall time",
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1),
        )
        self.breaker_open = r.gauge(
            "crypto", "breaker_open",
            "1 while the device circuit breaker is OPEN "
            "(batches on the host fallback path)")
        # verify plane (continuous-batching scheduler)
        self.plane_queue_depth = r.gauge(
            "verifyplane", "queue_depth",
            "Signature rows pending in the verify plane")
        # renamed from batch_size (PR 5): histograms carry a base unit
        # suffix (seconds/bytes/rows) per tools/metrics_lint.py
        self.plane_batch_size = r.histogram(
            "verifyplane", "batch_rows",
            "Rows per dispatched verify-plane flush",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096),
        )
        self.plane_wait_seconds = r.histogram(
            "verifyplane", "submit_to_result_seconds",
            "Verify-plane submit-to-result latency",
            buckets=(0.0005, 0.001, 0.002, 0.005, 0.01, 0.025,
                     0.05, 0.1, 0.5),
        )
        self.plane_padding_waste = r.counter(
            "verifyplane", "padding_waste_total",
            "Dead rows added padding flushes to compiled bucket shapes")
        self.plane_pack_seconds = r.histogram(
            "verifyplane", "pack_seconds",
            "Host-side staging time per verify-plane flush (template "
            "packing + row scatter, before device dispatch)",
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1),
        )
        self.plane_h2d_bytes = r.counter(
            "verifyplane", "h2d_bytes_total",
            "Bytes staged host-to-device by verify-plane flushes, "
            "split by path label: device (per-row delta buffers, "
            "sign-bytes stamped on device) vs host (full packed rows); "
            "valset tables are device-resident and excluded")
        # flush-ledger percentiles (PR 6): the always-on per-flush ring
        # (verifyplane.plane.FlushLedger) sampled at scrape time —
        # stage=queued|pack|flight|collect|settle, q=p50|p90|max, all
        # over the ledger's bounded window (recent flushes, not
        # lifetime)
        self.plane_flush_stage_ms = r.gauge(
            "verifyplane", "flush_stage_ms",
            "Per-stage flush cost percentiles over the flush-ledger "
            "window (labels: stage, q)")
        self.plane_flush_overlap = r.gauge(
            "verifyplane", "flush_overlap_frac",
            "Fraction of pack time hidden behind an airborne flight "
            "over the flush-ledger window")
        self.plane_flush_ledger_size = r.gauge(
            "verifyplane", "flush_ledger_records",
            "Flush records currently held by the bounded ledger ring")
        self.plane_flush_fallbacks = r.gauge(
            "verifyplane", "flush_host_fallbacks_recent",
            "Flushes in the ledger window that degraded to the host "
            "path (dispatch failpoint or in-flight device fault)")
        # QoS lanes (overload resilience): per-lane verified rows, shed
        # submissions (GATEWAY/BULK only — CONSENSUS is never shed),
        # and the per-lane pending depth sampled at scrape time
        self.plane_lane_rows = r.counter(
            "verifyplane", "lane_rows_total",
            "Signature rows verified per QoS lane "
            "(lane=consensus|gateway|bulk)")
        self.plane_shed = r.counter(
            "verifyplane", "shed_total",
            "Submissions shed with an explicit Overloaded verdict, "
            "labeled by lane (gateway/bulk deadline/queue-bound "
            "sheds; consensus stays 0 by construction)")
        self.plane_lane_depth = r.gauge(
            "verifyplane", "lane_queue_depth",
            "Pending signature rows per QoS lane at scrape time")
        # multichip sharded dispatch: cross-chip flush attribution
        # (the flush ledger's n_dev column, aggregated)
        self.plane_shard_flushes = r.counter(
            "verifyplane", "shard_flushes_total",
            "Fused flushes dispatched as one cross-chip sharded pass "
            "over the verify mesh")
        self.plane_shard_rows = r.counter(
            "verifyplane", "shard_rows_total",
            "Signature rows verified by cross-chip sharded flushes")
        self.plane_shard_ndev = r.gauge(
            "verifyplane", "shard_devices",
            "Resolved device fan-out of the verify plane's flush mesh "
            "(0 = single-device dispatch)")
        # flight deck (pipelined mesh halves): set LIVE by the owning
        # plane's dispatcher on every deck change — like shard_devices,
        # NOT sampled at scrape time (the process-global plane may not
        # be this node's, and an overwrite would clobber the live value)
        self.plane_deck_airborne = r.gauge(
            "verifyplane", "deck_airborne",
            "Verify-plane flushes currently airborne on the flight "
            "deck (2 = both mesh halves busy)")
        # light-client gateway (cometbft_tpu_torch.lightgate): counters are
        # SAMPLED at scrape time from the mounted gateway's scrape-safe
        # stats()/cache_stats() — the gateway has no metrics handle of
        # its own, and a scrape must stay current even when no request
        # has arrived since the last one
        self.lightgate_requests = r.counter(
            "lightgate", "requests_total",
            "Gateway serving outcomes sampled at scrape time "
            "(kind=requests|verifies|coalesced|divergences|overloaded"
            "|evidence_submitted)")
        self.lightgate_cache = r.counter(
            "lightgate", "cache_total",
            "Verified-pair LRU events "
            "(kind=hits|misses|evictions|expired)")
        self.lightgate_cache_entries = r.gauge(
            "lightgate", "cache_entries",
            "Verified (trusted, target) pairs currently cached")
        self.lightgate_store_heights = r.gauge(
            "lightgate", "trusted_store_heights",
            "Heights held by the gateway's shared trusted store")
        # mempool
        self.mempool_size = r.gauge("mempool", "size",
                                    "Pending transactions")
        self.mempool_admission = r.counter(
            "mempool", "admission_total",
            "CheckTx admission-control outcomes "
            "(outcome=admitted|rejected_inflight|rejected_watermark"
            "|rejected_breaker)")
        self.mempool_overloaded = r.counter(
            "mempool", "overloaded_total",
            "CheckTx requests answered with the explicit OVERLOADED "
            "code (admission fast-reject or BULK-lane shed)")
        # p2p
        self.peers = r.gauge("p2p", "peers", "Connected peers")
        # gossip observatory (p2p/peerledger.py): the always-on
        # per-peer traffic ledger sampled at scrape time from the
        # registered ledger — totals here, the per-peer split in
        # /dump_peers
        self.p2p_peer_msgs = r.counter(
            "p2p", "peer_msgs_total",
            "Messages across all peers (dir=tx|rx), sampled from the "
            "peer ledger at scrape time")
        self.p2p_peer_bytes = r.counter(
            "p2p", "peer_bytes_total",
            "Wire bytes across all peers (dir=tx|rx)")
        self.p2p_queue_full_drops = r.counter(
            "p2p", "send_queue_full_drops_total",
            "Messages dropped on a full per-channel send queue "
            "(non-blocking sends and timed-out blocking sends both "
            "count — the starvation signal the peer_starvation "
            "incident trigger watches)")
        self.p2p_blocked_puts = r.counter(
            "p2p", "send_blocked_puts_total",
            "Blocking sends that had to WAIT on a full send queue "
            "(the backed-up-queue half of the late-signer net_ms)")
        self.p2p_throttle_stalls = r.counter(
            "p2p", "throttle_stalls_total",
            "Send-routine stalls on the flow-control token bucket")
        self.p2p_link_drops = r.counter(
            "p2p", "link_drops_total",
            "Messages eaten by the link itself (simnet partitions, "
            "dead writes) — attributed per peer in /dump_peers")
        self.p2p_injected_faults = r.counter(
            "p2p", "injected_faults_total",
            "Faults injected by the fuzzer / simnet fault model "
            "(kind=drop|delay) — chaos runs attribute themselves "
            "instead of blaming the network")
        self.p2p_dup_votes = r.counter(
            "p2p", "duplicate_votes_total",
            "Duplicate vote-message receipts (lack-based gossip keeps "
            "this near zero; growth means HasVote/VoteSetBits healing "
            "is lagging)")
        self.p2p_ping_rtt = r.gauge(
            "p2p", "ping_rtt_ms",
            "Last measured ping RTT per peer (label peer; bounded "
            "top-K live peers)")
        self.p2p_ledger_peers = r.gauge(
            "p2p", "peer_ledger_peers",
            "Live peers currently tracked by the peer ledger")
        # blocksync
        self.blocksync_syncing = r.gauge("blocksync", "syncing",
                                         "1 while block-syncing")
        # --- scrape-time sampled internals (PR 5): these subsystems
        # mutate their counters with no metrics handle in scope, so the
        # families are registered here and their values are SAMPLED on
        # every expose_text — /metrics is always current even when the
        # subsystem has no push path.
        self.breaker_transitions = r.counter(
            "crypto", "breaker_transitions_total",
            "Circuit-breaker state transitions (kind=open|close)")
        self.breaker_probes = r.counter(
            "crypto", "breaker_probes_total",
            "Half-open device probes attempted by the breaker")
        self.valset_table_cache = r.counter(
            "crypto", "valset_table_cache_total",
            "Device-resident valset table cache events "
            "(ops.ed25519_cached.table_cache_stats, kind-labeled)")
        self.table_cache_evictions = r.counter(
            "crypto", "table_cache_evictions_total",
            "Entries the bounded valset-table caches dropped under "
            "epoch-churn pressure (kind=tables|shard|valset_memo|"
            "key_memo — ops/table_cache.py LRU eviction counts)")
        self.table_cache_resident = r.gauge(
            "crypto", "table_cache_resident_bytes",
            "Host+device bytes pinned by the bounded valset-table "
            "caches (epoch churn must hold this flat)")
        self.warmer_builds = r.counter(
            "verifyplane", "valset_warmer_builds_total",
            "Next-epoch table warmer build outcomes "
            "(outcome=ok|failed|skipped|superseded; "
            "outcome=incremental sub-counts the ok-builds satisfied "
            "by patching a cached table's delta rows instead of a "
            "full build)")
        self.warmer_hits = r.counter(
            "verifyplane", "valset_warmer_hits_total",
            "Table lookups answered by a warmer-prebuilt table (the "
            "first commit after a rotation, when the warm won)")
        self.mesh_step_cache = r.counter(
            "parallel", "mesh_step_cache_total",
            "Memoized sharded-step builder cache events "
            "(parallel.mesh.cache_stats)")
        self.staging_pool_events = r.counter(
            "crypto", "staging_pool_total",
            "Staging-pool buffer requests (kind=hits rotation reuse, "
            "kind=misses fresh allocations)")
        self.staging_pool_bytes = r.gauge(
            "crypto", "staging_pool_resident_bytes",
            "Host bytes pinned in rotating staging buffers")
        self.failpoint_hits = r.counter(
            "failpoints", "hits_total",
            "Armed-failpoint evaluations, labeled by point")
        self.failpoint_fires = r.counter(
            "failpoints", "fires_total",
            "Failpoint actions actually fired, labeled by point")
        self.wal_fsync = r.counter(
            "wal", "fsync_total", "WAL fsyncs completed")
        self.wal_fsync_seconds = r.counter(
            "wal", "fsync_seconds_total",
            "Cumulative WAL fsync wall time")
        # device observatory (libs/deviceledger.py): the process-global
        # compile ledger + device-memory residency accounting, sampled
        # at scrape time (the core imports no torch, so a scrape never
        # pays a cold import; the ledger only fills once something
        # compiled)
        self.device_compiles = r.counter(
            "device", "compiles_total",
            "Kernel builds (nvcc, ops/_build) recorded by the device "
            "observatory, "
            "labeled phase=cold (before the steady-state declaration) "
            "or phase=steady (after — the round-5 recompile "
            "regression class the compile_storm incident watches)")
        self.device_compile_seconds = r.counter(
            "device", "compile_seconds_total",
            "Total wall seconds of recorded backend compiles")
        self.device_pcache_hits = r.counter(
            "device", "compile_pcache_hits_total",
            "Compiles absorbed by a persistent compilation cache "
            "instead of a build (the port records none: a kernel "
            "library loaded from build/kernels is not a compile)")
        self.device_resident = r.gauge(
            "device", "resident_bytes",
            "Bytes pinned per residency family per device "
            "(family=valset_tables|shard_tables|staging|combs; "
            "dev=chip id or 'host' for pinned staging)")
        self.device_headroom = r.gauge(
            "device", "hbm_headroom_rows",
            "Valset-slot headroom per chip against the 65536-slot "
            "window-table budget (negative = retired epochs pin more "
            "table rows than one chip serves live)")
        self.device_ledger_records = r.gauge(
            "device", "compile_ledger_records",
            "Compile events currently held by the bounded compile "
            "ledger ring")
        # self-tuning control plane (libs/controller.py): decision
        # counters + live actuator positions, sampled at scrape time
        # from the registered controller (same _GLOBAL/_LAST caveat as
        # the plane: the ledger belongs to the last node that mounted
        # one)
        self.controller_decisions = r.counter(
            "controller", "decisions_total",
            "Actuator moves committed by the self-tuning control "
            "plane, labeled actuator + direction (up widens/relaxes, "
            "down tightens/shrinks)")
        self.controller_value = r.gauge(
            "controller", "actuator_value",
            "Current value of each controller-movable actuator "
            "(window/deadline actuators in ms, admission watermark as "
            "a fraction, pipeline_flights as a count)")
        self.controller_slo_violation = r.counter(
            "controller", "slo_violation_seconds_total",
            "Cumulative seconds the height-ledger commit p99 spent "
            "above the declared [controller] SLO, accrued between "
            "controller evaluations")
        # multi-tenant verify plane (verifyplane/tenants.py): per-chain
        # accounting sampled from the tenancy registry at scrape time.
        # Cardinality discipline: tenant-labeled families carry only
        # the top-K tenants by cumulative rows (the ping_rtt_ms bound)
        # plus one tenant="_retired" series accumulating evicted
        # tenants' totals so the family-wide sum stays monotone across
        # registry eviction (the PR-14 drop-ring lesson)
        self.tenant_rows = r.counter(
            "verifyplane", "tenant_rows_total",
            "Rows the verify plane served per tenant chain (label "
            "tenant; top-K by cumulative rows + tenant=\"_retired\" "
            "folding evicted tenants' totals)")
        self.tenant_sheds = r.counter(
            "verifyplane", "tenant_sheds_total",
            "Explicit per-tenant sheds — quota refusals and lane "
            "deadline/overload sheds attributed to the submitting "
            "chain (label tenant; same top-K + _retired bound as "
            "tenant_rows_total)")
        self.tenant_device_ms = r.counter(
            "verifyplane", "tenant_device_ms_total",
            "Device milliseconds the verify plane's flushes charged "
            "per tenant chain — each flush's dev_ms split across its "
            "tenants column (exact at sub-flush boundaries, "
            "row-proportional within a fused batch; label tenant; "
            "same top-K + _retired bound as tenant_rows_total)")
        self.tenant_registry_size = r.gauge(
            "verifyplane", "tenant_registry_size",
            "Chains currently registered with the verify plane's "
            "tenancy registry")
        self.tenant_resident = r.gauge(
            "verifyplane", "tenant_resident_bytes",
            "Bytes of cached valset tables attributed per tenant "
            "chain through the registry's owner map (label tenant; "
            "unowned tables fall to tenant=\"default\")")
        # archival bootstrap plane (statesync/stats.py): process-global
        # counters bumped on the fetch/apply/serve seams, sampled at
        # scrape time like the other push-less subsystems
        self.statesync_chunks = r.counter(
            "statesync", "chunks_total",
            "Statesync chunks by disposition "
            "(kind=fetched|applied|served|shed: fetched/applied on "
            "the restoring side, served/shed on the donor — sheds are "
            "EXPLICIT retry-hinted serve-gate verdicts, never silent "
            "drops)")
        self.statesync_fetch_timeouts = r.counter(
            "statesync", "fetch_timeouts_total",
            "Chunk waits that expired on the applier side before any "
            "provider delivered (each reclaims the hung slot for "
            "re-request from another provider)")
        self.statesync_providers = r.counter(
            "statesync", "providers_total",
            "Chunk provider lifecycle events "
            "(kind=punished|dropped: punished counts failure strikes, "
            "dropped counts providers banned at the strike limit)")
        self.statesync_retry_rounds = r.counter(
            "statesync", "retry_snapshot_rounds_total",
            "RETRY_SNAPSHOT rounds — the app rejected a restored "
            "snapshot's content and the chunk sequence restarted with "
            "the suspect chunks refetched")
        self.statesync_snapshots = r.counter(
            "statesync", "snapshots_total",
            "Snapshot lifecycle events "
            "(kind=offered|restored|served|shed: offered/restored on "
            "the restoring side, served/shed snapshot listings on the "
            "donor's serve gate)")

    def _sample(self) -> None:
        """Scrape-time refresh of the push-less internals. Modules that
        may not be loaded yet (torch-heavy ops/parallel) are only
        sampled once something imported them — a scrape must never pay
        a cold torch import. Every group is individually fault-isolated: a sick
        subsystem costs its own rows, never the whole scrape."""
        import sys

        try:
            from cometbft_tpu_torch.crypto import batch as cbatch

            brk = cbatch.device_breaker()
            self.breaker_open.set(1.0 if brk.state == "open" else 0.0)
            self.breaker_transitions._set((("kind", "open"),),
                                          float(brk.trips))
            self.breaker_transitions._set((("kind", "close"),),
                                          float(brk.closes))
            self.breaker_probes._set((), float(brk.probes))
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            from cometbft_tpu_torch.crypto import batch as cbatch

            # the rows crypto/batch.py handed each key type's kernel
            for kt, rows in cbatch.rows_verified().items():
                self.verify_sigs._set((("key_type", kt),), float(rows))
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            from cometbft_tpu_torch.crypto import batch as cbatch

            st = cbatch.staging_pool().stats()
            pools = [st]
            vp = sys.modules.get("cometbft_tpu_torch.verifyplane.plane")
            if vp is not None and vp._GLOBAL is not None:
                pools.append(vp._GLOBAL._staging.stats())
            self.staging_pool_events._set(
                (("kind", "hits"),),
                float(sum(p["hits"] for p in pools)))
            self.staging_pool_events._set(
                (("kind", "misses"),),
                float(sum(p["misses"] for p in pools)))
            self.staging_pool_bytes.set(
                float(sum(p["resident_bytes"] for p in pools)))
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            vp = sys.modules.get("cometbft_tpu_torch.verifyplane.plane")
            plane = vp and (vp._GLOBAL or vp._LAST)
            if plane is not None:
                for lane, d in plane.lane_depths().items():
                    self.plane_lane_depth.set(float(d), lane=lane)
                # shard_devices is NOT sampled here: _flush_mesh sets
                # the owning plane's registry live at resolution, and
                # overwriting from the process-global plane would
                # clobber it (4 -> 0) whenever this node's plane isn't
                # the global one — same reason sheds aren't sampled
                # sheds are NOT sampled here: _shed_count inc's the
                # owning plane's registry live, and overwriting from
                # the process-global plane would regress the counter
                # (50 -> 0) whenever this node's plane isn't the global
                # one (LocalNetwork: several planes, one process)
                s = plane.ledger.summary()
                self.plane_flush_ledger_size.set(float(s["flushes"]))
                if s["flushes"]:
                    for stage, qs in s["stage_ms"].items():
                        for q, v in qs.items():
                            self.plane_flush_stage_ms.set(
                                float(v), stage=stage, q=q)
                    self.plane_flush_overlap.set(
                        float(s["overlap_frac"]))
                    self.plane_flush_fallbacks.set(
                        float(s["host_fallback"]))
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            lg = sys.modules.get("cometbft_tpu_torch.lightgate.gateway")
            gw = lg and lg.last_gateway()
            if gw is not None:
                st = gw.stats()
                for kind in ("requests", "verifies", "coalesced",
                             "divergences", "overloaded",
                             "evidence_submitted"):
                    self.lightgate_requests._set(
                        (("kind", kind),), float(st[kind]))
                cs = st["cache"]
                for kind in ("hits", "misses", "evictions", "expired"):
                    self.lightgate_cache._set(
                        (("kind", kind),), float(cs[kind]))
                self.lightgate_cache_entries.set(float(cs["size"]))
                self.lightgate_store_heights.set(
                    float(st["store_heights"]))
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            # the table-cache core imports no torch (ops/table_cache.py),
            # so sampling it never risks a cold import; eviction kinds
            # and warm-attribution land in their own families
            from cometbft_tpu_torch.ops import table_cache as tcache

            for kind, v in tcache.stats().items():
                if kind.startswith("evictions_"):
                    self.table_cache_evictions._set(
                        (("kind", kind[len("evictions_"):]),), float(v))
                elif kind == "warmed_hits":
                    self.warmer_hits._set((), float(v))
                else:
                    self.valset_table_cache._set((("kind", kind),),
                                                 float(v))
            self.table_cache_resident.set(
                float(tcache.resident_bytes()))
        except Exception:  # noqa: BLE001
            pass
        try:
            wm = sys.modules.get("cometbft_tpu_torch.verifyplane.warmer")
            w = wm and wm.last_warmer()
            if w is not None:
                st = w.stats()
                for outcome in ("ok", "failed", "skipped",
                                "skipped_quota", "incremental"):
                    self.warmer_builds._set(
                        (("outcome", outcome),),
                        float(st.get("builds_" + outcome, 0)))
                self.warmer_builds._set(
                    (("outcome", "superseded"),),
                    float(st["superseded"]))
        except Exception:  # noqa: BLE001
            pass
        try:
            pm = sys.modules.get("cometbft_tpu_torch.parallel.mesh")
            if pm is not None:
                for kind, v in pm.cache_stats().items():
                    self.mesh_step_cache._set((("kind", kind),), float(v))
        except Exception:  # noqa: BLE001
            pass
        try:
            from cometbft_tpu_torch.libs import failpoints as fp

            for name, c in fp.registry().counters().items():
                if c["hits"] or c["fires"]:
                    key = (("point", name),)
                    self.failpoint_hits._set(key, float(c["hits"]))
                    self.failpoint_fires._set(key, float(c["fires"]))
        except Exception:  # noqa: BLE001
            pass
        try:
            from cometbft_tpu_torch.consensus import wal as walmod

            fs = walmod.fsync_stats()
            self.wal_fsync._set((), float(fs["count"]))
            self.wal_fsync_seconds._set((), float(fs["seconds"]))
        except Exception:  # noqa: BLE001
            pass
        try:
            # height ledger (module-loaded-only like the plane: the
            # ledger belongs to whichever consensus engine registered
            # last — same _LAST caveat as the flush percentiles)
            hl = sys.modules.get("cometbft_tpu_torch.consensus.heightledger")
            led = hl and hl.global_ledger()
            if led is not None:
                s = led.summary()
                self.height_ledger_size.set(float(s.get("heights", 0)))
                if s.get("heights"):
                    for stage, qs in s["stage_ms"].items():
                        for q, v in qs.items():
                            self.height_stage.set(
                                float(v), stage=stage, q=q)
                for row in led.top_late_signers():
                    key = str(row["val"])
                    self.late_signers._set(
                        (("kind", "late"), ("val", key)),
                        float(row["late_heights"]))
                    self.late_signers._set(
                        (("kind", "absent"), ("val", key)),
                        float(row["absent_heights"]))
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            from cometbft_tpu_torch.libs import incidents

            rec = incidents.recorder()
            self.incidents_ring.set(float(len(rec)))
            for kind, n in rec.fired.items():
                self.incidents_fired._set((("trigger", kind),),
                                          float(n))
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            # device observatory: counters from the compile ledger,
            # residency per family/device, per-chip headroom — all
            # torch-free reads (heavy modules only via sys.modules
            # inside residency())
            from cometbft_tpu_torch.libs import deviceledger

            c = deviceledger.counters()
            steady = float(c["steady_compiles"])
            self.device_compiles._set((("phase", "cold"),),
                                      float(c["compiles"]) - steady)
            self.device_compiles._set((("phase", "steady"),), steady)
            self.device_compile_seconds._set((),
                                             float(c["compile_s"]))
            self.device_pcache_hits._set((), float(c["pcache_hits"]))
            self.device_ledger_records.set(
                float(len(deviceledger.ledger())))
            fams = deviceledger.residency()
            # drop stale label sets first: an evicted family/device
            # must vanish from the scrape, not freeze at its last
            # pre-eviction value (gauges are point-in-time state)
            with self.device_resident._lock:
                self.device_resident._values.clear()
            with self.device_headroom._lock:
                self.device_headroom._values.clear()
            for fam, devs in fams.items():
                for dev, slot in devs.items():
                    self.device_resident.set(
                        float(slot["bytes"]), family=fam, dev=str(dev))
            for dev, n in deviceledger.headroom_rows(fams).items():
                self.device_headroom.set(float(n), dev=str(dev))
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            # gossip observatory (module-loaded-only like the plane:
            # the ledger belongs to whichever switch registered last —
            # same _LAST caveat as the flush percentiles)
            pl = sys.modules.get("cometbft_tpu_torch.p2p.peerledger")
            led = pl and pl.global_ledger()
            if led is not None:
                s = led.summary()
                self.p2p_ledger_peers.set(float(s["peers_live"]))
                self.p2p_peer_msgs._set((("dir", "tx"),),
                                        float(s["msgs_tx"]))
                self.p2p_peer_msgs._set((("dir", "rx"),),
                                        float(s["msgs_rx"]))
                self.p2p_peer_bytes._set((("dir", "tx"),),
                                         float(s["bytes_tx"]))
                self.p2p_peer_bytes._set((("dir", "rx"),),
                                         float(s["bytes_rx"]))
                self.p2p_queue_full_drops._set(
                    (), float(s["full_drops"]))
                self.p2p_blocked_puts._set(
                    (), float(s["blocked_puts"]))
                self.p2p_throttle_stalls._set(
                    (), float(s["throttle_stalls"]))
                self.p2p_link_drops._set((), float(s["link_drops"]))
                self.p2p_injected_faults._set(
                    (("kind", "drop"),), float(s["inj_drops"]))
                self.p2p_injected_faults._set(
                    (("kind", "delay"),), float(s["inj_delays"]))
                self.p2p_dup_votes._set((), float(s["dup_votes"]))
                for peer, rtt in led.rtt_rows():
                    self.p2p_ping_rtt.set(float(rtt), peer=peer)
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            # multi-tenant verify plane (module-loaded-only like the
            # plane: the registry belongs to the last plane that went
            # global; _LAST keeps a stopped plane's tenants scrapeable)
            vt = sys.modules.get("cometbft_tpu_torch.verifyplane.tenants")
            reg = vt and vt.last_registry()
            if reg is not None:
                mr = reg.metrics_rows()
                for name, row in mr["top"].items():
                    key = (("tenant", name),)
                    self.tenant_rows._set(key, float(row["rows"]))
                    self.tenant_sheds._set(key, float(row["sheds"]))
                    self.tenant_device_ms._set(
                        key, float(row["device_ms"]))
                ret = mr["retired"]
                self.tenant_rows._set((("tenant", "_retired"),),
                                      float(ret["rows"]))
                self.tenant_sheds._set((("tenant", "_retired"),),
                                       float(ret["sheds"]))
                self.tenant_device_ms._set(
                    (("tenant", "_retired"),),
                    round(ret["device_us"] / 1000.0, 3))
                self.tenant_registry_size.set(
                    float(mr["registry_size"]))
                # gauge: stale tenants must vanish, not freeze (the
                # device_resident discipline)
                with self.tenant_resident._lock:
                    self.tenant_resident._values.clear()
                for name, slot in reg.residency_by_tenant().items():
                    self.tenant_resident.set(float(slot["bytes"]),
                                             tenant=name)
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            # archival bootstrap plane (module-loaded-only: a node that
            # never statesync'd or served a snapshot pays nothing)
            st = sys.modules.get("cometbft_tpu_torch.statesync.stats")
            if st is not None:
                c = st.stats()
                for kind in ("fetched", "applied", "served", "shed"):
                    self.statesync_chunks._set(
                        (("kind", kind),), float(c["chunks_" + kind]))
                self.statesync_fetch_timeouts._set(
                    (), float(c["fetch_timeouts"]))
                for kind in ("punished", "dropped"):
                    self.statesync_providers._set(
                        (("kind", kind),),
                        float(c["providers_" + kind]))
                self.statesync_retry_rounds._set(
                    (), float(c["retry_snapshot_rounds"]))
                for kind in ("offered", "restored", "served", "shed"):
                    self.statesync_snapshots._set(
                        (("kind", kind),),
                        float(c["snapshots_" + kind]))
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass
        try:
            # self-tuning control plane (module-loaded-only like the
            # plane: decisions belong to whichever node mounted the
            # controller last; _LAST keeps a stopped node's totals
            # scrapeable)
            cm = sys.modules.get("cometbft_tpu_torch.libs.controller")
            ctl = cm and (cm._GLOBAL or cm._LAST)
            if ctl is not None:
                for (act, direction), n in ctl.decision_counts.items():
                    self.controller_decisions._set(
                        (("actuator", act), ("direction", direction)),
                        float(n))
                for act, v in ctl.actuator_values().items():
                    self.controller_value.set(float(v), actuator=act)
                self.controller_slo_violation._set(
                    (), float(ctl.slo_violation_s))
        except Exception:  # noqa: BLE001 - scrape must never fail
            pass

    def expose_text(self) -> str:
        self._sample()
        return self.registry.expose_text()
