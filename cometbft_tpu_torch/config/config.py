"""Typed node configuration + TOML persistence.

Reference: config/config.go:76-1312 (Config with Base/RPC/P2P/Mempool/
Blocksync/Consensus/Storage sections, ValidateBasic per section),
config/toml.go (template render). New here per SURVEY §5: the `[crypto]`
section selecting the signature-verification backend — `verifier =
"tpu"` routes commit verification through the device kernels, "cpu"
forces the host path.

The port's copy of the JAX package's config/config.py: the same
sections, keys, defaults, TOML and ConfigError texts, so either package
loads the other's file. `verifier = "tpu"` keeps its spelling and means
the accelerator, here the CUDA card. The builders give the port's
objects: the verify plane, the table warmer, the light-client gateway,
the controller, the tracer with its torch.profiler bracket, the incident
recorder and the failpoints. Two seams differ: for `verifier = "cpu"`
the JAX package's batch_fn() returns None (host single-verify to its
executor), where the port's executor reads None as the card, so the
port returns the explicit host callable validation.oracle_batch_fn(). For
`verifier = "tpu"` the JAX package returns a batch_fn straight to the
device; the port's rides the running verify plane's CONSENSUS lane and
goes to `device` (None: the card) only when no plane runs
(verifyplane.consensus_batch_fn), so a node's LastCommits coalesce with
its votes on one plane.
"""
from __future__ import annotations

import os

try:
    import tomllib
except ImportError:  # Python < 3.11: the vendored tomli is identical
    import tomli as tomllib
from dataclasses import dataclass, field


class ConfigError(Exception):
    pass


@dataclass
class BaseConfig:
    chain_id: str = "cometbft-tpu-chain"
    moniker: str = "node"
    proxy_app: str = "kvstore"      # in-process app by name
    blocksync: bool = True          # sync before joining consensus


@dataclass
class RPCConfig:
    laddr: str = "tcp://127.0.0.1:26657"
    enabled: bool = True
    # serve dial_seeds/dial_peers/unsafe_flush_mempool + /debug/pprof
    # (config.go RPCConfig.Unsafe + PprofListenAddress)
    unsafe: bool = False


@dataclass
class P2PConfig:
    laddr: str = "tcp://0.0.0.0:26656"
    persistent_peers: str = ""      # comma-separated id@host:port
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10


@dataclass
class MempoolConfig:
    size: int = 5000
    cache_size: int = 10000
    recheck: bool = True
    # node-side sigtx envelope verification through the verify plane's
    # BULK lane (mempool/sigtx.py); unsigned txs are unaffected
    verify_sigs: bool = True
    # CheckTx admission control (mempool/admission.py); `admission =
    # false` removes the gate entirely (every CheckTx runs)
    admission: bool = True
    max_inflight_checktx: int = 64
    # tightened in-flight bound while the device breaker is OPEN (all
    # verification is on the 1-core host then)
    breaker_inflight_checktx: int = 8
    # pool-fill watermarks with hysteresis: fast-reject broadcast_tx at
    # high, resume below low
    high_watermark: float = 0.9
    low_watermark: float = 0.7
    # backoff hint attached to OVERLOADED responses (Retry-After analog)
    retry_after_ms: float = 500.0

    def build_admission(self, fill_fn=None, breaker_open_fn=None):
        """An AdmissionController per this config, or None when the
        gate is disabled."""
        if not self.admission:
            return None
        from cometbft_tpu_torch.mempool.admission import AdmissionController

        return AdmissionController(
            max_inflight=self.max_inflight_checktx,
            breaker_inflight=self.breaker_inflight_checktx,
            high_watermark=self.high_watermark,
            low_watermark=self.low_watermark,
            retry_after_ms=self.retry_after_ms,
            fill_fn=fill_fn, breaker_open_fn=breaker_open_fn,
        )


@dataclass
class ConsensusConfig:
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0

    def timeout_params(self):
        from cometbft_tpu_torch.consensus.ticker import TimeoutParams

        return TimeoutParams(
            propose=self.timeout_propose,
            propose_delta=self.timeout_propose_delta,
            prevote=self.timeout_prevote,
            prevote_delta=self.timeout_prevote_delta,
            precommit=self.timeout_precommit,
            precommit_delta=self.timeout_precommit_delta,
            commit=self.timeout_commit,
        )


@dataclass
class CryptoConfig:
    """SURVEY §5: the accelerator verifier seam lives in config."""

    verifier: str = "tpu"   # "tpu" | "cpu"
    device: str = ""        # informational (e.g. "v5e-1")
    # device circuit breaker (crypto/batch.py): consecutive kernel
    # faults before batches fall back to the host verify path, and how
    # often an open breaker re-probes the device
    breaker_failure_threshold: int = 2
    breaker_cooldown: float = 30.0
    # bounded valset-table caches (ops/table_cache.py): how many built
    # window tables / sharded table sets / identity-memo entries stay
    # resident across epoch rotations. Each retired epoch's table is
    # LRU-evictable dead weight; these bound it (min 2 per cache — a
    # next-epoch warm insert must never evict the LIVE table).
    # table_cache_stats()/resident_bytes ride /metrics at scrape time.
    table_cache_tables: int = 8
    table_cache_shard_tables: int = 4
    table_cache_memo_entries: int = 8

    def apply_table_cache(self) -> None:
        """Push the cache capacities into the table-cache core; safe to
        call before any device module loads."""
        from cometbft_tpu_torch.ops import table_cache as tcache

        tcache.set_capacities(
            tables=self.table_cache_tables,
            shard_tables=self.table_cache_shard_tables,
            key_memo=self.table_cache_memo_entries * 2,
            valset_memo=self.table_cache_memo_entries,
        )

    def batch_fn(self, device=None):
        from cometbft_tpu_torch.crypto import batch as cbatch

        self.apply_table_cache()
        cbatch.configure_breaker(self.breaker_failure_threshold,
                                 self.breaker_cooldown)
        from cometbft_tpu_torch.types import validation

        if self.verifier == "cpu":
            return validation.oracle_batch_fn()
        from cometbft_tpu_torch.verifyplane.plane import consensus_batch_fn

        return consensus_batch_fn(device=device)


@dataclass
class VerifyPlaneConfig:
    """The always-on cross-caller batch-verification scheduler
    (cometbft_tpu_torch.verifyplane). `enable = true` starts it with the node;
    every verification consumer (gossiped votes, vote extensions, light
    client, crypto.batch callers) then coalesces into shared device
    passes."""

    enable: bool = False
    window_ms: float = 1.5      # micro-batch deadline (added latency cap)
    max_batch: int = 1024       # flush early at this many pending rows
    max_queue: int = 8192       # CONSENSUS-lane backpressure bound
    # QoS BULK lane (mempool CheckTx, backfill): its own coalescing
    # window (bulk favors batch fullness over latency; 0 = 4x window_ms),
    # queue bound (0 = max_queue), and shed deadline — a BULK submission
    # older than this is answered with an explicit Overloaded verdict
    # (0 disables deadline shedding)
    bulk_window_ms: float = 0.0
    bulk_max_queue: int = 0
    bulk_deadline_ms: float = 250.0
    # QoS GATEWAY lane (light-client gateway header verifies): drains
    # after CONSENSUS, ahead of BULK; window 0 = 2x window_ms, queue
    # bound 0 = max_queue, shed deadline answered with explicit
    # retry-hinted Overloaded verdicts (0 disables deadline shedding)
    gateway_window_ms: float = 0.0
    gateway_max_queue: int = 0
    gateway_deadline_ms: float = 500.0
    # Multichip sharded dispatch: mesh = true shards eligible fused
    # flushes across the local device mesh (per-shard device-resident
    # valset tables, on-device psum tally — one cross-chip pass for
    # commits past a single chip's valset ceiling). mesh_devices caps
    # the fan-out (0 = all local devices); mesh_min_rows keeps small
    # flushes on one chip.
    mesh: bool = False
    mesh_devices: int = 0
    mesh_min_rows: int = 256
    # Pipelined mesh halves (the flight deck): pipeline_flights > 1
    # keeps up to that many flushes airborne at once on DISJOINT
    # sub-mesh halves — while one half verifies flush k, the other
    # half flies flush k+1, so no chip idles between collect and
    # dispatch. Needs a >=4-device mesh for real halves (each half
    # runs the sharded program on >=2 chips); otherwise the deck
    # degrades to the classic single-flight double buffer.
    # half_mesh_rows caps how many rows a flush may carry and still
    # ride a half (0 = budget-only: any flush whose stride count fits
    # the half's 65536-slot/device budget takes it); a flush past the
    # cap takes the full mesh and drains the deck first.
    pipeline_flights: int = 1
    # controller headroom: the self-tuning loop ([controller]) may
    # grow the deck up to this ceiling at runtime (0 = no headroom,
    # the deck stays at pipeline_flights). The staging pool and mesh
    # halves are sized for the CEILING at construction, and the
    # table_cache_shard_tables cross-check below applies to it.
    pipeline_flights_max: int = 0
    half_mesh_rows: int = 0
    # Next-epoch table warmer (verifyplane/warmer.py): when the block
    # executor applies validator updates, a background thread builds
    # the epoch e+1 valset's window tables (sharded too, when a mesh
    # is configured) while epoch e is still live — the first commit
    # after a rotation then hits a warm cache instead of paying the
    # build inline. Pure optimization: warmer faults/skips degrade to
    # the cold path and never touch live verdicts.
    warm_next_epoch: bool = True

    def build(self, metrics=None, device=None):
        """A VerifyPlane per this config on `device` (None: the card),
        or None when disabled."""
        if not self.enable:
            return None
        from cometbft_tpu_torch.verifyplane import VerifyPlane

        return VerifyPlane(
            window_ms=self.window_ms,
            max_batch=self.max_batch,
            max_queue=self.max_queue, metrics=metrics,
            bulk_window_ms=self.bulk_window_ms or None,
            bulk_max_queue=self.bulk_max_queue or None,
            bulk_deadline_ms=self.bulk_deadline_ms,
            gateway_window_ms=self.gateway_window_ms or None,
            gateway_max_queue=self.gateway_max_queue or None,
            gateway_deadline_ms=self.gateway_deadline_ms,
            mesh_devices=self.mesh_devices if self.mesh else None,
            mesh_min_rows=self.mesh_min_rows,
            pipeline_flights=self.pipeline_flights,
            pipeline_flights_max=self.pipeline_flights_max or None,
            half_mesh_rows=self.half_mesh_rows, device=device,
        )

    def build_warmer(self, device=None):
        """The next-epoch TableWarmer on `device` (None: the card), or
        None when the plane or the warm_next_epoch knob is off."""
        if not (self.enable and self.warm_next_epoch):
            return None
        from cometbft_tpu_torch.verifyplane.warmer import TableWarmer

        return TableWarmer(device=device)


@dataclass
class LightGateConfig:
    """The light-client gateway (cometbft_tpu_torch.lightgate): serve
    skipping verification to many concurrent light clients with
    request coalescing, a shared trusted store, and a verified-pair
    LRU. `enable = true` mounts it on the node and exposes the
    lightgate_* JSON-RPC routes."""

    enable: bool = False
    cache_size: int = 4096          # verified (trusted, target) pairs
    trusting_period: float = 14 * 24 * 3600.0
    coalesce_timeout: float = 30.0  # follower wait on a shared flight
    max_batch_headers: int = 64     # heights per lightgate_headers call

    def build(self, node):
        """A LightGateway mounted on `node`, or None when disabled."""
        if not self.enable:
            return None
        from cometbft_tpu_torch.lightgate import LightGateway

        return LightGateway.for_node(
            node,
            cache_size=self.cache_size,
            trusting_period=self.trusting_period,
            coalesce_timeout=self.coalesce_timeout,
            max_batch_headers=self.max_batch_headers,
        )


@dataclass
class ControllerConfig:
    """The closed-loop self-tuning control plane (libs/controller).
    Off by default: `enable = true` mounts it on the node, poked from
    the consensus-step and dispatcher-drain seams. The SLO knobs are
    the operator's declaration; everything else is loop mechanics with
    safe defaults. Every actuator the loop may move carries explicit
    clamp bounds here (validated against the static sections), so a
    runaway loop degrades to the static config, never past it."""

    enable: bool = False
    # the operator-declared SLOs: commit p99 (the height ledger's
    # apply-latency percentile) and the per-lane wait targets (these
    # double as widen ceilings — a coalescing window IS added latency
    # on its lane, so the controller never widens past half the target)
    slo_commit_p99_ms: float = 500.0
    slo_gateway_wait_ms: float = 250.0
    slo_bulk_wait_ms: float = 1000.0
    # loop mechanics: pokes per evaluation, per-actuator cooldown (in
    # evaluations), the hysteresis exit threshold (pressure enters at
    # SLO violation / fill_high, exits only below pressure_low AND
    # fill_low — the PR-7 admission-hysteresis template)
    decision_interval: int = 8
    cooldown: int = 4
    pressure_low: float = 0.5
    fill_high: float = 0.6
    fill_low: float = 0.3
    # per-move step sizes (multiplicative for windows/deadline,
    # additive for watermarks)
    window_step: float = 1.5
    watermark_step: float = 0.08
    deadline_step: float = 0.75
    util_low: float = 0.5
    # actuator clamp bounds (satellite hardening): the window maxima,
    # the deadline floor (must cover at least one flush window — a
    # deadline under the window sheds EVERYTHING), and the admission
    # floor (the high watermark may never be tightened below it)
    bulk_window_max_ms: float = 24.0
    gateway_window_max_ms: float = 12.0
    bulk_deadline_min_ms: float = 50.0
    admission_floor: float = 0.2

    def build(self):
        """A Controller per this config, or None when disabled."""
        if not self.enable:
            return None
        from cometbft_tpu_torch.libs.controller import Controller

        return Controller(
            slo_commit_p99_ms=self.slo_commit_p99_ms,
            slo_gateway_wait_ms=self.slo_gateway_wait_ms,
            slo_bulk_wait_ms=self.slo_bulk_wait_ms,
            decision_interval=self.decision_interval,
            cooldown=self.cooldown,
            pressure_low=self.pressure_low,
            fill_high=self.fill_high,
            fill_low=self.fill_low,
            window_step=self.window_step,
            watermark_step=self.watermark_step,
            deadline_step=self.deadline_step,
            util_low=self.util_low,
        )

    def bounds(self, verify_plane: "VerifyPlaneConfig",
               mempool: "MempoolConfig") -> dict:
        """Actuator name -> (min, max) clamps, anchored at the static
        sections' effective bases (the values the loop relaxes back
        to and may never cross)."""
        bulk_base = verify_plane.bulk_window_ms \
            or 4 * verify_plane.window_ms
        gw_base = verify_plane.gateway_window_ms \
            or 2 * verify_plane.window_ms
        return {
            "bulk_window_ms": (
                bulk_base, max(bulk_base, self.bulk_window_max_ms)),
            "gateway_window_ms": (
                gw_base, max(gw_base, self.gateway_window_max_ms)),
            "bulk_deadline_ms": (
                min(self.bulk_deadline_min_ms,
                    verify_plane.bulk_deadline_ms),
                verify_plane.bulk_deadline_ms),
            "admission_high_watermark": (
                min(self.admission_floor, mempool.high_watermark),
                mempool.high_watermark),
        }


@dataclass
class TracingConfig:
    """The span/event trace plane (libs/tracing.py). Off by default
    and near-free while off. `enable = true` installs the global
    tracer (ring of `buffer` events, served by GET /dump_traces and
    the dump_traces RPC as perfetto-loadable Chrome trace JSON).
    `profile_dir` additionally arms the torch.profiler bracket around
    verify-plane device flights — device traces land in that directory
    (expensive; profiling runs only). While a torch profiler records,
    every span is also a `record_function` of its name, so each trace
    holds the host spans as `user_annotation` events on the clock of
    its kernel and copy events, tracer on or off."""

    enable: bool = False
    buffer: int = 16384     # ring capacity, in events
    profile_dir: str = ""

    def apply(self) -> None:
        """Symmetric: applying a config with tracing off DISABLES the
        global tracer and clears the profile dir — rebuilding a node
        from an edited config must not leave the previous config's
        tracer (or torch.profiler arming) running."""
        from cometbft_tpu_torch.libs import tracing

        tracing.set_profile_dir(self.profile_dir)
        if self.enable:
            tracing.enable(capacity=self.buffer)
        else:
            tracing.disable()


@dataclass
class IncidentsConfig:
    """The incident flight recorder (libs/incidents.py). ALWAYS ON —
    there is no enable knob, only thresholds: the recorder's poke path
    costs a clock read + integer compares per consensus step, and the
    snapshot only allocates when a trigger actually fires. Knob costs:
    lowering commit_stall_s / round_limit makes drills fire earlier
    (more ring churn, same per-poke cost); cooldown_s bounds how often
    one persistent condition re-freezes."""

    commit_stall_s: float = 20.0   # no commit for this long => incident
    round_limit: int = 4           # a height reaching this round fires
    breaker_flaps: int = 4         # breaker transitions inside window_s
    shed_storm: int = 256          # sheddable-lane sheds inside window_s
    peer_starvation: int = 64      # p2p send-queue stalls inside window_s
    compile_storm: int = 3         # steady-state recompiles inside window_s
    window_s: float = 10.0         # flap/storm evaluation window
    cooldown_s: float = 30.0       # per-trigger-kind re-arm time

    def apply(self, fingerprint=None) -> None:
        from cometbft_tpu_torch.libs import incidents

        incidents.configure(
            commit_stall_s=self.commit_stall_s,
            round_limit=self.round_limit,
            breaker_flaps=self.breaker_flaps,
            shed_storm=self.shed_storm,
            peer_starvation=self.peer_starvation,
            compile_storm=self.compile_storm,
            window_s=self.window_s,
            cooldown_s=self.cooldown_s,
        )
        if fingerprint is not None:
            incidents.recorder().set_fingerprint(fingerprint)


@dataclass
class FailpointsConfig:
    """Deterministic fault injection (libs/failpoints.py). `spec` uses
    the same syntax as the CBT_FAILPOINTS env var:
    ``name=action[:arg][*count][;...]`` with actions
    crash|raise|delay|flake. Empty = nothing armed."""

    spec: str = ""

    def apply(self) -> None:
        if self.spec:
            from cometbft_tpu_torch.libs import failpoints

            failpoints.arm_from_spec(self.spec)


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    crypto: CryptoConfig = field(default_factory=CryptoConfig)
    verify_plane: VerifyPlaneConfig = field(
        default_factory=VerifyPlaneConfig)
    lightgate: LightGateConfig = field(default_factory=LightGateConfig)
    controller: ControllerConfig = field(
        default_factory=ControllerConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    incidents: IncidentsConfig = field(default_factory=IncidentsConfig)
    failpoints: FailpointsConfig = field(default_factory=FailpointsConfig)

    def validate_basic(self) -> None:
        if not self.base.chain_id:
            raise ConfigError("chain_id must not be empty")
        if self.crypto.verifier not in ("tpu", "cpu"):
            raise ConfigError(
                f"[crypto] verifier must be tpu|cpu, "
                f"got {self.crypto.verifier!r}"
            )
        if self.crypto.breaker_failure_threshold < 1:
            raise ConfigError(
                "[crypto] breaker_failure_threshold must be >= 1"
            )
        if self.crypto.breaker_cooldown < 0:
            raise ConfigError("[crypto] breaker_cooldown must be >= 0")
        for name in ("table_cache_tables", "table_cache_shard_tables",
                     "table_cache_memo_entries"):
            if getattr(self.crypto, name) < 2:
                raise ConfigError(
                    f"[crypto] {name} must be >= 2 — capacity 1 would "
                    f"let a next-epoch warm insert evict the LIVE "
                    f"epoch's table mid-flush")
        if self.verify_plane.pipeline_flights_max < 0:
            raise ConfigError(
                "[verify_plane] pipeline_flights_max must be >= 0 "
                "(0 = no controller headroom)")
        if self.verify_plane.pipeline_flights_max and \
                self.verify_plane.pipeline_flights_max \
                < self.verify_plane.pipeline_flights:
            raise ConfigError(
                "[verify_plane] pipeline_flights_max must be >= "
                "pipeline_flights (it is the controller's grow "
                "ceiling, not a second starting value)")
        flights_ceiling = max(self.verify_plane.pipeline_flights,
                              self.verify_plane.pipeline_flights_max)
        if flights_ceiling > 1 \
                and self.crypto.table_cache_shard_tables < 4:
            raise ConfigError(
                "[crypto] table_cache_shard_tables must be >= 4 with "
                "[verify_plane] pipeline_flights (or the controller "
                "ceiling pipeline_flights_max) > 1 — the deck keeps "
                "a LIVE sharded table per mesh half (two), so a "
                "next-epoch warm of both halves needs headroom or it "
                "evicts a live half's table mid-flush")
        if self.verify_plane.window_ms < 0:
            raise ConfigError("[verify_plane] window_ms must be >= 0")
        if self.verify_plane.max_batch < 1:
            raise ConfigError("[verify_plane] max_batch must be >= 1")
        if self.verify_plane.max_queue < self.verify_plane.max_batch:
            raise ConfigError(
                "[verify_plane] max_queue must be >= max_batch")
        for name in ("bulk_window_ms", "bulk_max_queue",
                     "bulk_deadline_ms", "gateway_window_ms",
                     "gateway_max_queue", "gateway_deadline_ms",
                     "mesh_devices", "mesh_min_rows",
                     "half_mesh_rows"):
            if getattr(self.verify_plane, name) < 0:
                raise ConfigError(f"[verify_plane] {name} must be >= 0")
        if self.verify_plane.mesh_devices == 1:
            raise ConfigError(
                "[verify_plane] mesh_devices must be 0 (all) or >= 2 — "
                "a 1-device mesh is just the single-device path")
        if self.verify_plane.pipeline_flights < 1:
            raise ConfigError(
                "[verify_plane] pipeline_flights must be >= 1 "
                "(1 = classic single-flight dispatch)")
        lg = self.lightgate
        if lg.cache_size < 1:
            raise ConfigError("[lightgate] cache_size must be >= 1")
        if lg.trusting_period <= 0:
            raise ConfigError("[lightgate] trusting_period must be > 0")
        if lg.coalesce_timeout <= 0:
            raise ConfigError("[lightgate] coalesce_timeout must be > 0")
        if lg.max_batch_headers < 1:
            raise ConfigError("[lightgate] max_batch_headers must be >= 1")
        mp = self.mempool
        if mp.size < 1:
            raise ConfigError("[mempool] size must be >= 1")
        if mp.max_inflight_checktx < 1 or mp.breaker_inflight_checktx < 1:
            raise ConfigError(
                "[mempool] inflight CheckTx bounds must be >= 1")
        if not 0.0 < mp.high_watermark <= 1.0:
            raise ConfigError(
                "[mempool] high_watermark must be in (0, 1]")
        if not 0.0 <= mp.low_watermark <= mp.high_watermark:
            raise ConfigError(
                "[mempool] low_watermark must be in [0, high_watermark]")
        if mp.retry_after_ms < 0:
            raise ConfigError("[mempool] retry_after_ms must be >= 0")
        ctl = self.controller
        for name in ("slo_commit_p99_ms", "slo_gateway_wait_ms",
                     "slo_bulk_wait_ms"):
            if getattr(ctl, name) <= 0:
                raise ConfigError(f"[controller] {name} must be > 0")
        if ctl.decision_interval < 1:
            raise ConfigError(
                "[controller] decision_interval must be >= 1")
        if ctl.cooldown < 0:
            raise ConfigError("[controller] cooldown must be >= 0")
        if not 0.0 < ctl.pressure_low < 1.0:
            raise ConfigError(
                "[controller] pressure_low must be in (0, 1) — it is "
                "the hysteresis EXIT threshold under the SLO")
        if not 0.0 < ctl.fill_low < ctl.fill_high <= 1.0:
            raise ConfigError(
                "[controller] fill thresholds must satisfy "
                "0 < fill_low < fill_high <= 1 (enter high, exit low "
                "— equal thresholds flap at one boundary)")
        if ctl.window_step <= 1.0:
            raise ConfigError(
                "[controller] window_step must be > 1 "
                "(a multiplicative widen factor)")
        if not 0.0 < ctl.deadline_step < 1.0:
            raise ConfigError(
                "[controller] deadline_step must be in (0, 1) "
                "(a multiplicative tighten factor)")
        if ctl.watermark_step <= 0:
            raise ConfigError(
                "[controller] watermark_step must be > 0")
        if not 0.0 < ctl.util_low <= 1.0:
            raise ConfigError(
                "[controller] util_low must be in (0, 1]")
        # actuator clamp hardening: the bounds a runaway loop degrades
        # to must themselves be sane against the STATIC sections
        if ctl.bulk_deadline_min_ms < self.verify_plane.window_ms:
            raise ConfigError(
                "[controller] bulk_deadline_min_ms must be >= "
                "[verify_plane] window_ms — a shed deadline under one "
                "flush window sheds every BULK submission before a "
                "flush can reach it")
        if not 0.0 < ctl.admission_floor <= 1.0:
            raise ConfigError(
                "[controller] admission_floor must be in (0, 1]")
        if ctl.admission_floor > mp.high_watermark:
            raise ConfigError(
                "[controller] admission_floor must be <= [mempool] "
                "high_watermark (the floor is a tighten LIMIT, not a "
                "second watermark)")
        for name in ("bulk_window_max_ms", "gateway_window_max_ms"):
            if getattr(ctl, name) <= 0:
                raise ConfigError(f"[controller] {name} must be > 0")
        if self.tracing.buffer < 16:
            raise ConfigError("[tracing] buffer must be >= 16 events")
        inc = self.incidents
        for name in ("commit_stall_s", "window_s", "cooldown_s"):
            if getattr(inc, name) < 0:
                raise ConfigError(f"[incidents] {name} must be >= 0")
        if inc.round_limit < 1 or inc.breaker_flaps < 1 \
                or inc.shed_storm < 1 or inc.peer_starvation < 1 \
                or inc.compile_storm < 1:
            raise ConfigError(
                "[incidents] round_limit/breaker_flaps/shed_storm/"
                "peer_starvation/compile_storm must be >= 1")
        if self.failpoints.spec:
            # parse-validate without arming: a typo'd spec must fail at
            # config load, not silently never fire
            from cometbft_tpu_torch.libs.failpoints import parse_spec

            try:
                parse_spec(self.failpoints.spec)
            except ValueError as e:
                raise ConfigError(f"[failpoints] bad spec: {e}")
        for name in ("timeout_propose", "timeout_prevote",
                     "timeout_precommit", "timeout_commit"):
            if getattr(self.consensus, name) < 0:
                raise ConfigError(f"[consensus] {name} must be >= 0")


def _render(cfg: Config) -> str:
    """TOML template (config/toml.go analog)."""

    def v(x):
        if isinstance(x, bool):
            return "true" if x else "false"
        if isinstance(x, (int, float)):
            return repr(x)
        return f'"{x}"'

    out = ["# cometbft-tpu node configuration\n"]
    for section, obj in [
        ("base", cfg.base), ("rpc", cfg.rpc), ("p2p", cfg.p2p),
        ("mempool", cfg.mempool), ("consensus", cfg.consensus),
        ("crypto", cfg.crypto), ("verify_plane", cfg.verify_plane),
        ("lightgate", cfg.lightgate),
        ("controller", cfg.controller),
        ("tracing", cfg.tracing), ("incidents", cfg.incidents),
        ("failpoints", cfg.failpoints),
    ]:
        out.append(f"[{section}]")
        for k, val in vars(obj).items():
            out.append(f"{k} = {v(val)}")
        out.append("")
    return "\n".join(out)


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        f.write(_render(cfg))


def load_config(path: str) -> Config:
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    cfg = Config()
    for section, obj in [
        ("base", cfg.base), ("rpc", cfg.rpc), ("p2p", cfg.p2p),
        ("mempool", cfg.mempool), ("consensus", cfg.consensus),
        ("crypto", cfg.crypto), ("verify_plane", cfg.verify_plane),
        ("lightgate", cfg.lightgate),
        ("controller", cfg.controller),
        ("tracing", cfg.tracing), ("incidents", cfg.incidents),
        ("failpoints", cfg.failpoints),
    ]:
        for k, val in doc.get(section, {}).items():
            if not hasattr(obj, k):
                raise ConfigError(f"unknown key [{section}] {k}")
            setattr(obj, k, val)
    cfg.validate_basic()
    return cfg


def default_home() -> str:
    return os.path.expanduser(os.environ.get("CBT_HOME", "~/.cometbft-tpu"))
