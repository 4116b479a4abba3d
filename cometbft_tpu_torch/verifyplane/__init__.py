"""Verify plane: cross-caller continuous batching for signature verify.

The device is a shared service: every verification consumer (gossiped
votes, vote extensions, light-client commits, crypto.batch callers)
submits items to one always-on scheduler that coalesces them into padded
bucket batches, flushes on a micro-batch deadline or a full bucket, and
fuses per-group voting-power tallies into the same pass.

The port's copy of the JAX package's verifyplane/__init__.py.
"""
from cometbft_tpu_torch.verifyplane.plane import (
    DEFAULT_TENANT,
    LANE_BULK,
    LANE_CONSENSUS,
    LANE_GATEWAY,
    LANES,
    SHEDDABLE_LANES,
    FlushLedger,
    PlaneError,
    PlaneOverloaded,
    PlaneQueueFull,
    PlaneStopped,
    QuorumGroup,
    VerifyFuture,
    VerifyPlane,
    clear_global_plane,
    consensus_batch_fn,
    dump_flushes,
    flush_stats_for_seqs,
    global_plane,
    ledger_advanced,
    ledger_mark,
    ledger_tail,
    plane_batch_fn,
    set_global_plane,
)
from cometbft_tpu_torch.verifyplane.tenants import (
    TenantOverloaded,
    TenantRegistry,
    dump_tenants,
    global_registry,
    last_registry,
)
from cometbft_tpu_torch.verifyplane.warmer import (
    TableWarmer,
    clear_global_warmer,
    global_warmer,
    notify_next_valset,
    set_global_warmer,
)

__all__ = [
    "DEFAULT_TENANT",
    "LANE_BULK",
    "LANE_CONSENSUS",
    "LANE_GATEWAY",
    "LANES",
    "SHEDDABLE_LANES",
    "FlushLedger",
    "PlaneError",
    "PlaneOverloaded",
    "PlaneQueueFull",
    "PlaneStopped",
    "QuorumGroup",
    "TableWarmer",
    "TenantOverloaded",
    "TenantRegistry",
    "VerifyFuture",
    "VerifyPlane",
    "clear_global_plane",
    "consensus_batch_fn",
    "clear_global_warmer",
    "global_warmer",
    "notify_next_valset",
    "set_global_warmer",
    "dump_flushes",
    "dump_tenants",
    "flush_stats_for_seqs",
    "global_plane",
    "global_registry",
    "last_registry",
    "ledger_advanced",
    "ledger_mark",
    "ledger_tail",
    "plane_batch_fn",
    "set_global_plane",
]
