"""ABCI: the application boundary interface and message types.

Reference: abci/types/application.go:9-60 (the 14-method Application
interface), proto/tendermint/abci (message fields — represented here as
dataclasses; the socket/grpc wire codecs serialize them when the app runs
out of process).

The in-process path (proxy.local_client analog) passes these dataclasses
directly — no serialization, mirroring abci/client/local_client.go.

The port's copy of the JAX package's abci/types.py (host code, no device).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

CODE_TYPE_OK = 0
# Non-OK CheckTx codes the NODE itself (not the app) may answer with.
# The reference leaves code semantics to the app; these two sit far
# above the small codes sample apps use so they can never collide.
# OVERLOADED is the explicit load-shed verdict: admission control
# fast-rejected the tx, or the verify plane shed its BULK-lane
# signature check past the deadline. The log carries a
# `retry_after_ms=N` hint (the Retry-After analog for JSON-RPC).
CODE_TYPE_OVERLOADED = 1001
# the node-side signature pre-check (mempool sigtx envelope) failed —
# the tx never reached the app
CODE_TYPE_BAD_SIGNATURE = 1002


@dataclass
class ValidatorUpdate:
    pub_key: bytes  # raw ed25519 key bytes
    power: int
    key_type: str = "ed25519"


@dataclass
class Snapshot:
    """abci Snapshot (proto/tendermint/abci Snapshot)."""

    height: int = 0
    format: int = 1
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


# ResponseApplySnapshotChunk.Result (abci/types.proto ApplySnapshotChunk
# result enum) — lets the app direct the statesync chunk engine:
APPLY_CHUNK_ACCEPT = 0          # chunk applied, move on
APPLY_CHUNK_ABORT = 1           # abort all snapshot restoration
APPLY_CHUNK_RETRY = 2           # refetch + reapply THIS chunk
APPLY_CHUNK_RETRY_SNAPSHOT = 3  # restart the whole snapshot
APPLY_CHUNK_REJECT_SNAPSHOT = 4  # never try this snapshot again


@dataclass
class ResponseApplySnapshotChunk:
    """Rich apply result (abci Response.ApplySnapshotChunk). Apps may
    also return a bare bool (True == ACCEPT, False == RETRY)."""

    result: int = APPLY_CHUNK_ACCEPT
    refetch_chunks: list = field(default_factory=list)
    reject_senders: list = field(default_factory=list)


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class RequestInitChain:
    time_seconds: int = 0
    chain_id: str = ""
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass
class ResponseInitChain:
    validators: List[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    recheck: bool = False


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    # structured backoff hint for CODE_TYPE_OVERLOADED responses (0 =
    # none): the machine-readable source for the RPC layer's
    # `retry_after_ms` field — the log carries the same number for
    # humans, but clients must never have to parse it out of a string
    retry_after_ms: float = 0.0


@dataclass
class VoteInfo:
    """abci.VoteInfo: one LastCommit entry for the app's incentive
    logic (execution.go:443 buildLastCommitInfo)."""

    validator_address: bytes = b""
    power: int = 0
    block_id_flag: int = 0  # types/block.go BlockIDFlag values


@dataclass
class CommitInfo:
    round: int = 0
    votes: List[VoteInfo] = field(default_factory=list)


@dataclass
class ExtendedVoteInfo:
    """abci.ExtendedVoteInfo: VoteInfo + the validator's vote extension
    (execution.go:472 buildExtendedCommitInfo)."""

    validator_address: bytes = b""
    power: int = 0
    block_id_flag: int = 0
    vote_extension: bytes = b""
    extension_signature: bytes = b""


@dataclass
class ExtendedCommitInfo:
    round: int = 0
    votes: List[ExtendedVoteInfo] = field(default_factory=list)


@dataclass
class Misbehavior:
    """abci.Misbehavior (evidence reported to the app in FinalizeBlock)."""

    type: str = "duplicate_vote"  # or "light_client_attack"
    validator_address: bytes = b""
    height: int = 0
    time_seconds: int = 0
    total_voting_power: int = 0


@dataclass
class RequestPrepareProposal:
    max_tx_bytes: int = 0
    txs: List[bytes] = field(default_factory=list)
    height: int = 0
    proposer_address: bytes = b""
    # extensions from the previous height's precommits, when enabled
    # (the app may fold them into the proposed txs)
    local_last_commit: Optional[ExtendedCommitInfo] = None


@dataclass
class ResponsePrepareProposal:
    txs: List[bytes] = field(default_factory=list)


@dataclass
class RequestProcessProposal:
    txs: List[bytes] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    proposer_address: bytes = b""


PROCESS_PROPOSAL_ACCEPT = 1
PROCESS_PROPOSAL_REJECT = 2


@dataclass
class ResponseProcessProposal:
    status: int = PROCESS_PROPOSAL_ACCEPT


@dataclass
class RequestFinalizeBlock:
    txs: List[bytes] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    proposer_address: bytes = b""
    time_seconds: int = 0
    # who signed the block's LastCommit + flags (incentive logic)
    decided_last_commit: Optional[CommitInfo] = None
    # evidence committed in this block (execution.go extendedCommitInfo)
    misbehavior: List[Misbehavior] = field(default_factory=list)


@dataclass
class RequestExtendVote:
    """ExtendVote (application.go, execution.go:318): the app attaches
    arbitrary data to this validator's precommit."""

    hash: bytes = b""
    height: int = 0
    round: int = 0


@dataclass
class ResponseExtendVote:
    vote_extension: bytes = b""


@dataclass
class RequestVerifyVoteExtension:
    """VerifyVoteExtension (execution.go:349): validate another
    validator's extension before accepting its precommit."""

    hash: bytes = b""
    validator_address: bytes = b""
    height: int = 0
    vote_extension: bytes = b""


VERIFY_VOTE_EXTENSION_ACCEPT = 1
VERIFY_VOTE_EXTENSION_REJECT = 2


@dataclass
class ResponseVerifyVoteExtension:
    status: int = VERIFY_VOTE_EXTENSION_ACCEPT


@dataclass
class ExecTxResult:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0


@dataclass
class ResponseFinalizeBlock:
    tx_results: List[ExecTxResult] = field(default_factory=list)
    validator_updates: List[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class ResponseCommit:
    retain_height: int = 0


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class ResponseQuery:
    code: int = CODE_TYPE_OK
    key: bytes = b""
    value: bytes = b""
    height: int = 0
    log: str = ""
    # crypto.proof_ops.ProofOp list when the request set prove=True
    # (abci ResponseQuery.proof_ops) — chains value -> app_hash
    proof_ops: list = field(default_factory=list)


class Application:
    """The 14-method ABCI++ surface (abci/types/application.go:9-60).

    Base implementations are accept-everything no-ops, mirroring
    abci/types/application.go BaseApplication."""

    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx()

    def prepare_proposal(
        self, req: RequestPrepareProposal
    ) -> ResponsePrepareProposal:
        return ResponsePrepareProposal(txs=list(req.txs))

    def process_proposal(
        self, req: RequestProcessProposal
    ) -> ResponseProcessProposal:
        return ResponseProcessProposal()

    def finalize_block(
        self, req: RequestFinalizeBlock
    ) -> ResponseFinalizeBlock:
        return ResponseFinalizeBlock(
            tx_results=[ExecTxResult() for _ in req.txs]
        )

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery()

    # vote extensions (application.go ExtendVote/VerifyVoteExtension;
    # consensus calls these for precommits once
    # ConsensusParams.abci.vote_extensions_enable_height is reached)
    def extend_vote(self, req: RequestExtendVote) -> ResponseExtendVote:
        return ResponseExtendVote()

    def verify_vote_extension(
        self, req: RequestVerifyVoteExtension
    ) -> ResponseVerifyVoteExtension:
        return ResponseVerifyVoteExtension()

    # state-sync snapshots (abci/types/application.go:9 ListSnapshots/
    # OfferSnapshot/LoadSnapshotChunk/ApplySnapshotChunk)
    def list_snapshots(self) -> list:
        return []

    def offer_snapshot(self, snapshot: "Snapshot") -> bool:
        return False

    def load_snapshot_chunk(self, height, fmt, chunk) -> bytes:
        return b""

    def apply_snapshot_chunk(self, index, chunk, sender):
        """Returns bool (True == ACCEPT, False == RETRY) or a
        ResponseApplySnapshotChunk for refetch/reject control."""
        return False
