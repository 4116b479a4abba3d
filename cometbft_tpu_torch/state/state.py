"""Chain state + persistent state store.

Reference: state/state.go:355 (State: validators cur/next/last, params,
last results), state/store.go (dbStore: save/load, validator-set history
LoadValidators, bootstrap). sqlite3 stands in for cometbft-db.

The port's copy of the JAX package's state/state.py. The persisted JSON
is byte-equal to the JAX package's, so one store file reads in both.
"""
from __future__ import annotations

import json
import sqlite3
import threading
from dataclasses import dataclass, field, replace
from typing import Optional

from cometbft_tpu_torch.crypto.keys import PubKey
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.params import ConsensusParams
from cometbft_tpu_torch.types.serde import (
    bid_from_j,
    bid_to_j,
    ts_from_j,
    ts_to_j,
)
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet


@dataclass
class State:
    """Immutable-ish snapshot of the replicated state machine's frame
    (state/state.go:34-80). Copy-on-update via `replace`."""

    chain_id: str
    initial_height: int
    last_block_height: int
    last_block_id: BlockID
    last_block_time: Timestamp
    validators: ValidatorSet
    next_validators: ValidatorSet
    last_validators: Optional[ValidatorSet]
    last_height_validators_changed: int
    consensus_params: ConsensusParams
    app_hash: bytes
    last_results_hash: bytes = b""

    def copy(self) -> "State":
        return replace(
            self,
            validators=self.validators.copy(),
            next_validators=self.next_validators.copy(),
            last_validators=(
                self.last_validators.copy() if self.last_validators else None
            ),
        )

    @staticmethod
    def make_genesis(
        chain_id: str,
        validators: ValidatorSet,
        app_hash: bytes = b"",
        initial_height: int = 1,
        genesis_time: Optional[Timestamp] = None,
        params: Optional[ConsensusParams] = None,
    ) -> "State":
        """MakeGenesisState (state/state.go:355)."""
        return State(
            chain_id=chain_id,
            initial_height=initial_height,
            last_block_height=0,
            last_block_id=BlockID(),
            last_block_time=genesis_time or Timestamp.now(),
            validators=validators.copy(),
            next_validators=validators.copy_increment_proposer_priority(1),
            last_validators=None,
            last_height_validators_changed=initial_height,
            consensus_params=params or ConsensusParams(),
            app_hash=app_hash,
        )


def _valset_to_j(vs: Optional[ValidatorSet]):
    """The persisted form CARRIES THE PROPOSER (types proto ValidatorSet
    has an explicit Proposer field): increment_proposer_priority selects
    the proposer and then decrements its priority by the total power, so
    the selection CANNOT be recomputed from the priorities alone — a
    restart that re-derived "max priority" would elect a different
    validator than every live peer and broadcast proposals they reject
    as forged (found by the simnet's kill/restart schedules)."""
    if vs is None:
        return None
    return {
        "vals": [
            {
                "pub": v.pub_key.data.hex(),
                "kt": v.pub_key.key_type,
                "power": v.voting_power,
                "prio": v.proposer_priority,
            }
            for v in vs.validators
        ],
        "proposer": (vs.proposer.address.hex()
                     if vs.proposer is not None else None),
    }


def _valset_from_j(j) -> Optional[ValidatorSet]:
    if j is None:
        return None
    # legacy rows were a bare list (no proposer memo)
    rows = j["vals"] if isinstance(j, dict) else j
    proposer_addr = j.get("proposer") if isinstance(j, dict) else None
    vs = ValidatorSet.__new__(ValidatorSet)
    vals = [
        Validator(
            PubKey(bytes.fromhex(r["pub"]), r["kt"]), r["power"],
            proposer_priority=r["prio"],
        )
        for r in rows
    ]
    vs.validators = vals
    vs._index = {v.address: i for i, v in enumerate(vals)}
    vs._total_power = None
    vs.proposer = None
    if proposer_addr is not None:
        i = vs._index.get(bytes.fromhex(proposer_addr), -1)
        if i >= 0:
            vs.proposer = vals[i]
    return vs


class StateStore:
    """Persistent State + per-height validator sets (state/store.go)."""

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._db:
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS state (k TEXT PRIMARY KEY, "
                "v TEXT)"
            )
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS validators ("
                "height INTEGER PRIMARY KEY, vals TEXT)"
            )
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS abci_responses ("
                "height INTEGER PRIMARY KEY, resp TEXT)"
            )
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS params ("
                "height INTEGER PRIMARY KEY, p TEXT)"
            )

    def save(self, st: State) -> None:
        doc = {
            "chain_id": st.chain_id,
            "initial_height": st.initial_height,
            "last_block_height": st.last_block_height,
            "last_block_id": bid_to_j(st.last_block_id),
            "last_block_time": ts_to_j(st.last_block_time),
            "validators": _valset_to_j(st.validators),
            "next_validators": _valset_to_j(st.next_validators),
            "last_validators": _valset_to_j(st.last_validators),
            "lhvc": st.last_height_validators_changed,
            "app_hash": st.app_hash.hex(),
            "last_results_hash": st.last_results_hash.hex(),
            "params": st.consensus_params.to_j(),
        }
        with self._lock, self._db:
            self._db.execute(
                "INSERT OR REPLACE INTO state VALUES ('state', ?)",
                (json.dumps(doc),),
            )
            # validator-set history: the set that signs height H
            self._db.execute(
                "INSERT OR REPLACE INTO validators VALUES (?, ?)",
                (
                    st.last_block_height + 1,
                    json.dumps(_valset_to_j(st.validators)),
                ),
            )
            # consensus-params history (state/store.go ConsensusParamsInfo)
            self._db.execute(
                "INSERT OR REPLACE INTO params VALUES (?, ?)",
                (
                    st.last_block_height + 1,
                    json.dumps(st.consensus_params.to_j()),
                ),
            )

    def load(self) -> Optional[State]:
        with self._lock:
            cur = self._db.execute("SELECT v FROM state WHERE k='state'")
            row = cur.fetchone()
            if not row:
                return None
            j = json.loads(row[0])
            return State(
                chain_id=j["chain_id"],
                initial_height=j["initial_height"],
                last_block_height=j["last_block_height"],
                last_block_id=bid_from_j(j["last_block_id"]),
                last_block_time=ts_from_j(j["last_block_time"]),
                validators=_valset_from_j(j["validators"]),
                next_validators=_valset_from_j(j["next_validators"]),
                last_validators=_valset_from_j(j["last_validators"]),
                last_height_validators_changed=j["lhvc"],
                consensus_params=ConsensusParams.from_j(j.get("params")),
                app_hash=bytes.fromhex(j["app_hash"]),
                last_results_hash=bytes.fromhex(j["last_results_hash"]),
            )

    def load_validators(self, height: int) -> Optional[ValidatorSet]:
        """The validator set responsible for signing `height`
        (state/store.go LoadValidators)."""
        with self._lock:
            cur = self._db.execute(
                "SELECT vals FROM validators WHERE height=?", (height,)
            )
            row = cur.fetchone()
            return _valset_from_j(json.loads(row[0])) if row else None

    def load_consensus_params(self, height: int):
        """Params in force at `height` (the newest record <= height —
        params persist until changed; state/store.go LoadConsensusParams)."""
        with self._lock:
            cur = self._db.execute(
                "SELECT p FROM params WHERE height<=? "
                "ORDER BY height DESC LIMIT 1", (height,)
            )
            row = cur.fetchone()
            if row is None:
                return None
            return ConsensusParams.from_j(json.loads(row[0]))

    def save_abci_responses(self, height: int, doc: dict) -> None:
        """Persist a height's FinalizeBlock results for `block_results`
        and event reindexing (state/store.go SaveFinalizeBlockResponse).
        `doc` is the JSON form built by execution.responses_to_j."""
        with self._lock, self._db:
            self._db.execute(
                "INSERT OR REPLACE INTO abci_responses VALUES (?, ?)",
                (height, json.dumps(doc)),
            )

    def load_abci_responses(self, height: int) -> Optional[dict]:
        with self._lock:
            cur = self._db.execute(
                "SELECT resp FROM abci_responses WHERE height=?", (height,)
            )
            row = cur.fetchone()
            return json.loads(row[0]) if row else None

    def prune_abci_responses(self, retain_height: int) -> None:
        with self._lock, self._db:
            self._db.execute(
                "DELETE FROM abci_responses WHERE height < ?",
                (retain_height,),
            )

    def prune_validators(self, retain_height: int) -> None:
        """Drop validator-set history below retain_height (the pruner's
        state-store arm; state/store.go PruneStates)."""
        with self._lock, self._db:
            self._db.execute(
                "DELETE FROM validators WHERE height < ?", (retain_height,)
            )

    def close(self) -> None:
        with self._lock:
            self._db.close()
