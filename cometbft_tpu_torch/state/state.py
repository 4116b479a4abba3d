"""Chain state: the validator-set serde of the persisted state.

Reference: state/store.go (validator-set persistence). The port's copy of
the JAX package's state/state.py `_valset_to_j` / `_valset_from_j`, which
light/store.py needs; the rest of that module (`State`, `ConsensusParams`
and the sqlite `StateStore`) comes with the node path.
"""
from __future__ import annotations

from typing import Optional

from cometbft_tpu_torch.crypto.keys import PubKey
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet


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
