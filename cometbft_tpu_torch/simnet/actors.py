"""Byzantine validator actors for the simnet.

Three behaviors from the adversarial-consensus literature
(arXiv:2302.00418 treats equivocation detection and batch verification
of adversarial inputs as first-class; CometBFT's e2e runner injects the
same classes):

  * equivocator — double-signs prevotes/precommits. Honest nodes must
    surface it as DuplicateVoteEvidence (consensus/height_vote_set.py
    conflict detection -> evidence/pool.py -> block inclusion ->
    mark_committed).
  * garbage signer — gossips syntactically-valid votes with forged
    signatures. The verify path (host or verify plane) must reject them
    without poisoning coalesced batches and without tripping the
    circuit breaker (a bad SIGNATURE is a verdict, not a device fault).
  * light-client attacker — a >=1/3 coalition signs a forged header at
    a committed height; the resulting LightClientAttackEvidence (with
    its conflicting-commit proof attached) must pass
    verify_light_client_attack on honest nodes and flow through the
    same pool -> block -> mark_committed pipeline.
"""
from __future__ import annotations

import hashlib
from dataclasses import replace
from typing import List

from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.commit import (
    BLOCK_ID_FLAG_COMMIT,
    Commit,
    CommitSig,
)
from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.types.vote import Vote


def election_score(seed: int, epoch: int, pub: bytes, stake: int) -> float:
    """Deterministic stake-weighted sampling key (Efraimidis–Spirakis
    A-Res): u^(1/stake) with u drawn from a hash of (seed, epoch, pub).
    Ranking the pool by this key descending IS a proportional weighted
    sample without replacement — a member's selection probability is
    proportional to its stake, the committee-election property the
    proportional rule of arXiv 2004.12990 targets. Pure function of its
    arguments: the same (seed, schedule) elects the same committees in
    every replay."""
    h = hashlib.sha256(
        b"simnet-election" + seed.to_bytes(8, "big", signed=True)
        + epoch.to_bytes(8, "big") + pub
    ).digest()
    u = (int.from_bytes(h[:8], "big") + 1) / float(2 ** 64 + 1)
    return u ** (1.0 / max(1, int(stake)))


def proportional_election(seed: int, epoch: int, committee, standby,
                          stakes, churn: float):
    """One epoch of deterministic proportional committee election with
    bounded churn.

    committee / standby: disjoint lists of pool member indices;
    stakes: {index: (pub_bytes, stake)} — scores key on the member's
    PUBKEY so an index renumbering can never re-seed the draw; churn:
    fraction of the committee re-elected this epoch. The K = round(churn * size) sitting members
    with the WORST stake-weighted score this epoch rotate out and the
    K best-scoring standby members rotate in (so every seat turnover is
    itself a proportional draw). Returns (new_committee, new_standby,
    rotated_out, rotated_in) — all index lists, sorted for determinism.

    This is the election half of the simnet epoch driver; the harness
    turns the rotation into kvstore ``val:`` txs so the change set
    flows through the REAL ABCI -> update_with_change_set ->
    state/execution.py pipeline on every node."""
    committee = sorted(int(i) for i in committee)
    standby = sorted(int(i) for i in standby)
    size = len(committee)
    k = min(int(round(max(0.0, float(churn)) * size)), size,
            len(standby))
    if k == 0 or not committee:
        return committee, standby, [], []

    def score(i: int) -> float:
        return election_score(seed, epoch, stakes[i][0], stakes[i][1])

    out = sorted(sorted(committee, key=score)[:k])
    inn = sorted(sorted(standby, key=score, reverse=True)[:k])
    new_committee = sorted(set(committee) - set(out) | set(inn))
    new_standby = sorted(set(standby) - set(inn) | set(out))
    return new_committee, new_standby, out, inn


def _fake_block_id(tag: bytes) -> BlockID:
    h = hashlib.sha256(b"simnet-byzantine-" + tag).digest()
    return BlockID(h, PartSetHeader(1, h))


def conflicting_vote(vote: Vote, priv, chain_id: str) -> Vote:
    """The equivocator's second signature: same (height, round, type),
    different block ID, properly signed with the RAW private key —
    FilePV would refuse (privval/file_pv.py double-sign guard), which is
    precisely why a byzantine signer doesn't use it."""
    bad = replace(
        vote,
        block_id=_fake_block_id(b"%d-%d-%d" % (
            vote.height, vote.round, vote.vote_type
        )),
        signature=b"", extension=b"", extension_signature=b"",
    )
    bad.signature = priv.sign(bad.sign_bytes(chain_id))
    return bad


def garbage_sign(vote: Vote, rng) -> Vote:
    """The garbage signer's output: the vote with a seeded-random 64-byte
    forgery in place of the signature (still structurally valid, so it
    reaches signature verification — and, when a verify plane runs,
    coalesces into shared device batches)."""
    return replace(vote, signature=bytes(rng.getrandbits(8)
                                         for _ in range(64)))


def build_light_attack(privs, valset, chain_id: str,
                       byz_idxs: List[int], height: int,
                       now: Timestamp) -> LightClientAttackEvidence:
    """Forge a conflicting header at `height` sealed by the byzantine
    coalition, and package it as LightClientAttackEvidence with the
    commit proof attached.

    The coalition must hold >= 1/3 of the voting power at `height` for
    the evidence to verify (types/validation.py
    verify_commit_light_trusting with the default (1, 3) trust level) —
    the same threshold a real light-client attack needs."""
    forged = hashlib.sha256(
        b"simnet-forged-header-%d" % height
    ).digest()
    bid = BlockID(forged, PartSetHeader(1, forged))
    sigs = [CommitSig.absent() for _ in range(len(valset))]
    byz_addrs = []
    for idx in byz_idxs:
        priv = privs[idx]
        addr = priv.pub_key().address()
        vidx, val = valset.get_by_address(addr)
        assert val is not None, "byzantine index not in validator set"
        v = Vote(
            vote_type=canonical.PRECOMMIT_TYPE, height=height, round=0,
            block_id=bid, timestamp=now, validator_address=addr,
            validator_index=vidx,
        )
        sigs[vidx] = CommitSig(
            BLOCK_ID_FLAG_COMMIT, addr, now,
            priv.sign(v.sign_bytes(chain_id)),
        )
        byz_addrs.append(addr)
    return LightClientAttackEvidence(
        conflicting_header_hash=forged,
        conflicting_height=height,
        common_height=height,
        byzantine_validators=byz_addrs,
        total_voting_power=valset.total_voting_power(),
        timestamp=now,
        conflicting_commit=Commit(height, 0, bid, sigs),
    )


def forged_claim(privs, valset, chain_id: str, byz_idxs: List[int],
                 height: int, now: Timestamp) -> dict:
    """The wire-shaped claim a light client deceived by a lying primary
    submits to `lightgate_verify`: a forged header at `height` plus the
    byzantine coalition's commit sealing it ({"header": .., "commit":
    ..} in serde JSON form). Unlike :func:`build_light_attack` this is
    the RAW divergent view — the GATEWAY turns it into
    LightClientAttackEvidence through the light client's
    _make_attack_evidence path, which is exactly the seam the scenario
    exercises."""
    from cometbft_tpu_torch.types import serde
    from cometbft_tpu_torch.types.block import Header

    header = Header(
        chain_id=chain_id, height=height, time=now,
        last_block_id=BlockID(),
        validators_hash=valset.hash(),
        next_validators_hash=valset.hash(),
        proposer_address=valset.validators[0].address,
        app_hash=hashlib.sha256(b"simnet-forged-app-%d" % height
                                ).digest(),
    )
    hh = header.hash()
    bid = BlockID(hh, PartSetHeader(1, hh))
    sigs = [CommitSig.absent() for _ in range(len(valset))]
    for idx in byz_idxs:
        priv = privs[idx]
        addr = priv.pub_key().address()
        vidx, val = valset.get_by_address(addr)
        assert val is not None, "byzantine index not in validator set"
        v = Vote(
            vote_type=canonical.PRECOMMIT_TYPE, height=height, round=0,
            block_id=bid, timestamp=now, validator_address=addr,
            validator_index=vidx,
        )
        sigs[vidx] = CommitSig(
            BLOCK_ID_FLAG_COMMIT, addr, now,
            priv.sign(v.sign_bytes(chain_id)),
        )
    return {
        "header": serde.header_to_j(header),
        "commit": serde.commit_to_j(Commit(height, 0, bid, sigs)),
    }
