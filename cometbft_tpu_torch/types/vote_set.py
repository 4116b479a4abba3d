"""VoteSet: thread-safe per-(height, round, type) vote accumulator.

Reference: types/vote_set.go — AddVote (:157) -> validation -> signature
verify (:216-231) -> addVerifiedVote (:257-328) with 2/3 quorum detection
(:307-325), votesBitArray (:70), conflicting-vote tracking in votesByBlock
(:74), peer maj23 claims (:335), MakeCommit/MakeExtendedCommit (:636).

The port's copy of the JAX package's types/vote_set.py, over the port's
verify plane. With a running plane, a vote's signature (and extension
signature) is one submission. A plane that stops, fills or sheds under
the vote (PlaneError, an admission outcome) sends it down the serial host
path when it is a host plane (use_device=False), as in the JAX package;
a device plane's vote is then verified directly on the plane's device
(crypto/batch.verify_batch_direct), so no vote moves to the host behind
a card (ROADMAP C1). A DeviceError from a device plane (a faulting flush,
a verdict that timed out) is not a PlaneError: it propagates out of
add_vote and the vote is not admitted, where the JAX plane would have
answered from the host (C1). A VoteSet given a `device` verifies on that
device when no plane runs (crypto/batch.verify_batch_direct, one call a
vote with its extension row), so a node on a card without a plane does
not verify its votes on the host; with no device it takes the serial
host path, as the JAX VoteSet does.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.block_id import BlockID
from cometbft_tpu_torch.types.commit import (
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    Commit,
    CommitSig,
)
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote, VoteError


class VoteSetError(Exception):
    pass


class ConflictingVoteError(VoteSetError):
    def __init__(self, existing: Vote, new: Vote):
        self.existing = existing
        self.new = new
        super().__init__("conflicting votes from validator")


@dataclass
class _BlockVotes:
    """Votes for one particular block (vote_set.go blockVotes)."""

    peer_maj23: bool
    bit_array: BitArray
    votes: List[Optional[Vote]]
    sum: int = 0


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int,
                 signed_msg_type: int, valset: ValidatorSet,
                 ext_enabled: bool = False, device=None):
        if height == 0:
            raise VoteSetError("cannot make VoteSet for height == 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.valset = valset
        # vote extensions REQUIRED on non-nil precommits when enabled,
        # forbidden otherwise (params.go VoteExtensionsEnableHeight)
        self.ext_enabled = ext_enabled
        # where a vote verifies when no plane runs: None is the serial
        # host path, a device is verify_batch_direct on it
        self.device = device
        self._lock = threading.RLock()
        n = len(valset)
        self.votes_bit_array = BitArray(n)
        self.votes: List[Optional[Vote]] = [None] * n
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: Dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: Dict[str, BlockID] = {}
        # verify-plane integration: None = follow the global plane; a
        # VerifyPlane instance pins one (tests). Per-block quorum groups
        # carry this set's fused voting-power tally on the plane.
        self.verify_plane = None
        self._plane_groups: Dict[bytes, object] = {}
        self._valset_cols = None  # (pubs tuple, powers tuple), lazy
        # flush-seq observer: called with the verify-plane flush-ledger
        # seq that served an admitted vote (the consensus height
        # ledger's /dump_flushes join key); None = nobody listening
        self.on_flush = None

    def size(self) -> int:
        return len(self.valset)

    # -- adding votes --------------------------------------------------------

    def add_vote(self, vote: Optional[Vote], verify: bool = True) -> bool:
        """AddVote (vote_set.go:157). Returns True if added. Raises
        ConflictingVoteError on equivocation, VoteSetError/VoteError on
        invalid votes.

        With a running verify plane, signature verification leaves the
        lock: the vote (and its extension signature, as ONE submission)
        coalesces with other callers into a shared device pass, and the
        block's power tally is fused into that same pass; admission is
        re-checked under the lock afterwards."""
        if vote is None:
            raise VoteSetError("nil vote")
        plane = self._plane() if verify else None
        if plane is not None:
            return self._add_vote_plane(vote, plane)
        with self._lock:
            return self._add_vote(vote, verify)

    def _precheck(self, vote: Vote):
        """Structural checks preceding verification (vote_set.go:
        157-214). Returns the validator, or None for an exact
        duplicate. Caller holds the lock."""
        val_index = vote.validator_index
        if val_index < 0:
            raise VoteSetError("index < 0")
        if not vote.signature:
            raise VoteSetError("empty signature")
        if (vote.height != self.height or vote.round != self.round
                or vote.vote_type != self.signed_msg_type):
            raise VoteSetError(
                f"expected {self.height}/{self.round}/"
                f"{self.signed_msg_type}, got {vote.height}/"
                f"{vote.round}/{vote.vote_type}"
            )
        val = self.valset.get_by_index(val_index)
        if val is None:
            raise VoteSetError(f"no validator at index {val_index}")
        if vote.validator_address != val.address:
            raise VoteSetError("validator address/index mismatch")
        existing = self.votes[val_index]
        if existing is not None and existing.block_id == vote.block_id:
            return None  # duplicate
        return val

    def _ext_discipline(self, vote: Vote):
        """(need_ext_verify, deferred_error): extension rules
        (vote_set.go:216-231). The error string is raised only after
        the vote signature itself verifies, preserving the serial
        path's error precedence."""
        is_commit_precommit = (
            self.signed_msg_type == 2 and not vote.block_id.is_nil()
        )
        if self.ext_enabled and is_commit_precommit:
            if not vote.extension_signature:
                return False, "vote extension signature is missing"
            return True, None
        if vote.extension or vote.extension_signature:
            return False, "unexpected vote extension"
        return False, None

    def _add_vote(self, vote: Vote, verify: bool) -> bool:
        val = self._precheck(vote)
        if val is None:
            return False  # duplicate

        need_ext, ext_err = self._ext_discipline(vote)
        if verify and self.device is not None:
            self._verify_on_device(vote, val, need_ext)
        elif verify:
            if need_ext:
                # one host pass over vote + extension signatures — the
                # serial-path mirror of the plane's single submission
                try:
                    vote.verify_with_extension(self.chain_id, val.pub_key)
                except VoteError as e:
                    kind = ("invalid vote extension"
                            if "extension" in str(e) else "invalid vote")
                    raise VoteSetError(f"{kind}: {e}") from e
            else:
                try:
                    vote.verify(self.chain_id, val.pub_key)
                except VoteError as e:
                    raise VoteSetError(f"invalid vote: {e}") from e
        if ext_err is not None:
            raise VoteSetError(ext_err)

        return self._add_verified(vote, val.voting_power)

    def _verify_on_device(self, vote: Vote, val, need_ext: bool) -> None:
        """The vote's signature (and its extension's) in one
        verify_batch_direct call on this set's device, with the serial
        path's errors; a DeviceError propagates."""
        from cometbft_tpu_torch.crypto import batch as cbatch

        pubs = [val.pub_key]
        msgs = [vote.sign_bytes(self.chain_id)]
        sigs = [vote.signature]
        if need_ext:
            pubs.append(val.pub_key)
            msgs.append(vote.extension_sign_bytes(self.chain_id))
            sigs.append(vote.extension_signature)
        ok = cbatch.verify_batch_direct(pubs, msgs, sigs,
                                        device=self.device)
        if not ok[0]:
            raise VoteSetError("invalid vote: invalid signature")
        if need_ext and not ok[1]:
            raise VoteSetError(
                "invalid vote extension: invalid vote extension signature")

    # -- verify-plane path ---------------------------------------------------

    def _plane(self):
        """The verify plane to use, or None for the serial host path."""
        p = self.verify_plane
        if p is not None:
            return p if p.is_running() and not p.in_dispatcher() else None
        from cometbft_tpu_torch.verifyplane import global_plane

        return global_plane()

    def _valset_columns(self):
        if self._valset_cols is None:
            self._valset_cols = (
                tuple(v.pub_key.data for v in self.valset.validators),
                tuple(v.voting_power for v in self.valset.validators),
            )
        return self._valset_cols

    def _plane_group(self, block_id: BlockID):
        """The fused-tally quorum group for one candidate block. Caller
        holds the lock."""
        key = block_id.key()
        g = self._plane_groups.get(key)
        if g is None:
            from cometbft_tpu_torch.verifyplane import QuorumGroup

            pubs, powers = self._valset_columns()
            g = QuorumGroup(
                self.valset.total_voting_power() * 2 // 3 + 1,
                name=f"h{self.height}/r{self.round}"
                     f"/t{self.signed_msg_type}",
                valset_pubs=pubs, valset_powers=powers,
            )
            self._plane_groups[key] = g
        return g

    def _add_vote_plane(self, vote: Vote, plane) -> bool:
        from cometbft_tpu_torch.verifyplane import PlaneError

        with self._lock:
            val = self._precheck(vote)
            if val is None:
                return False
            need_ext, ext_err = self._ext_discipline(vote)
            group = self._plane_group(vote.block_id)
            # counted = this vote would add power to its block's tally
            # if valid and still admissible (existing None, or
            # peer-maj23-unlocked equivocation with a free slot); a
            # discipline violation rejects the vote regardless
            existing = self.votes[vote.validator_index]
            bv = self.votes_by_block.get(vote.block_id.key())
            counted = ext_err is None and (
                existing is None
                or (bv is not None and bv.peer_maj23
                    and bv.votes[vote.validator_index] is None)
            )

        # signature staging + the wait happen OUTSIDE the lock: that is
        # what lets concurrent gossip callers coalesce into one flush
        rows = [(val.pub_key, vote.sign_bytes(self.chain_id),
                 vote.signature)]
        vidx = [vote.validator_index]
        # device-stamp metadata: the vote row differs from its commit
        # siblings only in timestamp, so the plane can ship the
        # (template, secs, nanos) delta and stamp sign-bytes on device;
        # extension rows have no vote template and stay host-packed
        from cometbft_tpu_torch.types.vote import sign_bytes_template
        tmpl = sign_bytes_template(
            self.chain_id, vote.vote_type, vote.height, vote.round,
            None if vote.block_id.is_nil() else vote.block_id)
        stamp = [(tmpl, vote.timestamp.seconds, vote.timestamp.nanos)]
        # best-effort template prefetch: the rest of this height's
        # votes cite the same site, so the warmer can stage the device
        # template off the hot path (a no-op once cached; it marks
        # only what it built)
        from cometbft_tpu_torch.verifyplane import warmer as vwarmer
        w = vwarmer.global_warmer()
        if w is not None:
            w.request_template((tmpl.stamp_site(),))
        if need_ext:
            rows.append((val.pub_key,
                         vote.extension_sign_bytes(self.chain_id),
                         vote.extension_signature))
            vidx.append(vote.validator_index)
            stamp.append(None)
        try:
            fut = plane.submit_many(rows, power=val.voting_power,
                                    group=group, counted=counted,
                                    vidx=vidx, chain_id=self.chain_id,
                                    stamp=stamp)
            verdicts = fut.result()
        except PlaneError:
            if plane.device is None:
                # a host plane stopped/saturated mid-call: the serial
                # host path, as upstream
                with self._lock:
                    return self._add_vote(vote, True)
            # a device plane that could not take the vote verifies it
            # on its own device, outside the fused tally (admission
            # adds the power to the group); a DeviceError propagates
            from cometbft_tpu_torch.crypto import batch as cbatch

            verdicts = tuple(bool(v) for v in cbatch.verify_batch_direct(
                *zip(*rows), device=plane.device))
            fut, counted = None, False
        if (self.on_flush is not None and fut is not None
                and fut.flush_seq is not None):
            # report which flush served this vote (valid or not — the
            # plane paid for it either way) for per-height attribution
            try:
                self.on_flush(fut.flush_seq)
            except Exception:  # noqa: BLE001 - observer must not veto
                pass

        if not verdicts[0]:
            raise VoteSetError("invalid vote: invalid signature")
        if ext_err is not None:
            if counted:  # unreachable (counted excludes ext_err) — guard
                group.retract(val.voting_power)
            raise VoteSetError(ext_err)
        if need_ext and not verdicts[1]:
            # vote power must not stand once the extension is rejected;
            # the plane's all-rows gate (or the fused path's post-
            # correction) already kept it out of the tally
            raise VoteSetError(
                "invalid vote extension: invalid vote extension signature"
            )

        with self._lock:
            return self._admit_verified(vote, val.voting_power, group,
                                        counted)

    def _admit_verified(self, vote: Vote, power: int, group,
                        plane_counted: bool) -> bool:
        """Post-plane admission: _add_verified minus re-verification,
        plus reconciliation of the plane's fused tally against what was
        actually admitted (the state may have moved while the signature
        was in flight). Caller holds the lock."""
        val_index = vote.validator_index
        key = vote.block_id.key()
        existing = self.votes[val_index]
        admitted_to_block = False
        if existing is not None:
            if existing.block_id == vote.block_id:
                # duplicate raced in while we verified
                if plane_counted and group is not None:
                    group.retract(power)
                return False
            bv = self.votes_by_block.get(key)
            if bv is None or not bv.peer_maj23:
                if plane_counted and group is not None:
                    group.retract(power)
                raise ConflictingVoteError(existing, vote)
            self.votes[val_index] = vote
        else:
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += power

        bv = self.votes_by_block.get(key)
        if bv is None:
            bv = _BlockVotes(
                peer_maj23=False,
                bit_array=BitArray(self.size()),
                votes=[None] * self.size(),
            )
            self.votes_by_block[key] = bv
        elif existing is not None and bv.votes[val_index] is not None:
            if plane_counted and group is not None:
                group.retract(power)
            return False  # already counted in this block's tally
        bv.votes[val_index] = vote
        bv.bit_array.set_index(val_index, True)
        old_sum = bv.sum
        bv.sum += power
        admitted_to_block = True

        if group is not None and not plane_counted and admitted_to_block:
            # the plane didn't tally this one (precheck said it wouldn't
            # count) but admission did — bring the fused tally back in
            # sync with bv.sum
            group.add(power)

        # quorum: the plane's fused tally fires the group event inside
        # the flush; maj23 itself flips on the exact same crossing
        # (vote_set.go:307-325), kept bit-identical with the serial path
        quorum = self.valset.total_voting_power() * 2 // 3 + 1
        if old_sum < quorum <= bv.sum and self.maj23 is None:
            self.maj23 = vote.block_id
        return True

    def _add_verified(self, vote: Vote, power: int) -> bool:
        """addVerifiedVote (vote_set.go:257-328)."""
        val_index = vote.validator_index
        key = vote.block_id.key()
        existing = self.votes[val_index]
        if existing is not None:
            if existing.block_id == vote.block_id:
                return False
            # equivocation: keep the first vote unless the new one is for
            # a block with a peer-claimed maj23 (vote_set.go:281-302)
            bv = self.votes_by_block.get(key)
            if bv is None or not bv.peer_maj23:
                raise ConflictingVoteError(existing, vote)
            self.votes[val_index] = vote
        else:
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += power

        bv = self.votes_by_block.get(key)
        if bv is None:
            bv = _BlockVotes(
                peer_maj23=False,
                bit_array=BitArray(self.size()),
                votes=[None] * self.size(),
            )
            self.votes_by_block[key] = bv
        elif existing is not None and bv.votes[val_index] is not None:
            return False  # already counted in this block's tally
        bv.votes[val_index] = vote
        bv.bit_array.set_index(val_index, True)
        old_sum = bv.sum
        bv.sum += power

        # quorum detection (vote_set.go:307-325)
        quorum = self.valset.total_voting_power() * 2 // 3 + 1
        if old_sum < quorum <= bv.sum and self.maj23 is None:
            self.maj23 = vote.block_id
        return True

    # -- queries -------------------------------------------------------------

    def get_vote(self, val_index: int, block_key: bytes) -> Optional[Vote]:
        with self._lock:
            v = self.votes[val_index]
            if v is not None and v.block_id.key() == block_key:
                return v
            bv = self.votes_by_block.get(block_key)
            return bv.votes[val_index] if bv else None

    def get_by_index(self, val_index: int) -> Optional[Vote]:
        with self._lock:
            return self.votes[val_index]

    def two_thirds_majority(self) -> Optional[BlockID]:
        with self._lock:
            return self.maj23

    def has_two_thirds_majority(self) -> bool:
        with self._lock:
            return self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        with self._lock:
            return self.sum > self.valset.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        with self._lock:
            return self.sum == self.valset.total_voting_power()

    def bit_array(self) -> BitArray:
        with self._lock:
            return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[BitArray]:
        with self._lock:
            bv = self.votes_by_block.get(block_id.key())
            return bv.bit_array.copy() if bv else None

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """SetPeerMaj23 (vote_set.go:335): a peer claims 2/3 for a block;
        unlocks conflicting-vote acceptance for that block."""
        with self._lock:
            prev = self.peer_maj23s.get(peer_id)
            if prev is not None:
                if prev == block_id:
                    return
                raise VoteSetError("conflicting maj23 claim from peer")
            self.peer_maj23s[peer_id] = block_id
            key = block_id.key()
            bv = self.votes_by_block.get(key)
            if bv is None:
                bv = _BlockVotes(
                    peer_maj23=True,
                    bit_array=BitArray(self.size()),
                    votes=[None] * self.size(),
                )
                self.votes_by_block[key] = bv
            else:
                bv.peer_maj23 = True

    # -- commit construction -------------------------------------------------

    def make_commit(self) -> Commit:
        """MakeExtendedCommit sans extensions (vote_set.go:636): requires
        an established 2/3 majority on a non-nil block."""
        with self._lock:
            if self.signed_msg_type != 2:  # PRECOMMIT_TYPE
                raise VoteSetError("cannot MakeCommit() unless precommits")
            if self.maj23 is None or self.maj23.is_nil():
                raise VoteSetError(
                    "cannot MakeCommit() unless +2/3 committed a block"
                )
            sigs = []
            for i, v in enumerate(self.votes):
                if v is None:
                    sigs.append(CommitSig.absent())
                    continue
                if v.block_id == self.maj23:
                    flag = BLOCK_ID_FLAG_COMMIT
                elif v.block_id.is_nil():
                    flag = BLOCK_ID_FLAG_NIL
                else:
                    flag = BLOCK_ID_FLAG_NIL  # vote for other block
                sigs.append(CommitSig(
                    flag, v.validator_address, v.timestamp, v.signature,
                ))
            return Commit(self.height, self.round, self.maj23, sigs)

    def make_extended_commit(self) -> "ExtendedCommit":
        """MakeExtendedCommit (vote_set.go:636): the commit WITH each
        precommit's vote extension, for PrepareProposal hand-off."""
        from cometbft_tpu_torch.types.commit import (
            ExtendedCommit,
            ExtendedCommitSig,
        )

        commit = self.make_commit()
        with self._lock:
            esigs = []
            for cs, v in zip(commit.signatures, self.votes):
                if v is None or not cs.is_commit():
                    esigs.append(ExtendedCommitSig(cs))
                else:
                    esigs.append(ExtendedCommitSig(
                        cs, v.extension, v.extension_signature
                    ))
            return ExtendedCommit(
                commit.height, commit.round, commit.block_id, esigs
            )
