"""Commit verification: the VerifyCommit family over the device verifier.

Reference: types/validation.go — VerifyCommit (:26), VerifyCommitLight
(:60), VerifyCommitLightTrusting (:95), shouldBatchVerify gate (:13-17),
verifyCommitBatch (:153-257) with per-sig blame (:243-250),
verifyCommitSingle (:266-333). Counterpart of the JAX package's
types/validation.py; the outcome (exception type and blamed index) is the
same for the same commit.

The whole commit is packed once (vectorized host staging) and verified in
one device pass; the reference's early 2/3 break becomes "don't collect
what you don't need" — the collection loop stops at the threshold, the
device verifies every collected signature.

A batch-verified call's stages are timed, always: the collection loop
and the sign-bytes, each a span (`validation.collect`,
`validation.sign_bytes`, libs/tracing.py), and the call's batch_fn, into
one record a call in the bounded ring `call_stats()`.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np

from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.types.commit import Commit
from cometbft_tpu_torch.types.validator import ValidatorSet


class VerificationError(Exception):
    pass


class InvalidSignatureError(VerificationError):
    def __init__(self, idx: int, msg: str = ""):
        self.idx = idx
        super().__init__(msg or f"wrong signature (#{idx})")


class NotEnoughPowerError(VerificationError):
    def __init__(self, got: int, needed: int):
        self.got = got
        self.needed = needed
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, "
            f"needed more than {needed}"
        )


# Batch path gate (types/validation.go:13-17): >=2 sigs and a batch-capable
# key type. The device adds its own economics: below this many signatures
# the H2D+dispatch overhead exceeds the pure-Python single verify cost.
BATCH_VERIFY_THRESHOLD = 2


def _should_batch_verify(commit: Commit) -> bool:
    return len(commit.signatures) >= BATCH_VERIFY_THRESHOLD


# One record a batch-verified call, newest last: {"rows": signatures
# collected, and the milliseconds of "collect" (the collection loop),
# "sign_bytes" and "batch" (the batch_fn call)}. A reader (a benchmark
# metric, an operator's tool) keeps the records of its own calls, whose
# identity it knows.
_CALLS: deque = deque(maxlen=4096)


def call_stats() -> deque:
    """The bounded ring of the batch-verified calls' records."""
    return _CALLS


# Template packing: batch verification builds its sign-bytes via
# Commit.sign_bytes_rows (vectorized template patching) instead of the
# per-vote encode loop. The toggle exists for the differential path only
# (the simnet's determinism scenario): the bytes are identical either way.
_TEMPLATE_PACK = True


def set_template_packing(on: bool) -> bool:
    """Enable/disable the template-packing path; returns the previous
    setting."""
    global _TEMPLATE_PACK
    prev = _TEMPLATE_PACK
    _TEMPLATE_PACK = bool(on)
    return prev


def template_packing_enabled() -> bool:
    return _TEMPLATE_PACK


def _commit_msgs(chain_id: str, commit: Commit, idxs) -> List[bytes]:
    """Sign-bytes for the collected signature indices: one vectorized
    template patch per commit, or the per-vote encode loop."""
    if _TEMPLATE_PACK:
        return commit.sign_bytes_rows(chain_id, idxs)
    return [commit.vote_sign_bytes(chain_id, i) for i in idxs]


def commit_packed_batch(chain_id: str, commit: Commit, keys, idxs=None,
                        pad_to: Optional[int] = None, native: bool = True):
    """A commit's signatures staged for the device verifier without
    building per-row sign-bytes in Python.

    keys[i] is validator i's 32-byte ed25519 key (valset order); idxs
    (default: every for-block signature with a key) selects the rows. The
    native host packer builds each row's sign-bytes from the commit's
    for-block and for-nil templates (Commit.sign_bytes_template) and the
    row's timestamp (native.ed25519_pack_commits). Rows of bad lengths,
    and every row with native=False, go through pack_batch over
    Commit.sign_bytes_rows. The JAX package's commit_packed_batch gives
    the same bytes.

    Returns (PackedBatch, idxs): row k of the batch is commit signature
    idxs[k]."""
    from cometbft_tpu_torch import native as _native
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    css = commit.signatures
    if idxs is None:
        idxs = [i for i, cs in enumerate(css)
                if cs.for_block() and i < len(keys)]
    pubs = [keys[i] for i in idxs]
    sigs = [css[i].signature for i in idxs]
    n = len(idxs)
    padded = pad_to if pad_to is not None else ek.bucket_size(max(n, 1))
    if (native and n and all(len(p) == 32 for p in pubs)
            and all(len(s) == 64 for s in sigs)):
        tmpl_b, tmpl_n = commit.sign_bytes_template(chain_id)
        packed = _native.ed25519_pack_commits(
            b"".join(pubs), b"".join(sigs),
            [tmpl_b.template, tmpl_n.template],
            np.fromiter((not css[i].is_commit() for i in idxs), np.int32, n),
            np.fromiter((css[i].timestamp.seconds for i in idxs), np.int64,
                        n),
            np.fromiter((css[i].timestamp.nanos for i in idxs), np.int64, n),
            padded)
        return ek.PackedBatch(n, padded, *packed), idxs
    return ek.pack_batch(pubs, _commit_msgs(chain_id, commit, idxs), sigs,
                         pad_to=padded, native=native), idxs


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id,
    height: int,
    commit: Commit,
    batch_fn: Optional[Callable] = None,
) -> None:
    """Full verification (types/validation.go:26): 2/3+ of the total power
    of `vals` must have signed block_id; all signatures are checked."""
    _verify_basic(vals, block_id, height, commit)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    _verify(
        chain_id, vals, commit, voting_power_needed,
        ignore_sig=lambda cs: cs.is_absent(),
        count_sig=lambda cs: cs.for_block(),
        count_all=True,
        lookup_by_address=False,
        batch_fn=batch_fn,
    )


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id,
    height: int,
    commit: Commit,
    batch_fn: Optional[Callable] = None,
) -> None:
    """Light verification (types/validation.go:60): stop at 2/3+, only
    commit-flag signatures checked."""
    _verify_basic(vals, block_id, height, commit)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    _verify(
        chain_id, vals, commit, voting_power_needed,
        ignore_sig=lambda cs: not cs.for_block(),
        count_sig=lambda cs: cs.for_block(),
        count_all=False,
        lookup_by_address=False,
        batch_fn=batch_fn,
    )


def verify_commit_light_trusting(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level=(1, 3),
    batch_fn: Optional[Callable] = None,
) -> None:
    """Trusting verification (types/validation.go:95): trust_level (default
    1/3) of the OLD validator set must have signed; validators are looked
    up by address (indices differ between sets)."""
    if commit is None:
        raise VerificationError("nil commit")
    num, denom = trust_level
    if denom == 0:
        # reference panics on zero denominator before any math
        # (validation.go:101-103); no further range check is applied here
        # (the light client validates [1/3, 1] separately)
        raise VerificationError("trustLevel has zero Denominator")
    total = vals.total_voting_power()
    voting_power_needed = total * num // denom
    _verify(
        chain_id, vals, commit, voting_power_needed,
        ignore_sig=lambda cs: not cs.for_block(),
        count_sig=lambda cs: cs.for_block(),
        count_all=False,
        lookup_by_address=True,
        batch_fn=batch_fn,
    )


def _verify_basic(vals, block_id, height, commit) -> None:
    """Shared header checks (types/validation.go verifyBasicValsAndCommit)."""
    if vals is None or vals.is_nil_or_empty():
        raise VerificationError("nil or empty validator set")
    if commit is None:
        raise VerificationError("nil commit")
    if len(vals) != len(commit.signatures):
        raise VerificationError(
            f"invalid commit -- wrong set size: {len(vals)} vs "
            f"{len(commit.signatures)}"
        )
    if height != commit.height:
        raise VerificationError(
            f"invalid commit -- wrong height: {height} vs {commit.height}"
        )
    if block_id != commit.block_id:
        raise VerificationError(
            f"invalid commit -- wrong block ID: want {block_id}, "
            f"got {commit.block_id}"
        )


def _verify(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable,
    count_sig: Callable,
    count_all: bool,
    lookup_by_address: bool,
    batch_fn: Optional[Callable],
) -> None:
    if _should_batch_verify(commit) and batch_fn is not None:
        _verify_batch(
            chain_id, vals, commit, voting_power_needed,
            ignore_sig, count_sig, count_all, lookup_by_address, batch_fn,
        )
    else:
        _verify_single(
            chain_id, vals, commit, voting_power_needed,
            ignore_sig, count_sig, count_all, lookup_by_address,
        )


def _row(chain_id, vals, commit, idx, cs, lookup_by_address):
    """Resolve (pubkey, power) for a commit sig, or None to skip.

    By-index for same-set verification, by-address for trusting mode
    (types/validation.go:176-199)."""
    if lookup_by_address:
        vi, val = vals.get_by_address(cs.validator_address)
        if val is None:
            return None
        return val.pub_key, val.voting_power
    val = vals.get_by_index(idx)
    if val is None:
        return None
    return val.pub_key, val.voting_power


def _verify_batch(
    chain_id, vals, commit, voting_power_needed,
    ignore_sig, count_sig, count_all, lookup_by_address, batch_fn,
) -> None:
    """Device path: one fused pack+verify+tally pass, blame on failure
    (types/validation.go:153-257).

    Outcome-equivalence with the reference's collection loop:
    - signatures are collected in commit order; with count_all=False the
      collection STOPS once the optimistic tally crosses the threshold
      (validation.go:223-225 early break) — later signatures, valid or
      not, are never examined;
    - the power threshold is checked on the optimistic tally BEFORE any
      cryptographic verification (validation.go:230-233);
    - on batch failure the reference re-verifies one-by-one for blame
      (:243-250); the device returns per-signature validity, so blame is
      the first invalid collected index, which is exactly where the
      single-verify fallback would stop.
    """
    pubs: List = []  # crypto.keys.PubKey — batch_fn groups by key_type
    sigs: List[bytes] = []
    idxs: List[int] = []
    tallied = 0
    seen = set()
    rec = {"rows": 0, "collect": 0.0, "sign_bytes": 0.0, "batch": 0.0}
    _CALLS.append(rec)
    t0 = time.perf_counter()
    with tracing.span("validation.collect", "validation"):
        for idx, cs in enumerate(commit.signatures):
            if ignore_sig(cs):
                continue
            resolved = _row(chain_id, vals, commit, idx, cs,
                            lookup_by_address)
            if resolved is None:
                continue
            if lookup_by_address:
                # duplicate check only for resolved validators
                # (validation.go:188-198: skip-unknown precedes seenVals)
                if cs.validator_address in seen:
                    raise VerificationError(
                        f"double vote from {cs.validator_address.hex()}"
                    )
                seen.add(cs.validator_address)
            pub_key, power = resolved
            pubs.append(pub_key)
            sigs.append(cs.signature)
            idxs.append(idx)
            if count_sig(cs):
                tallied += power
                if not count_all and tallied > voting_power_needed:
                    break
    t1 = time.perf_counter()
    rec["rows"] = len(pubs)
    rec["collect"] = (t1 - t0) * 1e3

    if tallied <= voting_power_needed:
        raise NotEnoughPowerError(tallied, voting_power_needed)

    # sign-bytes built AFTER collection: one vectorized template patch
    # over the collected rows
    with tracing.span("validation.sign_bytes", "validation"):
        msgs = _commit_msgs(chain_id, commit, idxs)
    t2 = time.perf_counter()
    rec["sign_bytes"] = (t2 - t1) * 1e3
    valid = np.asarray(batch_fn(pubs, msgs, sigs))[: len(pubs)]
    rec["batch"] = (time.perf_counter() - t2) * 1e3
    if not valid.all():
        bad = int(np.flatnonzero(~valid)[0])
        raise InvalidSignatureError(idxs[bad])


def _verify_single(
    chain_id, vals, commit, voting_power_needed,
    ignore_sig, count_sig, count_all, lookup_by_address,
) -> None:
    """CPU fallback loop (types/validation.go:266-333). By-index lookups
    trust the index↔validator correspondence without an address compare,
    exactly like the reference (verifyCommitSingle lookUpByIndex arm)."""
    tallied = 0
    seen = set()
    for idx, cs in enumerate(commit.signatures):
        if ignore_sig(cs):
            continue
        resolved = _row(chain_id, vals, commit, idx, cs, lookup_by_address)
        if resolved is None:
            continue
        if lookup_by_address:
            if cs.validator_address in seen:
                raise VerificationError(
                    f"double vote from {cs.validator_address.hex()}"
                )
            seen.add(cs.validator_address)
        pub_key, power = resolved
        if not pub_key.verify_signature(
            commit.vote_sign_bytes(chain_id, idx), cs.signature
        ):
            raise InvalidSignatureError(idx)
        if count_sig(cs):
            tallied += power
            if not count_all and tallied > voting_power_needed:
                return
    if tallied <= voting_power_needed:
        raise NotEnoughPowerError(tallied, voting_power_needed)


# --------------------------------------------------------------------------
# Device batch_fn factories
# --------------------------------------------------------------------------


def device_batch_fn(device=None, cached: bool = False) -> Callable:
    """Build a batch_fn backed by the CUDA verify kernels.

    Returns fn(pubs: [PubKey], msgs, sigs) -> (n,) bool validity, with rows
    grouped by key type under the device circuit breaker (crypto/batch.py):
    ed25519 rows on the ed25519 kernel, sr25519 rows on the sr25519
    kernel, secp256k1 rows on the ECDSA kernel, so a mixed commit costs one
    launch per key type present. `device` defaults to the CUDA card (device.default_device, resolved
    here so a missing card fails at construction); pass "cpu" for the plain
    PyTorch versions. With `cached=True`, ed25519 groups of at least 128
    rows go to the cached-valset kernel (ed25519_cached.verify_batch_cached),
    whose window table is keyed on the exact pubkey list: callers must
    present a stable list (the whole valset in order, as verify_commit
    does) or every call pays a table build. The voting-power tally stays
    host-side here because the collection loop's early break is
    sequential; the fused device tally serves whole-commit streams
    (blocksync.pipeline.StreamVerifier).
    """
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.device import resolve

    dev = resolve(device)

    def fn(pubs, msgs, sigs):
        return cbatch.verify_batch(pubs, msgs, sigs, device=dev,
                                   cached=cached)

    return fn


def oracle_batch_fn() -> Callable:
    """Pure-Python batch_fn (no device): the host reference path
    (PubKey.verify_signature), one row at a time. It is the differential
    tests' oracle and `[crypto] verifier = "cpu"`'s batch_fn: the JAX
    package spells that choice None, which the port's executor reads as
    the card. `on_host` marks it for the node, whose votes then take the
    VoteSet's serial path."""

    def fn(pubs, msgs, sigs):
        return np.asarray(
            [p.verify_signature(m, s) for p, m, s in zip(pubs, msgs, sigs)]
        )

    fn.on_host = True
    return fn
