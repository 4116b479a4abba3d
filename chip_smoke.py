#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cometbft_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result line):
  1. card and build: the card's name and power limit, capability 9.0, and
     the nvcc build of every kernel from csrc/ (seconds printed, and each
     kernel's ptxas registers, stack and spills, labelled by source), then
     the host C++ build of the native host packer, csrc/hostaccel.cpp
     (`native_build_s`);
  2. each kernel against its plain PyTorch version on the card, exactly:
     ed25519_verify on 256 columns (valid, flipped bit, tampered message,
     S >= L, garbage, ZIP-215 edge cases; both must equal the ed25519_ref
     oracle) and tally_quorum on 8 commits with random masks, large powers
     and one commit that misses quorum by exactly 1, then on every case of
     edge_cases.TALLY_CASES (up to 2^17 columns, one commit above the
     kernel's shared-memory cap);
  3. the main path at full size: a 10,000-validator ValidatorSet and one
     signed commit through verify_commit_light (6,667 signatures) and
     verify_commit (10,000), both padded to 16,384 columns, with
     device_batch_fn(); a tampered signature 4,321 must be blamed; prints
     the VerifyCommitLight p50 and verify_commit sigs/s, and both calls'
     host pack p50 (the native pack) beside the plain pack's time (numpy,
     once), whose rows must equal the native pack's at 6,667 and 10,000
     rows; then
     ed25519_verify at both calls' shapes (10,000 and 6,667 live of
     16,384 columns) against its plain version, timed by device time;
  4. the fused verify + tally step on a blocksync-shaped chunk: 16 commits
     x 1,000 validators through verify_tally_rows, one commit short of
     quorum; tallies must equal the host integer sums exactly; then
     ed25519_verify at the chunk's shape against its plain version, in
     device time (a profiler trace), and tally_quorum at it, per call
     (CUDA events) and in device time, beside index_add_ on the same
     inputs;
  5. the cached-path kernels against their plain versions on the card,
     exactly: valset_table_build at M = 128 (bad and edge keys included;
     the wrapper and each of its entries),
     ed25519_verify_cached on 256 columns (also against the oracle),
     stamp_rows over every fuzzed timestamp width with two templates and
     over every case of edge_cases.STAMP_CASES (chain ids of 0-80 bytes
     under both block-id forms, rows of 1-3 SHA-512 blocks, keys that wrap,
     dead lanes, two threshold rows, clamped template indices), each also
     against pack_rows_cached of a host pack, and tally_quorum_cached on 8
     commits and on every case of edge_cases.TALLY_CASES;
  6. blocksync at BASELINE config 4's width: make_stream_verifier() over 80
     heights of a 1,000-validator set (64 under V0, 16 under V1 = V0 with 8
     rotated keys), one tampered signature and one commit short of quorum;
     outcomes must match the oracle, every chunk must be device-stamped
     (no host pack runs), launch counts exact; then stamp_rows at both of
     its launches (65,536 and 16,384 columns) against its plain version
     and the native commit pack (the pipeline's host pack),
     timed in device time; each cached kernel at the stream's shapes
     (B = 65,536 columns, M = 1,024) against its plain version, the tally
     also with 513 commits (above its shared-memory cap) and timed in
     device time beside index_add_; then both entries of
     ed25519_verify_cached (the one-thread kernel first, then the quad) on
     the chunk's first 8,192 / 10,240 / 16,384 / 32,768 / 65,536 columns,
     each against plain and timed in device time; valset_table_build at
     the stream's M = 1,024 and at update_table's 128-slot delta (the 8
     rotated keys), the wrapper and each entry against plain, timed in
     device time, and update_table's columns equal to the delta's plain
     build;
  7. verify_commit on phase 3's 10k commit with device_batch_fn(cached=True):
     a cold table build, then warm calls; tampered signature 4,321 blamed;
     the path's host pack p50 (native) and the plain pack's time, the two
     packs' rows equal to each other and to the rows the path verified;
     then ed25519_verify_cached on the rows that path verified (10,240
     columns, M = 16,384) and valset_table_build at M = 16,384 (the wrapper
     and each entry, also against the cached table) against their plain
     versions, both verify entries and both table entries timed at that
     shape, and both table entries also at the table's first 2,048 and
     4,096 slots (TABLE_CROSS_SWEEP), against the plain table's prefix;
  8. sr25519_verify and ecdsa_verify against their plain versions on the
     card, exactly, 256 columns each over every edge case (edge_cases.py);
     both sides must also equal the sr25519_ref / secp256k1_ref oracles;
  9. BASELINE config 3 at full width: a 10,000-validator set, 5,000 ed25519
     and 5,000 sr25519, one signed commit through verify_commit_light and
     verify_commit with device_batch_fn() (two groups, two launches a call;
     a tampered sr25519 signature must be blamed), each group's host pack
     p50 (native) beside its plain pack's time, the two packs' rows equal
     for the 5,000 ed25519 and the 5,000 sr25519 rows; then the fused
     form, each group through its verify_tally_rows, tallies summed to the
     total power exactly and each group's (tally, quorum) equal to
     tally_quorum_plain on the same verdicts and rows; then ed25519_verify
     and sr25519_verify on the rows the light and full calls launched them
     on (4,096 and 16,384 columns, clean and tampered) against plain, and
     sr25519_verify's device time at both shapes (the light and the full
     call's live counts);
 10. BASELINE config 5's verification core at full width: a 10,000-validator
     secp256k1 set, one signed commit through verify_commit_light_trusting
     (1/3) and verify_commit_light, the two calls verify_non_adjacent makes;
     a tampered signature must be blamed; then ecdsa_verify on the rows both
     calls launched it on (4,096 and 16,384 columns, clean and tampered)
     against plain, and its device time at both shapes (the trusting and
     the light call's live counts);
 11. the verify plane: phase 3's commit (tampered signature 4,321) as
     10,000 gossiped precommits, each a counted submission with its
     validator index and device stamp (template, secs, nanos) as VoteSet
     makes it, from 8 threads into a started VerifyPlane on the card with
     the config's defaults (window 1.5 ms, max_batch 1,024), in a
     QuorumGroup backed by the valset (2/3 + 1 of the power); 5 runs (the
     first with a cold table): quorum fires, the tally equals the host
     sum exactly, 4,321 is False, every flush is fused and device-stamped,
     the first flush cold and the rest warm, no breaker fault, and one
     stamp_rows, ed25519_verify_cached and tally_quorum_cached a flush
     with one valset_table_build; one more run under the profiler (the
     card's busy share); then the host-packed branch
     (set_device_stamping(False)) and two flights (pipeline_flights=2),
     each equal to the clean runs, and an in-flight fault on 1,024 of the
     precommits (the `verifyplane.collect` failpoint, once): that flush
     lands on device_fault, its futures fail with DeviceError (no host
     fallback on the card) and its breaker counts one fault, the other
     flushes give the oracle's verdicts, and the failed precommits
     resubmitted give theirs on fused flushes; then the flush's three
     kernels at its shape
     (16,384 columns, 1,024 live, M = 16,384) against their plain
     versions, timed by device time; prints flushes, rows a flush, the
     quorum latency p50 (host clock) and the ledger's per-flush comp_ms,
     h2d_ms and dev_ms medians with the card's name and power limit.
 12. VoteSet and the table warmer (the north star's `VoteSet.AddVote`
     entry, config 3's width): phase 3's commit as 10,000 precommit Votes
     (Commit.get_vote; 4,321 tampered) added from 8 threads to a port
     VoteSet, with a card VerifyPlane mounted as the global plane and a
     card TableWarmer as the global warmer; 3 VoteSets over epoch e (the
     first with a cold table): vote 4,321 raises the invalid-signature
     VoteSetError, every other vote is admitted, the majority is the
     commit's block from the fused tally, make_commit() is the commit
     without 4,321, the plane verified every vote (none took the serial
     path), every flush fused and device-stamped, launches exact; then
     the rotation to epoch e+1 (the last 100 validators' powers halved,
     keys and order kept): notify_next_valset warms its table (one
     incremental build), e+1's VoteSet over the same votes gives the same
     commit, its first flush is warm with one warmed hit and no table
     build; the flush's three kernels on the warmed table against plain;
     then the rotation to epoch e+2 (those 100 validators replaced by 100
     new keys at twice the power, so every slot moves): the warmer's full
     valset_table_build (counted from the notify to the warmer's idle,
     under its own path), e+2's VoteSet over the votes re-indexed and the
     new keys' signed votes gives the expected commit, its first flush
     warm with one warmed hit, and the flush kernels on that table against
     plain; then a host-plane VoteSet (use_device=False) over 1,024 of the
     votes (4,321 among them) gives each vote the card's outcome; prints
     the quorum p50, the first flush's dev_ms cold and warmed, the
     warmer's build ms for each rotation, the launches;
 13. the light client (config 5 as a whole): light_plan's chain of 8
     heights over 10,000 secp256k1 validators (era A signs 1-4, era B,
     which keeps just under 30 % of A's power, 5-8; each height signed
     when first fetched), a skipping light Client with batch_fn=None from
     trusted height 1 to 8 through a card VerifyPlane (its grouped path:
     ecdsa_verify): the heights stored and the verification count equal
     the 16-validator copy's under the oracle, a target commit with a
     tampered signature is refused with ErrInvalidHeader blaming it, one
     ecdsa_verify a flush, the kernel against plain on the rows the path
     launched it on; prints the verification's ms net of the signing and
     each flush's work ms;
 14. the catch-up engine (blocksync/catchup.py, config 4's width): 80 real
     Blocks over phase 6's 1,000 keys and powers (V0 for 1-64, V1 with 8
     rotated keys for 65-80, every commit fully signed), replayed from a
     cold table cache by a CatchupEngine with its default verifier (the
     card's StreamVerifier) and a card TableWarmer as the global warmer:
     two segments (1-64, 65-80), warm-ahead of V1 once, while height 63 is
     applied (the script waits for the warmer between the segments), the
     65-80 segment on the warmed table (one warmed hit, no table build);
     launches exact (stamp_rows, ed25519_verify_cached and
     tally_quorum_cached 2 each, valset_table_build 2: V0's cold build and
     the warmer's delta for V1); a kill at the catchup.read_ahead
     failpoint once 1-64 are applied and a resume from the persisted
     cursor that verifies only 65-80; a history with one tampered
     signature at height 20 raises CatchupError naming it; each captured
     chunk's three kernels against their plain versions; prints blocks/s
     and each segment's verify_ms and apply_ms;
 15. the light-client gateway and evidence (lightgate/, evidence/, config
     5's width): a LightGateway (its default batch_fn, the plane's GATEWAY
     lane) and an EvidencePool (batch_fn=None) over phase 13's chain and a
     card VerifyPlane; 64 clients asking verify(1, 8) at once cost one
     verification (the others coalesced or LRU hits) with phase 13's
     heights and verification count, one ecdsa_verify a flush on GATEWAY
     rows; the same 64 again are LRU hits with no flush; 8 clients on the
     era-B pair (6, 8), 4 handed a header that era B's 10,000 validators
     signed with another app hash: 4 verified, 4 divergent, one
     LightClientAttackEvidence in the pool, verified on the card (the
     named rows in one batch, then the trusting check); ecdsa_verify
     against plain on the rows the path launched it on; prints each
     wave's ms, the flushes and their rows;
 16. the application boundary and block execution (mempool/, abci/,
     state/execution.py, BASELINE config 2's width, config 1's kvstore):
     a port Mempool(KVStoreApplication(), verify_sigs=True) with an
     AdmissionController wired to the device breaker, a card VerifyPlane
     as the global plane and a card TableWarmer as the global warmer; 64
     threads send 5,000 CheckTx (4,000 valid sigtx envelopes of 1,000
     client keys, 500 with a flipped signature byte, 250 malformed, 250
     unsigned), a tx answered OVERLOADED sent again after its hint: every
     code is the one the tx was built for, 256 signed ones agree with
     ed25519_ref, the pool holds the OK txs, the BULK lane took every
     signed row on grouped flushes (one ed25519_verify each); then a
     BlockExecutor (batch_fn=None: the plane's CONSENSUS lane) over a
     StateStore and a BlockStore from a GenesisDoc of phase 6's 1,000
     validators proposes 8 blocks with create_proposal_block (the block
     size spreads the pool over them), each signed by its 1,000
     validators and applied with validate=True: each LastCommit after
     height 1 one grouped flush and one ed25519_verify, height 3's 16
     val: txs rotate 8 validators (the warmer's one valset_table_build,
     its table equal to plain; the new set signs from height 5); the
     pool ends empty, the app hash is its state's, the stores hold what
     was applied; then a tampered LastCommit refused (nothing changes), a
     dispatch fault answered by verify_batch_direct on the card, and a
     BULK lane of one row answering OVERLOADED with a hint; ed25519_verify
     against plain on the rows both paths launched it on and timed by
     device time at both shapes; prints CheckTx/s and each height's
     validate, apply, update and LastCommit flush ms.
 17. the verify path over a mesh (parallel/mesh.py) of 8 slots of the card
     (CBT_TORCH_DEVICE_SLOTS=8 for this phase only; each slot its own
     stream): sharded_verify_tally_rows on phase 3's 10k commit (16,384
     columns, 2,048 a slot), sharded_stream_verify on phase 6's
     16-commit chunk (2 commits a slot) and sharded_stamp_rows on the
     plane's deltas, each equal to the one-device launches bit for bit;
     carry_quorum against its plain version on partials whose limbs all
     carry; phase 11's 10,000 precommits through a card VerifyPlane with
     mesh_devices=0, mesh_min_rows=1, pipeline_flights=2 and
     half_mesh_rows=2,048: quorum, verdicts and tally as phase 11's, every
     flush `fused_sharded` over a half's clamp (3 slots of 4,096, dev0 0
     or 4), two flights airborne at once, launches exact; a burst of
     3,200 precommits in one flush drains the deck and takes the full
     mesh's clamp (0, 1, 2); a card TableWarmer warms phase 12's e+2
     valset for both halves, whose first flushes are warm; a dispatch
     fault fails its flush with DeviceError (`device_fault`); then one
     flush over a half under the profiler (each slot's kernels and the
     reduce) and carry_quorum's times beside torch.stack(...).sum(0).
     The slots share one card's SMs, so these are not eight cards' times.
Before the last line it prints the `kernels` JSON (launches on the main
paths, in all and by path; times; bounds; for every kernel `device_ms`, from
a profiler trace at its phase's shape, by live columns or by shape where a
phase runs it at two; for the two tallies also `library_device_ms`; for
ed25519_verify_cached and valset_table_build the entry the wrapper
launched at each shape and the sweep of every entry); the last line is
{"ok": true, "device": {...}}.

Launch counters are set to 0 just before each main-path run and read just
after; launches made to compare a kernel with its plain version are not
counted. The circuit breaker must record no fault.
"""
from __future__ import annotations

import argparse
import collections
import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import time

CHAIN_ID = "chip-smoke"
N_VALS = 10_000
VAL_POWER = 1000
TAMPER_IDX = 4321
MIXED_VALS = 10_000          # BASELINE config 3: half ed25519, half sr25519
MIXED_RUNS = 5
LC_VALS = 10_000             # BASELINE config 5: secp256k1
LC_RUNS = 5
LC_TAMPER_IDX = 1234         # inside the 1/3 the trusting call collects
CHUNK_COMMITS = 16
CHUNK_VALS = 1000
SHORT_COMMIT = 9             # the chunk's commit that misses quorum
LIGHT_RUNS = 7
FULL_RUNS = 5
STREAM_VALS = 1000           # BASELINE config 4's width
STREAM_HEIGHTS = 80
V0_HEIGHTS = 64              # heights 1-64 under V0, then V1
ROTATED = (5, 77, 150, 303, 421, 600, 777, 999)  # V1's new keys
TAMPER_HEIGHT = 20
TAMPER_VAL = 100
SHORT_HEIGHT = 70            # its top SHORT_ABSENT validators are absent
SHORT_ABSENT = 400
STREAM_RUNS = 3              # one cold, two warm
CACHED_RUNS = 5
DEVICE_REPS = 50             # calls in a profiler trace for device_ms
# column prefixes of the stream chunk (M = 1,024) at which every entry of
# the cached verify is timed; 8,192 is pad_rows(6,667), the light call's
STREAM_SWEEP = (8192, 10_240, 16_384, 32_768, 65_536)
# slot prefixes of the cached commit's table (all live) at which every
# entry of the table build is also timed: above the stream's M = 1,024,
# so that they bracket the entries' crossover (WARP_MAX_VALS_PER_SM)
TABLE_CROSS_SWEEP = (2048, 4096)
# timestamps that cross every varint width boundary, the zero-skipping
# cases and the 10-byte two's-complement negatives
FUZZ_SECS = [0, 1, 127, 128, 16383, 16384, 1_700_000_000, 2**31 - 1,
             2**31, 2**40, 2**62, -1, -2**33]
FUZZ_NANOS = [0, 1, 127, 128, 999_999_999, 5, 42, -7]
PLANE_RUNS = 5               # clean runs of the 10k precommits (one cold)
PLANE_THREADS = 8            # submitting threads
PLANE_WINDOW_MS = 1.5        # [verify_plane] defaults (config.py)
PLANE_MAX_BATCH = 1024
PLANE_MAX_QUEUE = 8192
PLANE_FAULT_VALS = (4096, 5120)  # the fault run's validators
PLANE_FAULT_BATCH = 256
PLANE_TIMEOUT_S = 120.0
PLANE_LEDGER = 16384         # flush ledger ring of the phase's planes
VS_ROTATED = 100             # phase 12: validators whose power rotates
VS_THREADS = 8               # phase 12: threads adding votes
VS_RUNS = 3                  # phase 12: VoteSets over epoch e's votes
VS_HOST_VOTES = (4096, 5120)  # phase 12: the host plane's slice of votes
LCC_VALS = 10_000            # phase 13: BASELINE config 5's width
LCC_COPY_VALS = 16           # phase 13: the plan's copy the CPU test runs
LCC_SEED = 13                # phase 13: the plan's seed
LCC_TAMPER_IDX = 0           # phase 13: the tampered target's signature
LCC_T0 = 1_700_300_000       # phase 13: height h's header time is T0 + h
H100_SMS = 132
GW_THREADS = 64              # phase 15: clients asking verify(1, 8) at once
GW_DIVERGENT_THREADS = 8     # phase 15: era-B pair clients, half lied to
GW_ERA_B_PAIR = (6, 8)       # phase 15: trusted and target heights in era B
APP_CLIENTS = 1000           # phase 16: client keys signing txs
APP_MIX = (4000, 500, 250, 250)  # phase 16: valid, flipped, malformed, unsigned
APP_THREADS = 64             # phase 16: broadcast_tx clients at once
APP_RESENDS = 8              # phase 16: sends of a tx answered OVERLOADED
APP_SPOT = 256               # phase 16: signed txs checked by ed25519_ref
APP_HEIGHTS = 8              # phase 16: blocks produced and applied
APP_ROTATE_AT = 3            # phase 16: the height carrying the val: txs
APP_ROTATED = 8              # phase 16: validators removed, keys added
APP_TAMPER_IDX = 321         # phase 16: the tampered LastCommit signature
APP_T0 = 1_700_400_000       # phase 16: genesis time; commit h at T0 + h
APP_SQUEEZE_TXS = 32         # phase 16: txs into the one-row BULK lane
APP_SQUEEZE_THREADS = 8
IMAD_PER_CLK = 64            # INT32 multiply-adds per SM per clock
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


# --------------------------------------------------------------------------
# fixtures (host, parallel)
# --------------------------------------------------------------------------


def _sign_job(args):
    from cometbft_tpu_torch.crypto import ed25519_ref

    seed, msgs = args
    return ed25519_ref.sign_many(seed, msgs)


def sign_all(pool, jobs):
    """[(seed, [msg])] -> [(pub, [sig])] over the worker pool."""
    return pool.map(_sign_job, jobs, chunksize=max(1, len(jobs) // 64))


def _sign_typed_job(args):
    kind, seed, msgs = args
    if kind == "sr25519":
        from cometbft_tpu_torch.crypto import sr25519_ref

        return sr25519_ref.sign_many(seed, msgs, rng=seed)
    if kind == "secp256k1":
        from cometbft_tpu_torch.crypto import keys, secp256k1_ref

        d = keys.Secp256k1PrivKey.generate(seed).secret
        return secp256k1_ref.sign_many(d, msgs)
    return _sign_job((seed, msgs))


def sign_typed(pool, jobs):
    """[(key type, seed, [msg])] -> [(pub, [sig])] over the worker pool;
    sr25519 and secp256k1 sign in pure Python (no `cryptography` on the
    card's machine)."""
    return pool.map(_sign_typed_job, jobs,
                    chunksize=max(1, len(jobs) // 64))


def _oracle_job(args):
    kind, pub, msg, sig = args
    from cometbft_tpu_torch.crypto.keys import PubKey

    return PubKey(pub, kind).verify_signature(msg, sig)


def oracle_verdicts(pool, kind, pubs, msgs, sigs):
    import numpy as np

    return np.asarray(pool.map(
        _oracle_job, [(kind, p, m, s) for p, m, s in zip(pubs, msgs, sigs)],
        chunksize=16))


def make_typed_valset(pool, rng, kinds, powers):
    """Validators of the given key types from seeded keys; returns
    (ValidatorSet, (key type, seed) by address)."""
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    seeds = [seed_bytes(rng) for _ in kinds]
    pubs = [pub for pub, _ in sign_typed(
        pool, [(k, s, []) for k, s in zip(kinds, seeds)])]
    vals = [Validator(PubKey(p, k), int(w))
            for p, k, w in zip(pubs, kinds, powers)]
    vs = ValidatorSet(vals)
    return vs, {v.address: (k, s) for v, k, s in zip(vals, kinds, seeds)}


def sign_commit_typed(pool, commit, key_of):
    for cs, (_, (sig,)) in zip(commit.signatures, sign_typed(pool, [
            (*key_of[cs.validator_address], [m])
            for cs, m in zip(commit.signatures,
                             commit.sign_bytes_rows(CHAIN_ID))])):
        cs.signature = sig


def seed_bytes(rng) -> bytes:
    return bytes(rng.integers(0, 256, 32, dtype="uint8"))


def make_valset(pool, rng, n, powers):
    """n validators from seeded keys; returns (ValidatorSet, seed by
    address)."""
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    seeds = [seed_bytes(rng) for _ in range(n)]
    pubs = [pub for pub, _ in sign_all(pool, [(s, []) for s in seeds])]
    vals = [Validator(PubKey(p), int(w)) for p, w in zip(pubs, powers)]
    vs = ValidatorSet(vals)
    by_addr = {v.address: s for v, s in zip(vals, seeds)}
    return vs, by_addr


def light_plan(n, seed=LCC_SEED):
    """Phase 13's chain plan (config 5 as a whole): era A, n secp256k1
    validators from seeded keys with seeded powers in 1-1,000, signs
    heights 1-4; era B signs 5-8. Era B keeps A's validators, taken in a
    seeded order, while their power stays within 30 % of A's total, and
    replaces the rest with new seeded keys and powers, so a jump from an
    era A height to an era B height fails the 1/3 trust check and the
    skipping client bisects across the adjacent link 4 -> 5. Returns
    {height: [(key seed, power)]}, each height's validators in plan order;
    tests/test_torch_light.py runs the same plan at LCC_COPY_VALS."""
    import numpy as np

    rng = np.random.default_rng(seed)
    era_a = [(seed_bytes(rng), int(p)) for p in rng.integers(1, 1001, n)]
    total = sum(p for _, p in era_a)
    kept, power = [], 0
    for i in rng.permutation(n):
        if (power + era_a[i][1]) * 10 <= total * 3:
            kept.append(era_a[i])
            power += era_a[i][1]
    era_b = kept + [(seed_bytes(rng), int(p))
                    for p in rng.integers(1, 1001, n - len(kept))]
    return {h: era_a if h < 5 else era_b for h in range(1, 9)}


def block_id(rng):
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader

    return BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))


def unsigned_commit(vs, height, bid, base_ts):
    from cometbft_tpu_torch.types.commit import (
        BLOCK_ID_FLAG_COMMIT, Commit, CommitSig,
    )
    from cometbft_tpu_torch.types.timestamp import Timestamp

    sigs = [CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                      Timestamp(base_ts, (i * 7919) % 1_000_000_000), b"")
            for i, v in enumerate(vs.validators)]
    return Commit(height, 0, bid, sigs)


def flip(sig: bytes, byte: int, bit: int = 1) -> bytes:
    return sig[:byte] + bytes([sig[byte] ^ bit]) + sig[byte + 1:]


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _traced(fn, name, cats=("kernel", "gpu_memcpy", "gpu_memset")):
    """(events of the categories `cats`, by default the device's, wall
    ms) of fn() under torch.profiler; the trace is kept under
    build/traces/<name>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    os.makedirs(os.path.join("build", "traces"), exist_ok=True)
    path = os.path.join("build", "traces", name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events if e.get("cat") in cats], wall


def trace_device_ms(fn, name):
    """(kernel ms, memcpy ms, wall ms) of one call under torch.profiler,
    summed from the exported trace's device events, or None when the trace
    holds no device events."""
    events, wall = _traced(fn, name)
    kern = sum(e.get("dur", 0) for e in events if e["cat"] == "kernel")
    copy = sum(e.get("dur", 0) for e in events if e["cat"] != "kernel")
    if kern <= 0:
        return None
    return kern / 1e3, copy / 1e3, wall


def device_ms(fn, reps: int, name: str):
    """Device time of one call of fn, from a profiler trace of `reps`
    calls: for kernels and for memsets, the mean duration of the trace's
    events times their count per call rounded to a whole number (a trace
    may miss an event or two of a run). Returns (ms, kernel events per
    call, memset events per call), or None when the trace holds no kernel.
    Unlike `cuda_ms`, which times a loop of calls between two events and so
    also counts the host's time to enqueue each one, this counts only the
    time the card works."""
    import torch

    fn()
    torch.cuda.synchronize()

    def loop():
        for _ in range(reps):
            fn()

    try:
        events, _ = _traced(loop, name)
    except Exception as e:  # noqa: BLE001 - the trace is a measurement only
        print(f"device_ms {name}: profiler failed: {e!r}", flush=True)
        return None
    kern = [e.get("dur", 0) for e in events if e["cat"] == "kernel"]
    mset = [e.get("dur", 0) for e in events if e["cat"] == "gpu_memset"]
    if not kern:
        return None
    us = sum(sum(d) / len(d) * round(len(d) / reps)
             for d in (kern, mset) if d)
    return us / 1e3, len(kern) / reps, len(mset) / reps


def dev_ms(fn, name: str):
    """Device ms of one call of fn (`device_ms` over DEVICE_REPS calls),
    or None where the trace holds no kernel."""
    t = device_ms(fn, DEVICE_REPS, name)
    return t and t[0]


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.6f}"


def device_line(kernel, library) -> str:
    """The phase line's report of two device_ms results."""
    def one(t):
        return "not measured" if t is None else (
            f"{t[0]:.6f} (kernels/call={t[1]:g} memsets/call={t[2]:g})")
    return f"device_ms={one(kernel)} index_add_device_ms={one(library)}"


def cached_entry_sweep(dev, rows, table, plain, widths, phase):
    """Each entry of the cached verify (ec.VERIFY_CACHED_ENTRIES, the one-
    thread entry first) on the first B columns of rows for every B in
    widths: held against the plain verdicts `plain` of those columns and
    timed by device time. Launches through ec.launch_verify_cached, so the
    wrappers' counts do not move. Returns {entry: {"BxM": device ms}}."""
    import torch

    from cometbft_tpu_torch.ops import ed25519_cached as ec

    M = table.n_vals
    entries = sorted(ec.VERIFY_CACHED_ENTRIES, key=lambda e: e != "thread")
    sweep = {}
    for entry in entries:
        sweep[entry] = {}
        for B in widths:
            r = rows[:, :B].contiguous()
            got = ec.launch_verify_cached(r, table.tab, table.ok, entry)
            check(torch.equal(got, plain[:B]),
                  f"ed25519_verify_cached entry {entry} != plain at "
                  f"{B} columns, M={M}")
            t = dev_ms(lambda: ec.launch_verify_cached(  # noqa: B023
                r, table.tab, table.ok, entry),
                f"ed25519_verify_cached_{entry}_{B}x{M}_trace.json")
            sweep[entry][f"{B}x{M}"] = t
        print(f"{phase} ed25519_verify_cached entry={entry} M={M} "
              f"kernel==plain, device_ms by cols " + " ".join(
                  f"{k.split('x')[0]}={fmt_ms(t)}"
                  for k, t in sweep[entry].items()), flush=True)
    return sweep


def table_build_entries() -> dict:
    """Every entry of valset_table_build: name -> fn(pub_raw, lenok) ->
    (tab, ok), launched through ec.launch_valset_table_build, so the
    wrapper's count does not move."""
    from cometbft_tpu_torch.ops import ed25519_cached as ec

    return {e: (lambda pub, ln, e=e: ec.launch_valset_table_build(pub, ln, e))
            for e in ec.TABLE_BUILD_ENTRIES}


def table_entry_sweep(pub, lenok, want, phase):
    """Each entry of valset_table_build on (pub, lenok), held byte for byte
    against `want` = (tab, ok) and timed by device time. Returns
    {entry: {"M=<M>": device ms}}."""
    import torch

    M = pub.shape[0]
    sweep = {}
    for entry, fn in table_build_entries().items():
        tab, ok = fn(pub, lenok)
        torch.cuda.synchronize()
        check(torch.equal(tab, want[0]) and torch.equal(ok, want[1]),
              f"valset_table_build entry {entry} != plain at M={M}")
        del tab, ok
        t = dev_ms(lambda: fn(pub, lenok),  # noqa: B023
                   f"valset_table_build_{entry}_{M}_trace.json")
        sweep[entry] = {f"M={M}": t}
        print(f"{phase} valset_table_build entry={entry} M={M} "
              f"kernel==plain (bytes) device_ms={fmt_ms(t)}", flush=True)
    return sweep


def merge_sweep(stats: dict, sweep: dict) -> None:
    for entry, times in sweep.items():
        stats.setdefault("sweep_device_ms", {}).setdefault(
            entry, {}).update(times)


def plain_pack_equals(what, pack, rows):
    """Time `pack(native=False)`, the plain host pack, once and check its
    rows equal `rows` (the native pack's) byte for byte; -> ms."""
    import numpy as np

    t = time.perf_counter()
    plain = pack(native=False)
    plain_ms = (time.perf_counter() - t) * 1e3
    check(np.asarray(plain).dtype == np.asarray(rows).dtype
          and np.array_equal(plain, rows),
          f"{what}: the native host pack != the plain pack")
    return plain_ms


def split_times(dev, vs, commit, n, runs):
    """Host pack ms (host clock) and device ms (CUDA events around upload,
    kernel and download) of `runs` verify batches of the commit's first n
    signatures, through the same calls verify_batch makes, with the share of
    pack_rows in the host pack; then the plain host pack's ms, once, its
    rows held equal to the native pack's."""
    import torch

    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    idxs = list(range(n))
    pubs = [vs.validators[i].pub_key.data for i in idxs]
    msgs = commit.sign_bytes_rows(CHAIN_ID, idxs)
    sigs = [commit.signatures[i].signature for i in idxs]

    def pack(native=True):
        return kf.pack_rows(ek.pack_batch(pubs, msgs, sigs, native=native,
                                          pad_to=kf.pad_to_tile(n)))

    pack_ms, rows_ms, dev_ms = [], [], []
    for _ in range(runs):
        t = time.perf_counter()
        pb = ek.pack_batch(pubs, msgs, sigs, pad_to=kf.pad_to_tile(n))
        t_rows = time.perf_counter()
        rows = kf.pack_rows(pb)
        pack_ms.append((time.perf_counter() - t) * 1e3)
        rows_ms.append((time.perf_counter() - t_rows) * 1e3)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        valid = kf.verify_rows(rows, dev).cpu().numpy()
        b.record()
        b.synchronize()
        dev_ms.append(a.elapsed_time(b))
        check(valid[:n].all() and not valid[n:].any(),
              f"split-time batch of {n} verified wrongly")
    return pack_ms, rows_ms, dev_ms, plain_pack_equals(
        f"{n} ed25519 rows", pack, rows)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_card_and_build():
    import torch

    from cometbft_tpu_torch.device import default_device
    from cometbft_tpu_torch.ops import _build

    print("nvidia-smi:", smi("name,power.limit"), flush=True)
    dev = default_device()  # raises unless capability is (9, 0)
    t0 = time.perf_counter()
    _build.build_all()
    entry, source = "?", "?"
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            source = next((s for s in _build.KERNELS
                           if f"_{s.replace('.', '_')}_" in entry), "?")
        elif "registers" in line or "spill" in line or "bytes stack" in line:
            print(f"ptxas [{source}]: {entry}: {line.strip()}")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.native_lib()  # the native host packer (host C++ compiler)
    native_s = time.perf_counter() - t0
    from cometbft_tpu_torch.crypto import secp256k1_ref

    print(f"phase1 build_s={build_s:.3f} native_build_s={native_s:.3f} "
          f"device={torch.cuda.get_device_name(0)} kernel_sources="
          f"{len(_build.KERNELS)} ripemd160="
          f"{secp256k1_ref.ripemd160_source()}", flush=True)
    return dev


def tally_edge_cases(dev, cached: bool) -> int:
    """Each tally entry against its plain version and the exact integer
    sums on every case of edge_cases.TALLY_CASES; returns the count."""
    import torch

    from cometbft_tpu_torch.edge_cases import TALLY_CASES, tally_edge_case
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    for name, *_ in TALLY_CASES:
        case = tally_edge_case(name, cached)
        v = torch.from_numpy(case.valid).to(dev)
        r = torch.from_numpy(case.rows).to(dev)
        if cached:
            p5 = torch.from_numpy(case.power5).to(dev)
            tk, qk = ec.tally_quorum_cached(v, r, p5, case.C)
            tp, qp = ec.tally_quorum_cached_plain(v, r, p5, case.C)
        else:
            tk, qk = kf.tally_quorum(v, r, case.C)
            tp, qp = kf.tally_quorum_plain(v, r, case.C)
        check(torch.equal(tk, tp) and torch.equal(qk, qp),
              f"tally (cached={cached}) != plain on edge case {name}")
        check([int(x) for x in ek.tally_to_int(tk.cpu().numpy())]
              == case.sums, f"tally (cached={cached}) != host sums on {name}")
    return len(TALLY_CASES)


def phase_kernels_vs_plain(dev, pool, rng):
    import numpy as np
    import torch

    from cometbft_tpu_torch import edge_cases
    from cometbft_tpu_torch.crypto import ed25519_ref as ed
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.types.validator import MAX_TOTAL_VOTING_POWER

    # ed25519_verify on 256 columns (2 tiles)
    seeds = [seed_bytes(rng) for _ in range(200)]
    msgs = [rng.bytes(int(rng.integers(0, 120))) for _ in range(200)]
    signed = sign_all(pool, [(s, [m]) for s, m in zip(seeds, msgs)])
    pubs = [p for p, _ in signed]
    sigs = [s[0] for _, s in signed]
    for i in range(0, 200, 9):
        sigs[i] = flip(sigs[i], int(rng.integers(0, 64)),
                       1 << int(rng.integers(0, 8)))
    for i in range(4, 200, 11):
        msgs[i] = msgs[i] + b"!"
    for i in range(7, 200, 23):
        s = int.from_bytes(sigs[i][32:], "little") + ed.L
        if s < 2**256:
            sigs[i] = sigs[i][:32] + int.to_bytes(s, 32, "little")
    for _ in range(24):
        pubs.append(rng.bytes(32))
        msgs.append(rng.bytes(5))
        sigs.append(rng.bytes(64))
    zip_cases = edge_cases.ed25519_zip215_cases()
    for p, m, s in zip_cases:
        pubs.append(p)
        msgs.append(m)
        sigs.append(s)
    n = len(pubs)
    check(128 < n <= 256, f"phase2 fixture has {n} rows")
    oracle = np.array([ed.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)])
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=256)
    rows = torch.from_numpy(kf.pack_rows(pb)).to(dev)
    got_k = kf.ed25519_verify(rows).cpu().numpy()
    got_p = kf.ed25519_verify_plain(rows, kf.base_points(dev)).cpu().numpy()
    torch.cuda.synchronize()
    check(np.array_equal(got_k, got_p), "ed25519_verify != plain on 256 cols")
    check(np.array_equal(got_k[:n].astype(bool), oracle),
          "ed25519_verify != ed25519_ref oracle")
    check(not got_k[n:].any(), "a padding column verified")
    check(oracle.any() and not oracle.all(), "phase2 mix is one-sided")
    print(f"phase2 ed25519_verify cols=256 rows={n} valid={int(oracle.sum())}"
          f" zip215_cases={len(zip_cases)} kernel==plain==oracle", flush=True)

    # tally_quorum on 8 commits
    C, B = 8, 1024
    per_val = MAX_TOTAL_VOTING_POWER // 10_000
    powers = per_val - rng.integers(0, 1000, B)
    valid = rng.integers(0, 2, B).astype(np.int32)
    counted = rng.integers(0, 4, B) != 0
    cids = rng.integers(0, C, B).astype(np.int32)
    sums = [int(sum(int(powers[b]) for b in range(B)
                    if valid[b] and counted[b] and cids[b] == c))
            for c in range(C)]
    thresh_int = [s - 1 for s in sums]
    thresh_int[5] = sums[5]  # misses quorum by exactly 1
    thresh = np.stack([ek.threshold_limbs(t)[0] for t in thresh_int])
    pb = ek.pack_batch([], [], [], pad_to=B)
    trows = torch.from_numpy(kf.pack_rows(
        pb, ek.power_limbs(powers), counted, cids, thresh)).to(dev)
    tvalid = torch.from_numpy(valid).to(dev)
    tk, qk = kf.tally_quorum(tvalid, trows, C)
    tp, qp = kf.tally_quorum_plain(tvalid, trows, C)
    check(torch.equal(tk, tp) and torch.equal(qk, qp),
          "tally_quorum != plain")
    check([int(x) for x in ek.tally_to_int(tk.cpu().numpy())] == sums,
          "tally_quorum != host integer sums")
    want_q = [True] * C
    want_q[5] = False
    check(qk.cpu().numpy().tolist() == want_q, "quorum bits wrong")
    print(f"phase2 tally_quorum commits={C} cols={B} kernel==plain==host "
          f"quorum={qk.cpu().numpy().astype(int).tolist()}", flush=True)
    n = tally_edge_cases(dev, cached=False)
    print(f"phase2 tally_quorum edge_cases={n} (up to {1 << 17} cols, "
          f"{kf.TALLY_SMEM_COMMITS + 1} commits) kernel==plain==host",
          flush=True)


def phase_main_path(dev, pool, rng, kernel_stats):
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.types import validation as val

    t0 = time.perf_counter()
    vs, seed_of = make_valset(pool, rng, N_VALS, [VAL_POWER] * N_VALS)
    bid = block_id(rng)
    height = 1_000_001
    commit = unsigned_commit(vs, height, bid, 1_700_000_000)
    msgs = commit.sign_bytes_rows(CHAIN_ID)
    jobs = [(seed_of[cs.validator_address], [m])
            for cs, m in zip(commit.signatures, msgs)]
    for cs, (_, (sig,)) in zip(commit.signatures, sign_all(pool, jobs)):
        cs.signature = sig
    print(f"phase3 fixtures validators={N_VALS} keys+signatures_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)

    fn = val.device_batch_fn()
    brk = cbatch.device_breaker()
    kf.ed25519_verify.launches = 0
    kf.tally_quorum.launches = 0
    light_ms, full_ms = [], []
    for _ in range(LIGHT_RUNS):
        t = time.perf_counter()
        val.verify_commit_light(CHAIN_ID, vs, bid, height, commit, fn)
        light_ms.append((time.perf_counter() - t) * 1e3)
    for _ in range(FULL_RUNS):
        t = time.perf_counter()
        val.verify_commit(CHAIN_ID, vs, bid, height, commit, fn)
        full_ms.append((time.perf_counter() - t) * 1e3)
    good = commit.signatures[TAMPER_IDX].signature
    commit.signatures[TAMPER_IDX].signature = flip(good, 40)
    blamed = []
    for verify in (val.verify_commit, val.verify_commit_light):
        try:
            verify(CHAIN_ID, vs, bid, height, commit, fn)
            blamed.append(None)
        except val.InvalidSignatureError as e:
            blamed.append(e.idx)
    commit.signatures[TAMPER_IDX].signature = good
    torch.cuda.synchronize()
    launches = {"ed25519_verify": kf.ed25519_verify.launches,
                "tally_quorum": kf.tally_quorum.launches}
    calls = LIGHT_RUNS + FULL_RUNS + 2
    check(blamed == [TAMPER_IDX, TAMPER_IDX],
          f"tampered signature blamed at {blamed}, want {TAMPER_IDX}")
    check(brk.trips == 0 and brk.faults == 0,
          f"breaker trips={brk.trips} faults={brk.faults}")
    check(launches["ed25519_verify"] == calls,
          f"ed25519_verify launched {launches['ed25519_verify']} times "
          f"for {calls} batches")
    full_p50 = statistics.median(full_ms)
    n_light = vs.total_voting_power() * 2 // 3 // VAL_POWER + 1
    saved = kf.ed25519_verify.launches
    light_pack, light_rows, light_dev, light_plain = split_times(
        dev, vs, commit, n_light, LIGHT_RUNS)
    full_pack, full_rows, full_dev, full_plain = split_times(
        dev, vs, commit, N_VALS, FULL_RUNS)
    kf.ed25519_verify.launches = saved
    print(f"phase3 launches {json.dumps(launches)} breaker_trips=0 faults=0 "
          f"blamed_idx={TAMPER_IDX}", flush=True)
    print(f"phase3 VerifyCommitLight n_sigs={n_light} "
          f"padded={kf.pad_to_tile(n_light)} "
          f"p50_ms={statistics.median(light_ms):.3f} "
          f"host_pack_p50_ms={statistics.median(light_pack):.3f} "
          f"of_which_pack_rows_p50_ms={statistics.median(light_rows):.3f} "
          f"plain_host_pack_p50_ms={light_plain:.3f} "
          f"device_p50_ms={statistics.median(light_dev):.3f} "
          f"runs={LIGHT_RUNS} all_ms={[round(x, 3) for x in light_ms]}",
          flush=True)
    print(f"phase3 VerifyCommit n_sigs={N_VALS} p50_ms={full_p50:.3f} "
          f"sigs_per_s={N_VALS / (full_p50 / 1e3):.1f} "
          f"host_pack_p50_ms={statistics.median(full_pack):.3f} "
          f"of_which_pack_rows_p50_ms={statistics.median(full_rows):.3f} "
          f"plain_host_pack_p50_ms={full_plain:.3f} "
          f"device_p50_ms={statistics.median(full_dev):.3f} "
          "native pack == plain pack at both shapes", flush=True)

    # the kernel at the main path's shape (10,000 signatures in 16,384
    # columns), against its plain version on the same rows
    idxs = list(range(N_VALS))
    pubs = [vs.validators[i].pub_key.data for i in idxs]
    sigs = [commit.signatures[i].signature for i in idxs]
    pb = ek.pack_batch(pubs, commit.sign_bytes_rows(CHAIN_ID, idxs), sigs,
                       pad_to=kf.pad_to_tile(N_VALS))
    rows = torch.from_numpy(kf.pack_rows(pb)).to(dev)
    saved = kf.ed25519_verify.launches
    ms = cuda_ms(lambda: kf.ed25519_verify(rows), 10)
    t = time.perf_counter()
    plain = kf.ed25519_verify_plain(rows, kf.base_points(dev))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    out = kf.ed25519_verify(rows)
    kf.ed25519_verify.launches = saved
    err = int((out - plain).abs().max())
    check(err == 0, "ed25519_verify != plain at 16,384 cols")
    check(int(out.sum()) == N_VALS, "not every commit signature verified")
    dev_full = dev_ms(lambda: kf.ed25519_verify(rows),
                      "ed25519_verify_10000_trace.json")
    # the light call's shape: its 6,667 signatures in 16,384 columns
    pb_l = ek.pack_batch(pubs[:n_light],
                         commit.sign_bytes_rows(CHAIN_ID, idxs[:n_light]),
                         sigs[:n_light], pad_to=kf.pad_to_tile(n_light))
    rows_l = torch.from_numpy(kf.pack_rows(pb_l)).to(dev)
    out_l = kf.ed25519_verify(rows_l)
    err_l = int((out_l - kf.ed25519_verify_plain(
        rows_l, kf.base_points(dev))).abs().max())
    check(err_l == 0, f"ed25519_verify != plain at {n_light} live columns")
    check(int(out_l.sum()) == n_light, "not every light signature verified")
    dev_light = dev_ms(lambda: kf.ed25519_verify(rows_l),
                       f"ed25519_verify_{n_light}_trace.json")
    kf.ed25519_verify.launches = saved
    kernel_stats["ed25519_verify"] = dict(
        launches_by_path={"verify_commit": launches["ed25519_verify"]},
        ms=ms, plain_ms=plain_ms,
        n_checked=int(pb.precheck.sum()), cols=int(rows.shape[1]),
        max_abs_err=max(err, err_l),
        bytes=rows.shape[1] * (kf.C_KROWS + 1) * 4 + 8192 * 3 * 10 * 4,
        library_ms=None, device_ms=dev_full,
        device_ms_by_live={N_VALS: dev_full, n_light: dev_light},
    )
    print(f"phase3 ed25519_verify cols={rows.shape[1]} kernel_ms={ms:.4f} "
          f"device_ms={fmt_ms(dev_full)} (live={N_VALS}) device_ms="
          f"{fmt_ms(dev_light)} (live={n_light}) plain_ms={plain_ms:.1f} "
          f"kernel==plain at live={N_VALS} and {n_light}", flush=True)
    return {"light_p50_ms": statistics.median(light_ms),
            "full_sigs_per_s": N_VALS / (full_p50 / 1e3),
            "tally_launches": launches["tally_quorum"],
            "fixture": (vs, bid, height, commit)}


def phase_fused_step(dev, pool, rng, kernel_stats, tally_on_commit_path):
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    t0 = time.perf_counter()
    powers = rng.integers(1, 1_000_000, CHUNK_VALS)
    vs, seed_of = make_valset(pool, rng, CHUNK_VALS, powers)
    total = vs.total_voting_power()
    need = total * 2 // 3
    commits = [unsigned_commit(vs, 500 + c, block_id(rng), 1_700_000_000 + c)
               for c in range(CHUNK_COMMITS)]
    per_seed: dict = {}
    for c, cm in enumerate(commits):
        for cs, m in zip(cm.signatures, cm.sign_bytes_rows(CHAIN_ID)):
            per_seed.setdefault(cs.validator_address, []).append(m)
    addrs = list(per_seed)
    signed = sign_all(pool, [(seed_of[a], per_seed[a]) for a in addrs])
    sig_of = {a: sg for a, (_, sg) in zip(addrs, signed)}
    for c, cm in enumerate(commits):
        for cs in cm.signatures:
            cs.signature = sig_of[cs.validator_address][c]
    # SHORT is left with at most the threshold of valid power: its
    # signatures are tampered from the top until the rest is <= need
    SHORT = SHORT_COMMIT
    truth = np.ones((CHUNK_COMMITS, CHUNK_VALS), bool)
    vpow = [v.voting_power for v in vs.validators]
    left = total
    for i in range(CHUNK_VALS):
        if left <= need:
            break
        cs = commits[SHORT].signatures[i]
        cs.signature = flip(cs.signature, 3)
        truth[SHORT, i] = False
        left -= vpow[i]
    print(f"phase4 fixtures commits={CHUNK_COMMITS} validators={CHUNK_VALS} "
          f"keys+signatures_s={time.perf_counter() - t0:.3f}", flush=True)

    pubs, msgs, sigs, pw, cid = [], [], [], [], []
    for c, cm in enumerate(commits):
        for i, (cs, m) in enumerate(zip(cm.signatures,
                                        cm.sign_bytes_rows(CHAIN_ID))):
            pubs.append(vs.validators[i].pub_key.data)
            msgs.append(m)
            sigs.append(cs.signature)
            pw.append(vpow[i])
            cid.append(c)
    n = len(pubs)
    B = kf.pad_to_tile(n)
    pad = B - n
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=B)
    rows_np = kf.pack_rows(
        pb,
        ek.power_limbs(np.asarray(pw + [0] * pad, np.int64)),
        np.asarray([True] * n + [False] * pad),
        np.asarray(cid + [0] * pad, np.int32),
        ek.threshold_limbs(need, CHUNK_COMMITS),
    )
    brk = cbatch.device_breaker()
    faults0 = brk.faults
    kf.ed25519_verify.launches = 0
    kf.tally_quorum.launches = 0
    step_ms = []
    runs = 3
    for _ in range(runs):
        t = time.perf_counter()
        valid, tally, quorum = kf.verify_tally_rows(rows_np, CHUNK_COMMITS,
                                                    dev)
        valid, tally, quorum = (valid.cpu().numpy(), tally.cpu().numpy(),
                                quorum.cpu().numpy())
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = {"ed25519_verify": kf.ed25519_verify.launches,
                "tally_quorum": kf.tally_quorum.launches}
    check(launches == {"ed25519_verify": runs, "tally_quorum": runs},
          f"phase4 launches {launches}")
    check(brk.faults == faults0 and brk.trips == 0, "breaker recorded a fault")
    check(np.array_equal(valid[:n], truth.reshape(-1)), "phase4 verdicts")
    check(not valid[n:].any(), "phase4 padding verified")
    sums = [sum(vpow[i] for i in range(CHUNK_VALS) if truth[c, i])
            for c in range(CHUNK_COMMITS)]
    got = [int(x) for x in ek.tally_to_int(tally)]
    check(got == sums, f"phase4 tallies {got} != host sums {sums}")
    want_q = [s > need for s in sums]
    check(quorum.tolist() == want_q and want_q.count(False) == 1,
          f"phase4 quorum {quorum.tolist()}")
    check(sums[SHORT] <= need, "the short commit reached quorum")
    # an oracle sample of the verdicts
    from cometbft_tpu_torch.crypto import ed25519_ref as ed

    for j in rng.choice(n, 48, replace=False).tolist() + [
            SHORT * CHUNK_VALS, SHORT * CHUNK_VALS + CHUNK_VALS - 1]:
        check(bool(valid[j]) == ed.verify(pubs[j], msgs[j], sigs[j]),
              f"phase4 row {j} disagrees with the oracle")
    print(f"phase4 launches {json.dumps(launches)} rows={n} padded={B} "
          f"step_p50_ms={statistics.median(step_ms):.3f} "
          f"quorum={quorum.astype(int).tolist()} short_commit={SHORT} "
          f"short_by={need - sums[SHORT] + 1} tallies==host", flush=True)

    # tally_quorum at this shape, against its plain version and
    # index_add_ (the segmented sum alone)
    r = torch.from_numpy(rows_np).to(dev)
    saved_v = kf.ed25519_verify.launches
    verdicts = kf.ed25519_verify(r)
    v_err = int((verdicts - kf.ed25519_verify_plain(
        r, kf.base_points(dev))).abs().max())
    check(v_err == 0, f"ed25519_verify != plain at {n} live of {B} cols")
    v_dev = dev_ms(lambda: kf.ed25519_verify(r),
                   f"ed25519_verify_{n}_trace.json")
    kf.ed25519_verify.launches = saved_v
    saved = kf.tally_quorum.launches
    ms = cuda_ms(lambda: kf.tally_quorum(verdicts, r, CHUNK_COMMITS), 50)
    kf.tally_quorum.launches = saved
    plain_ms = cuda_ms(
        lambda: kf.tally_quorum_plain(verdicts, r, CHUNK_COMMITS), 5)
    tk, qk = kf.tally_quorum(verdicts, r, CHUNK_COMMITS)
    tp, qp = kf.tally_quorum_plain(verdicts, r, CHUNK_COMMITS)
    kf.tally_quorum.launches = saved
    err = max(int((tk - tp).abs().max()), int((qk != qp).sum()))
    check(err == 0, "tally_quorum != plain at the chunk's shape")
    power5, counted, cids, _ = kf.tally_inputs(r, CHUNK_COMMITS)
    contrib = power5 * ((verdicts != 0) & counted).to(torch.int64)[:, None]
    acc = torch.zeros((CHUNK_COMMITS, 5), dtype=torch.int64, device=dev)
    library = lambda: acc.index_add_(0, cids, contrib)  # noqa: E731
    library_ms = cuda_ms(library, 50)
    dev_t = device_ms(lambda: kf.tally_quorum(verdicts, r, CHUNK_COMMITS),
                      DEVICE_REPS, "tally_quorum_trace.json")
    kf.tally_quorum.launches = saved
    lib_t = device_ms(library, DEVICE_REPS, "index_add_chunk_trace.json")
    kernel_stats["tally_quorum"] = dict(
        launches_by_path={"verify_commit": tally_on_commit_path,
                          "fused_step": launches["tally_quorum"]},
        ms=ms, plain_ms=plain_ms,
        cols=B, bytes=B * 6 * 4 + CHUNK_COMMITS * (6 * 4 * 2 + 1),
        max_abs_err=err,
        library_ms=library_ms,
        device_ms=dev_t and dev_t[0], library_device_ms=lib_t and lib_t[0],
    )
    v = kernel_stats["ed25519_verify"]
    v["launches_by_path"]["fused_step"] = launches["ed25519_verify"]
    v["max_abs_err"] = max(v["max_abs_err"], v_err)
    v["device_ms_by_live"][n] = v_dev
    print(f"phase4 ed25519_verify cols={B} live={n} device_ms="
          f"{fmt_ms(v_dev)} kernel==plain", flush=True)
    print(f"phase4 tally_quorum cols={B} commits={CHUNK_COMMITS} "
          f"kernel_ms={ms:.5f} plain_ms={plain_ms:.4f} "
          f"index_add_ms={library_ms:.5f} "
          f"{device_line(dev_t, lib_t)}", flush=True)


def all_kernels():
    """Every kernel wrapper whose launch counter the phases read: name ->
    function."""
    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.ops import sr25519_kernel as srk

    return {"ed25519_verify": kf.ed25519_verify,
            "tally_quorum": kf.tally_quorum,
            "valset_table_build": ec.valset_table_build,
            "ed25519_verify_cached": ec.ed25519_verify_cached,
            "tally_quorum_cached": ec.tally_quorum_cached,
            "stamp_rows": es.stamp_rows,
            "sr25519_verify": srk.sr25519_verify,
            "ecdsa_verify": ef.ecdsa_verify}


def zero_launches() -> None:
    for fn in all_kernels().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in all_kernels().items()}


def restore_launches(saved: dict) -> None:
    for name, n in saved.items():
        all_kernels()[name].launches = n


def stamp_fixture(pool, rng, seeds, pubs, n, B, C):
    """n precommits signed by seeds[b] (validator b of a table over pubs)
    under two templates at every fuzzed timestamp: the staged deltas and
    the host-packed rows they must stamp into."""
    import numpy as np

    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import sign_bytes_template

    bids = [None, BlockID(rng.bytes(32), PartSetHeader(9, rng.bytes(32)))]
    combos = [(s, nn) for s in FUZZ_SECS for nn in FUZZ_NANOS]
    secs = [combos[b % len(combos)][0] for b in range(n)]
    nanos = [combos[b % len(combos)][1] for b in range(n)]
    tids = [b % 2 for b in range(n)]
    msgs = [canonical.canonical_vote_bytes(
        CHAIN_ID, canonical.PRECOMMIT_TYPE, 1000 + t, 0, bids[t],
        Timestamp(s, nn)) for s, nn, t in zip(secs, nanos, tids)]
    sigs = [s[0] for _, s in sign_all(
        pool, [(seeds[b], [msgs[b]]) for b in range(n)])]
    counted = np.zeros(B, bool)
    counted[:n] = [b % 4 != 0 for b in range(n)]
    cids = np.zeros(B, np.int32)
    cids[:n] = [b % C for b in range(n)]
    thresh = np.stack([ek.threshold_limbs(int(v))[0]
                       for v in rng.integers(0, 2**40, C)])
    pb = ek.pack_batch(pubs[:n], msgs, sigs, pad_to=B)
    ref = ec.pack_rows_cached(pb, counted, cids, thresh)
    dsig = np.zeros((B, 64), np.uint8)
    dsig[:n] = np.frombuffer(b"".join(sigs), np.uint8).reshape(-1, 64)
    dts = np.zeros((B, 3), np.int32)
    dts[:n] = canonical.split_ts_words(secs, nanos)
    dfl = np.zeros(B, np.int32)
    dfl[:n] = (1 | (counted[:n].astype(np.int32) << 1)
               | (np.asarray(tids, np.int32) << 2) | (cids[:n] << 10))
    tmpls = [sign_bytes_template(CHAIN_ID, canonical.PRECOMMIT_TYPE,
                                 1000 + t, 0, bids[t]) for t in range(2)]
    return dsig, dts, dfl, thresh, ref, [t.stamp_site() for t in tmpls]


def phase_cached_kernels_vs_plain(dev, pool, rng):
    import numpy as np
    import torch

    from cometbft_tpu_torch import edge_cases
    from cometbft_tpu_torch.crypto import ed25519_ref as ed
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    # valset_table_build at M = 128: 120 keys and 4 bad or edge keys
    seeds = [seed_bytes(rng) for _ in range(120)]
    keys = [p for p, _ in sign_all(pool, [(s, []) for s in seeds])]
    keys += [b"\xff" * 32, keys[0][:31], ed.pt_compress(ed.IDENT),
             int.to_bytes(1 | (1 << 255), 32, "little")]
    a_raw, lenok = ec._pack_pub_arrays(keys, 128)
    pub = torch.from_numpy(a_raw).to(dev)
    ln = torch.from_numpy(lenok).to(dev)
    tk, ok_k = ec.valset_table_build(pub, ln)
    tp, ok_p = ec.valset_table_build_plain(pub, ln)
    torch.cuda.synchronize()
    check(torch.equal(tk, tp) and torch.equal(ok_k, ok_p),
          "valset_table_build != plain at M = 128")
    okv = ok_k.cpu().numpy()
    check(okv[:121].all() and not okv[121] and okv[122:124].all()
          and not okv[124:].any(), f"table ok bits {okv[118:128]}")
    for entry, fn in table_build_entries().items():
        te, ok_e = fn(pub, ln)
        torch.cuda.synchronize()
        check(torch.equal(te, tp) and torch.equal(ok_e, ok_p),
              f"valset_table_build entry {entry} != plain at M = 128")
    print("phase5 valset_table_build M=128 keys=124 kernel==plain (bytes), "
          f"entries {sorted(table_build_entries())} ==plain ok="
          f"{int(okv.sum())}", flush=True)

    # ed25519_verify_cached on 256 columns (the mix of phase 2)
    seeds = [seed_bytes(rng) for _ in range(200)]
    msgs = [rng.bytes(int(rng.integers(0, 120))) for _ in range(200)]
    signed = sign_all(pool, [(s, [m]) for s, m in zip(seeds, msgs)])
    pubs = [p for p, _ in signed]
    sigs = [s[0] for _, s in signed]
    for i in range(0, 200, 9):
        sigs[i] = flip(sigs[i], int(rng.integers(0, 64)),
                       1 << int(rng.integers(0, 8)))
    for i in range(4, 200, 11):
        msgs[i] = msgs[i] + b"!"
    for i in range(7, 200, 23):
        s = int.from_bytes(sigs[i][32:], "little") + ed.L
        if s < 2**256:
            sigs[i] = sigs[i][:32] + int.to_bytes(s, 32, "little")
    for _ in range(24):
        pubs.append(rng.bytes(32))
        msgs.append(rng.bytes(5))
        sigs.append(rng.bytes(64))
    for p, m, s in edge_cases.ed25519_zip215_cases():
        pubs.append(p)
        msgs.append(m)
        sigs.append(s)
    n = len(pubs)
    table = ec.build_table(pubs, device=dev)
    check(table.n_vals == 256 and 128 < n <= 256, f"phase5 n={n}")
    oracle = np.array([ed.verify(p, m, s) for p, m, s in zip(pubs, msgs,
                                                              sigs)])
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=256)
    rows = torch.from_numpy(ec.pack_rows_cached(pb)).to(dev)
    got_k = ec.ed25519_verify_cached(rows, table.tab, table.ok)
    got_p = ec.ed25519_verify_cached_plain(rows, table.tab, table.ok,
                                           kf.base_points(dev))
    torch.cuda.synchronize()
    got_k, got_p = got_k.cpu().numpy(), got_p.cpu().numpy()
    check(np.array_equal(got_k, got_p), "ed25519_verify_cached != plain")
    check(np.array_equal(got_k[:n].astype(bool), oracle),
          "ed25519_verify_cached != ed25519_ref oracle")
    check(not got_k[n:].any(), "a dead cached column verified")
    print(f"phase5 ed25519_verify_cached cols=256 rows={n} "
          f"valid={int(oracle.sum())} kernel==plain==oracle", flush=True)

    # stamp_rows: 200 rows, two templates, every fuzzed timestamp width
    B, C = 256, 3
    dsig, dts, dfl, thresh, ref, sites = stamp_fixture(
        pool, rng, seeds, pubs, 200, B, C)
    ent = es.template_entry(sites, dev)
    t_rows = ec.packed_rows_shape(B, C)[0] - ec.V_THRESH
    args = [torch.from_numpy(a).to(dev) for a in (dsig, dts, dfl)]
    thr = torch.from_numpy(thresh).to(dev)
    sk = es.stamp_rows(*args, ent, table.pub_raw, thr, t_rows)
    sp = es.stamp_rows_plain(*args, ent.pre_mat, ent.pre_len, ent.suf_mat,
                             ent.suf_len, ent.ts_tag, table.pub_raw, thr,
                             ent.msg_max, t_rows)
    torch.cuda.synchronize()
    check(torch.equal(sk, sp), "stamp_rows != plain")
    check(np.array_equal(sk.cpu().numpy(), ref),
          "stamp_rows != pack_rows_cached of a host pack")
    v = ec.ed25519_verify_cached(sk, table.tab, table.ok).cpu().numpy()
    check(v[:200].all() and not v[200:].any(),
          "stamped rows did not verify")
    print(f"phase5 stamp_rows rows=200 cols={B} templates=2 "
          f"timestamps={len(FUZZ_SECS)}x{len(FUZZ_NANOS)} "
          "kernel==plain==host pack (bytes), all verify", flush=True)
    # stamp_rows over the chain-id sweep and its twists (256 columns each)
    for name in edge_cases.STAMP_CASES:
        case = edge_cases.stamp_case(name)
        ent = es.template_entry(case.sites, dev)
        t_rows = case.ref.shape[0] - ec.V_THRESH
        args = [torch.from_numpy(a).to(dev)
                for a in (case.dsig, case.dts, case.dfl)]
        pub = torch.from_numpy(case.pub_raw).to(dev)
        thr = torch.from_numpy(case.thresh.astype(np.int32)).to(dev)
        sk = es.stamp_rows(*args, ent, pub, thr, t_rows)
        sp = es.stamp_rows_plain(*args, ent.pre_mat, ent.pre_len,
                                 ent.suf_mat, ent.suf_len, ent.ts_tag, pub,
                                 thr, ent.msg_max, t_rows)
        torch.cuda.synchronize()
        check(torch.equal(sk, sp), f"stamp_rows != plain on case {name}")
        check(np.array_equal(sk.cpu().numpy(), case.ref),
              f"stamp_rows != pack_rows_cached of a host pack on case {name}")
    print(f"phase5 stamp_rows cases={list(edge_cases.STAMP_CASES)} cols=256 "
          f"chain_ids=0-{max(edge_cases.STAMP_CHAIN_LENS)} bytes x 2 block "
          "ids, sha512 blocks 1-3 kernel==plain==host pack (bytes)",
          flush=True)

    # tally_quorum_cached on 8 commits
    M, C = 256, 8
    B = M * C
    powers = rng.integers(1, 2**50, M)
    power5 = torch.from_numpy(ek.power_limbs(powers)).to(dev)
    counted = rng.random(B) < 0.9
    valid = (rng.random(B) < 0.8).astype(np.int32)
    sums = [sum(int(powers[b % M]) for b in range(c * M, (c + 1) * M)
                if valid[b] and counted[b]) for c in range(C)]
    thr = [s - 1 for s in sums]
    thr[3] = sums[3]  # misses quorum by exactly 1
    rows = np.zeros(ec.packed_rows_shape(B, C), np.int32)
    rows[ec.V_FLAGS] = (counted.astype(np.int32) << 2) | (
        np.repeat(np.arange(C, dtype=np.int32), M) << 3)
    rows[ec.V_THRESH:].reshape(-1)[:C * 6] = np.stack(
        [ek.threshold_limbs(t)[0] for t in thr]).reshape(-1)
    r = torch.from_numpy(rows).to(dev)
    vt = torch.from_numpy(valid).to(dev)
    tk, qk = ec.tally_quorum_cached(vt, r, power5, C)
    tp, qp = ec.tally_quorum_cached_plain(vt, r, power5, C)
    check(torch.equal(tk, tp) and torch.equal(qk, qp),
          "tally_quorum_cached != plain")
    check([int(x) for x in ek.tally_to_int(tk.cpu().numpy())] == sums,
          "tally_quorum_cached != host integer sums")
    want_q = [True] * C
    want_q[3] = False
    check(qk.cpu().numpy().tolist() == want_q, "cached quorum bits wrong")
    print(f"phase5 tally_quorum_cached commits={C} cols={B} "
          "kernel==plain==host", flush=True)
    n = tally_edge_cases(dev, cached=True)
    print(f"phase5 tally_quorum_cached edge_cases={n} kernel==plain==host",
          flush=True)


def _stream_fixture(pool, rng):
    """80 signed commits of a 1,000-validator set: heights 1-64 under V0,
    65-80 under V1 (V0 with 8 keys rotated, same powers and slots)."""
    import numpy as np

    from cometbft_tpu_torch.blocksync.pipeline import CommitJob
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.types.commit import CommitSig
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    n = STREAM_VALS
    # distinct powers keep the power order, so a rotated key keeps its slot
    powers = [1_000_000 - 997 * i for i in range(n)]
    seeds0 = [seed_bytes(rng) for _ in range(n)]
    seeds1 = list(seeds0)
    for i in ROTATED:
        seeds1[i] = seed_bytes(rng)
    extra = [seeds1[i] for i in ROTATED]
    pubs = [p for p, _ in sign_all(pool, [(s, []) for s in seeds0 + extra])]
    pub_of = dict(zip(seeds0 + extra, pubs))
    sets = [ValidatorSet([Validator(PubKey(pub_of[s]), w)
                          for s, w in zip(seeds, powers)])
            for seeds in (seeds0, seeds1)]
    seed_of = {}
    for vs, seeds in zip(sets, (seeds0, seeds1)):
        for v, s in zip(vs.validators, seeds):
            check(pub_of[s] == v.pub_key.data, "validator order moved")
            seed_of[v.address] = s
    jobs, per_seed = [], {}
    for h in range(1, STREAM_HEIGHTS + 1):
        vs = sets[0] if h <= V0_HEIGHTS else sets[1]
        bid = block_id(rng)
        commit = unsigned_commit(vs, h, bid, 1_700_000_000 + h)
        if h == SHORT_HEIGHT:
            for i in range(SHORT_ABSENT):
                commit.signatures[i] = CommitSig()
        for i, (cs, m) in enumerate(zip(commit.signatures,
                                        commit.sign_bytes_rows(CHAIN_ID))):
            if cs.for_block():
                per_seed.setdefault(seed_of[cs.validator_address],
                                    []).append((h, i, m))
        jobs.append(CommitJob(vs, bid, h, commit, CHAIN_ID))
    order = list(per_seed)
    signed = sign_all(pool, [(s, [m for _, _, m in per_seed[s]])
                             for s in order])
    n_sigs = 0
    for s, (_, sigs) in zip(order, signed):
        for (h, i, _), sig in zip(per_seed[s], sigs):
            jobs[h - 1].commit.signatures[i].signature = sig
            n_sigs += 1
    cs = jobs[TAMPER_HEIGHT - 1].commit.signatures[TAMPER_VAL]
    cs.signature = flip(cs.signature, 50)
    return jobs, sets, n_sigs, np.asarray(powers), seed_of


def _oracle_outcome(job):
    from cometbft_tpu_torch.types import validation as val

    try:
        val.verify_commit_light(job.chain_id, job.vals, job.block_id,
                                job.height, job.commit,
                                val.oracle_batch_fn())
        return None
    except val.InvalidSignatureError as e:
        return ("InvalidSignatureError", e.idx)
    except val.VerificationError as e:
        return (type(e).__name__,)


def _outcome(err):
    if err is None:
        return None
    return ((type(err).__name__, err.idx) if hasattr(err, "idx")
            else (type(err).__name__,))


def _host_pack_chunk(jobs, M, B, thresh):
    """pack_rows_cached over the native commit pack (the pipeline's host
    pack: sign-bytes built in C from each commit's template and the row's
    timestamp) of one cached stream chunk: the for-block signature of
    validator i in commit c at column c * M + i, dead columns zero."""
    import numpy as np

    from cometbft_tpu_torch import native
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.types import canonical

    pubs, sigs, pos, tmpl, secs, nanos = [], [], [], [], [], []
    for c, job in enumerate(jobs):
        for i, cs in enumerate(job.commit.signatures):
            if cs.for_block():
                pubs.append(job.vals.validators[i].pub_key.data)
                sigs.append(cs.signature)
                pos.append(c * M + i)
                tmpl.append(c)
                secs.append(cs.timestamp.seconds)
                nanos.append(cs.timestamp.nanos)
    templates = [canonical.CanonicalVoteEncoder(
        job.chain_id, canonical.PRECOMMIT_TYPE, job.commit.height,
        job.commit.round, job.commit.block_id).template for job in jobs]
    n = len(pos)
    pos = np.asarray(pos)
    pb = ek.PackedBatch(n, n, *native.ed25519_pack_commits(
        b"".join(pubs), b"".join(sigs), templates, np.asarray(tmpl, np.int32),
        np.asarray(secs, np.int64), np.asarray(nanos, np.int64), n))

    def spread(a):
        a = np.asarray(a)
        out = np.zeros((B,) + a.shape[1:], a.dtype)
        out[pos] = a[:n]
        return out

    live = spread(np.ones(n, bool))
    full = ek.PackedBatch(n, B, None, None, spread(pb.ry), spread(pb.rsign),
                          spread(pb.sdig), spread(pb.hdig),
                          spread(pb.precheck))
    cids = np.where(live, np.arange(B) // M, 0).astype(np.int32)
    return ec.pack_rows_cached(full, live, cids, thresh)


def phase_stream(dev, pool, rng, kernel_stats):
    import numpy as np
    import torch

    from cometbft_tpu_torch import native
    from cometbft_tpu_torch.blocksync import pipeline as bp
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    t0 = time.perf_counter()
    jobs, sets, n_sigs, powers, seed_of = _stream_fixture(pool, rng)
    print(f"phase6 fixtures validators={STREAM_VALS} heights="
          f"{STREAM_HEIGHTS} signatures={n_sigs} keys+signatures_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)

    brk = cbatch.device_breaker()
    real_pack, real_commit_pack = ek.pack_batch, native.ed25519_pack_commits
    packs = []

    def counting_pack(*a, **k):
        packs.append(len(a[0]))
        return real_pack(*a, **k)

    def counting_commit_pack(*a, **k):
        packs.append(len(a[3]))
        return real_commit_pack(*a, **k)

    runs = []  # (seconds, launches, stats, host_ms)
    captured = []  # the delta chunks of the first warm run, in order
    real_delta = es.verify_tally_delta_cached

    def capture_delta(sig, ts, flags, ent, table, n_commits, thresh=None):
        captured.append(dict(sig=sig.copy(), ts=ts.copy(),
                             flags=flags.copy(), ent=ent, table=table,
                             n_commits=n_commits,
                             thresh=np.asarray(thresh).copy()))
        return real_delta(sig, ts, flags, ent, table, n_commits, thresh)

    ek.pack_batch = counting_pack
    native.ed25519_pack_commits = counting_commit_pack
    try:
        for k in range(STREAM_RUNS):
            s0 = ec.table_cache_stats()
            if k == 1:
                es.verify_tally_delta_cached = capture_delta
            zero_launches()
            sv = bp.make_stream_verifier()
            t = time.perf_counter()
            results = sv.verify(jobs)
            runs.append((time.perf_counter() - t, read_launches(),
                         {key: ec.table_cache_stats()[key] - s0[key]
                          for key in s0}, dict(sv.stats)))
            es.verify_tally_delta_cached = real_delta
    finally:
        ek.pack_batch = real_pack
        native.ed25519_pack_commits = real_commit_pack
        es.verify_tally_delta_cached = real_delta
    got = [_outcome(r) for r in results]
    want = [None] * STREAM_HEIGHTS
    want[TAMPER_HEIGHT - 1] = ("InvalidSignatureError", TAMPER_VAL)
    want[SHORT_HEIGHT - 1] = ("NotEnoughPowerError",)
    failed = [(i + 1, g) for i, g in enumerate(got) if g is not None]
    check(got == want, f"stream outcomes by height {failed}")
    sample = [1, TAMPER_HEIGHT, V0_HEIGHTS, V0_HEIGHTS + 1, SHORT_HEIGHT,
              STREAM_HEIGHTS]
    oracle = pool.map(_oracle_outcome, [jobs[h - 1] for h in sample])
    check([got[h - 1] for h in sample] == oracle,
          f"stream != oracle on heights {sample}: {oracle}")
    check(not packs, f"a host pack ran on the stamped path ({packs})")
    for name in ("ed25519_verify", "tally_quorum"):
        kernel_stats[name]["launches_by_path"]["stream"] = runs[0][1][name]
    cold, warm = runs[0], runs[1:]
    want_cold = {"ed25519_verify": 0, "tally_quorum": 0,
                 "valset_table_build": 2, "ed25519_verify_cached": 2,
                 "tally_quorum_cached": 2, "stamp_rows": 2,
                 "sr25519_verify": 0, "ecdsa_verify": 0}
    check(cold[1] == want_cold, f"phase6 cold launches {cold[1]}")
    check(cold[2]["misses"] == 2 and cold[2]["incremental_patches"] == 1,
          f"phase6 cold table lookups {cold[2]}")
    for _, launches, st, _ in warm:
        check(launches == dict(want_cold, valset_table_build=0),
              f"phase6 warm launches {launches}")
        check(st["misses"] == 0, f"phase6 warm table lookups {st}")
    for _, _, _, sst in runs:
        check(sst["stamped_chunks"] == 2 and sst["general_chunks"] == 0
              and sst["host_packed_cached_chunks"] == 0,
              f"phase6 chunk branches {sst}")
    check(brk.trips == 0 and brk.faults == 0,
          f"breaker trips={brk.trips} faults={brk.faults}")
    warm_s = statistics.median(r[0] for r in warm)
    host_ms = [round(x, 3) for r in runs for x in r[3]["host_ms"]]
    print(f"phase6 launches cold={json.dumps(cold[1])} chunks=2 stamped=2 "
          f"host_packs=0 breaker_trips=0 faults=0 blamed_height="
          f"{TAMPER_HEIGHT} idx={TAMPER_VAL} short_height={SHORT_HEIGHT}",
          flush=True)
    print(f"phase6 stream cold_s={cold[0]:.3f} warm_s="
          f"{[round(r[0], 3) for r in warm]} blocks_per_s_cold="
          f"{STREAM_HEIGHTS / cold[0]:.1f} blocks_per_s_warm="
          f"{STREAM_HEIGHTS / warm_s:.1f} sigs_per_s_cold="
          f"{n_sigs / cold[0]:.1f} sigs_per_s_warm={n_sigs / warm_s:.1f} "
          f"host_ms_per_chunk={host_ms}", flush=True)

    # the device's busy share of one warm run, from a profiler trace
    saved = read_launches()
    try:
        busy = trace_device_ms(
            lambda: bp.make_stream_verifier().verify(jobs),
            "stream_trace.json")
    except Exception as e:  # noqa: BLE001 - the trace is a measurement only
        busy = None
        print(f"phase6 profiler failed: {e!r}", flush=True)
    if busy is None:
        print("phase6 device busy share: not measured (no device events in "
              "a trace)", flush=True)
    else:
        kern_ms, copy_ms, wall_ms = busy
        print(f"phase6 traced warm run wall_ms={wall_ms:.3f} kernel_ms="
              f"{kern_ms:.3f} memcpy_ms={copy_ms:.3f} device_idle_share="
              f"{1 - (kern_ms + copy_ms) / wall_ms:.4f}", flush=True)

    # the kernels at the stream's shapes, against their plain versions;
    # stamp_rows at both of its launches
    check(len(captured) == 2, f"{len(captured)} delta chunks captured")
    stamps, first = [], 0
    for chunk in captured:
        tb, en, n_c = chunk["table"], chunk["ent"], chunk["n_commits"]
        Bc = chunk["sig"].shape[0]
        tr = ec.packed_rows_shape(Bc, n_c)[0] - ec.V_THRESH
        args = [torch.from_numpy(chunk[k]).to(dev)
                for k in ("sig", "ts", "flags")]
        thr_t = torch.from_numpy(chunk["thresh"]).to(dev)
        stamp = lambda: es.stamp_rows(  # noqa: E731
            *args, en, tb.pub_raw, thr_t, tr)  # noqa: B023
        sk = stamp()
        t = time.perf_counter()
        rows_p = es.stamp_rows_plain(*args, en.pre_mat, en.pre_len,
                                     en.suf_mat, en.suf_len, en.ts_tag,
                                     tb.pub_raw, thr_t, en.msg_max, tr)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        err = int((sk.to(torch.int64) - rows_p.to(torch.int64)).abs().max())
        check(err == 0, f"stamp_rows != plain at {Bc} columns")
        # the same chunk through the host pack: stamped rows are its bytes
        check(np.array_equal(sk.cpu().numpy(), _host_pack_chunk(
            jobs[first:first + n_c], tb.n_vals, Bc, chunk["thresh"])),
            f"stamped chunk of {Bc} columns != pack_rows_cached of the "
            "host pack")
        live = int((chunk["flags"] & 1).sum())
        blocks = sum(
            es.sha512_blocks(len(m)) for job in jobs[first:first + n_c]
            for m, cs in zip(job.commit.sign_bytes_rows(CHAIN_ID),
                             job.commit.signatures) if cs.for_block())
        st = dict(shape=f"B={Bc},live={live}", rows=sk, plain_ms=plain_ms,
                  err=err, ops=blocks * es.SHA512_OPS_PER_BLOCK,
                  ms=cuda_ms(stamp, 10),
                  device_ms=dev_ms(stamp, f"stamp_rows_{Bc}_trace.json"))
        stamps.append(st)
        print(f"phase6 stamp_rows cols={Bc} live={live} sha512_blocks="
              f"{blocks} kernel_ms={st['ms']:.4f} device_ms="
              f"{fmt_ms(st['device_ms'])} plain_ms={plain_ms:.1f} "
              "kernel==plain==host pack (bytes)", flush=True)
        first += n_c
    rows = stamps[0]["rows"]
    chunk = captured[0]
    table, cap = chunk["table"], chunk["n_commits"]
    live = int((chunk["flags"] & 1).sum())
    M = table.n_vals
    B = chunk["sig"].shape[0]
    t_rows = ec.packed_rows_shape(B, cap)[0] - ec.V_THRESH

    vk = lambda: ec.ed25519_verify_cached(rows, table.tab,  # noqa: E731
                                          table.ok)
    verify_ms = cuda_ms(vk, 5)
    verdicts = vk()
    t = time.perf_counter()
    vp = ec.ed25519_verify_cached_plain(rows, table.tab, table.ok,
                                        ec.kf.base_points(dev))
    torch.cuda.synchronize()
    verify_plain_ms = (time.perf_counter() - t) * 1e3
    verify_err = int((verdicts - vp).abs().max())
    check(verify_err == 0, "ed25519_verify_cached != plain at B=65,536")
    bad = 1 if TAMPER_HEIGHT <= cap else 0  # the planted signature
    check(int(verdicts.sum()) == live - bad,
          "the chunk's valid rows did not all verify")
    verify_dev = dev_ms(vk, "ed25519_verify_cached_stream_trace.json")
    verify_entry = ec.verify_cached_entry(B, ec.sm_count(dev))
    print(f"phase6 ed25519_verify_cached cols={B} M={M} live={live} "
          f"entry={verify_entry} kernel_ms={verify_ms:.4f} "
          f"device_ms={fmt_ms(verify_dev)} plain_ms={verify_plain_ms:.1f} "
          "kernel==plain", flush=True)
    verify_sweep = cached_entry_sweep(dev, rows, table, vp, STREAM_SWEEP,
                                      "phase6")

    tq = lambda: ec.tally_quorum_cached(verdicts, rows,  # noqa: E731
                                        table.power5, cap)
    tally_ms = cuda_ms(tq, 50)
    tally_plain_ms = cuda_ms(lambda: ec.tally_quorum_cached_plain(
        verdicts, rows, table.power5, cap), 3)
    tk, qk = tq()
    tp, qp = ec.tally_quorum_cached_plain(verdicts, rows, table.power5, cap)
    tally_err = max(int((tk - tp).abs().max()), int((qk != qp).sum()))
    check(tally_err == 0, "tally_quorum_cached != plain at the chunk shape")
    # the same verdicts and rows with more commits than the kernel keeps in
    # shared memory (its global-atomics branch): commit ids in runs of 128
    # columns over 2 * TALLY_SMEM_COMMITS + 1 commits, thresholds at each
    # exact sum - 1, the sum and the sum + 1
    big_c = 2 * ec.kf.TALLY_SMEM_COMMITS + 1
    big = rows.clone()
    col = torch.arange(B, dtype=torch.int32, device=dev)
    big[ec.V_FLAGS] = (rows[ec.V_FLAGS] & 7) | (((col // 128) % big_c) << 3)
    big_sums = [int(x) for x in ek.tally_to_int(ec.tally_quorum_cached_plain(
        verdicts, big, table.power5, big_c)[0].cpu().numpy())]
    big_thr = [max(0, x + c % 3 - 1) for c, x in enumerate(big_sums)]
    big[ec.V_THRESH:].reshape(-1)[:big_c * 6] = torch.from_numpy(np.stack(
        [ek.threshold_limbs(t)[0] for t in big_thr]).reshape(-1)).to(dev)
    tk, qk = ec.tally_quorum_cached(verdicts, big, table.power5, big_c)
    tp, qp = ec.tally_quorum_cached_plain(verdicts, big, table.power5, big_c)
    big_err = max(int((tk - tp).abs().max()), int((qk != qp).sum()))
    check(big_err == 0 and qk.cpu().tolist() == [
        s > t for s, t in zip(big_sums, big_thr)],
        f"tally_quorum_cached != plain at {big_c} commits")
    tally_err = max(tally_err, big_err)
    print(f"phase6 tally_quorum_cached cols={B} commits={big_c} (above the "
          f"shared-memory cap of {ec.kf.TALLY_SMEM_COMMITS}) kernel==plain",
          flush=True)
    flags = rows[ec.V_FLAGS].to(torch.int64)
    pw = table.power5[torch.arange(B, device=dev) % M].to(torch.int64)
    contrib = pw * ((verdicts != 0) & (((flags >> 2) & 1) != 0)).to(
        torch.int64)[:, None]
    acc = torch.zeros((cap, 5), dtype=torch.int64, device=dev)
    cids = flags >> 3
    library = lambda: acc.index_add_(0, cids, contrib)  # noqa: E731
    tally_lib_ms = cuda_ms(library, 50)
    tally_dev = device_ms(tq, DEVICE_REPS, "tally_quorum_cached_trace.json")
    tally_lib_dev = device_ms(library, DEVICE_REPS,
                              "index_add_stream_trace.json")
    print(f"phase6 tally_quorum_cached cols={B} commits={cap} "
          f"kernel_ms={tally_ms:.5f} plain_ms={tally_plain_ms:.3f} "
          f"index_add_ms={tally_lib_ms:.5f} "
          f"{device_line(tally_dev, tally_lib_dev)}", flush=True)

    lenok = torch.ones((M,), dtype=torch.bool, device=dev)
    lenok[STREAM_VALS:] = False
    build = lambda: ec.valset_table_build(table.pub_raw, lenok)  # noqa
    build_ms = cuda_ms(build, 3)
    tab_k, ok_k = build()
    t = time.perf_counter()
    tab_p, ok_p = ec.valset_table_build_plain(table.pub_raw, lenok)
    torch.cuda.synchronize()
    build_plain_ms = (time.perf_counter() - t) * 1e3
    build_err = int((tab_k - tab_p).abs().max())
    check(build_err == 0 and torch.equal(ok_k, ok_p)
          and torch.equal(tab_k, table.tab),
          "valset_table_build != plain (or != the cached table) at M=1,024")
    v1_pubs = [v.pub_key.data for v in sets[1].validators]
    update_ms = []
    for _ in range(3):
        t = time.perf_counter()
        patched = ec.update_table(table, [(i, v1_pubs[i]) for i in ROTATED])
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t) * 1e3)
    check(torch.equal(patched.tab, ec.table_for_valset(sets[1]).tab),
          "update_table != the stream's V1 table")
    build_dev = dev_ms(build, "valset_table_build_1024_trace.json")
    sms = ec.sm_count(dev)
    table_sweep = table_entry_sweep(table.pub_raw, lenok, (tab_p, ok_p),
                                    "phase6")
    del tab_k, tab_p
    # update_table's delta: the 8 rotated keys in UPDATE_PAD = 128 slots,
    # the same inputs update_table hands the wrapper
    d_raw, d_len = ec._pack_pub_arrays([v1_pubs[i] for i in ROTATED],
                                       ec.UPDATE_PAD)
    d_pub = torch.from_numpy(d_raw).to(dev)
    d_len = torch.from_numpy(d_len).to(dev)
    delta = lambda: ec.valset_table_build(d_pub, d_len)  # noqa: E731
    delta_dev = dev_ms(delta, "valset_table_build_128_trace.json")
    d_tab, d_ok = ec.valset_table_build_plain(d_pub, d_len)
    check(torch.equal(patched.tab.view(M, -1)[list(ROTATED)],
                      d_tab.view(ec.UPDATE_PAD, -1)[:len(ROTATED)]),
          "update_table's columns != the plain delta build")
    for entry, times in table_entry_sweep(d_pub, d_len, (d_tab, d_ok),
                                          "phase6").items():
        table_sweep[entry].update(times)
    print(f"phase6 valset_table_build M={M} entry="
          f"{ec.table_build_entry(M, sms)} kernel_ms={build_ms:.3f} "
          f"device_ms={fmt_ms(build_dev)} "
          f"plain_ms={build_plain_ms:.1f}; update delta M={ec.UPDATE_PAD} "
          f"entry={ec.table_build_entry(ec.UPDATE_PAD, sms)} device_ms="
          f"{fmt_ms(delta_dev)} update_table_8_keys_ms="
          f"{[round(x, 3) for x in update_ms]}", flush=True)
    restore_launches(saved)

    kernel_stats["valset_table_build"] = dict(
        launches_by_path={"stream": cold[1]["valset_table_build"]},
        ms=build_ms, plain_ms=build_plain_ms, max_abs_err=build_err,
        ops=M * ec.build_products_per_validator(),
        bytes=M * (32 + 1) + M * (ec.ENT_PER_VAL * 120 + 1), library_ms=None,
        device_ms=build_dev,
        device_ms_by_shape={f"M={ec.UPDATE_PAD}": delta_dev,
                            f"M={M}": build_dev},
        entry_by_shape={
            f"M={m}": ec.table_build_entry(m, sms)
            for m in (ec.UPDATE_PAD, M)},
        sweep_device_ms=table_sweep)
    kernel_stats["ed25519_verify_cached"] = dict(
        launches_by_path={"stream": cold[1]["ed25519_verify_cached"]},
        ms=verify_ms, plain_ms=verify_plain_ms, max_abs_err=verify_err,
        ops=live * ec.verify_cached_products_per_signature(),
        bytes=(B * (ec.V_KROWS * 4 + 4) + M * (ec.ENT_PER_VAL * 120 + 1)
               + 8192 * 120),
        library_ms=None, device_ms=verify_dev,
        device_ms_by_shape={f"{B}x{M}": verify_dev},
        entry_by_shape={f"{B}x{M}": verify_entry},
        sweep_device_ms=verify_sweep)
    kernel_stats["tally_quorum_cached"] = dict(
        launches_by_path={"stream": cold[1]["tally_quorum_cached"]},
        ms=tally_ms, plain_ms=tally_plain_ms, max_abs_err=tally_err,
        ops=B * 6, bytes=B * 8 + M * 20 + cap * (6 * 4 * 2 + 1),
        library_ms=tally_lib_ms, device_ms=tally_dev and tally_dev[0],
        library_device_ms=tally_lib_dev and tally_lib_dev[0])
    kernel_stats["stamp_rows"] = dict(
        launches_by_path={"stream": cold[1]["stamp_rows"]},
        ms=stamps[0]["ms"], plain_ms=stamps[0]["plain_ms"],
        max_abs_err=max(st["err"] for st in stamps), ops=stamps[0]["ops"],
        bytes=B * (64 + 12 + 4) + M * 32 + (ec.V_THRESH + t_rows) * B * 4,
        library_ms=None, device_ms=stamps[0]["device_ms"],
        **{f"{key}_by_shape": {st["shape"]: st[key] for st in stamps}
           for key in ("device_ms", "ms", "ops")})
    return {"stream_blocks_per_s": STREAM_HEIGHTS / warm_s,
            "stream_sigs_per_s": n_sigs / warm_s,
            "stream_sets": sets, "stream_seed_of": seed_of,
            # the 16-commit chunk (16,384 columns) phase 17 shards
            "stream_chunk": (stamps[1]["rows"], captured[1]["table"],
                             captured[1]["n_commits"],
                             captured[1]["thresh"])}


def phase_cached_commit(dev, res, kernel_stats):
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.types import validation as val

    vs, bid, height, commit = res["fixture"]
    fn = val.device_batch_fn(cached=True)
    brk = cbatch.device_breaker()
    captured = []  # (rows, table) of the clean and the tampered call
    real_rows = ec.verify_rows_cached

    def capture_rows(rows, table):
        captured.append((rows, table))
        return real_rows(rows, table)

    ec.verify_rows_cached = capture_rows
    try:
        zero_launches()
        t = time.perf_counter()
        val.verify_commit(CHAIN_ID, vs, bid, height, commit, fn)
        cold_ms = (time.perf_counter() - t) * 1e3
        warm_ms = []
        for _ in range(CACHED_RUNS):
            t = time.perf_counter()
            val.verify_commit(CHAIN_ID, vs, bid, height, commit, fn)
            warm_ms.append((time.perf_counter() - t) * 1e3)
        good = commit.signatures[TAMPER_IDX].signature
        commit.signatures[TAMPER_IDX].signature = flip(good, 40)
        try:
            val.verify_commit(CHAIN_ID, vs, bid, height, commit, fn)
            blamed = None
        except val.InvalidSignatureError as e:
            blamed = e.idx
        commit.signatures[TAMPER_IDX].signature = good
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        ec.verify_rows_cached = real_rows
    check(blamed == TAMPER_IDX, f"cached verify_commit blamed {blamed}")
    want = {"ed25519_verify": 0, "tally_quorum": 0, "valset_table_build": 1,
            "ed25519_verify_cached": CACHED_RUNS + 2,
            "tally_quorum_cached": 0, "stamp_rows": 0,
            "sr25519_verify": 0, "ecdsa_verify": 0}
    check(launches == want, f"phase7 launches {launches}")
    check(brk.trips == 0 and brk.faults == 0,
          f"breaker trips={brk.trips} faults={brk.faults}")
    p50 = statistics.median(warm_ms)
    check(len(captured) == CACHED_RUNS + 2,
          f"phase7 verify_rows_cached calls {len(captured)}")

    # the path's host pack of the commit (10,000 rows in 10,240 columns):
    # the native pack's p50, the plain pack once, held equal, and the rows
    # of the path's clean call equal to them
    pubs = [v.pub_key.data for v in vs.validators]
    msgs = commit.sign_bytes_rows(CHAIN_ID)
    sigs = [cs.signature for cs in commit.signatures]

    def pack(native=True):
        return ec.pack_rows_cached(ek.pack_batch(
            pubs, msgs, sigs, pad_to=ec.pad_rows(N_VALS), native=native))

    pack_ms = []
    for _ in range(CACHED_RUNS):
        t = time.perf_counter()
        rows_n = pack()
        pack_ms.append((time.perf_counter() - t) * 1e3)
    plain_pack_ms = plain_pack_equals("the cached commit's rows", pack,
                                      rows_n)
    check(np.array_equal(rows_n, captured[0][0]),
          "phase7: the path's rows != the native pack of the commit")

    # the kernels at this path's shapes, against their plain versions: the
    # verify kernel on the rows of the clean and the tampered call
    table = captured[0][1]
    M = table.n_vals
    verify_err = 0
    for (rows_np, tb), n_valid in ((captured[0], N_VALS),
                                   (captured[-1], N_VALS - 1)):
        check(tb is table, "phase7 calls used different tables")
        rows = torch.from_numpy(rows_np).to(dev)
        got = ec.ed25519_verify_cached(rows, table.tab, table.ok)
        want = ec.ed25519_verify_cached_plain(rows, table.tab, table.ok,
                                              ec.kf.base_points(dev))
        verify_err = max(verify_err, int((got - want).abs().max()))
        check(int(got.sum()) == n_valid, "phase7 verdicts: valid count")
    check(verify_err == 0,
          f"ed25519_verify_cached != plain at {rows.shape[1]} columns, M={M}")
    vk = lambda: ec.ed25519_verify_cached(rows, table.tab,  # noqa: E731
                                          table.ok)
    verify_ms = cuda_ms(vk, 5)
    verify_dev = dev_ms(vk, "ed25519_verify_cached_commit_trace.json")
    verify_entry = ec.verify_cached_entry(rows.shape[1], ec.sm_count(dev))
    verify_sweep = cached_entry_sweep(dev, rows, table, want,
                                      (rows.shape[1],), "phase7")
    # the M = 16,384 table build, kernel and plain, against the cached table
    lenok = torch.ones((M,), dtype=torch.bool, device=dev)
    lenok[N_VALS:] = False
    build = lambda: ec.valset_table_build(table.pub_raw, lenok)  # noqa
    build16k_ms = cuda_ms(build, 2)
    build16k_dev = dev_ms(build, f"valset_table_build_{M}_trace.json")
    tab_k, ok_k = ec.valset_table_build(table.pub_raw, lenok)
    tab_p, ok_p = ec.valset_table_build_plain(table.pub_raw, lenok)
    build_err = int((tab_k - tab_p).abs().max())
    check(build_err == 0 and torch.equal(ok_k, ok_p)
          and torch.equal(tab_k, table.tab),
          "valset_table_build != plain (or != the cached table) at M=16,384")
    del tab_k
    table_sweep = table_entry_sweep(table.pub_raw, lenok, (tab_p, ok_p),
                                    "phase7")
    for m in TABLE_CROSS_SWEEP:
        for entry, times in table_entry_sweep(
                table.pub_raw[:m], lenok[:m], (tab_p[:m * 128], ok_p[:m]),
                "phase7").items():
            table_sweep[entry].update(times)
    del tab_p
    restore_launches(launches)
    for name, err, shape, t in (
            ("valset_table_build", build_err, f"M={M}", build16k_dev),
            ("ed25519_verify_cached", verify_err, f"{rows.shape[1]}x{M}",
             verify_dev)):
        k = kernel_stats[name]
        k["launches_by_path"]["verify_commit_cached"] = launches[name]
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["device_ms_by_shape"][shape] = t
    k = kernel_stats["ed25519_verify_cached"]
    k["entry_by_shape"][f"{rows.shape[1]}x{M}"] = verify_entry
    merge_sweep(k, verify_sweep)
    k = kernel_stats["valset_table_build"]
    k["entry_by_shape"][f"M={M}"] = ec.table_build_entry(M, ec.sm_count(dev))
    merge_sweep(k, table_sweep)
    print(f"phase7 launches {json.dumps(launches)} breaker_trips=0 faults=0 "
          f"blamed_idx={TAMPER_IDX}", flush=True)
    rate = int_ops_per_s()[1]
    verify_bound = (N_VALS * ec.verify_cached_products_per_signature()
                    / rate * 1e3)
    build_bound = M * ec.build_products_per_validator() / rate * 1e3
    print(f"phase7 ed25519_verify_cached cols={rows.shape[1]} M={M} "
          f"entry={verify_entry} kernel_ms={verify_ms:.4f} "
          f"device_ms={fmt_ms(verify_dev)} ops_bound_ms={verify_bound:.4f} "
          "kernel==plain (clean and tampered rows); valset_table_build "
          f"M={M} entry={ec.table_build_entry(M, ec.sm_count(dev))} "
          f"kernel_ms={build16k_ms:.3f} device_ms="
          f"{fmt_ms(build16k_dev)} ops_bound_ms={build_bound:.4f} "
          "kernel==plain==cached table", flush=True)
    print(f"phase7 cached VerifyCommit n_sigs={N_VALS} M={M} "
          f"cold_ms={cold_ms:.3f} p50_ms={p50:.3f} sigs_per_s="
          f"{N_VALS / (p50 / 1e3):.1f} "
          f"host_pack_p50_ms={statistics.median(pack_ms):.3f} "
          f"plain_host_pack_p50_ms={plain_pack_ms:.3f} runs={CACHED_RUNS} "
          f"all_ms={[round(x, 3) for x in warm_ms]} native pack == plain "
          "pack == the path's rows", flush=True)
    return {"cached_p50_ms": p50, "cached_sigs_per_s": N_VALS / (p50 / 1e3)}


def phase_new_kernels_vs_plain(dev, pool, rng):
    import numpy as np
    import torch

    from cometbft_tpu_torch import edge_cases
    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.ops import ecdsa_kernel as eck
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import sr25519_kernel as srk

    saved = read_launches()
    # sr25519_verify on 256 columns: 200 signed rows and every edge case
    pubs, msgs, sigs = edge_cases.sr25519_cases(rng, n_valid=200)
    n = len(pubs)
    check(128 < n <= 256, f"phase8 sr25519 fixture has {n} rows")
    oracle = oracle_verdicts(pool, "sr25519", pubs, msgs, sigs)
    rows = torch.from_numpy(srk.pack_batch_sr(pubs, msgs, sigs,
                                              pad_to=256)).to(dev)
    got_k = srk.sr25519_verify(rows).cpu().numpy()
    got_p = srk.sr25519_verify_plain(rows, kf.base_points(dev)).cpu().numpy()
    check(np.array_equal(got_k, got_p), "sr25519_verify != plain on 256 cols")
    check(np.array_equal(got_k[:n].astype(bool), oracle),
          "sr25519_verify != sr25519_ref oracle")
    check(not got_k[n:].any(), "an sr25519 padding column verified")
    check(oracle[:200].all() and oracle[-1] and not oracle[200:-1].any(),
          "phase8 sr25519 edge cases do not split as built")
    print(f"phase8 sr25519_verify cols=256 rows={n} valid={int(oracle.sum())}"
          f" edge_cases={n - 200} kernel==plain==oracle", flush=True)

    # ecdsa_verify on 256 columns: 200 signed rows and every edge case
    pubs, msgs, sigs = edge_cases.ecdsa_cases(rng, n_valid=200)
    n = len(pubs)
    check(128 < n <= 256, f"phase8 ecdsa fixture has {n} rows")
    oracle = oracle_verdicts(pool, "secp256k1", pubs, msgs, sigs)
    pb = eck.pack_batch(pubs, msgs, sigs, pad_to=256)
    check(int(pb.precheck[n - 2]) == 1 and not np.array_equal(
        pb.xr1[n - 2], pb.xr2[n - 2]), "the xr2 case packs no r + N")
    rows = torch.from_numpy(ef.pack_rows(pb)).to(dev)
    got_k = ef.ecdsa_verify(rows).cpu().numpy()
    got_p = ef.ecdsa_verify_plain(rows, ef.base_points(dev)).cpu().numpy()
    check(np.array_equal(got_k, got_p), "ecdsa_verify != plain on 256 cols")
    check(np.array_equal(got_k[:n].astype(bool), oracle),
          "ecdsa_verify != secp256k1_ref.verify_py oracle")
    check(not got_k[n:].any(), "an ECDSA padding column verified")
    check(oracle[:200].all() and oracle[-1] and oracle[-2]
          and not oracle[200:-2].any(),
          "phase8 ECDSA edge cases do not split as built")
    restore_launches(saved)
    print(f"phase8 ecdsa_verify cols=256 rows={n} valid={int(oracle.sum())} "
          f"edge_cases={n - 200} xr2_branch_valid=1 kernel==plain==oracle",
          flush=True)


def group_split_times(dev, kind, pubs, msgs, sigs, runs):
    """Host pack ms (host clock) and device ms (CUDA events around upload,
    kernel and download) of `runs` batches of one key-type group, through
    the calls its verify_batch makes; for an ed25519 or sr25519 group, also
    the plain host pack's ms, once, its rows held equal to the native
    pack's (None for secp256k1, whose pack has no native route)."""
    import torch

    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.ops import ecdsa_kernel as eck
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import sr25519_kernel as srk

    n = len(pubs)

    def pack(native=True):
        if kind == "sr25519":
            return srk.pack_batch_sr(pubs, msgs, sigs, native=native)
        if kind == "secp256k1":
            return ef.pack_rows(eck.pack_batch(pubs, msgs, sigs,
                                               pad_to=ef.pad_to_tile(n)))
        return kf.pack_rows(ek.pack_batch(pubs, msgs, sigs, native=native,
                                          pad_to=kf.pad_to_tile(n)))

    verify = {"sr25519": srk.verify_rows,
              "secp256k1": ef.verify_rows}.get(kind, kf.verify_rows)
    pack_ms, dev_ms = [], []
    for _ in range(runs):
        t = time.perf_counter()
        rows = pack()
        pack_ms.append((time.perf_counter() - t) * 1e3)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        valid = verify(rows, dev).cpu().numpy()
        b.record()
        b.synchronize()
        dev_ms.append(a.elapsed_time(b))
        check(valid[:n].all() and not valid[n:].any(),
              f"split-time {kind} batch of {n} verified wrongly")
    plain_ms = (None if kind == "secp256k1" else
                plain_pack_equals(f"{n} {kind} rows", pack, rows))
    return pack_ms, dev_ms, rows, plain_ms


class capture_verify_rows:
    """While the block runs, record the packed rows of every verify_rows
    call of the given modules, in call order: {name: [rows, ...]}."""

    def __init__(self, **modules):
        self.modules = modules
        self.seen = {name: [] for name in modules}

    def __enter__(self):
        self.real = {name: m.verify_rows for name, m in self.modules.items()}
        for name, m in self.modules.items():
            m.verify_rows = self._recorder(name)
        return self.seen

    def _recorder(self, name):
        def rec(rows, device=None):
            self.seen[name].append(rows)
            return self.real[name](rows, device)
        return rec

    def __exit__(self, *exc):
        for name, m in self.modules.items():
            m.verify_rows = self.real[name]


def hold_shapes_against_plain(dev, kernel, plain, captured):
    """Run `kernel` and `plain` on the first (clean) and the last
    (tampered) rows of each column count in `captured`, the rows a path
    launched its kernel on; -> (max |kernel - plain|, [column counts])."""
    import torch

    by_cols: dict = {}
    for rows in captured:
        by_cols.setdefault(rows.shape[1], []).append(rows)
    err = 0
    for batches in by_cols.values():
        for rows_np in {id(r): r for r in (batches[0], batches[-1])}.values():
            rows = torch.as_tensor(rows_np).to(dev)
            err = max(err, int((kernel(rows) - plain(rows)).abs().max()))
    return err, sorted(by_cols)


def phase_mixed_commit(dev, pool, rng, kernel_stats):
    """BASELINE config 3: a 10,000-validator commit, half ed25519 and half
    sr25519."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import sr25519_kernel as srk
    from cometbft_tpu_torch.types import validation as val

    t0 = time.perf_counter()
    half = MIXED_VALS // 2
    kinds = ["ed25519"] * half + ["sr25519"] * (MIXED_VALS - half)
    vs, key_of = make_typed_valset(pool, rng, kinds,
                                   [VAL_POWER] * MIXED_VALS)
    bid = block_id(rng)
    height = 2_000_003
    commit = unsigned_commit(vs, height, bid, 1_700_100_000)
    sign_commit_typed(pool, commit, key_of)
    types = [v.pub_key.key_type for v in vs.validators]
    groups = {k: [i for i, t in enumerate(types) if t == k]
              for k in ("ed25519", "sr25519")}
    tamper = next(i for i in groups["sr25519"] if i >= TAMPER_IDX)
    print(f"phase9 fixtures validators={MIXED_VALS} ed25519="
          f"{len(groups['ed25519'])} sr25519={len(groups['sr25519'])} "
          f"keys+signatures_s={time.perf_counter() - t0:.3f}", flush=True)

    fn = val.device_batch_fn()
    brk = cbatch.device_breaker()
    with capture_verify_rows(ed25519=kf, sr25519=srk) as path_rows:
        zero_launches()
        light_ms, full_ms = [], []
        for _ in range(MIXED_RUNS):
            t = time.perf_counter()
            val.verify_commit_light(CHAIN_ID, vs, bid, height, commit, fn)
            light_ms.append((time.perf_counter() - t) * 1e3)
        for _ in range(MIXED_RUNS):
            t = time.perf_counter()
            val.verify_commit(CHAIN_ID, vs, bid, height, commit, fn)
            full_ms.append((time.perf_counter() - t) * 1e3)
        good = commit.signatures[tamper].signature
        commit.signatures[tamper].signature = flip(good, 40)
        blamed = []
        for verify in (val.verify_commit, val.verify_commit_light):
            try:
                verify(CHAIN_ID, vs, bid, height, commit, fn)
                blamed.append(None)
            except val.InvalidSignatureError as e:
                blamed.append(e.idx)
        commit.signatures[tamper].signature = good
        torch.cuda.synchronize()
        launches = read_launches()
    calls = 2 * MIXED_RUNS + 2
    want = dict.fromkeys(launches, 0)
    want.update(ed25519_verify=calls, sr25519_verify=calls)
    check(launches == want, f"phase9 launches {launches}, want {want}")
    check(blamed == [tamper, tamper],
          f"tampered sr25519 signature blamed at {blamed}, want {tamper}")
    check(brk.trips == 0 and brk.faults == 0,
          f"breaker trips={brk.trips} faults={brk.faults}")
    print(f"phase9 launches {json.dumps(launches)} breaker_trips=0 faults=0 "
          f"blamed_idx={tamper} (sr25519)", flush=True)
    full_p50 = statistics.median(full_ms)
    print(f"phase9 mixed VerifyCommitLight p50_ms="
          f"{statistics.median(light_ms):.3f} all_ms="
          f"{[round(x, 3) for x in light_ms]}", flush=True)
    print(f"phase9 mixed VerifyCommit n_sigs={MIXED_VALS} p50_ms="
          f"{full_p50:.3f} sigs_per_s={MIXED_VALS / (full_p50 / 1e3):.1f} "
          f"all_ms={[round(x, 3) for x in full_ms]}", flush=True)
    msgs_all = commit.sign_bytes_rows(CHAIN_ID)
    for kind, idxs in groups.items():
        pubs = [vs.validators[i].pub_key.data for i in idxs]
        msgs = [msgs_all[i] for i in idxs]
        sigs = [commit.signatures[i].signature for i in idxs]
        pack, devt, rows, plain = group_split_times(dev, kind, pubs, msgs,
                                                    sigs, MIXED_RUNS)
        part = ""
        if kind == "sr25519":  # the native merlin challenges' share, once
            t = time.perf_counter()
            srk.batch_challenges(msgs, pubs, [s[:32] for s in sigs])
            part = ("of_which_challenges_ms="
                    f"{(time.perf_counter() - t) * 1e3:.3f} ")
        print(f"phase9 group {kind} n_sigs={len(idxs)} padded="
              f"{rows.shape[1]} host_pack_p50_ms={statistics.median(pack):.3f}"
              f" {part}plain_host_pack_p50_ms={plain:.3f} device_p50_ms="
              f"{statistics.median(devt):.3f} native pack == plain pack",
              flush=True)
    restore_launches(launches)

    # the fused form: each group's rows through its verify_tally_rows, the
    # two tallies summed on the host (a 6-limb add)
    total = vs.total_voting_power()
    need = total * 2 // 3
    fused_rows = {}
    for kind, idxs in groups.items():
        n = len(idxs)
        pad = kf.pad_to_tile(n)
        power5 = np.zeros((pad, ek.POWER_LIMBS), np.int32)
        power5[:n] = ek.power_limbs(np.asarray(
            [vs.validators[i].voting_power for i in idxs], np.int64))
        args = ([vs.validators[i].pub_key.data for i in idxs],
                [msgs_all[i] for i in idxs],
                [commit.signatures[i].signature for i in idxs])
        meta = dict(power5=power5, counted=np.arange(pad) < n,
                    commit_ids=np.zeros(pad, np.int32),
                    thresh=ek.threshold_limbs(1))
        if kind == "sr25519":
            fused_rows[kind] = srk.pack_batch_sr(*args, pad_to=pad, **meta)
        else:
            fused_rows[kind] = kf.pack_rows(
                ek.pack_batch(*args, pad_to=pad), meta["power5"],
                meta["counted"], meta["commit_ids"], meta["thresh"])
    zero_launches()
    step_ms = []
    for _ in range(MIXED_RUNS):
        t = time.perf_counter()
        out_ed = kf.verify_tally_rows(fused_rows["ed25519"], 1, dev)
        out_sr = srk.verify_tally_rows(fused_rows["sr25519"], 1, dev)
        tallies = [out_ed[1].cpu().numpy(), out_sr[1].cpu().numpy()]
        v_ed, v_sr = out_ed[0].cpu().numpy(), out_sr[0].cpu().numpy()
        step_ms.append((time.perf_counter() - t) * 1e3)
    fused_launches = read_launches()
    want = dict.fromkeys(fused_launches, 0)
    want.update(ed25519_verify=MIXED_RUNS, sr25519_verify=MIXED_RUNS,
                tally_quorum=2 * MIXED_RUNS)
    check(fused_launches == want, f"phase9 fused launches {fused_launches}")
    summed = sum(int(ek.tally_to_int(t)[0]) for t in tallies)
    check(summed == total, f"phase9 fused tallies sum to {summed}, want "
          f"the total power {total}")
    check(summed > need, "phase9 fused quorum does not hold")
    check(v_ed[:len(groups["ed25519"])].all()
          and v_sr[:len(groups["sr25519"])].all(), "phase9 fused verdicts")
    # each group's (tally, quorum) against the plain tally of the same
    # verdicts and rows (one commit over 16,384 columns)
    tally_err = 0
    for kind, (valid, tally, quorum) in (("ed25519", out_ed),
                                         ("sr25519", out_sr)):
        rows = torch.from_numpy(fused_rows[kind]).to(dev)
        t_plain, q_plain = kf.tally_quorum_plain(valid, rows, 1)
        tally_err = max(tally_err, int((tally - t_plain).abs().max()),
                        int((quorum.int() - q_plain.int()).abs().max()))
    check(tally_err == 0, "phase9 fused tally_quorum != plain")
    print(f"phase9 fused launches {json.dumps(fused_launches)} step_p50_ms="
          f"{statistics.median(step_ms):.3f} tally_sum={summed} == total "
          f"power, quorum={summed > need}, tally_quorum==plain per group "
          f"cols={fused_rows['sr25519'].shape[1]}", flush=True)

    # both verify kernels on the rows the light and full calls launched them
    # on (clean and tampered), against their plain versions
    points = kf.base_points(dev)
    ed_err, ed_cols = hold_shapes_against_plain(
        dev, kf.ed25519_verify,
        lambda r: kf.ed25519_verify_plain(r, points), path_rows["ed25519"])
    err, sr_cols = hold_shapes_against_plain(
        dev, srk.sr25519_verify,
        lambda r: srk.sr25519_verify_plain(r, points), path_rows["sr25519"])
    check(ed_err == 0, f"ed25519_verify != plain at {ed_cols} cols")
    check(err == 0, f"sr25519_verify != plain at {sr_cols} cols")
    check(len(path_rows["sr25519"]) == launches["sr25519_verify"]
          and len(path_rows["ed25519"]) == launches["ed25519_verify"],
          "phase9 captured rows do not match the launches")
    # sr25519_verify timed at this path's widest shape (the full call's)
    # and at the light call's
    rows = torch.as_tensor(path_rows["sr25519"][MIXED_RUNS]).to(dev)
    ms = cuda_ms(lambda: srk.sr25519_verify(rows), 10)
    sr_dev = dev_ms(lambda: srk.sr25519_verify(rows),
                    "sr25519_verify_trace.json")
    rows_l = torch.as_tensor(path_rows["sr25519"][0]).to(dev)
    n_sr_light = int(((rows_l[kf.C_FLAGS] >> 2) & 1).sum())
    check(rows_l.shape[1] == min(sr_cols),
          f"the light call's sr25519 rows have {rows_l.shape[1]} cols")
    sr_dev_light = dev_ms(lambda: srk.sr25519_verify(rows_l),
                          "sr25519_verify_light_trace.json")
    t = time.perf_counter()
    plain = srk.sr25519_verify_plain(rows, points)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    out = srk.sr25519_verify(rows)
    restore_launches(launches)
    n_sr = len(groups["sr25519"])
    check(rows.shape[1] == max(sr_cols) and torch.equal(out, plain),
          f"sr25519_verify != plain at {rows.shape[1]} cols")
    check(int(out.sum()) == n_sr, "not every sr25519 signature verified")
    kernel_stats["sr25519_verify"] = dict(
        launches_by_path={"mixed_commit": launches["sr25519_verify"],
                          "mixed_fused": fused_launches["sr25519_verify"]},
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        ops=n_sr * srk.verify_products_per_signature(),
        bytes=rows.shape[1] * (kf.C_KROWS + 1) * 4 + 8192 * 3 * 10 * 4,
        library_ms=None, device_ms=sr_dev,
        device_ms_by_live={n_sr: sr_dev, n_sr_light: sr_dev_light})
    for name, e in (("ed25519_verify", ed_err), ("tally_quorum", tally_err)):
        k = kernel_stats[name]
        k["launches_by_path"]["mixed_commit"] = launches[name]
        k["launches_by_path"]["mixed_fused"] = fused_launches[name]
        k["max_abs_err"] = max(k["max_abs_err"], e)
    print(f"phase9 sr25519_verify cols={rows.shape[1]} live={n_sr} "
          f"kernel_ms={ms:.4f} device_ms={fmt_ms(sr_dev)}; cols="
          f"{rows_l.shape[1]} live={n_sr_light} device_ms="
          f"{fmt_ms(sr_dev_light)}; "
          f"plain_ms={plain_ms:.1f}; kernel==plain for "
          f"ed25519_verify at cols={ed_cols} and sr25519_verify at cols="
          f"{sr_cols} (clean and tampered rows of the path)", flush=True)
    return {"mixed_light_p50_ms": statistics.median(light_ms),
            "mixed_sigs_per_s": MIXED_VALS / (full_p50 / 1e3)}


def phase_light_secp(dev, pool, rng, kernel_stats):
    """BASELINE config 5's verification core: the two commit checks
    light/verifier.verify_non_adjacent makes, on a 10,000-validator
    secp256k1 set."""
    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.types import validation as val

    t0 = time.perf_counter()
    vs, key_of = make_typed_valset(pool, rng, ["secp256k1"] * LC_VALS,
                                   [VAL_POWER] * LC_VALS)
    bid = block_id(rng)
    height = 3_000_005
    commit = unsigned_commit(vs, height, bid, 1_700_200_000)
    sign_commit_typed(pool, commit, key_of)
    print(f"phase10 fixtures validators={LC_VALS} secp256k1 "
          f"keys+signatures_s={time.perf_counter() - t0:.3f}", flush=True)

    def pair():
        val.verify_commit_light_trusting(CHAIN_ID, vs, commit, (1, 3), fn)
        val.verify_commit_light(CHAIN_ID, vs, bid, height, commit, fn)

    fn = val.device_batch_fn()
    brk = cbatch.device_breaker()
    with capture_verify_rows(secp256k1=ef) as path_rows:
        zero_launches()
        pair_ms = []
        for _ in range(LC_RUNS):
            t = time.perf_counter()
            pair()
            pair_ms.append((time.perf_counter() - t) * 1e3)
        good = commit.signatures[LC_TAMPER_IDX].signature
        commit.signatures[LC_TAMPER_IDX].signature = flip(good, 40)
        blamed = []
        for call in (lambda: val.verify_commit_light_trusting(
                         CHAIN_ID, vs, commit, (1, 3), fn),
                     lambda: val.verify_commit_light(CHAIN_ID, vs, bid,
                                                     height, commit, fn)):
            try:
                call()
                blamed.append(None)
            except val.InvalidSignatureError as e:
                blamed.append(e.idx)
        commit.signatures[LC_TAMPER_IDX].signature = good
        torch.cuda.synchronize()
        launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want.update(ecdsa_verify=2 * LC_RUNS + 2)
    check(launches == want, f"phase10 launches {launches}, want {want}")
    check(blamed == [LC_TAMPER_IDX, LC_TAMPER_IDX],
          f"tampered secp256k1 signature blamed at {blamed}")
    check(brk.trips == 0 and brk.faults == 0,
          f"breaker trips={brk.trips} faults={brk.faults}")
    print(f"phase10 launches {json.dumps(launches)} breaker_trips=0 faults=0"
          f" blamed_idx={LC_TAMPER_IDX}", flush=True)
    total = vs.total_voting_power()
    n_trust = total // 3 // VAL_POWER + 1
    n_light = total * 2 // 3 // VAL_POWER + 1
    msgs_all = commit.sign_bytes_rows(CHAIN_ID)
    for name, n in (("trusting", n_trust), ("light", n_light)):
        pack, devt, rows, _ = group_split_times(
            dev, "secp256k1", [v.pub_key.data for v in vs.validators[:n]],
            msgs_all[:n], [cs.signature for cs in commit.signatures[:n]],
            LC_RUNS)
        print(f"phase10 {name} n_sigs={n} padded={rows.shape[1]} "
              f"host_pack_p50_ms={statistics.median(pack):.3f} "
              f"device_p50_ms={statistics.median(devt):.3f}", flush=True)
    restore_launches(launches)
    p50 = statistics.median(pair_ms)
    print(f"phase10 light pair (trusting 1/3 + VerifyCommitLight) p50_ms="
          f"{p50:.3f} all_ms={[round(x, 3) for x in pair_ms]}", flush=True)

    # ecdsa_verify on the rows both calls launched it on (clean and
    # tampered), against its plain version; timed at the widest shape (the
    # light call's) and at the trusting call's
    points = ef.base_points(dev)
    err, ec_cols = hold_shapes_against_plain(
        dev, ef.ecdsa_verify, lambda r: ef.ecdsa_verify_plain(r, points),
        path_rows["secp256k1"])
    check(err == 0, f"ecdsa_verify != plain at {ec_cols} cols")
    check(len(path_rows["secp256k1"]) == launches["ecdsa_verify"],
          "phase10 captured rows do not match the launches")
    rows = torch.as_tensor(path_rows["secp256k1"][1]).to(dev)
    ms = cuda_ms(lambda: ef.ecdsa_verify(rows), 10)
    ec_dev = dev_ms(lambda: ef.ecdsa_verify(rows), "ecdsa_verify_trace.json")
    rows_t = torch.as_tensor(path_rows["secp256k1"][0]).to(dev)
    check(rows_t.shape[1] == min(ec_cols),
          f"the trusting call's rows have {rows_t.shape[1]} cols")
    n_trust_live = int(((rows_t[ef.E_FLAGS] >> 2) & 1).sum())
    ec_dev_trust = dev_ms(lambda: ef.ecdsa_verify(rows_t),
                          "ecdsa_verify_trusting_trace.json")
    t = time.perf_counter()
    plain = ef.ecdsa_verify_plain(rows, points)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    out = ef.ecdsa_verify(rows)
    restore_launches(launches)
    check(rows.shape[1] == max(ec_cols) and torch.equal(out, plain),
          f"ecdsa_verify != plain at {rows.shape[1]} cols")
    check(int(out.sum()) == n_light, "not every secp256k1 signature verified")
    kernel_stats["ecdsa_verify"] = dict(
        launches_by_path={"light_pair": launches["ecdsa_verify"]},
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        ops=n_light * ef.verify_products_per_signature(),
        bytes=rows.shape[1] * (ef.E_KROWS + 1) * 4 + 8192 * 3 * 10 * 4,
        library_ms=None, device_ms=ec_dev,
        device_ms_by_live={n_light: ec_dev, n_trust_live: ec_dev_trust})
    print(f"phase10 ecdsa_verify cols={rows.shape[1]} live={n_light} "
          f"kernel_ms={ms:.4f} device_ms={fmt_ms(ec_dev)}; cols="
          f"{rows_t.shape[1]} live={n_trust_live} device_ms="
          f"{fmt_ms(ec_dev_trust)}; plain_ms={plain_ms:.1f}; kernel==plain at "
          f"cols={ec_cols} (clean and tampered rows of the path)", flush=True)
    return {"lc_pair_p50_ms": p50}


# --------------------------------------------------------------------------
# phase 11: the verify plane on the card
# --------------------------------------------------------------------------


def plane_subs(vs, commit):
    """Each CommitSig of phase 3's commit as the precommit submission a
    VoteSet makes (types/vote_set.py in the JAX package): counted, with the
    validator index and the device stamp (template, secs, nanos)."""
    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.vote import sign_bytes_template

    tpl = sign_bytes_template(CHAIN_ID, canonical.PRECOMMIT_TYPE,
                              commit.height, commit.round, commit.block_id)
    secs = [cs.timestamp.seconds for cs in commit.signatures]
    nanos = [cs.timestamp.nanos for cs in commit.signatures]
    msgs = tpl.patch_rows(secs, nanos).tolist()
    check(msgs == commit.sign_bytes_rows(CHAIN_ID),
          "phase11 template rows != the commit's sign-bytes")
    return [dict(rows=[(v.pub_key, m, cs.signature)], power=v.voting_power,
                 counted=True, vidx=[i], stamp=[(tpl, s, n)])
            for i, (v, cs, m, s, n) in enumerate(zip(
                vs.validators, commit.signatures, msgs, secs, nanos))]


def plane_run(plane, subs, pubs, powers, quorum=True):
    """Submit every submission to the running plane from PLANE_THREADS
    threads into one fresh QuorumGroup; -> (verdicts, "DeviceError" for a
    submission whose flush faulted, group, ms from the first submission to
    the quorum event, or None when `quorum` is False or it never fired,
    ledger records of the run's flushes)."""
    import threading

    from cometbft_tpu_torch.device import DeviceError
    from cometbft_tpu_torch.verifyplane import QuorumGroup

    def verdict(f):
        try:
            return f.result(PLANE_TIMEOUT_S)[0]
        except DeviceError:
            return "DeviceError"

    group = QuorumGroup(sum(powers) * 2 // 3 + 1, "phase11",
                        valset_pubs=pubs, valset_powers=powers)
    futs = [None] * len(subs)
    seq0 = len(plane.ledger.records())
    go = threading.Event()

    def worker(k):
        go.wait()
        for i in range(k, len(subs), PLANE_THREADS):
            futs[i] = plane.submit_many(group=group, **subs[i])

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(PLANE_THREADS)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    go.set()
    reached = quorum and group.wait_quorum(PLANE_TIMEOUT_S)
    quorum_ms = (time.perf_counter() - t0) * 1e3 if reached else None
    for t in threads:
        t.join(PLANE_TIMEOUT_S)
    verdicts = [verdict(f) for f in futs]
    # a flush resolves its futures just before its ledger record lands
    deadline = time.perf_counter() + PLANE_TIMEOUT_S
    while sum(r["rows"] for r in plane.ledger.records()[seq0:]) < len(subs):
        check(time.perf_counter() < deadline, "phase11 ledger incomplete")
        time.sleep(0.001)
    return verdicts, group, quorum_ms, plane.ledger.records()[seq0:]


def flush_kernels_vs_plain(dev, subs, pubs, powers, phase):
    """One fused flush of `subs` (plane_subs submissions) planned as the
    plane plans it, on the valset's cached (warm) table: stamp_rows,
    ed25519_verify_cached and tally_quorum_cached against their plain
    versions on the flush's inputs, exactly. Returns the shape (B, M,
    live), the three launches as closures (stamp, vk, tq), their errors
    and the plain stamp's ms. Every submission's signature must be
    valid."""
    import types

    import torch

    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.verifyplane import QuorumGroup
    from cometbft_tpu_torch.verifyplane import fused as fz
    from cometbft_tpu_torch.verifyplane.plane import _Submission

    g = QuorumGroup(1, f"{phase}-check", valset_pubs=pubs,
                    valset_powers=powers)
    batch = [_Submission(s["rows"], g, s["power"], True, s["vidx"],
                         stamp=s["stamp"]) for s in subs]
    plan = fz.plan_fused(batch, device=dev)
    table, warm = ec.table_for_pubs_info(pubs, powers, device=dev)
    check(warm and plan.stamped, f"{phase} kernel check: cold or unstamped")
    ent = es.template_entry(plan.sites, device=dev)
    sig_t, ts_t, fl_t = (torch.from_numpy(a).to(dev) for a in plan.delta)
    thr = torch.from_numpy(plan.thresh).to(dev)
    B = sig_t.shape[0]
    M = table.n_vals
    live = len(batch)
    t_rows = ec.packed_rows_shape(B, plan.n_commits)[0] - ec.V_THRESH
    stamp = lambda: es.stamp_rows(sig_t, ts_t, fl_t, ent,  # noqa: E731
                                  table.pub_raw, thr, t_rows)
    rows_k = stamp()
    t = time.perf_counter()
    rows_p = es.stamp_rows_plain(sig_t, ts_t, fl_t, ent.pre_mat,
                                 ent.pre_len, ent.suf_mat, ent.suf_len,
                                 ent.ts_tag, table.pub_raw, thr, ent.msg_max,
                                 t_rows)
    torch.cuda.synchronize()
    stamp_plain_ms = (time.perf_counter() - t) * 1e3
    stamp_err = int((rows_k.to(torch.int64)
                     - rows_p.to(torch.int64)).abs().max())
    check(stamp_err == 0, f"{phase} stamp_rows != plain at {B} columns")
    vk = lambda: ec.ed25519_verify_cached(rows_k, table.tab,  # noqa: E731
                                          table.ok)
    v_k = vk()
    v_p = ec.ed25519_verify_cached_plain(rows_k, table.tab, table.ok,
                                         ec.kf.base_points(dev))
    verify_err = int((v_k - v_p).abs().max())
    check(verify_err == 0 and int(v_k.sum()) == live,
          f"{phase} ed25519_verify_cached != plain at {B}x{M}")
    tq = lambda: ec.tally_quorum_cached(v_k, rows_k,  # noqa: E731
                                        table.power5, plan.n_commits)
    t_k, q_k = tq()
    t_p, q_p = ec.tally_quorum_cached_plain(v_k, rows_k, table.power5,
                                            plan.n_commits)
    tally_err = max(int((t_k - t_p).abs().max()), int((q_k != q_p).sum()))
    check(tally_err == 0, f"{phase} tally_quorum_cached != plain at {B}")
    return types.SimpleNamespace(
        B=B, M=M, live=live, stamp=stamp, vk=vk, tq=tq,
        errs=(stamp_err, verify_err, tally_err),
        stamp_plain_ms=stamp_plain_ms)


def phase_plane(dev, res, kernel_stats):
    """Phase 3's signed 10k commit as gossiped precommits through a started
    VerifyPlane on the card: fused flushes (stamp_rows, the cached verify,
    the cached tally), the quorum bit from the kernel, the tampered vote
    blamed; then the host-packed branch, two flights, and one in-flight
    fault."""
    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.libs import failpoints as fp
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import table_cache as tc
    from cometbft_tpu_torch.verifyplane import FlushLedger, VerifyPlane
    from cometbft_tpu_torch.verifyplane import fused as fz

    def make_plane(**kw):
        p = VerifyPlane(window_ms=PLANE_WINDOW_MS, max_queue=PLANE_MAX_QUEUE,
                        **kw)
        check(p.device == dev, f"phase11 plane device {p.device}")
        # room for every flush of the phase in the ledger's ring
        p.ledger = FlushLedger(capacity=PLANE_LEDGER)
        return p

    vs, bid, height, commit = res["fixture"]
    good = commit.signatures[TAMPER_IDX].signature
    commit.signatures[TAMPER_IDX].signature = flip(good, 40)
    try:
        subs = plane_subs(vs, commit)
    finally:
        commit.signatures[TAMPER_IDX].signature = good
    pubs = tuple(v.pub_key.data for v in vs.validators)
    powers = tuple(v.voting_power for v in vs.validators)
    want = [i != TAMPER_IDX for i in range(N_VALS)]
    want_tally = sum(powers) - powers[TAMPER_IDX]
    brk = cbatch.device_breaker()
    # the earlier phases cached this valset's table: start cold
    tc.reset_for_tests()

    def runs_check(name, out, stamp, cold_first):
        verdicts, group, quorum_ms, recs = out
        check(quorum_ms is not None, f"phase11 {name}: no quorum")
        check(verdicts == want,
              f"phase11 {name}: verdicts != the oracle's (tampered "
              f"{TAMPER_IDX} False, the rest True)")
        check(group.tally == want_tally,
              f"phase11 {name}: tally {group.tally} != {want_tally}")
        check({r["path"] for r in recs} == {"fused"},
              f"phase11 {name}: paths {[r['path'] for r in recs]}")
        check({r["stamp"] for r in recs} == {stamp},
              f"phase11 {name}: stamps {[r['stamp'] for r in recs]}")
        warm = [r["warm"] for r in recs]
        check(warm == [0 if cold_first else 1] + [1] * (len(recs) - 1),
              f"phase11 {name}: warm column {warm}")
        return recs

    def launches_check(name, flushes, stamped, builds):
        got = read_launches()
        want_l = {k: 0 for k in got}
        want_l.update(stamp_rows=flushes if stamped else 0,
                      ed25519_verify_cached=flushes,
                      tally_quorum_cached=flushes,
                      valset_table_build=builds)
        check(got == want_l, f"phase11 {name} launches {got}, want {want_l}")
        return got

    # the clean runs: one plane, the config's defaults, the global breaker
    plane = make_plane(max_batch=PLANE_MAX_BATCH)
    plane.start()
    clean, quorum_ms = [], []
    try:
        zero_launches()
        for k in range(PLANE_RUNS):
            out = plane_run(plane, subs, pubs, powers)
            clean += runs_check(f"run {k}", out, "device", k == 0)
            quorum_ms.append(out[2])
        torch.cuda.synchronize()
        launches = launches_check("clean", len(clean), True, 1)
        # one more warm run under the profiler: the card's busy share
        traced_out = []
        busy = trace_device_ms(
            lambda: traced_out.append(plane_run(plane, subs, pubs, powers)),
            "plane_run_trace.json")
        traced = runs_check("traced", traced_out[0], "device", False)
        # the host-packed branch, on the same plane
        zero_launches()
        fz.set_device_stamping(False)
        try:
            out = plane_run(plane, subs, pubs, powers)
        finally:
            fz.set_device_stamping(True)
        host = runs_check("host-packed", out, "host", False)
        launches_check("host-packed", len(host), False, 0)
    finally:
        plane.stop()
    check(brk.faults == 0 and brk.trips == 0,
          f"phase11 breaker faults={brk.faults} trips={brk.trips}")

    # two flights: flushes land by their CUDA events
    plane2 = make_plane(max_batch=PLANE_MAX_BATCH, pipeline_flights=2)
    plane2.start()
    try:
        zero_launches()
        out = plane_run(plane2, subs, pubs, powers)
        two = runs_check("two flights", out, "device", False)
        launches_check("two flights", len(two), True, 0)
        deck_peak = plane2.stats()["deck_peak"]
    finally:
        plane2.stop()
    check(brk.faults == 0 and brk.trips == 0,
          f"phase11 breaker faults={brk.faults} trips={brk.trips}")

    # one in-flight fault: the first flush's fetch raises; its futures
    # fail with DeviceError, and the caller's retry of those precommits
    # goes through fused flushes
    lo, hi = PLANE_FAULT_VALS
    fault_brk = cbatch.CircuitBreaker(name="phase11-fault")
    plane3 = make_plane(max_batch=PLANE_FAULT_BATCH, breaker=fault_brk)
    plane3.start()
    fp.arm("verifyplane.collect", "raise", count=1)
    try:
        zero_launches()
        try:
            verdicts, group, _, frecs = plane_run(plane3, subs[lo:hi], pubs,
                                                  powers, quorum=False)
        finally:
            fp.reset()
        failed = [lo + i for i, v in enumerate(verdicts)
                  if v == "DeviceError"]
        retry, rgroup, _, rrecs = plane_run(
            plane3, [subs[i] for i in failed], pubs, powers, quorum=False)
    finally:
        plane3.stop()
    fpaths = [r["path"] for r in frecs]
    check(fpaths == ["device_fault"] + ["fused"] * (len(frecs) - 1),
          f"phase11 fault run paths {fpaths}")
    check(len(failed) == frecs[0]["rows"] > 0,
          f"phase11 fault run: {len(failed)} DeviceError futures, the "
          f"faulted flush held {frecs[0]['rows']} rows")
    check(all(v == want[lo + i] for i, v in enumerate(verdicts)
              if v != "DeviceError"), "phase11 fault run verdicts != oracle")
    check(group.tally == sum(powers[lo + i] for i, v in enumerate(verdicts)
                             if v is True),
          f"phase11 fault run tally {group.tally}")
    check(retry == [want[i] for i in failed]
          and {r["path"] for r in rrecs} == {"fused"}
          and rgroup.tally == sum(powers[i] for i in failed if want[i]),
          "phase11 retry of the faulted flush: verdicts, paths or tally")
    check(fault_brk.faults == 1 and fault_brk.state == "closed",
          f"phase11 fault breaker faults={fault_brk.faults} "
          f"state={fault_brk.state}")
    launches_check("fault", len(frecs) + len(rrecs), True, 0)
    restore_launches(launches)

    # the flush's three kernels at the path's shape against their plain
    # versions: one flush of PLANE_MAX_BATCH precommits
    fk = flush_kernels_vs_plain(dev, subs[:PLANE_MAX_BATCH], pubs, powers,
                                "phase11")
    B, M, live = fk.B, fk.M, fk.live
    stamp, vk, tq = fk.stamp, fk.vk, fk.tq
    stamp_err, verify_err, tally_err = fk.errs
    stamp_plain_ms = fk.stamp_plain_ms
    stamp_dev = dev_ms(stamp, "stamp_rows_plane_trace.json")
    verify_dev = dev_ms(vk, "ed25519_verify_cached_plane_trace.json")
    tally_dev = dev_ms(tq, "tally_quorum_cached_plane_trace.json")
    restore_launches(launches)
    shape = f"plane B={B},live={live}"
    k = kernel_stats["stamp_rows"]
    k["launches_by_path"]["verify_plane"] = launches["stamp_rows"]
    k["max_abs_err"] = max(k["max_abs_err"], stamp_err)
    k["device_ms_by_shape"][shape] = stamp_dev
    k = kernel_stats["ed25519_verify_cached"]
    k["launches_by_path"]["verify_plane"] = launches["ed25519_verify_cached"]
    k["max_abs_err"] = max(k["max_abs_err"], verify_err)
    k["device_ms_by_shape"][f"plane {B}x{M},live={live}"] = verify_dev
    k["entry_by_shape"][f"plane {B}x{M}"] = ec.verify_cached_entry(
        B, ec.sm_count(dev))
    k = kernel_stats["tally_quorum_cached"]
    k["launches_by_path"]["verify_plane"] = launches["tally_quorum_cached"]
    k["max_abs_err"] = max(k["max_abs_err"], tally_err)
    k.setdefault("device_ms_by_shape", {})[shape] = tally_dev
    kernel_stats["valset_table_build"]["launches_by_path"][
        "verify_plane"] = launches["valset_table_build"]

    rows = [r["rows"] for r in clean]
    med = {c: statistics.median(r[c] for r in clean)
           for c in ("comp_ms", "h2d_ms", "dev_ms", "pack_ms", "collect_ms")}
    util = statistics.median(r["util"] for r in clean)
    print(f"phase11 launches {json.dumps(launches)} (clean runs) "
          f"breaker_faults=0 blamed_idx={TAMPER_IDX} tally={want_tally}",
          flush=True)
    print(f"phase11 kernels at the flush shape (cols={B} M={M} live={live}): "
          f"stamp_rows device_ms={fmt_ms(stamp_dev)} plain_ms="
          f"{stamp_plain_ms:.1f} ed25519_verify_cached device_ms="
          f"{fmt_ms(verify_dev)} tally_quorum_cached device_ms="
          f"{fmt_ms(tally_dev)}; kernel==plain for all three", flush=True)
    print(f"phase11 VerifyPlane validators={N_VALS} runs={PLANE_RUNS} "
          f"threads={PLANE_THREADS} window_ms={PLANE_WINDOW_MS} "
          f"max_batch={PLANE_MAX_BATCH} flushes={len(clean)} "
          f"flushes_per_run={len(clean) / PLANE_RUNS:.1f} rows_per_flush "
          f"p50={statistics.median(rows)} min={min(rows)} max={max(rows)} "
          f"util_p50={util} quorum_p50_ms={statistics.median(quorum_ms):.3f} "
          f"quorum_ms={[round(x, 3) for x in quorum_ms]} (the first run "
          f"cold) per-flush medians comp_ms={med['comp_ms']} "
          f"h2d_ms={med['h2d_ms']} dev_ms={med['dev_ms']} "
          f"pack_ms={med['pack_ms']} collect_ms={med['collect_ms']} "
          f"card={smi('name,power.limit')}", flush=True)
    if busy is None:
        busy_line = "device busy share: not measured (no device events)"
    else:
        busy_line = (f"traced warm run: flushes={len(traced)} wall_ms="
                     f"{busy[2]:.3f} kernel_ms={busy[0]:.3f} memcpy_ms="
                     f"{busy[1]:.3f} device busy share="
                     f"{(busy[0] + busy[1]) / busy[2]:.4f}")
    print(f"phase11 {busy_line}", flush=True)
    print(f"phase11 host-packed flushes={len(host)} two-flight flushes="
          f"{len(two)} deck_peak={deck_peak} (verdicts and tallies equal the "
          f"clean runs'); fault run validators={lo}-{hi - 1} "
          f"flushes={len(frecs)} paths={fpaths} device_error_futures="
          f"{len(failed)} breaker_faults=1 retry_flushes={len(rrecs)} (fused, "
          f"the oracle's verdicts)", flush=True)
    return {"plane_quorum_p50_ms": statistics.median(quorum_ms),
            "plane_flushes_per_run": len(clean) / PLANE_RUNS}


# --------------------------------------------------------------------------
# phase 12: VoteSet and the table warmer on the card
# --------------------------------------------------------------------------


def voteset_run(vs, votes, height, quorum=True):
    """Add `votes` (precommits of one block, each True or raising) to a
    fresh VoteSet over `vs` from VS_THREADS threads, through the mounted
    plane and warmer; -> (VoteSet, the outcome of each add: its return
    value or the exception, ms from the first add to the quorum event of
    the block's QuorumGroup, or None when `quorum` is False (the votes
    hold too little power to wait for it) or it never fired)."""
    import threading

    from cometbft_tpu_torch.types import canonical
    from cometbft_tpu_torch.types.vote_set import VoteSet

    vset = VoteSet(CHAIN_ID, height, 0, canonical.PRECOMMIT_TYPE, vs)
    outs = [None] * len(votes)
    go = threading.Event()

    def worker(k):
        go.wait()
        for i in range(k, len(votes), VS_THREADS):
            try:
                outs[i] = vset.add_vote(votes[i])
            except Exception as e:  # noqa: BLE001 - checked by the caller
                outs[i] = e

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(VS_THREADS)]
    for t in threads:
        t.start()
    key = votes[0].block_id.key()
    deadline = time.perf_counter() + PLANE_TIMEOUT_S
    t0 = time.perf_counter()
    go.set()
    group = None
    while quorum and group is None and time.perf_counter() < deadline:
        group = vset._plane_groups.get(key)
        time.sleep(0.0002)
    reached = group is not None and group.wait_quorum(PLANE_TIMEOUT_S)
    quorum_ms = (time.perf_counter() - t0) * 1e3 if reached else None
    for t in threads:
        t.join(PLANE_TIMEOUT_S)
        check(not t.is_alive(), "phase12 a VoteSet thread hung")
    return vset, outs, quorum_ms


def voteset_check(name, vset, outs, want_commit, bad_idx=TAMPER_IDX):
    """Vote `bad_idx` raised the invalid-signature VoteSetError, every
    other vote was admitted, the majority is the commit's block and
    make_commit() is `want_commit`, the commit with that signature
    absent."""
    from cometbft_tpu_torch.types.vote_set import VoteSetError

    bad = outs[bad_idx]
    check(isinstance(bad, VoteSetError)
          and str(bad) == "invalid vote: invalid signature",
          f"phase12 {name}: vote {bad_idx} gave {bad!r}")
    others = [o for i, o in enumerate(outs) if i != bad_idx]
    check(all(o is True for o in others),
          f"phase12 {name}: {sum(o is not True for o in others)} valid "
          f"votes not admitted, e.g. "
          f"{next((o for o in others if o is not True), None)!r}")
    check(vset.two_thirds_majority() == want_commit.block_id,
          f"phase12 {name}: majority {vset.two_thirds_majority()}")
    got = vset.make_commit()
    check(got.signatures == want_commit.signatures
          and got.hash() == want_commit.hash(),
          f"phase12 {name}: make_commit() != the commit without "
          f"signature {bad_idx}")
    return got


def rotated_commit(pool, rng, vs, commit):
    """Epoch e+2's valset and commit: `vs` without its last VS_ROTATED
    validators, plus VS_ROTATED new keys at twice VAL_POWER (they sort
    first, so every slot of the table moves: a full build). The kept
    validators' signatures are the commit's (a precommit's sign-bytes
    hold no validator index); the new keys sign theirs. -> (valset,
    commit, the tampered vote's index in it)."""
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                 Commit, CommitSig)
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

    new, seed_of = make_valset(pool, rng, VS_ROTATED,
                               [2 * VAL_POWER] * VS_ROTATED)
    kept = vs.validators[:N_VALS - VS_ROTATED]
    vs3 = ValidatorSet([Validator(v.pub_key, v.voting_power)
                        for v in kept + new.validators])
    check(vs3.validators[0].address in seed_of
          and vs3.validators[VS_ROTATED].address == kept[0].address,
          "phase12 e+2's new keys do not sort first")
    by_addr = {cs.validator_address: cs for cs in commit.signatures}
    ts = commit.signatures[0].timestamp
    commit3 = Commit(commit.height, commit.round, commit.block_id, [
        by_addr.get(v.address)
        or CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts, b"")
        for v in vs3.validators])
    fresh = [i for i, v in enumerate(vs3.validators) if v.address in seed_of]
    jobs = [(seed_of[vs3.validators[i].address],
             [commit3.vote_sign_bytes(CHAIN_ID, i)]) for i in fresh]
    for i, (_, (sig,)) in zip(fresh, sign_all(pool, jobs)):
        commit3.signatures[i].signature = sig
    bad = [v.address for v in vs3.validators].index(
        vs.validators[TAMPER_IDX].address)
    return vs3, commit3, bad


def phase_voteset(dev, pool, rng, res, kernel_stats):
    """The consensus entry of the main path: phase 3's commit as 10,000
    precommit Votes added to a port VoteSet from 8 threads, with a card
    VerifyPlane and a card TableWarmer mounted; then two rotations, each
    warmed by the warmer before its first flush: e+1 changes 100
    validators' powers (a power patch of the live table), e+2 replaces
    those 100 validators with new keys (a full table build)."""
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import table_cache as tc
    from cometbft_tpu_torch.types.commit import Commit, CommitSig
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
    from cometbft_tpu_torch.verifyplane import (FlushLedger, TableWarmer,
                                                VerifyPlane,
                                                notify_next_valset,
                                                set_global_plane,
                                                set_global_warmer)

    vs, bid, height, commit = res["fixture"]
    votes = [commit.get_vote(i) for i in range(len(commit.signatures))]
    votes[TAMPER_IDX].signature = flip(votes[TAMPER_IDX].signature, 40)
    want = Commit(commit.height, commit.round, commit.block_id,
                  [CommitSig.absent() if i == TAMPER_IDX else cs
                   for i, cs in enumerate(commit.signatures)])
    brk = cbatch.device_breaker()
    # e+1, a rotation that keeps every key and the valset's order: the
    # last VS_ROTATED validators (equal powers sort by address) lose half
    # their power, so the content key changes and the warm is a power
    # patch of the live table
    vs2 = ValidatorSet([
        Validator(v.pub_key, VAL_POWER // 2 if i >= N_VALS - VS_ROTATED
                  else v.voting_power) for i, v in enumerate(vs.validators)])
    check([v.pub_key for v in vs2.validators]
          == [v.pub_key for v in vs.validators],
          "phase12 the rotated valset changed the validators' order")
    # e+2, a rotation that brings in new keys
    t = time.perf_counter()
    vs3, commit3, bad3 = rotated_commit(pool, rng, vs, commit)
    sign3_s = time.perf_counter() - t
    votes3 = [commit3.get_vote(i) for i in range(N_VALS)]
    votes3[bad3].signature = flip(votes3[bad3].signature, 40)
    want3 = Commit(commit3.height, commit3.round, commit3.block_id,
                   [CommitSig.absent() if i == bad3 else cs
                    for i, cs in enumerate(commit3.signatures)])

    plane = VerifyPlane(window_ms=PLANE_WINDOW_MS, max_batch=PLANE_MAX_BATCH,
                        max_queue=PLANE_MAX_QUEUE)
    check(plane.device == dev, f"phase12 plane device {plane.device}")
    plane.ledger = FlushLedger(capacity=PLANE_LEDGER)
    warmer = TableWarmer()
    check(warmer.device == dev, f"phase12 warmer device {warmer.device}")
    tc.reset_for_tests()  # epoch e starts cold
    plane.start()
    warmer.start()
    set_global_plane(plane)
    set_global_warmer(warmer)

    def epoch(name, vals, vs_votes, want_commit, bad_idx):
        """One VoteSet over `vs_votes` on the mounted plane: the checks
        every epoch shares; -> (VoteSet, outcomes, quorum ms, ledger
        records of its flushes, launches)."""
        zero_launches()
        n0 = len(plane.ledger.records())
        rows0 = plane.rows_verified
        vset, outs, q = voteset_run(vals, vs_votes, height)
        recs = plane.ledger.records()[n0:]
        launches = read_launches()
        check(q is not None, f"phase12 {name}: no quorum")
        voteset_check(name, vset, outs, want_commit, bad_idx)
        group = vset._plane_groups[bid.key()]
        check(group.quorum_reached
              and group.tally == sum(v.voting_power for v in vals.validators)
              - vals.validators[bad_idx].voting_power,
              f"phase12 {name}: group tally {group.tally}")
        check(plane.rows_verified - rows0 == N_VALS,
              f"phase12 {name}: the plane verified "
              f"{plane.rows_verified - rows0} rows of {N_VALS} votes "
              f"(a vote left the plane)")
        paths = sorted({r["path"] for r in recs})
        check(paths == ["fused"] and {r["stamp"] for r in recs} == {"device"},
              f"phase12 {name}: paths {paths}")
        return vset, outs, q, recs, launches

    def rotate(name, vals):
        """notify_next_valset(vals) as state/execution.py makes it, and
        the warmer's build to its idle: -> (its launches, warmer stats,
        table_cache's warmed hits before the next epoch)."""
        zero_launches()
        notify_next_valset(vals)
        check(warmer.wait_idle(PLANE_TIMEOUT_S),
              f"phase12 {name}: warmer not idle")
        return read_launches(), warmer.stats(), tc.STATS["warmed_hits"]

    def flush_launches(name, launches, n, table_builds=0):
        want_l = dict.fromkeys(launches, 0)
        want_l.update(stamp_rows=n, ed25519_verify_cached=n,
                      tally_quorum_cached=n, valset_table_build=table_builds)
        check(launches == want_l,
              f"phase12 {name} launches {launches}, want {want_l}")

    try:
        runs, quorum_ms, launches_e = [], [], {}
        for k in range(VS_RUNS):
            vset, outs, q, recs, lk = epoch(f"epoch e run {k}", vs, votes,
                                            want, TAMPER_IDX)
            warm = [r["warm"] for r in recs]
            check(warm == [0 if k == 0 else 1] + [1] * (len(recs) - 1),
                  f"phase12 run {k}: warm column {warm}")
            flush_launches(f"epoch e run {k}", lk, len(recs),
                           1 if k == 0 else 0)
            launches_e = {n: launches_e.get(n, 0) + c for n, c in lk.items()}
            runs.append(recs)
            quorum_ms.append(q)
        check(warmer.builds_ok == 0, "phase12 the warmer built in epoch e")

        # rotation to e+1: the warmer patches V''s powers in
        warm_l1, wst1, hits1 = rotate("e+1", vs2)
        check(wst1["builds_ok"] == 1 and wst1["builds_failed"] == 0
              and wst1["builds_incremental"] == 1,
              f"phase12 warmer after e+1 {wst1}")
        flush_launches("e+1 warmer", warm_l1, 0)  # a power patch: none
        vset2, _, q2, recs2, launches_r = epoch("epoch e+1", vs2, votes,
                                                want, TAMPER_IDX)
        check(tc.STATS["warmed_hits"] - hits1 == 1,
              f"phase12 e+1 warmed_hits {tc.STATS['warmed_hits'] - hits1}")
        check([r["warm"] for r in recs2] == [1] * len(recs2),
              f"phase12 e+1 warm column {[r['warm'] for r in recs2]}")
        flush_launches("epoch e+1", launches_r, len(recs2))
        fk = flush_kernels_vs_plain(dev, plane_subs(vs2, commit)[
            :PLANE_MAX_BATCH], tuple(v.pub_key.data for v in vs2.validators),
            tuple(v.voting_power for v in vs2.validators), "phase12 e+1")

        # rotation to e+2: new keys, every slot moved, the warmer's full
        # table build
        warm_l2, wst2, hits2 = rotate("e+2", vs3)
        check(wst2["builds_ok"] == 2 and wst2["builds_failed"] == 0
              and wst2["builds_incremental"] == 1,
              f"phase12 warmer after e+2 {wst2} (want a full build)")
        flush_launches("e+2 warmer", warm_l2, 0, table_builds=1)
        _, _, q3, recs3, launches_3 = epoch("epoch e+2", vs3, votes3,
                                            want3, bad3)
        check(tc.STATS["warmed_hits"] - hits2 == 1,
              f"phase12 e+2 warmed_hits {tc.STATS['warmed_hits'] - hits2}")
        check([r["warm"] for r in recs3] == [1] * len(recs3),
              f"phase12 e+2 warm column {[r['warm'] for r in recs3]}")
        flush_launches("epoch e+2", launches_3, len(recs3))
        fk3 = flush_kernels_vs_plain(dev, plane_subs(vs3, commit3)[
            :PLANE_MAX_BATCH], tuple(v.pub_key.data for v in vs3.validators),
            tuple(v.voting_power for v in vs3.validators), "phase12 e+2")
    finally:
        set_global_plane(None)
        set_global_warmer(None)
        warmer.stop()
        plane.stop()
    check(brk.faults == 0 and brk.trips == 0,
          f"phase12 breaker faults={brk.faults} trips={brk.trips}")

    # a slice of epoch e's votes through a VoteSet on a host plane: each
    # vote's outcome and the admitted bits equal the card's last run's
    lo, hi = VS_HOST_VOTES
    host = VerifyPlane(window_ms=PLANE_WINDOW_MS, max_batch=PLANE_MAX_BATCH,
                       max_queue=PLANE_MAX_QUEUE, use_device=False)
    host.start()
    set_global_plane(host)
    try:
        t = time.perf_counter()
        hset, houts, _ = voteset_run(vs, votes[lo:hi], height,
                                     quorum=False)
        host_s = time.perf_counter() - t
    finally:
        set_global_plane(None)
        host.stop()

    def kind(o):
        return o if o is True else (type(o).__name__, str(o))

    check([kind(o) for o in houts] == [kind(o) for o in outs[lo:hi]]
          and [hset.get_by_index(i) is not None for i in range(lo, hi)]
          == [vset.get_by_index(i) is not None for i in range(lo, hi)]
          and hset.sum == VAL_POWER * (hi - lo - 1),
          f"phase12 the host plane's VoteSet over votes {lo}-{hi - 1} != "
          f"the card's")

    launches = {k: launches_e[k] + launches_r[k] + launches_3[k]
                for k in launches_e}
    warmer_l = {k: warm_l1[k] + warm_l2[k] for k in warm_l1}
    for name in ("stamp_rows", "ed25519_verify_cached",
                 "tally_quorum_cached", "valset_table_build"):
        kernel_stats[name]["launches_by_path"]["vote_set"] = launches[name]
    kernel_stats["valset_table_build"]["launches_by_path"]["warmer"] = (
        warmer_l["valset_table_build"])
    for name, e1, e3 in zip(("stamp_rows", "ed25519_verify_cached",
                             "tally_quorum_cached"), fk.errs, fk3.errs):
        kernel_stats[name]["max_abs_err"] = max(
            kernel_stats[name]["max_abs_err"], e1, e3)
    cold, warm1, warm3 = runs[0][0], recs2[0], recs3[0]
    n_e = sum(len(r) for r in runs)
    print(f"phase12 launches {json.dumps(launches)} warmer_launches "
          f"{json.dumps(warmer_l)} epoch_e_flushes={n_e} "
          f"epoch_e1_flushes={len(recs2)} epoch_e2_flushes={len(recs3)} "
          f"blamed_idx={TAMPER_IDX} (e+2: {bad3}) breaker_faults=0",
          flush=True)
    print(f"phase12 VoteSet validators={N_VALS} threads={VS_THREADS} "
          f"runs={VS_RUNS} quorum_p50_ms={statistics.median(quorum_ms):.3f} "
          f"quorum_ms={[round(x, 3) for x in quorum_ms]} (the first cold) "
          f"e+1 quorum_ms={q2:.3f} e+2 quorum_ms={q3:.3f}; first flush of "
          f"epoch e (cold) rows={cold['rows']} dev_ms={cold['dev_ms']} "
          f"comp_ms={cold['comp_ms']} h2d_ms={cold['h2d_ms']}; first flush "
          f"of e+1 (warm) rows={warm1['rows']} dev_ms={warm1['dev_ms']} "
          f"h2d_ms={warm1['h2d_ms']}; first flush of e+2 (warm) rows="
          f"{warm3['rows']} dev_ms={warm3['dev_ms']} h2d_ms="
          f"{warm3['h2d_ms']}; card={smi('name,power.limit')}", flush=True)
    print(f"phase12 warmer e+1 (power patch) last_build_ms="
          f"{wst1['last_build_ms']}; e+2 ({VS_ROTATED} new keys, full build) "
          f"last_build_ms={wst2['last_build_ms']}; builds_ok="
          f"{wst2['builds_ok']} builds_incremental="
          f"{wst2['builds_incremental']} tmpl_warms={wst2['tmpl_warms']} "
          f"superseded={wst2['superseded']} warmed_hits=1 a rotation (each "
          f"first flush warm, no table build in e+1 or e+2); e+2 keys signed "
          f"s={sign3_s:.3f}; flush kernels on both warmed tables == plain "
          f"(B={fk.B} M={fk.M} live={fk.live}); host-plane VoteSet over "
          f"votes {lo}-{hi - 1} s={host_s:.1f} (same outcomes and bits)",
          flush=True)
    return {"vs_quorum_p50_ms": statistics.median(quorum_ms),
            "e2": (vs3, commit3)}


# --------------------------------------------------------------------------
# phase 13: the light client on the card
# --------------------------------------------------------------------------


class PlanChain:
    """light_plan's chain for the port's light client: each height's
    header carries its era's validators hash and the next height's;
    a height's commit (every validator for the block, at T0 + h) is
    signed on the pool the first time the provider is asked for it."""

    def __init__(self, pool, plan):
        from cometbft_tpu_torch.crypto.keys import PubKey
        from cometbft_tpu_torch.types.block import Header
        from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
        from cometbft_tpu_torch.types.validator import Validator, ValidatorSet

        self.pool = pool
        seeds = list(dict.fromkeys(s for vals in plan.values()
                                   for s, _ in vals))
        pubs = dict(zip(seeds, (p for p, _ in sign_typed(
            pool, [("secp256k1", s, []) for s in seeds]))))
        sets = {}
        for vals in plan.values():
            if id(vals) not in sets:
                sets[id(vals)] = ValidatorSet([
                    Validator(PubKey(pubs[s], "secp256k1"), w)
                    for s, w in vals])
        self.vals = {h: sets[id(vals)] for h, vals in plan.items()}
        self.key_of = {PubKey(pubs[s], "secp256k1").address():
                       ("secp256k1", s) for s in seeds}
        self.headers = {}
        prev = BlockID()
        for h in sorted(plan):
            vs = self.vals[h]
            header = Header(
                chain_id=CHAIN_ID, height=h,
                time=_ts(LCC_T0 + h), last_block_id=prev,
                validators_hash=vs.hash(),
                next_validators_hash=self.vals.get(h + 1, vs).hash(),
                proposer_address=vs.validators[0].address,
                app_hash=b"\x01" * 32)
            prev = BlockID(header.hash(), PartSetHeader(1, header.hash()))
            self.headers[h] = (header, prev)
        self.blocks = {}
        self.sign_s = 0.0

    def block(self, h):
        from cometbft_tpu_torch.light.verifier import LightBlock, SignedHeader
        from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                     Commit, CommitSig)

        if h not in self.headers:
            return None
        if h not in self.blocks:
            t = time.perf_counter()
            header, bid = self.headers[h]
            ts = _ts(LCC_T0 + h, 42)
            commit = Commit(h, 0, bid, [
                CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, ts, b"")
                for v in self.vals[h].validators])
            sign_commit_typed(self.pool, commit, self.key_of)
            self.blocks[h] = LightBlock(SignedHeader(header, commit),
                                        self.vals[h])
            self.sign_s += time.perf_counter() - t
        return self.blocks[h]

    def provider(self, blocks=None):
        from cometbft_tpu_torch.light.client import Provider

        over = blocks or {}
        return Provider(CHAIN_ID, lambda h: over.get(h) or self.block(h))


def _ts(secs, nanos=0):
    from cometbft_tpu_torch.types.timestamp import Timestamp

    return Timestamp(secs, nanos)


def light_run(chain, batch_fn):
    """The skipping client from trusted height 1 to 8; -> (heights stored,
    verifications, ms of the verification net of the provider's
    signing)."""
    from cometbft_tpu_torch.light.client import Client

    c = Client(CHAIN_ID, chain.provider(), trusting_period=1e6,
               batch_fn=batch_fn)
    c.trust_light_block(chain.block(1))
    s0 = chain.sign_s
    t = time.perf_counter()
    lb = c.verify_light_block_at_height(8, now=_ts(LCC_T0 + 1000))
    ms = ((time.perf_counter() - t) - (chain.sign_s - s0)) * 1e3
    check(lb.height == 8 and lb.signed_header.header.hash()
          == chain.headers[8][0].hash(), "phase13 verified a wrong block")
    return c, c.store.heights(), c.verifications, ms


def phase_light_client(dev, pool, kernel_stats):
    """BASELINE config 5 as a whole: a port light Client, skipping, from
    trusted height 1 to 8 over a 10,000-validator secp256k1 chain whose
    validators change at height 5, with batch_fn=None so its commits go
    through a card VerifyPlane (its grouped path: ecdsa_verify)."""
    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.light.client import Client
    from cometbft_tpu_torch.light.verifier import (ErrInvalidHeader,
                                                   LightBlock, SignedHeader)
    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.types.commit import Commit, CommitSig
    from cometbft_tpu_torch.types.validation import (InvalidSignatureError,
                                                     oracle_batch_fn)
    from cometbft_tpu_torch.verifyplane import (FlushLedger, VerifyPlane,
                                                set_global_plane)

    t0 = time.perf_counter()
    chain = PlanChain(pool, light_plan(LCC_VALS))
    keys_s = time.perf_counter() - t0
    # the copy the CPU test runs, under the oracle: the path to match
    copy = PlanChain(pool, light_plan(LCC_COPY_VALS))
    _, want_heights, want_verifs, _ = light_run(copy, oracle_batch_fn())
    check(want_heights == [1, 4, 5, 6, 8],
          f"phase13 the {LCC_COPY_VALS}-validator copy stored "
          f"{want_heights}")
    era_a, era_b = chain.vals[1], chain.vals[5]
    kept = sum(v.voting_power for v in era_a.validators
               if era_b.has_address(v.address))
    print(f"phase13 fixtures validators={LCC_VALS} secp256k1 eras A/B "
          f"kept={sum(era_b.has_address(v.address) for v in era_a.validators)}"
          f" holding {kept / era_a.total_voting_power():.4f} of A's power "
          f"keys_s={keys_s:.3f}", flush=True)

    plane = VerifyPlane(window_ms=PLANE_WINDOW_MS, max_batch=PLANE_MAX_BATCH,
                        max_queue=PLANE_MAX_QUEUE)
    check(plane.device == dev, f"phase13 plane device {plane.device}")
    plane.ledger = FlushLedger(capacity=PLANE_LEDGER)
    brk = cbatch.device_breaker()
    plane.start()
    set_global_plane(plane)
    try:
        with capture_verify_rows(secp256k1=ef) as path_rows:
            zero_launches()
            c, heights, verifs, wall_ms = light_run(chain, None)
            n_main = len(plane.ledger.records())
            # a target whose commit carries a tampered signature, from
            # the trusted height 6
            lb8 = chain.block(8)
            sigs = list(lb8.signed_header.commit.signatures)
            cs = sigs[LCC_TAMPER_IDX]
            sigs[LCC_TAMPER_IDX] = CommitSig(
                cs.flag, cs.validator_address, cs.timestamp,
                flip(cs.signature, 40))
            bad = LightBlock(SignedHeader(lb8.signed_header.header, Commit(
                8, 0, lb8.signed_header.commit.block_id, sigs)),
                lb8.validator_set)
            c2 = Client(CHAIN_ID, chain.provider({8: bad}),
                        trusting_period=1e6)
            c2.trust_light_block(c.store.get(6))
            err = None
            try:
                c2.verify_light_block_at_height(8, now=_ts(LCC_T0 + 1000))
            except ErrInvalidHeader as e:
                err = e
            torch.cuda.synchronize()
            launches = read_launches()
    finally:
        set_global_plane(None)
        plane.stop()
    recs = plane.ledger.records()
    check(heights == want_heights and verifs == want_verifs,
          f"phase13 heights {heights} verifications {verifs}, the copy's "
          f"{want_heights} {want_verifs}")
    check(err is not None and isinstance(err.__cause__,
                                         InvalidSignatureError)
          and err.__cause__.idx == LCC_TAMPER_IDX,
          f"phase13 the tampered target gave {err!r}")
    check({r["path"] for r in recs} == {"grouped"},
          f"phase13 flush paths {sorted({r['path'] for r in recs})}")
    want_l = dict.fromkeys(launches, 0)
    want_l.update(ecdsa_verify=len(recs))
    check(launches == want_l and len(recs) == n_main + 1,
          f"phase13 launches {launches}, want {want_l}; flushes "
          f"{len(recs)} (main {n_main})")
    check(brk.trips == 0 and brk.faults == 0,
          f"phase13 breaker trips={brk.trips} faults={brk.faults}")
    points = ef.base_points(dev)
    err_k, cols = hold_shapes_against_plain(
        dev, ef.ecdsa_verify, lambda r: ef.ecdsa_verify_plain(r, points),
        path_rows["secp256k1"])
    check(err_k == 0, f"phase13 ecdsa_verify != plain at {cols} cols")
    restore_launches(launches)
    k = kernel_stats["ecdsa_verify"]
    k["launches_by_path"]["light_client"] = launches["ecdsa_verify"]
    k["max_abs_err"] = max(k["max_abs_err"], err_k)
    work = [round(r["pack_ms"] + r["flight_ms"] + r["collect_ms"]
                  + r["settle_ms"], 3) for r in recs[:n_main]]
    print(f"phase13 launches {json.dumps(launches)} breaker_faults=0 "
          f"tampered target: {type(err).__name__} blamed_idx="
          f"{err.__cause__.idx}; ecdsa_verify == plain at cols={cols}",
          flush=True)
    print(f"phase13 light client skipping 1 -> 8: heights={heights} "
          f"verifications={verifs} (the {LCC_COPY_VALS}-validator copy's) "
          f"verify_ms={wall_ms:.3f} (net of signing; signing_s="
          f"{chain.sign_s:.3f}) flushes={n_main} rows="
          f"{[r['rows'] for r in recs[:n_main]]} flush_work_ms={work} "
          f"sum={sum(work):.3f}; card={smi('name,power.limit')}", flush=True)
    return {"lc_client_ms": wall_ms, "lc_chain": chain,
            "lc_heights": heights, "lc_verifs": verifs}


# --------------------------------------------------------------------------
# phase 14: archival catch-up (blocksync/catchup.py) at config 4's width
# --------------------------------------------------------------------------


class CatchupState:
    """The state the catch-up engine replays into: the height applied and
    the validators of the next two heights."""

    __slots__ = ("chain_id", "last_block_height", "validators",
                 "next_validators")

    def __init__(self, h, vals_at):
        self.chain_id = CHAIN_ID
        self.last_block_height = h
        self.validators = vals_at(h + 1)
        self.next_validators = vals_at(h + 2)


class HistorySource:
    """An in-memory archive: {height: (Block, Commit)}."""

    def __init__(self, items):
        self.items = items

    def tip(self):
        return max(self.items)

    def load(self, h):
        from cometbft_tpu_torch.blocksync.catchup import CatchupError

        if h not in self.items:
            raise CatchupError(f"history missing block {h}")
        return self.items[h]


def catchup_history(pool, sets, seed_of):
    """STREAM_HEIGHTS real Blocks over phase 6's keys and powers (V0 for
    heights 1-64, V1 after), each header carrying its validators hash and
    the next height's, each commit signed by every validator; -> (items,
    vals_at, signatures)."""
    from cometbft_tpu_torch.types.block import Block, Data, Header

    def vals_at(h):
        return sets[0] if h <= V0_HEIGHTS else sets[1]

    hashes = {id(vs): vs.hash() for vs in sets}
    items, per_seed, prev = {}, {}, None
    for h in range(1, STREAM_HEIGHTS + 1):
        vs = vals_at(h)
        hdr = Header(chain_id=CHAIN_ID, height=h,
                     time=_ts(1_700_000_000 + h),
                     validators_hash=hashes[id(vs)],
                     next_validators_hash=hashes[id(vals_at(h + 1))],
                     proposer_address=vs.validators[0].address)
        if prev is not None:
            hdr.last_block_id = prev
        blk = Block(hdr, Data())
        blk.fill_header()
        prev = blk.block_id()
        commit = unsigned_commit(vs, h, prev, 1_700_000_000 + h)
        for i, (cs, m) in enumerate(zip(commit.signatures,
                                        commit.sign_bytes_rows(CHAIN_ID))):
            per_seed.setdefault(seed_of[cs.validator_address],
                                []).append((h, i, m))
        items[h] = (blk, commit)
    order = list(per_seed)
    n_sigs = 0
    for s, (_, sigs) in zip(order, sign_all(
            pool, [(s, [m for _, _, m in per_seed[s]]) for s in order])):
        for (h, i, _), sig in zip(per_seed[s], sigs):
            items[h][1].signatures[i].signature = sig
            n_sigs += 1
    return items, vals_at, n_sigs


def tampered_history(items, height, val):
    """A copy of `items` whose commit at `height` carries validator
    `val`'s signature with one bit flipped."""
    import copy

    out = dict(items)
    blk, commit = items[height]
    commit = copy.copy(commit)
    commit.signatures = list(commit.signatures)
    cs = copy.copy(commit.signatures[val])
    cs.signature = flip(cs.signature, 50)
    commit.signatures[val] = cs
    out[height] = (blk, commit)
    return out


def catchup_engine(items, vals_at, cursor_path, start=0, on_apply=None,
                   **kw):
    """A CatchupEngine from height `start` with its default verifier (the
    card's StreamVerifier) and the global warmer; on_apply(h) runs as each
    height is applied."""
    from cometbft_tpu_torch.blocksync.catchup import CatchupEngine

    def apply_fn(st, blk, commit):
        if on_apply is not None:
            on_apply(blk.header.height)
        return CatchupState(blk.header.height, vals_at)

    return CatchupEngine(HistorySource(items), CatchupState(start, vals_at),
                         apply_fn=apply_fn, cursor_path=cursor_path, **kw)


def hold_delta_chunks(dev, chunks, phase):
    """Each captured delta chunk's stamp_rows, ed25519_verify_cached and
    tally_quorum_cached on the card against their plain versions; ->
    (max |kernel - plain|, [columns])."""
    import torch

    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    err, cols = 0, []
    for chunk in chunks:
        tb, en, n_c = chunk["table"], chunk["ent"], chunk["n_commits"]
        Bc = chunk["sig"].shape[0]
        tr = ec.packed_rows_shape(Bc, n_c)[0] - ec.V_THRESH
        args = [torch.from_numpy(chunk[k]).to(dev)
                for k in ("sig", "ts", "flags")]
        thr = torch.from_numpy(chunk["thresh"]).to(dev)
        rows = es.stamp_rows(*args, en, tb.pub_raw, thr, tr)
        rows_p = es.stamp_rows_plain(*args, en.pre_mat, en.pre_len,
                                     en.suf_mat, en.suf_len, en.ts_tag,
                                     tb.pub_raw, thr, en.msg_max, tr)
        v = ec.ed25519_verify_cached(rows, tb.tab, tb.ok)
        v_p = ec.ed25519_verify_cached_plain(rows, tb.tab, tb.ok,
                                             ec.kf.base_points(dev))
        t, q = ec.tally_quorum_cached(v, rows, tb.power5, n_c)
        t_p, q_p = ec.tally_quorum_cached_plain(v, rows, tb.power5, n_c)
        err = max(err,
                  int((rows.to(torch.int64) - rows_p.to(torch.int64))
                      .abs().max()),
                  int((v - v_p).abs().max()),
                  int((t.to(torch.int64) - t_p.to(torch.int64)).abs().max()),
                  int((q.to(torch.int64) - q_p.to(torch.int64)).abs().max()))
        cols.append(Bc)
    check(err == 0, f"{phase} a catch-up chunk's kernels != plain at {cols}")
    return err, cols


def phase_catchup(dev, pool, res, kernel_stats):
    """ROADMAP A5's catch-up engine at config 4's width: 80 real Blocks of
    phase 6's 1,000 validators (V0 for 1-64, V1 with 8 rotated keys for
    65-80), replayed by a CatchupEngine with its default verifier (the
    card's StreamVerifier) and a card TableWarmer mounted as the global
    warmer: two segments, warm-ahead of V1 at height 63, the 65-80 segment
    on the warmed table; then a kill at the read-ahead failpoint and a
    resume that re-verifies nothing, and a tampered history."""
    import tempfile

    import torch

    from cometbft_tpu_torch.blocksync import catchup as cu
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.libs import failpoints as fp
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.ops import table_cache as tcache
    from cometbft_tpu_torch.verifyplane.warmer import (TableWarmer,
                                                       clear_global_warmer,
                                                       set_global_warmer)

    t0 = time.perf_counter()
    items, vals_at, n_sigs = catchup_history(pool, res["stream_sets"],
                                             res["stream_seed_of"])
    print(f"phase14 fixtures blocks={STREAM_HEIGHTS} validators="
          f"{STREAM_VALS} signatures={n_sigs} keys+signatures_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)
    brk = cbatch.device_breaker()
    # phase 6 left V0's and V1's tables in the cache: start cold
    tcache.reset_for_tests()
    warmer = TableWarmer()
    check(warmer.device == dev, f"phase14 warmer device {warmer.device}")
    warmer.start()
    set_global_warmer(warmer)
    chunks = []
    real_delta = es.verify_tally_delta_cached

    def capture_delta(sig, ts, flags, ent, table, n_commits, thresh=None):
        import numpy as np

        chunks.append(dict(sig=sig.copy(), ts=ts.copy(), flags=flags.copy(),
                           ent=ent, table=table, n_commits=n_commits,
                           thresh=np.asarray(thresh).copy()))
        return real_delta(sig, ts, flags, ent, table, n_commits, thresh)

    cursors = tempfile.TemporaryDirectory(prefix="catchup-")
    td = cursors.name
    try:
        es.verify_tally_delta_cached = capture_delta
        at_boundary, applied, warm_at = {}, [0], []
        real_request = warmer.request_valset

        def request_valset(vals, chain_id=None):
            warm_at.append(applied[0])
            real_request(vals, chain_id=chain_id)

        warmer.request_valset = request_valset

        def on_apply(h):
            applied[0] = h
            # the last height before V1: hold its apply until the warm
            # that height 63 started is idle, so the 65-80 segment is
            # measured on the warmed table every run (the wait is printed)
            if h == V0_HEIGHTS:
                t = time.perf_counter()
                check(warmer.wait_idle(120.0), "phase14 warmer never idled")
                at_boundary.update(
                    wait_ms=(time.perf_counter() - t) * 1e3,
                    launches=read_launches(),
                    stats=ec.table_cache_stats(),
                    verified=eng.cursor.verified)

        zero_launches()
        s0 = ec.table_cache_stats()
        eng = catchup_engine(items, vals_at, os.path.join(td, "main.json"),
                             on_apply=on_apply)
        check(eng.verifier.device == dev,
              f"phase14 default verifier on {eng.verifier.device}")
        t = time.perf_counter()
        eng.run()
        wall_s = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = read_launches()
        s2 = ec.table_cache_stats()
        warmer.request_valset = real_request
        es.verify_tally_delta_cached = real_delta
        wstats = warmer.stats()

        # a kill at the read-ahead seam once 1-64 are applied, then a
        # resume from the persisted cursor
        cpath = os.path.join(td, "kill.json")
        fp.set_crash_handler(fp.simulated_crash)
        eng_k = catchup_engine(items, vals_at, cpath, read_ahead=V0_HEIGHTS)
        eng_k.run(until=V0_HEIGHTS)
        fp.arm("catchup.read_ahead", "crash", count=1)
        crashed = None
        try:
            eng_k.run()
        except fp.SimulatedCrash as e:
            crashed = e
        finally:
            fp.reset()
            fp.set_crash_handler(None)
        cursor_k = dict(eng_k.cursor.as_dict())
        zero_launches()
        eng_r = catchup_engine(items, vals_at, cpath,
                               start=cursor_k["applied"],
                               read_ahead=V0_HEIGHTS)
        check(eng_r.cursor.resumed and eng_r.cursor.verified == V0_HEIGHTS,
              f"phase14 resume cursor {eng_r.cursor.as_dict()}")
        eng_r.run()
        torch.cuda.synchronize()
        launches_resume = read_launches()

        # a tampered signature at height TAMPER_HEIGHT
        bad_items = tampered_history(items, TAMPER_HEIGHT, TAMPER_VAL)
        eng_t = catchup_engine(bad_items, vals_at,
                               os.path.join(td, "tamper.json"))
        tamper_err = None
        try:
            eng_t.run()
        except cu.CatchupError as e:
            tamper_err = e
    finally:
        es.verify_tally_delta_cached = real_delta
        fp.reset()
        fp.set_crash_handler(None)
        clear_global_warmer(warmer)
        warmer.stop()
        cursors.cleanup()

    recs = eng.ledger.records()
    c = eng.ledger.counters
    check(eng.state.last_block_height == STREAM_HEIGHTS,
          f"phase14 replay stopped at {eng.state.last_block_height}")
    # the first segment ends at the epoch boundary, or at MAX_RUN first
    # (the card's 64 heights fill it, so the pre-scan never reaches 65)
    check([(r["first"], r["last"], r["boundary"], r["warmed"])
           for r in recs] == [(1, V0_HEIGHTS, V0_HEIGHTS < cu.MAX_RUN, True),
                              (V0_HEIGHTS + 1, STREAM_HEIGHTS, False, False)],
          f"phase14 segments {recs}")
    check(c["blocks_verified"] == STREAM_HEIGHTS and c["warm_requests"] == 1
          and c["sigs_verified"] == n_sigs and warm_at == [V0_HEIGHTS - 1],
          f"phase14 counters {c}, warm-ahead at heights {warm_at}")
    want_seg1 = dict.fromkeys(launches, 0)
    want_seg1.update(stamp_rows=1, ed25519_verify_cached=1,
                     tally_quorum_cached=1, valset_table_build=1)
    launches_seg1, s1 = at_boundary["launches"], at_boundary["stats"]
    check(at_boundary["verified"] == V0_HEIGHTS
          and launches_seg1 == dict(want_seg1, valset_table_build=2),
          f"phase14 segment 1-64 with the warm: {at_boundary}")
    want = dict(want_seg1, stamp_rows=2, ed25519_verify_cached=2,
                tally_quorum_cached=2, valset_table_build=2)
    check(launches == want, f"phase14 launches {launches}, want {want}")
    check(s1["misses"] - s0["misses"] == 2
          and wstats["builds_incremental"] == 1,
          f"phase14 cold build and warm: table stats {s0} -> {s1}, "
          f"warmer {wstats}")
    check(s2["warmed_hits"] - s1["warmed_hits"] == 1
          and s2["misses"] == s1["misses"],
          f"phase14 the 65-80 segment's table lookups {s1} -> {s2}")
    check(isinstance(crashed, fp.SimulatedCrash)
          and cursor_k["verified"] == cursor_k["applied"] == V0_HEIGHTS,
          f"phase14 kill: {crashed!r} cursor {cursor_k}")
    cr = eng_r.ledger.counters
    check(eng_r.state.last_block_height == STREAM_HEIGHTS
          and cr["blocks_verified"] == STREAM_HEIGHTS - V0_HEIGHTS
          and cr["blocks_skipped"] == 0 and cr["resumes"] == 1
          and eng_r.ledger.records()[0]["first"] == V0_HEIGHTS + 1,
          f"phase14 resume {cr} {eng_r.ledger.records()}")
    check(launches_resume == dict(want_seg1, valset_table_build=0),
          f"phase14 resume launches {launches_resume}")
    check(tamper_err is not None
          and f"height {TAMPER_HEIGHT}:" in str(tamper_err)
          and f"#{TAMPER_VAL}" in str(tamper_err)
          and eng_t.cursor.verified == 0,
          f"phase14 tampered history gave {tamper_err!r}, cursor "
          f"{eng_t.cursor.as_dict()}")
    check(brk.trips == 0 and brk.faults == 0,
          f"phase14 breaker trips={brk.trips} faults={brk.faults}")
    err, cols = hold_delta_chunks(dev, chunks, "phase14")
    restore_launches(launches)
    for name in ("stamp_rows", "ed25519_verify_cached",
                 "tally_quorum_cached", "valset_table_build"):
        kernel_stats[name]["launches_by_path"]["catchup"] = launches[name]
        kernel_stats[name]["max_abs_err"] = max(
            kernel_stats[name]["max_abs_err"], err)
    wait_ms = at_boundary["wait_ms"]
    replay_s = wall_s - wait_ms / 1e3
    print(f"phase14 launches {json.dumps(launches)} (to height "
          f"{V0_HEIGHTS}, with the warmer's delta build: "
          f"{json.dumps(launches_seg1)}) warmed_hits=1 misses_in_"
          f"{V0_HEIGHTS + 1}_{STREAM_HEIGHTS}=0 "
          f"warmer={json.dumps(wstats)} wait_for_the_warmer_ms={wait_ms:.3f};"
          f" kernels == plain at cols={cols}", flush=True)
    print(f"phase14 catch-up 1 -> {STREAM_HEIGHTS}: wall_ms="
          f"{wall_s * 1e3:.3f} blocks_per_s={STREAM_HEIGHTS / replay_s:.1f} "
          f"sigs_per_s={n_sigs / replay_s:.1f} (net of the wait) "
          f"segments=" + json.dumps([
              {k: r[k] for k in ("first", "last", "blocks", "sigs",
                                 "read_ms", "verify_ms", "apply_ms",
                                 "boundary", "warmed")} for r in recs])
          + f" card={smi('name,power.limit')}", flush=True)
    print(f"phase14 kill at read {V0_HEIGHTS + 1}: cursor={cursor_k}, "
          f"resume verified {cr['blocks_verified']} re-verified 0 launches "
          f"{json.dumps(launches_resume)}; tampered height {TAMPER_HEIGHT}: "
          f"{type(tamper_err).__name__}: {tamper_err}", flush=True)
    return {"catchup_blocks_per_s": STREAM_HEIGHTS / replay_s}


# --------------------------------------------------------------------------
# phase 15: the light-client gateway and evidence at config 5's width
# --------------------------------------------------------------------------


def forged_claim(header, vals, sign_commit):
    """A lying primary's view of `header`'s height (tests/test_lightgate.py
    _forged_claim): the same header with another app hash, sealed by every
    validator of `vals` (sign_commit fills the commit's signatures); ->
    the {"header", "commit"} claim a client hands the gateway."""
    from cometbft_tpu_torch.types import serde
    from cometbft_tpu_torch.types.block import Header
    from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
    from cometbft_tpu_torch.types.commit import (BLOCK_ID_FLAG_COMMIT,
                                                 Commit, CommitSig)

    forged = Header(
        chain_id=header.chain_id, height=header.height, time=header.time,
        last_block_id=header.last_block_id,
        validators_hash=header.validators_hash,
        next_validators_hash=header.next_validators_hash,
        proposer_address=header.proposer_address, app_hash=b"\x66" * 32)
    hh = forged.hash()
    commit = Commit(header.height, 0, BlockID(hh, PartSetHeader(1, hh)), [
        CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, header.time, b"")
        for v in vals.validators])
    sign_commit(commit)
    return {"header": serde.header_to_j(forged),
            "commit": serde.commit_to_j(commit)}


def storm(n, fn):
    """n threads released together, thread k calling fn(k); -> ({k:
    result}, [error], wall ms)."""
    import threading

    barrier = threading.Barrier(n + 1)
    out, errs = {}, []
    lock = threading.Lock()

    def worker(k):
        barrier.wait()
        try:
            v = fn(k)
            with lock:
                out[k] = v
        except Exception as e:  # noqa: BLE001 - reported by the caller
            with lock:
                errs.append(repr(e))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n)]
    for th in threads:
        th.start()
    barrier.wait()
    t = time.perf_counter()
    for th in threads:
        th.join(300.0)
        check(not th.is_alive(), "a storm client never returned")
    return out, errs, (time.perf_counter() - t) * 1e3


def gateway_waves(gw, claim, now, threads, divergent_threads, after_wave):
    """The gateway's three waves: `threads` clients asking verify(1, 8) at
    once, the same again, then `divergent_threads` clients on the era-B
    pair, the odd ones handing over `claim`; after_wave() runs after each;
    -> [(results, errors, ms)] (tests/test_torch_lightgate.py runs these
    waves at LCC_COPY_VALS on the CPU)."""
    t_h, g_h = GW_ERA_B_PAIR
    waves = []
    for w in range(3):
        if w < 2:
            waves.append(storm(threads,
                               lambda k: gw.verify(1, g_h, now=now)))
        else:
            waves.append(storm(divergent_threads, lambda k: gw.verify(
                t_h, g_h, claimed=claim if k % 2 else None, now=now)))
        after_wave()
    return waves


def phase_gateway(dev, pool, res, kernel_stats):
    """ROADMAP A5's light-client gateway and evidence at config 5's width:
    a port LightGateway (default batch_fn: the GATEWAY lane) over a card
    VerifyPlane and phase 13's 10,000-validator secp256k1 chain, with a
    port EvidencePool (batch_fn=None); 64 clients coalesce into one
    verification, repeat as LRU hits, and 8 clients on the era-B pair, 4
    of them lied to by their primary, give one verified attack evidence."""
    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.evidence.pool import EvidencePool
    from cometbft_tpu_torch.lightgate import LightGateway
    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
    from cometbft_tpu_torch.verifyplane import (FlushLedger, VerifyPlane,
                                                set_global_plane)

    chain = res["lc_chain"]
    t_h, g_h = GW_ERA_B_PAIR
    era_b = chain.vals[g_h]
    t0 = time.perf_counter()
    claim = forged_claim(chain.headers[g_h][0], era_b,
                         lambda c: sign_commit_typed(pool, c, chain.key_of))
    print(f"phase15 fixtures the era-B forged claim at height {g_h}: "
          f"{len(era_b)} secp256k1 signatures in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    ev_pool = EvidencePool(CHAIN_ID, lambda h: chain.vals.get(h))
    ev_pool.height, ev_pool.time_s = g_h, LCC_T0 + g_h
    plane = VerifyPlane(window_ms=PLANE_WINDOW_MS, max_batch=PLANE_MAX_BATCH,
                        max_queue=PLANE_MAX_QUEUE)
    check(plane.device == dev, f"phase15 plane device {plane.device}")
    plane.ledger = FlushLedger(capacity=PLANE_LEDGER)
    brk = cbatch.device_breaker()
    gw = LightGateway(CHAIN_ID, chain.provider(), evidence_pool=ev_pool,
                      trusting_period=1e6)
    gw.client.trust_light_block(chain.block(1))
    gw.start(register=False)
    now = _ts(LCC_T0 + 1000)
    plane.start()
    set_global_plane(plane)
    try:
        with capture_verify_rows(secp256k1=ef) as path_rows:
            zero_launches()
            marks, stats, launch_marks = [], [], []

            def mark():
                torch.cuda.synchronize()
                marks.append(len(plane.ledger.records()))
                stats.append(gw.stats())
                launch_marks.append(read_launches())

            waves = gateway_waves(gw, claim, now, GW_THREADS,
                                  GW_DIVERGENT_THREADS, mark)
            launches = launch_marks[-1]
    finally:
        set_global_plane(None)
        plane.stop()
        gw.stop()
    recs = plane.ledger.records()
    want_hash = chain.headers[g_h][0].hash().hex()
    (w1, e1, ms1), (w2, e2, ms2), (w3, e3, ms3) = waves
    check(not e1 and not e2 and not e3, f"phase15 errors {e1 + e2 + e3}")
    check(len(w1) == GW_THREADS and all(
        v["status"] == "verified" and v["target_hash"] == want_hash
        for v in w1.values()), "phase15 wave 1 verdicts")
    st1, st2, st3 = stats
    check(st1["verifies"] == 1
          and st1["coalesced"] + st1["cache"]["hits"] == GW_THREADS - 1,
          f"phase15 wave 1 stats {st1}")
    check(gw.client.store.heights() == res["lc_heights"]
          and st1["client_verifications"] == res["lc_verifs"],
          f"phase15 store {gw.client.store.heights()} verifications "
          f"{st1['client_verifications']}, phase 13's {res['lc_heights']} "
          f"{res['lc_verifs']}")
    w1_recs = recs[:marks[0]]
    check(w1_recs and all(r["path"] == "grouped" and r["g_rows"] == r["rows"]
                          for r in w1_recs),
          "phase15 wave 1 flushes "
          f"{[(r['path'], r['rows'], r['g_rows']) for r in w1_recs]}")
    check(launch_marks[0]["ecdsa_verify"] == len(w1_recs)
          and sum(launch_marks[0].values()) == len(w1_recs),
          f"phase15 wave 1 launches {launch_marks[0]}, "
          f"{len(w1_recs)} flushes")
    check(len(w2) == GW_THREADS and all(v["cached"] for v in w2.values())
          and marks[1] == marks[0] and launch_marks[1] == launch_marks[0]
          and st2["verifies"] == 1
          and st2["cache"]["hits"] - st1["cache"]["hits"] == GW_THREADS,
          f"phase15 wave 2: flushes {marks}, stats {st2}")
    divergent = sorted(k for k, v in w3.items() if v["status"] == "divergent")
    check(len(w3) == GW_DIVERGENT_THREADS
          and divergent == list(range(1, GW_DIVERGENT_THREADS, 2))
          and all(v["status"] == "verified" and v["target_hash"] == want_hash
                  for k, v in w3.items() if k % 2 == 0),
          "phase15 wave 3 verdicts "
          f"{[(k, v['status']) for k, v in sorted(w3.items())]}")
    evs = ev_pool.pending_evidence()
    check(ev_pool.size() == 1 and isinstance(evs[0], LightClientAttackEvidence)
          and len(evs[0].byzantine_validators) == len(era_b)
          and evs[0].common_height == t_h
          and st3["evidence_submitted"] == 1
          and st3["divergences"] == GW_DIVERGENT_THREADS // 2,
          f"phase15 evidence pool size {ev_pool.size()} stats {st3}")
    w3_recs = recs[marks[1]:]
    check(w3_recs and all(r["path"] == "grouped" and r["c_rows"] == r["rows"]
                          for r in w3_recs)
          and max(r["rows"] for r in w3_recs) >= len(era_b),
          "phase15 wave 3 flushes "
          f"{[(r['path'], r['rows'], r['c_rows']) for r in w3_recs]}")
    want_l = dict.fromkeys(launches, 0)
    want_l.update(ecdsa_verify=len(recs))
    check(launches == want_l, f"phase15 launches {launches}, want {want_l}")
    check(brk.trips == 0 and brk.faults == 0,
          f"phase15 breaker trips={brk.trips} faults={brk.faults}")
    err_k, cols = hold_shapes_against_plain(
        dev, ef.ecdsa_verify,
        lambda r: ef.ecdsa_verify_plain(r, ef.base_points(dev)),
        path_rows["secp256k1"])
    check(err_k == 0, f"phase15 ecdsa_verify != plain at {cols} cols")
    restore_launches(launches)
    k = kernel_stats["ecdsa_verify"]
    k["launches_by_path"]["lightgate"] = launches["ecdsa_verify"]
    k["max_abs_err"] = max(k["max_abs_err"], err_k)
    print(f"phase15 launches {json.dumps(launches)} breaker_faults=0; "
          f"ecdsa_verify == plain at cols={cols}", flush=True)
    print(f"phase15 gateway wave 1: {GW_THREADS} clients verify(1, {g_h}) "
          f"ms={ms1:.3f} verifies={st1['verifies']} coalesced="
          f"{st1['coalesced']} lru_hits={st1['cache']['hits']} flushes="
          f"{marks[0]} rows={[r['rows'] for r in w1_recs]} heights="
          f"{gw.client.store.heights()} verifications="
          f"{st1['client_verifications']}; wave 2: ms={ms2:.3f} flushes="
          f"{marks[1] - marks[0]} lru_hits="
          f"{st2['cache']['hits'] - st1['cache']['hits']}; wave 3: "
          f"{GW_DIVERGENT_THREADS} clients verify({t_h}, {g_h}), "
          f"{len(divergent)} lied to: ms={ms3:.3f} divergent={divergent} "
          f"evidence=1 byzantine={len(evs[0].byzantine_validators)} "
          f"flushes={len(w3_recs)} rows={[r['rows'] for r in w3_recs]}; "
          f"card={smi('name,power.limit')}", flush=True)
    return {"gw_wave1_ms": ms1, "gw_wave3_ms": ms3}


# --------------------------------------------------------------------------
# phase 16: the application boundary and block execution at config 2's width
# --------------------------------------------------------------------------


def app_txs(pool, rng):
    """Phase 16's CheckTx mix over APP_CLIENTS client keys (not
    validators), shuffled: valid sigtx envelopes, envelopes with a flipped
    signature byte, malformed envelopes (the magic and a short frame) and
    unsigned key=value txs, APP_MIX of each; -> [(tx, expected code, (pub,
    msg, sig) or None)]."""
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.mempool import sigtx

    clients = APP_CLIENTS
    n_valid, n_flip, n_bad, n_plain = APP_MIX
    seeds = [seed_bytes(rng) for _ in range(clients)]
    per: dict = {}
    for j in range(n_valid + n_flip):
        per.setdefault(j % clients, []).append(j)

    def payload(j):
        return b"c%d-tx%d=%d" % (j % clients, j, j * 7919 % 100_003)

    order = list(per)
    signed = sign_all(pool, [(seeds[c], [sigtx.sign_bytes(payload(j))
                                         for j in per[c]]) for c in order])
    txs = []
    for c, (pub, sigs) in zip(order, signed):
        for j, sig in zip(per[c], sigs):
            code = abci.CODE_TYPE_OK
            if j >= n_valid:
                sig, code = flip(sig, 5), abci.CODE_TYPE_BAD_SIGNATURE
            msg = sigtx.sign_bytes(payload(j))
            txs.append((sigtx.MAGIC + pub + sig + payload(j), code,
                        (pub, msg, sig)))
    txs += [(sigtx.MAGIC + b"short-%d" % i, abci.CODE_TYPE_BAD_SIGNATURE,
             None) for i in range(n_bad)]
    txs += [(b"u%d=%d" % (i, i), abci.CODE_TYPE_OK, None)
            for i in range(n_plain)]
    return [txs[i] for i in rng.permutation(len(txs))]


def checktx_wave(mp, txs, threads):
    """`threads` clients released together, client k sending txs[k::threads]
    through mp.check_tx and sending a tx answered OVERLOADED again after
    its retry hint (as a client of broadcast_tx backs off); -> ({tx: final
    response}, OVERLOADED answers, [error], wall ms)."""
    import threading

    from cometbft_tpu_torch.abci import types as abci

    out, sheds, lock = {}, [0], threading.Lock()

    def client(k):
        for tx in txs[k::threads]:
            for _ in range(APP_RESENDS):
                r = mp.check_tx(tx)
                if r.code != abci.CODE_TYPE_OVERLOADED:
                    break
                with lock:
                    sheds[0] += 1
                time.sleep(r.retry_after_ms / 1e3)
            with lock:
                out[tx] = r

    _, errs, ms = storm(threads, client)
    return out, sheds[0], errs, ms


def app_genesis(vs, max_bytes):
    """A GenesisDoc of `vs`'s validators and powers whose block size
    spreads the mempool over the heights."""
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.params import ConsensusParams
    from cometbft_tpu_torch.types.timestamp import Timestamp

    return GenesisDoc(
        chain_id=CHAIN_ID, genesis_time=Timestamp(APP_T0, 0),
        validators=[GenesisValidator(v.pub_key, v.voting_power)
                    for v in vs.validators],
        consensus_params=ConsensusParams.from_j(
            {"block": {"max_bytes": max_bytes}}))


def signed_commit(pool, vs, bid, h, seed_of):
    """Height h's commit for `bid`, every validator of `vs` signing (on
    the pool)."""
    commit = unsigned_commit(vs, h, bid, APP_T0 + h)
    rows = commit.sign_bytes_rows(CHAIN_ID)
    for cs, (_, (sig,)) in zip(commit.signatures, sign_all(pool, [
            (seed_of[cs.validator_address], [m])
            for cs, m in zip(commit.signatures, rows)])):
        cs.signature = sig
    return commit


def time_calls(obj, name, sink):
    """Wrap obj.name so each call appends its ms to `sink`."""
    real = getattr(obj, name)

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            sink.append((time.perf_counter() - t) * 1e3)

    setattr(obj, name, timed)


def state_row(st) -> str:
    """The JSON a StateStore persists for `st`."""
    from cometbft_tpu_torch.state.state import StateStore

    s = StateStore(":memory:")
    s.save(st)
    row = s._db.execute("SELECT v FROM state WHERE k='state'").fetchone()[0]
    s.close()
    return row


def val_txs(gone, added):
    """`val:` txs removing the validators `gone` (power 0) and adding
    `added` [(pub, power)]."""
    import base64

    return ([b"val:" + base64.b64encode(v.pub_key.data) + b"!0"
             for v in gone]
            + [b"val:" + base64.b64encode(p) + b"!%d" % w
               for p, w in added])


def phase_app(dev, pool, rng, res, kernel_stats):
    """ROADMAP A6 and the execution half of A7a at BASELINE config 2's
    width: a port Mempool over the kvstore app (node-side sigtx checks on
    a card VerifyPlane's BULK lane, admission wired to the device breaker)
    takes a wave of CheckTx from 64 threads, then a BlockExecutor with
    batch_fn=None (the plane's CONSENSUS lane) proposes and applies 8
    blocks of phase 6's 1,000 validators from a GenesisDoc, each
    LastCommit verified on the card, height 3 rotating 8 validators
    (the card TableWarmer builds the next set); then a tampered LastCommit,
    a dispatch fault and a squeezed BULK lane."""
    import copy

    import torch

    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.crypto.keys import PubKey
    from cometbft_tpu_torch.libs import failpoints as fp
    from cometbft_tpu_torch.mempool import sigtx
    from cometbft_tpu_torch.mempool.admission import AdmissionController
    from cometbft_tpu_torch.mempool.mempool import Mempool
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import table_cache as tcache
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import StateStore
    from cometbft_tpu_torch.store.blockstore import BlockStore
    from cometbft_tpu_torch.types import serde
    from cometbft_tpu_torch.types.validation import InvalidSignatureError
    from cometbft_tpu_torch.verifyplane import (FlushLedger, TableWarmer,
                                                VerifyPlane,
                                                clear_global_warmer,
                                                set_global_plane,
                                                set_global_warmer)

    # -- fixtures ----------------------------------------------------------
    t0 = time.perf_counter()
    v0 = res["stream_sets"][0]
    seed_of = dict(res["stream_seed_of"])
    txs = app_txs(pool, rng)
    new_seeds = [seed_bytes(rng) for _ in range(APP_ROTATED)]
    gone = v0.validators[-APP_ROTATED:]
    added = [(pub, v.voting_power) for (pub, _), v in zip(
        sign_all(pool, [(s, []) for s in new_seeds]), gone)]
    new_addrs = set()
    for (pub, _), s in zip(added, new_seeds):
        new_addrs.add(PubKey(pub).address())
        seed_of[PubKey(pub).address()] = s
    rot_txs = val_txs(gone, added)
    # the fault runs' envelopes: one client, fresh payloads
    fault_payloads = [b"fault-%d=v" % i for i in range(2 + APP_SQUEEZE_TXS)]
    (fpub, fsigs), = sign_all(pool, [(seed_bytes(rng), [
        sigtx.sign_bytes(p) for p in fault_payloads])])
    fault_txs = [sigtx.MAGIC + fpub + s + p
                 for s, p in zip(fsigs, fault_payloads)]
    fault_txs[1] = sigtx.MAGIC + fpub + flip(fsigs[1], 9) + fault_payloads[1]
    ok_txs = [tx for tx, code, _ in txs if code == abci.CODE_TYPE_OK]
    signed_rows = [row for _, _, row in txs if row is not None]
    ok_bytes = sum(len(tx) for tx in ok_txs) + sum(len(t) for t in rot_txs)
    max_bytes = -(-ok_bytes // APP_HEIGHTS) + 1024
    doc = app_genesis(v0, max_bytes)
    print(f"phase16 fixtures validators={len(v0)} clients={APP_CLIENTS} "
          f"txs={len(txs)} (valid, flipped, malformed, unsigned = "
          f"{list(APP_MIX)}) signed_rows={len(signed_rows)} "
          f"block_max_bytes={max_bytes} keys+signatures_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)

    brk = cbatch.device_breaker()
    tcache.reset_for_tests()
    plane = VerifyPlane(window_ms=PLANE_WINDOW_MS, max_batch=PLANE_MAX_BATCH,
                        max_queue=PLANE_MAX_QUEUE)
    check(plane.device == dev, f"phase16 plane device {plane.device}")
    plane.ledger = FlushLedger(capacity=PLANE_LEDGER)
    warmer = TableWarmer()
    check(warmer.device == dev, f"phase16 warmer device {warmer.device}")
    app = KVStoreApplication()
    adm = AdmissionController(
        breaker_open_fn=lambda: brk.state == "open")
    mp_ = Mempool(app, verify_sigs=True, admission=adm)
    adm._fill_fn = mp_.fill_fraction
    store, blocks = StateStore(":memory:"), BlockStore(":memory:")
    ex = BlockExecutor(app, store, batch_fn=None, mempool=mp_)
    validate_ms, update_ms = [], []
    time_calls(ex, "validate_block", validate_ms)
    time_calls(mp_, "update", update_ms)
    notified = []
    real_request = warmer.request_valset

    def request_valset(vals, chain_id=None):
        notified.append(len(vals))
        real_request(vals, chain_id=chain_id)

    warmer.request_valset = request_valset
    plane.start()
    set_global_plane(plane)
    warmer.start()
    set_global_warmer(warmer)
    heights, applied = [], {}
    try:
        # -- the CheckTx wave ----------------------------------------------
        with capture_verify_rows(ed25519=kf) as wave_rows:
            zero_launches()
            got, sheds, errs, wave_ms = checktx_wave(
                mp_, [tx for tx, _, _ in txs], APP_THREADS)
            torch.cuda.synchronize()
            wave_l = read_launches()
        wave_recs = plane.ledger.records()
        lanes = plane.stats()["lane_rows"]
        check(not errs, f"phase16 CheckTx errors {errs[:3]}")
        wrong = [(tx[:12], got[tx].code, code) for tx, code, _ in txs
                 if got[tx].code != code]
        check(not wrong, f"phase16 {len(wrong)} CheckTx codes differ from "
              f"the built ones: {wrong[:3]}")
        spot = [signed_rows[i] for i in rng.choice(
            len(signed_rows), min(APP_SPOT, len(signed_rows)),
            replace=False)]
        oracle = oracle_verdicts(pool, "ed25519", *zip(*spot))
        by_row = {row: got[tx].code == abci.CODE_TYPE_OK
                  for tx, _, row in txs if row is not None}
        check([by_row[r] for r in spot] == list(oracle),
              "phase16 a signed tx's verdict differs from ed25519_ref")
        check(mp_.size() == mp_.gas_entries() == len(ok_txs),
              f"phase16 pool {mp_.size()} gas {mp_.gas_entries()}, want "
              f"{len(ok_txs)}")
        check(lanes["bulk"] == len(signed_rows) and lanes["consensus"] == 0,
              f"phase16 lane rows {lanes}, want bulk {len(signed_rows)}")
        paths = sorted({r["path"] for r in wave_recs})
        flushes = [r for r in wave_recs if r["path"] != "shed_only"]
        check(paths in (["grouped"], ["grouped", "shed_only"]),
              f"phase16 the wave's flush paths {paths}")
        want_l = dict.fromkeys(wave_l, 0)
        want_l.update(ed25519_verify=len(flushes))
        check(wave_l == want_l, f"phase16 wave launches {wave_l}, want "
              f"{want_l}")
        print(f"phase16 CheckTx wave: {len(txs)} txs from {APP_THREADS} "
              f"threads in {wave_ms:.3f} ms = "
              f"{len(txs) / wave_ms * 1e3:.1f} CheckTx/s; OK "
              f"{len(ok_txs)}, bad signature "
              f"{len(txs) - len(ok_txs)}, resent after OVERLOADED {sheds}; "
              f"spot-checked {len(spot)} against ed25519_ref; bulk rows "
              f"{lanes['bulk']} in {len(flushes)} flushes (paths {paths}), "
              f"rows a flush p50={statistics.median(r['rows'] for r in flushes)}"
              f" max={max(r['rows'] for r in flushes)}; ed25519_verify "
              f"launches {wave_l['ed25519_verify']}; admission "
              f"{json.dumps(adm.stats()['counts'])}", flush=True)

        # -- block production ----------------------------------------------
        state = doc.make_state()
        store.save(state)
        last_commit = None
        with capture_verify_rows(ed25519=kf) as block_rows:
            zero_launches()
            for h in range(1, APP_HEIGHTS + 1):
                t = time.perf_counter()
                extra = None
                if h == APP_ROTATE_AT:
                    for tx in rot_txs:
                        r = mp_.check_tx(tx)
                        check(r.code == 0, f"phase16 val tx refused: {r}")
                    room = max_bytes - sum(len(tx) for tx in rot_txs)
                    extra = rot_txs + mp_.reap(max_bytes=room)
                block = ex.create_proposal_block(
                    h, state, last_commit,
                    state.validators.get_proposer().address, txs=extra)
                bid = block.block_id()
                propose_ms = (time.perf_counter() - t) * 1e3
                t = time.perf_counter()
                commit = signed_commit(pool, state.validators, bid, h,
                                       seed_of)
                sign_s = time.perf_counter() - t
                n0 = len(plane.ledger.records())
                l0 = kf.ed25519_verify.launches
                t = time.perf_counter()
                state = ex.apply_block(state, bid, block, validate=True)
                apply_ms = (time.perf_counter() - t) * 1e3
                recs = plane.ledger.records()[n0:]
                blocks.save_block(block, commit)
                applied[h] = (block, commit)
                want_flush = [] if h == 1 else [("grouped", len(
                    block.last_commit.signatures))]
                check([(r["path"], r["rows"]) for r in recs] == want_flush
                      and kf.ed25519_verify.launches - l0 == len(want_flush),
                      f"phase16 height {h} flushes "
                      f"{[(r['path'], r['rows']) for r in recs]}, want "
                      f"{want_flush}")
                if h == APP_ROTATE_AT:
                    check(warmer.wait_idle(120.0),
                          "phase16 the warmer never idled")
                heights.append(dict(
                    height=h, txs=len(block.data.txs),
                    validate_ms=round(validate_ms[-1], 3),
                    apply_ms=round(apply_ms, 3),
                    update_ms=round(update_ms[-1], 3),
                    propose_ms=round(propose_ms, 3),
                    sign_s=round(sign_s, 3),
                    flush=recs[0]["path"] if recs else None,
                    flush_ms=round(sum(recs[0][k] for k in (
                        "queued_ms", "pack_ms", "flight_ms", "collect_ms",
                        "settle_ms")), 3) if recs else None))
                last_commit = commit
            torch.cuda.synchronize()
            exec_l = read_launches()
        wstats = warmer.stats()
    finally:
        set_global_plane(None)
        clear_global_warmer(warmer)
        warmer.stop()
    check(not any(r.get("path") == "device_fault" for r in
                  plane.ledger.records()), "phase16 a flush faulted")
    want_exec = dict.fromkeys(exec_l, 0)
    want_exec.update(ed25519_verify=APP_HEIGHTS - 1, valset_table_build=1)
    check(exec_l == want_exec,
          f"phase16 block production launches {exec_l}, want {want_exec}")
    check(notified == [len(v0)] and wstats["builds_ok"] == 1
          and wstats["builds_failed"] == 0,
          f"phase16 warmer told of {notified}, stats {wstats}")
    check(state.last_block_height == APP_HEIGHTS
          and state.last_height_validators_changed == APP_ROTATE_AT + 2,
          f"phase16 final height {state.last_block_height} lhvc "
          f"{state.last_height_validators_changed}")
    for h in range(2, APP_HEIGHTS + 1):
        signers = {cs.validator_address
                   for cs in applied[h][0].last_commit.signatures}
        check(bool(signers & new_addrs) == (h > APP_ROTATE_AT + 2),
              f"phase16 block {h}'s LastCommit signed by the new set: "
              f"{bool(signers & new_addrs)}")
    committed = {tx for b, _ in applied.values() for tx in b.data.txs}
    check(not committed & set(mp_.reap()),
          "phase16 the mempool still holds committed txs")
    check(committed >= set(ok_txs) and mp_.size() == 0,
          f"phase16 {len(set(ok_txs) - committed)} OK txs never committed, "
          f"pool {mp_.size()}")
    check(app._compute_app_hash(app.height) == app.app_hash == state.app_hash,
          "phase16 the app hash is not its state's")
    check(state_row(store.load()) == state_row(state),
          "phase16 StateStore.load() != the final state")
    for h, (b, c) in applied.items():
        check(serde.block_to_json(blocks.load_block(h))
              == serde.block_to_json(b)
              and serde.commit_to_j(blocks.load_seen_commit(h))
              == serde.commit_to_j(c)
              and serde.commit_to_j(blocks.load_block_commit(h))
              == serde.commit_to_j(c),
              f"phase16 BlockStore height {h} != what was applied")
    check(brk.trips == 0 and brk.faults == 0,
          f"phase16 breaker trips={brk.trips} faults={brk.faults}")
    # the warmer's table against the plain build on the same keys (a
    # cache hit: no build)
    b0 = ec.valset_table_build.launches
    table = ec.table_for_valset(state.validators)
    check(ec.valset_table_build.launches == b0,
          "phase16 the rotated set's table was not the warmer's")
    M = table.pub_raw.shape[0]
    lenok = torch.zeros((M,), dtype=torch.bool, device=dev)
    lenok[:len(state.validators)] = True
    tab_p, ok_p = ec.valset_table_build_plain(table.pub_raw, lenok)
    check(torch.equal(table.tab, tab_p),
          f"phase16 the warmer's table != plain at M={M}")
    points = kf.base_points(dev)
    err_k, cols = hold_shapes_against_plain(
        dev, kf.ed25519_verify, lambda r: kf.ed25519_verify_plain(r, points),
        wave_rows["ed25519"] + block_rows["ed25519"])
    check(err_k == 0, f"phase16 ed25519_verify != plain at {cols} cols")
    # device time at both paths' shapes: the fullest BULK flush and a
    # LastCommit
    wave_i = max(range(len(flushes)), key=lambda i: flushes[i]["rows"])
    shapes = {flushes[wave_i]["rows"]: wave_rows["ed25519"][wave_i],
              len(last_commit.signatures): block_rows["ed25519"][-1]}
    v_dev = {}
    for live, rows_np in shapes.items():
        rows = torch.as_tensor(rows_np).to(dev)
        v_dev[live] = dev_ms(lambda: kf.ed25519_verify(rows),  # noqa: B023
                             f"ed25519_verify_{live}_app_trace.json")
        print(f"phase16 ed25519_verify cols={rows.shape[1]} live={live} "
              f"device_ms={fmt_ms(v_dev[live])} kernel==plain", flush=True)
    print(f"phase16 blocks 1-{APP_HEIGHTS}: launches {json.dumps(exec_l)} "
          f"(one grouped ed25519_verify a LastCommit after height 1, the "
          f"warmer's valset_table_build after the rotation at "
          f"{APP_ROTATE_AT}: warmer={json.dumps(wstats)}; its table == plain "
          f"at M={M}); ed25519_verify == plain at cols={cols}; mempool "
          f"size 0, app_hash {state.app_hash.hex()[:16]}.. == recompute, "
          f"StateStore and BlockStore equal to what was applied; per height "
          + json.dumps(heights) + f" card={smi('name,power.limit')}",
          flush=True)

    # -- faults -------------------------------------------------------------
    # a tampered LastCommit signature: refused, nothing changes
    bad = copy.deepcopy(last_commit)
    bad.signatures[APP_TAMPER_IDX].signature = flip(
        bad.signatures[APP_TAMPER_IDX].signature, 17)
    before = (state_row(store.load()), blocks.height(), app.app_hash,
              app.height)
    set_global_plane(plane)
    try:
        blk = ex.create_proposal_block(
            APP_HEIGHTS + 1, state, bad,
            state.validators.get_proposer().address)
        tamper_err = None
        try:
            ex.apply_block(state, blk.block_id(), blk)
        except InvalidSignatureError as e:
            tamper_err = e
    finally:
        set_global_plane(None)
        plane.stop()
    check(tamper_err is not None and tamper_err.idx == APP_TAMPER_IDX,
          f"phase16 the tampered LastCommit gave {tamper_err!r}")
    check((state_row(store.load()), blocks.height(), app.app_hash,
           app.height) == before, "phase16 a refused block changed state")

    # a dispatch fault on a card plane: the row goes to verify_batch_direct
    # on the card (ROADMAP C1), with the verdict the oracle gives
    direct = []
    real_direct = cbatch.verify_batch_direct

    def spy(pubs, msgs, sigs, device=None, **kw):
        direct.append((len(pubs), str(device)))
        return real_direct(pubs, msgs, sigs, device=device, **kw)

    fplane = VerifyPlane(window_ms=PLANE_WINDOW_MS,
                         breaker=cbatch.CircuitBreaker(name="phase16-fault"))
    fplane.start()
    set_global_plane(fplane)
    fmp = Mempool(KVStoreApplication(), verify_sigs=True)
    cbatch.verify_batch_direct = spy
    fault_codes = []
    try:
        for tx in fault_txs[:2]:
            fp.arm("verifyplane.dispatch", "raise", count=1)
            try:
                fault_codes.append(fmp.check_tx(tx).code)
            finally:
                fp.reset()
    finally:
        cbatch.verify_batch_direct = real_direct
        set_global_plane(None)
        fplane.stop()
    frecs = fplane.ledger.records()
    check(fault_codes == [0, abci.CODE_TYPE_BAD_SIGNATURE]
          and [r["path"] for r in frecs] == ["device_fault"] * 2
          and direct == [(1, str(dev))] * 2 and brk.faults == 0,
          f"phase16 dispatch fault: codes {fault_codes}, paths "
          f"{[r['path'] for r in frecs]}, direct calls {direct}, breaker "
          f"faults {brk.faults}")

    # a BULK lane squeezed to one row: OVERLOADED with a retry hint, and
    # the shed tx is accepted when it is sent again
    splane = VerifyPlane(window_ms=60.0, bulk_window_ms=60.0,
                         bulk_max_queue=1, bulk_deadline_ms=500.0,
                         breaker=cbatch.CircuitBreaker(name="phase16-squeeze"))
    splane.start()
    set_global_plane(splane)
    smp = Mempool(KVStoreApplication(), verify_sigs=True)
    squeeze = fault_txs[2:]
    try:
        sq, sq_errs, sq_ms = storm(
            APP_SQUEEZE_THREADS,
            lambda k: [(tx, smp.check_tx(tx))
                       for tx in squeeze[k::APP_SQUEEZE_THREADS]])
        answers = dict(pair for v in sq.values() for pair in v)
        shed = [tx for tx, r in answers.items()
                if r.code == abci.CODE_TYPE_OVERLOADED]
        hints = {answers[tx].retry_after_ms for tx in shed}
        again = smp.check_tx(shed[0]).code if shed else None
        sheds = splane.stats()["sheds"]
    finally:
        set_global_plane(None)
        splane.stop()
    check(not sq_errs and shed and len(shed) < len(squeeze)
          and all("retry_after_ms=" in answers[tx].log for tx in shed)
          and all(answers[tx].code == 0 for tx in squeeze if tx not in shed)
          and hints == {500.0} and again == 0
          and sheds["bulk"] >= len(shed) and sheds["consensus"] == 0,
          f"phase16 squeezed lane: errors {sq_errs[:2]}, shed {len(shed)} "
          f"of {len(squeeze)}, hints {hints}, resent {again}, sheds {sheds}")
    print(f"phase16 faults: tampered LastCommit #{APP_TAMPER_IDX} -> "
          f"{type(tamper_err).__name__}: {tamper_err} (state, stores and "
          f"app unchanged); dispatch fault -> verify_batch_direct on "
          f"{direct[0][1]} x{len(direct)}, codes {fault_codes}; squeezed "
          f"BULK lane: {len(shed)} of {len(squeeze)} OVERLOADED (hint "
          f"{sorted(hints)} ms), the shed tx resent -> {again}", flush=True)

    restore_launches(exec_l)
    k = kernel_stats["ed25519_verify"]
    k["launches_by_path"]["mempool"] = wave_l["ed25519_verify"]
    k["launches_by_path"]["execution"] = exec_l["ed25519_verify"]
    k["max_abs_err"] = max(k["max_abs_err"], err_k)
    k["device_ms_by_live"].update(v_dev)
    kernel_stats["valset_table_build"]["launches_by_path"]["execution"] = (
        exec_l["valset_table_build"])
    return {"app_checktx_per_s": len(txs) / wave_ms * 1e3,
            "app_validate_p50_ms": statistics.median(
                r["validate_ms"] for r in heights[1:])}


# --------------------------------------------------------------------------
# phase 17: the verify plane over a mesh of slots of the card
# --------------------------------------------------------------------------

MESH_SLOTS = 8               # phase 17: CBT_TORCH_DEVICE_SLOTS
MESH_HALF_ROWS = 2048        # phase 17: the plane's half_mesh_rows
MESH_BURST = 3200            # phase 17: precommits of the giant flush
MESH_LEAD = 64               # phase 17: precommits flying before the burst
MESH_FAULT_VALS = (2048, 2304)  # phase 17: the dispatch fault's validators
MESH_GATE_CYCLES = 100_000_000  # phase 17: the gate's spin (~50 ms)


# a sharded flight's kernels, by symbol
FLIGHT_SYMBOLS = {"stamp_rows_kernel": "stamp_rows",
                  "ed25519_verify_cached": "ed25519_verify_cached",
                  "tally_kernel": "tally_quorum_cached",
                  "carry_quorum_kernel": "carry_quorum"}


def slot_kernel_ms(events) -> dict:
    """{kernel: (launches, device ms)} of a trace's kernel events, by the
    kernel's symbol."""
    out: dict = {}
    for e in events:
        if e["cat"] != "kernel":
            continue
        for sym, name in FLIGHT_SYMBOLS.items():
            if sym in e.get("name", ""):
                n, ms = out.get(name, (0, 0.0))
                out[name] = (n + 1, ms + e.get("dur", 0) / 1e3)
    return out


def flight_groups(events) -> list:
    """The sharded flights of a trace: its flight kernels (slot_kernel_ms's)
    in launch (correlation) order, cut after each carry_quorum, as one
    thread dispatches a flight's launches together. -> [(lead stream,
    {streams}, [(start us, end us)])]; the carry runs on the lead."""
    kern = sorted((e for e in events if e["cat"] == "kernel" and any(
        k in e.get("name", "") for k in FLIGHT_SYMBOLS)),
        key=lambda e: e["args"]["correlation"])
    groups, cur = [], []
    for e in kern:
        cur.append(e)
        if "carry_quorum_kernel" in e["name"]:
            groups.append((e["args"]["stream"],
                           {x["args"]["stream"] for x in cur},
                           [(x["ts"], x["ts"] + x["dur"]) for x in cur]))
            cur = []
    return groups


def stream_kernels(events) -> dict:
    """{stream: {flight kernel: launches}} of a trace."""
    out: dict = {}
    for e in events:
        for sym, name in FLIGHT_SYMBOLS.items():
            if e["cat"] == "kernel" and sym in e.get("name", ""):
                per = out.setdefault(e["args"]["stream"], {})
                per[name] = per.get(name, 0) + 1
    return out


def _union(iv) -> list:
    out: list = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(a, b) -> float:
    """Microseconds in which some interval of `a` and some of `b` both
    run."""
    ua, ub = _union(a), _union(b)
    tot, i, j = 0.0, 0, 0
    while i < len(ua) and j < len(ub):
        tot += max(0.0, min(ua[i][1], ub[j][1]) - max(ua[i][0], ub[j][0]))
        if ua[i][1] < ub[j][1]:
            i += 1
        else:
            j += 1
    return tot


def host_breakdown(events) -> dict:
    """The CUDA runtime calls of a trace's busiest calling thread (the
    plane's dispatcher): their count and ms, the most frequent, and the
    host time between consecutive calls, split at 1 ms into time inside
    a dispatch and time between flights."""
    rt = [e for e in events if e.get("cat") == "cuda_runtime"]
    if not rt:
        return {}
    tid = collections.Counter(e["tid"] for e in rt).most_common(1)[0][0]
    rt = sorted((e for e in rt if e["tid"] == tid), key=lambda e: e["ts"])
    gaps = [b["ts"] - (a["ts"] + a.get("dur", 0)) for a, b in zip(rt, rt[1:])]
    return {"calls": len(rt), "call_ms": sum(e.get("dur", 0)
                                             for e in rt) / 1e3,
            "span_ms": (rt[-1]["ts"] - rt[0]["ts"]) / 1e3,
            "top": collections.Counter(e["name"] for e in rt).most_common(6),
            "gap_in_ms": sum(g for g in gaps if g <= 1000) / 1e3,
            "gap_between_ms": sum(g for g in gaps if g > 1000) / 1e3,
            "gap_launch_p50_us": statistics.median(
                [g for a, g in zip(rt, gaps) if a["name"] == "cudaLaunchKernel"]
                or [0])}


def trace_breakdown(events, groups) -> dict:
    """A trace's device time: kernel and copy counts and ms, the span from
    the first device event to the last, the busy share of it, and the
    overlap of the flights led by the two most frequent lead streams."""
    def ms(ev):
        return sum(e["dur"] for e in ev) / 1e3

    events = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    kern = [e for e in events if e["cat"] == "kernel"]
    h2d = [e for e in events if e["cat"] == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    d2h = [e for e in events if e["cat"] == "gpu_memcpy"
           and "DtoH" in e.get("name", "")]
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in events]
    span = (max(b for _, b in iv) - min(a for a, _ in iv)) / 1e3 if iv \
        else 0.0
    busy = sum(b - a for a, b in _union(iv)) / 1e3
    leads = collections.Counter(g[0] for g in groups).most_common(2)
    by_lead = [[x for g in groups if g[0] == ld for x in g[2]]
               for ld, _ in leads]
    return {"kernels": len(kern), "kernel_ms": ms(kern),
            "h2d": len(h2d), "h2d_ms": ms(h2d), "d2h": len(d2h),
            "d2h_ms": ms(d2h), "span_ms": span, "busy_ms": busy,
            "idle_share": 1 - busy / span if span else None,
            "flights": len(groups),
            "halves_overlap_ms": overlap_us(*by_lead) / 1e3
            if len(by_lead) == 2 else 0.0}


def phase_mesh(dev, res, kernel_stats):
    """Phase 17: the sharded steps and the plane's flight deck over
    MESH_SLOTS slots of the card (parallel/mesh.py): the builders against
    the one-device launches, carry_quorum against its plain version, phase
    11's precommits through a plane whose flushes ride the deck's halves,
    a giant flush over the full mesh, the warmer's sharded tables for
    phase 12's e+2 rotation and a dispatch fault."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.libs import failpoints as fp
    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.ops import table_cache as tc
    from cometbft_tpu_torch.parallel import mesh as pm
    from cometbft_tpu_torch.verifyplane import (FlushLedger, QuorumGroup,
                                                TableWarmer, VerifyPlane,
                                                notify_next_valset,
                                                set_global_plane,
                                                set_global_warmer)
    from cometbft_tpu_torch.verifyplane import fused as fz
    from cometbft_tpu_torch.verifyplane.plane import _Submission

    def zero_mesh_launches():
        zero_launches()
        ek.carry_quorum.launches = 0

    def read_mesh_launches():
        return dict(read_launches(), carry_quorum=ek.carry_quorum.launches)

    os.environ[pm.SLOTS_ENV] = str(MESH_SLOTS)
    try:
        slots = pm.local_devices(dev)
        check(len(slots) == MESH_SLOTS and all(s.device == dev
                                              for s in slots),
              f"phase17 slots {slots}")
        mesh8 = fz.plane_mesh(0, dev)
        vs, bid, height, commit = res["fixture"]
        pubs = tuple(v.pub_key.data for v in vs.validators)
        powers = tuple(v.voting_power for v in vs.validators)
        eff8 = fz.effective_mesh(mesh8, N_VALS)
        halves = fz.half_meshes(mesh8)
        eff_h = [fz.effective_mesh(h, N_VALS) for h in halves]
        n_eff, m_s = eff8[1], eff8[2]
        full_devs = tuple(range(n_eff))
        half_devs = [full_devs, tuple(range(MESH_SLOTS // 2,
                                            MESH_SLOTS // 2 + n_eff))]
        check(eff8[0].indices == full_devs and n_eff >= 2
              and [(e[0].indices, e[1], e[2]) for e in eff_h]
              == [(d, n_eff, m_s) for d in half_devs],
              f"phase17 layout {eff8} {eff_h}")

        # (a) the builders against the one-device launches
        t = time.perf_counter()
        sigs = [cs.signature for cs in commit.signatures]
        sigs[TAMPER_IDX] = flip(sigs[TAMPER_IDX], 40)
        cols = kf.pad_to_tile(N_VALS)  # 16,384 at 10k
        pb = ek.pack_batch(list(pubs), commit.sign_bytes_rows(CHAIN_ID),
                           sigs, pad_to=cols)
        p5 = np.zeros((cols, ek.POWER_LIMBS), np.int32)
        p5[:N_VALS] = ek.power_limbs(np.asarray(powers, np.int64))
        counted = np.arange(cols) < N_VALS
        cids = np.zeros(cols, np.int32)
        thresh = ek.threshold_limbs(sum(powers) * 2 // 3)
        rows_t = torch.from_numpy(kf.pack_rows(pb, p5, counted, cids,
                                               thresh)).to(dev)
        one = kf.verify_tally_rows(rows_t, 1, device=dev)
        rows_g = torch.from_numpy(kf.pack_rows(pb, p5, counted, cids)).to(
            dev)
        rows_step = pm.sharded_verify_tally_rows(mesh8, 1)
        got = rows_step(rows_g, None, thresh)
        check(all(torch.equal(a, b) for a, b in zip(got, one))
              and int(got[0].sum()) == N_VALS - 1 and bool(got[2][0]),
              "phase17 sharded_verify_tally_rows != one device")
        # phase 6's second chunk (heights 65-80 in a launch of 64 commit
        # slots): its first CHUNK_COMMITS commits, with the thresholds the
        # rows carry for them
        s_all, stable, _, s_thr_all = res["stream_chunk"]
        s_c = CHUNK_COMMITS
        srows = s_all[:, :s_c * stable.n_vals].contiguous()
        s_thr = s_thr_all[:s_c]
        one_s = ec.verify_tally_rows_cached(srows, stable, s_c)
        stream_step = pm.sharded_stream_verify(mesh8, s_c)
        got_s = stream_step(srows, stable.tab, stable.ok, stable.power5,
                            None, s_thr)
        check(srows.shape[1] // MESH_SLOTS == 2 * stable.n_vals,
              f"phase17 stream chunk of {srows.shape[1]} columns")
        check(all(torch.equal(a, b) for a, b in zip(got_s, one_s))
              and not bool(got_s[2].all()),
              "phase17 sharded_stream_verify != one device")
        # the plane's delta rows, stamped a slot at a time, against the
        # one-device stamp of the same deltas
        subs = plane_subs(vs, commit)
        g = QuorumGroup(1, "phase17-check", valset_pubs=pubs,
                        valset_powers=powers)
        batch = [_Submission(sb["rows"], g, sb["power"], True, sb["vidx"],
                             stamp=sb["stamp"]) for sb in subs]
        plan = fz.plan_fused(batch, device=dev, mesh=mesh8)
        check(plan.stamped and plan.devs == full_devs
              and plan.delta[0].shape[0] == n_eff * m_s,
              "phase17 plan over the mesh")
        sh_tab, _ = ec.sharded_table_for_pubs_info(pubs, powers, plan.mesh)
        ent = es.template_entry(plan.sites, device=dev)
        dsig, dts, dfl = (torch.from_numpy(a).to(dev) for a in plan.delta)
        stamp_step = pm.sharded_stamp_rows(plan.mesh, ent.msg_max)
        rows_m = stamp_step(dsig, dts, dfl, ent.pre_mat, ent.pre_len,
                            ent.suf_mat, ent.suf_len, ent.ts_tag,
                            sh_tab.pub_raw)
        pub_all = torch.from_numpy(ec._pack_pub_arrays(
            pubs, n_eff * m_s)[0]).to(dev)
        rows_1 = es.stamp_rows(dsig, dts, dfl, ent, pub_all, torch.zeros(
            (1, ek.TALLY_LIMBS), dtype=torch.int32, device=dev), 1)
        check(torch.equal(rows_m, rows_1) and bool(rows_m.any()),
              "phase17 sharded_stamp_rows != one-device stamp_rows")
        # each builder's device ms (every slot's kernels and the reduce,
        # summed from a profiler trace) and ms a call, beside the
        # one-device launches of the same work
        thr0 = torch.zeros((1, ek.TALLY_LIMBS), dtype=torch.int32,
                           device=dev)
        timed = {
            "sharded_verify_tally_rows": (
                lambda: rows_step(rows_g, None, thresh),
                lambda: kf.verify_tally_rows(rows_t, 1, device=dev)),
            "sharded_stream_verify": (
                lambda: stream_step(srows, stable.tab, stable.ok,
                                    stable.power5, None, s_thr),
                lambda: ec.verify_tally_rows_cached(srows, stable, s_c)),
            "sharded_stamp_rows": (
                lambda: stamp_step(dsig, dts, dfl, ent.pre_mat,
                                   ent.pre_len, ent.suf_mat, ent.suf_len,
                                   ent.ts_tag, sh_tab.pub_raw),
                lambda: es.stamp_rows(dsig, dts, dfl, ent, pub_all, thr0,
                                      1)),
        }
        builder_ms = {
            name: tuple(round(x, 6) if x is not None else None for x in (
                dev_ms(fn, f"mesh_{name}_trace.json"), cuda_ms(fn, 10),
                dev_ms(one_fn, f"one_{name}_trace.json"),
                cuda_ms(one_fn, 10)))
            for name, (fn, one_fn) in timed.items()}
        # carry_quorum against plain on partials whose limbs all carry: at
        # every slot and 5 commits, and at the plane's flush shape (a
        # half's slots, one commit), where it is then timed
        carry_err = 0
        for n_d, c_n in ((MESH_SLOTS, 5), (n_eff, 1)):
            parts = torch.full((n_d, c_n, ek.TALLY_LIMBS), 8191,
                               dtype=torch.int32, device=dev)
            pt, _ = ek.carry_quorum_plain(parts.cpu(), torch.zeros(
                (c_n, ek.TALLY_LIMBS), dtype=torch.int32))
            thr_c = pt.clone()
            thr_c[1::2, 0] -= 1
            thr_c = thr_c.to(dev)
            tk, qk = ek.carry_quorum(parts, thr_c)
            tpl, qpl = ek.carry_quorum_plain(parts, thr_c)
            carry_err = max(carry_err, int((tk - tpl).abs().max()),
                            int((qk != qpl).sum()))
            check(carry_err == 0 and qk.tolist()
                  == [k % 2 == 1 for k in range(c_n)],
                  f"phase17 carry_quorum != plain at {n_d} x {c_n}")
        ck = lambda: ek.carry_quorum(parts, thr_c)  # noqa: E731
        builders_s = time.perf_counter() - t

        # (b) the plane: flushes on the deck's halves, then a giant flush
        brk = cbatch.CircuitBreaker(name="phase17")
        plane = VerifyPlane(window_ms=PLANE_WINDOW_MS,
                            max_batch=4 * PLANE_MAX_BATCH,
                            max_queue=PLANE_MAX_QUEUE, mesh_devices=0,
                            mesh_min_rows=1, pipeline_flights=2,
                            half_mesh_rows=MESH_HALF_ROWS, breaker=brk)
        check(plane.device == dev, f"phase17 plane device {plane.device}")
        plane.ledger = FlushLedger(capacity=PLANE_LEDGER)
        plans = []
        real_dispatch = fz.dispatch_fused

        def watch(p):
            plans.append((p.devs, p.drain_first, len(p.batch)))
            return real_dispatch(p)

        tc.reset_for_tests()
        want = [i != TAMPER_IDX for i in range(N_VALS)]
        good = commit.signatures[TAMPER_IDX].signature
        commit.signatures[TAMPER_IDX].signature = flip(good, 40)
        try:
            sub_t = plane_subs(vs, commit)
        finally:
            commit.signatures[TAMPER_IDX].signature = good
        plane.start()
        fz.dispatch_fused = watch
        try:
            zero_mesh_launches()
            verdicts, group, quorum_ms, recs = plane_run(
                plane, sub_t, pubs, powers)
            torch.cuda.synchronize()
            launches = read_mesh_launches()
            check(quorum_ms is not None and verdicts == want
                  and group.tally == sum(powers) - powers[TAMPER_IDX],
                  "phase17 plane: quorum, verdicts or tally != phase 11's")
            paths = {r["path"] for r in recs}
            dev0s = {r["dev0"] for r in recs}
            check(paths == {"fused_sharded"}
                  and {r["n_dev"] for r in recs} == {n_eff}
                  and dev0s == {half_devs[0][0], half_devs[1][0]}
                  and max(r["airborne"] for r in recs) >= 1,
                  f"phase17 ledger paths={paths} n_dev="
                  f"{sorted({r['n_dev'] for r in recs})} dev0={dev0s} "
                  f"airborne_max={max(r['airborne'] for r in recs)}")
            n_fl = len(recs)
            want_l = dict.fromkeys(launches, 0)
            want_l.update(stamp_rows=n_eff * n_fl,
                          ed25519_verify_cached=n_eff * n_fl,
                          tally_quorum_cached=n_eff * n_fl,
                          carry_quorum=n_fl, valset_table_build=2 * n_eff)
            check(launches == want_l,
                  f"phase17 launches {launches}, want {want_l}")
            check([r["warm"] for r in recs].count(0) <= 2,
                  "phase17 more than the two halves' first flushes cold")
            # the same run again under the profiler: where a flush's time
            # goes on the card, and no device-to-host copy but the
            # collect's two (verdicts, tally) a flush
            traced_run: list = []
            zero_mesh_launches()
            t_events, t_wall = _traced(lambda: traced_run.append(plane_run(
                plane, sub_t, pubs, powers)), "mesh_plane_trace.json",
                ("kernel", "gpu_memcpy", "gpu_memset", "cuda_runtime"))
            t_launched = sum(n for k, n in read_mesh_launches().items()
                             if k in FLIGHT_SYMBOLS.values())
            t_recs = traced_run[0][3]
            run_trace = trace_breakdown(t_events, flight_groups(t_events))
            run_trace["in_trace"] = sum(sum(k.values()) for k in
                                        stream_kernels(t_events).values())
            run_host = host_breakdown(t_events)
            check(traced_run[0][0] == want
                  and run_trace["d2h"] <= 2 * len(t_recs),
                  f"phase17 traced run: {len(t_recs)} flushes, trace "
                  f"{run_trace}")
            # the burst: a few precommits fly on a half, then one flush
            # above half_mesh_rows drains the deck and takes the full mesh
            burst_g = QuorumGroup(sum(powers) * 2 // 3 + 1, "phase17-burst",
                                  valset_pubs=pubs, valset_powers=powers)
            n_plans = len(plans)
            lead = [plane.submit_many(group=burst_g, **sb)
                    for sb in sub_t[:MESH_LEAD]]
            wait_for = time.perf_counter() + PLANE_TIMEOUT_S
            while len(plans) == n_plans:
                check(time.perf_counter() < wait_for, "phase17 lead flush")
                time.sleep(0.0005)
            with plane._cv:  # one flush
                burst = [plane.submit_many(group=burst_g, **sb)
                         for sb in sub_t[MESH_LEAD:MESH_LEAD + MESH_BURST]]
            bv = [f.result(PLANE_TIMEOUT_S)[0] for f in lead + burst]
            check(bv == want[:MESH_LEAD + MESH_BURST],
                  "phase17 burst verdicts")
            giant = [p for p in plans[n_plans:] if p[2] >= MESH_BURST]
            check(len(giant) == 1 and giant[0][0] == full_devs
                  and giant[0][1], f"phase17 giant flush plans {giant}")
            stats = plane.stats()
        except BaseException:
            plane.stop()
            raise
        finally:
            fz.dispatch_fused = real_dispatch
        deck_peak = stats["deck_peak"]

        # (c) the warmer: e+2's sharded tables for both halves, warmed
        vs3, commit3 = res["e2"]
        pubs3 = tuple(v.pub_key.data for v in vs3.validators)
        powers3 = tuple(v.voting_power for v in vs3.validators)
        warmer = TableWarmer(breaker=brk)
        warmer.start()
        set_global_plane(plane)
        set_global_warmer(warmer)
        try:
            hits0 = tc.STATS["warmed_hits"]
            miss0 = tc.STATS["shard_misses"]
            zero_launches()
            notify_next_valset(vs3)
            check(warmer.wait_idle(PLANE_TIMEOUT_S), "phase17 warmer idle")
            warm_l = read_launches()
            check(tc.STATS["shard_misses"] - miss0 == 2
                  and warm_l["valset_table_build"] == 1 + 2 * n_eff,
                  f"phase17 warmer builds {warm_l} shard_misses="
                  f"{tc.STATS['shard_misses'] - miss0}")
            v3, g3, q3, recs3 = plane_run(plane, plane_subs(vs3, commit3),
                                          pubs3, powers3)
            first = {}
            for r in recs3:
                first.setdefault(r["dev0"], r["warm"])
            check(q3 is not None and all(v3)
                  and first == {half_devs[0][0]: 1, half_devs[1][0]: 1}
                  and tc.STATS["warmed_hits"] - hits0 == 2,
                  f"phase17 e+2: quorum {q3}, first flush warm by half "
                  f"{first}, warmed hits {tc.STATS['warmed_hits'] - hits0}")
        except BaseException:
            plane.stop()
            raise
        finally:
            set_global_plane(None)
            set_global_warmer(None)
            warmer.stop()

        # (d) a dispatch fault on the mesh plane
        lo, hi = MESH_FAULT_VALS
        fp.arm("verifyplane.dispatch", "raise", count=1)
        try:
            fv, _, _, frecs = plane_run(plane, sub_t[lo:hi], pubs, powers,
                                        quorum=False)
        finally:
            fp.reset()
            plane.stop()
        fpaths = [r["path"] for r in frecs]
        failed = [v for v in fv if v == "DeviceError"]
        check(fpaths[0] == "device_fault"
              and set(fpaths[1:]) <= {"fused_sharded"}
              and len(failed) == frecs[0]["rows"] > 0
              and all(v == want[lo + i] for i, v in enumerate(fv)
                      if v != "DeviceError"),
              f"phase17 fault run paths {fpaths}")
        check(brk.faults == 0 and brk.trips == 0,
              f"phase17 breaker faults={brk.faults}")

        # the deck's halves on the card at once: both lead streams wait
        # for a gate (a spin on a side stream) while a flight is
        # dispatched on each half, so both are enqueued before either
        # may start; once the gate opens, kernels of the two halves must
        # overlap, which no stream of one flight ordered behind the other
        # allows. CUDA events recorded on each slot's stream around its
        # cached verify launch time the kernels (a profiler trace this
        # late in the run can miss device events; it is kept for the
        # report)
        gate_plans = [fz.plan_fused(batch[:PLANE_MAX_BATCH], device=dev,
                                    mesh=h) for h in halves]
        for gp in gate_plans:
            fz.dispatch_fused(gp)
            fz.collect_fused(gp)
        marks: list = []
        real_launch = ec.launch_verify_cached

        def marked_launch(*args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real_launch(*args)
            ev[1].record()
            marks.append(ev)
            return out

        gate_at: dict = {}

        def gated():
            gate = torch.cuda.Stream(dev)
            ref, held = (torch.cuda.Event(enable_timing=True)
                         for _ in range(2))
            ref.record(gate)
            with torch.cuda.stream(gate):
                torch.cuda._sleep(MESH_GATE_CYCLES)
            held.record(gate)
            for gp in gate_plans:
                pm.slot_stream(gp.mesh.slots[0]).wait_event(held)
            for gp in gate_plans:
                fz.dispatch_fused(gp)
            gate_at.update(ref=ref, held=held, open=held.query())

        ec.launch_verify_cached = marked_launch
        try:
            g_events, g_wall = _traced(gated, "mesh_halves_trace.json")
        finally:
            ec.launch_verify_cached = real_launch
        g_verdicts = [fz.collect_fused(gp)[0] for gp in gate_plans]
        gate_ms = gate_at["ref"].elapsed_time(gate_at["held"])
        g_iv = [(gate_at["ref"].elapsed_time(a),
                 gate_at["ref"].elapsed_time(b)) for a, b in marks]
        g_overlap = overlap_us(g_iv[:n_eff], g_iv[n_eff:])
        check(all(all(v) for v in g_verdicts) and len(g_iv) == 2 * n_eff
              and not gate_at["open"]
              and min(a for a, _ in g_iv) >= gate_ms and g_overlap > 0,
              f"phase17 gated halves: gate {gate_ms:.3f} ms (open at the "
              f"end of dispatch: {gate_at['open']}), verify intervals "
              f"{[(round(a, 4), round(b, 4)) for a, b in g_iv]} ms, "
              f"overlap {g_overlap:.6f} ms")
        g_trace = stream_kernels(g_events)

        # each slot's kernels and the reduce in a profiler trace of one
        # flush over a half (3 slots), and carry_quorum's own times
        hplan = fz.plan_fused(batch[:PLANE_MAX_BATCH], device=dev,
                              mesh=halves[1])
        fz.dispatch_fused(hplan)
        torch.cuda.synchronize()
        events, wall = _traced(lambda: fz.dispatch_fused(hplan),
                               "mesh_flush_trace.json")
        by_kernel = slot_kernel_ms(events)
        carry_ms = cuda_ms(ck, 50)
        carry_dev = dev_ms(ck, "carry_quorum_trace.json")
        stack_fn = lambda: torch.stack(list(parts)).sum(0)  # noqa: E731
        stack_dev = dev_ms(stack_fn, "carry_stack_trace.json")
        t = time.perf_counter()
        ek.carry_quorum_plain(parts, thr_c)
        torch.cuda.synchronize()
        carry_plain_ms = (time.perf_counter() - t) * 1e3
    finally:
        del os.environ[pm.SLOTS_ENV]

    n_shard = stats["shard_flushes"]
    k = kernel_stats.setdefault("carry_quorum", dict(
        launches_by_path={}, max_abs_err=0))
    k["launches_by_path"]["mesh_plane"] = launches["carry_quorum"]
    k["max_abs_err"] = max(k["max_abs_err"], carry_err)
    k.update(ms=carry_ms, plain_ms=carry_plain_ms, device_ms=carry_dev,
             library_device_ms=stack_dev,
             library_ms=cuda_ms(stack_fn, 50),
             # the timed shape's bytes (n_eff partial tallies of one
             # commit and its threshold in, the tally and the bit out) and
             # its int32 adds and carry steps
             bytes=n_eff * 24 + 24 + 25,
             ops=n_eff * ek.TALLY_LIMBS + 4 * (ek.TALLY_LIMBS - 1))
    for name in ("stamp_rows", "ed25519_verify_cached",
                 "tally_quorum_cached", "valset_table_build"):
        kernel_stats[name]["launches_by_path"]["mesh_plane"] = \
            launches[name]
    rows = [r["rows"] for r in recs]
    med = {c: statistics.median(r[c] for r in recs)
           for c in ("dev_ms", "h2d_ms", "pack_ms", "collect_ms")}
    per_slot = ", ".join(f"{n}: launches={c} device_ms={ms:.6f}"
                         for n, (c, ms) in sorted(by_kernel.items()))
    print(f"phase17 slots={MESH_SLOTS} of {torch.cuda.get_device_name(0)} "
          f"(one card: the slots share its SMs, so these are not the times "
          f"of {MESH_SLOTS} cards); flushes clamp to {n_eff} slots of "
          f"{m_s}; builders == one device (rows {cols} cols, stream "
          f"{srows.shape[1]} cols, stamp {n_eff * m_s} cols) "
          f"s={builders_s:.3f}; carry_quorum == plain", flush=True)
    print("phase17 builders (device_ms of all slots' kernels, ms a call; "
          "the same work on one device): " + "; ".join(
              f"{n} {b[0]} / {b[1]} vs one device {b[2]} / {b[3]}"
              for n, b in builder_ms.items()), flush=True)
    print(f"phase17 plane quorum_ms={quorum_ms:.3f} flushes={len(recs)} "
          f"rows_per_flush p50={statistics.median(rows)} max={max(rows)} "
          f"shard_flushes={n_shard} shard_rows={stats['shard_rows']} "
          f"deck_peak={deck_peak} dev0={sorted(dev0s)} per-flush medians "
          f"dev_ms={med['dev_ms']} h2d_ms={med['h2d_ms']} pack_ms="
          f"{med['pack_ms']} collect_ms={med['collect_ms']}; giant flush "
          f"rows={MESH_BURST} devs={full_devs} drain_first=True; e+2 warmed "
          f"both halves (first flushes warm); dispatch fault -> "
          f"DeviceError x{len(failed)}; card={smi('name,power.limit')}",
          flush=True)
    print(f"phase17 launches {json.dumps(launches)}", flush=True)
    tr = run_trace
    print(f"phase17 traced plane run (profiler on) wall_ms={t_wall:.3f} "
          f"flushes={len(t_recs)}, the trace holds {tr['in_trace']} of "
          f"{t_launched} flight kernel launches ({tr['flights']} flights): "
          f"device span_ms={tr['span_ms']:.3f} "
          f"busy_ms={tr['busy_ms']:.3f} idle_share={tr['idle_share']:.4f}; "
          f"kernels={tr['kernels']} kernel_ms={tr['kernel_ms']:.6f}; "
          f"HtoD copies={tr['h2d']} ms={tr['h2d_ms']:.6f}; DtoH copies="
          f"{tr['d2h']} ms={tr['d2h_ms']:.6f}; halves' kernels overlap "
          f"ms={tr['halves_overlap_ms']:.6f}; per-flush medians dev_ms="
          f"{statistics.median(r['dev_ms'] for r in t_recs)} h2d_ms="
          f"{statistics.median(r['h2d_ms'] for r in t_recs)} pack_ms="
          f"{statistics.median(r['pack_ms'] for r in t_recs)}", flush=True)
    if run_host:
        print(f"phase17 traced plane run, the dispatcher thread: "
              f"{run_host['calls']} CUDA runtime calls taking "
              f"{run_host['call_ms']:.3f} ms of a {run_host['span_ms']:.3f} "
              f"ms span, most frequent {run_host['top']}; host time between "
              f"calls {run_host['gap_in_ms']:.3f} ms in gaps up to 1 ms (a "
              f"dispatch's Python) and {run_host['gap_between_ms']:.3f} ms "
              f"in longer ones (between flights); after a launch p50 "
              f"{run_host['gap_launch_p50_us']:.1f} us", flush=True)
    print(f"phase17 gated halves (a gate of {MESH_GATE_CYCLES} cycles, "
          f"{gate_ms:.3f} ms): cached verify intervals after the gate, "
          f"half {half_devs[0]} "
          f"{[(round(a - gate_ms, 4), round(b - gate_ms, 4)) for a, b in g_iv[:n_eff]]}"
          f" half {half_devs[1]} "
          f"{[(round(a - gate_ms, 4), round(b - gate_ms, 4)) for a, b in g_iv[n_eff:]]}"
          f" ms, overlap ms={g_overlap:.6f}; its trace holds "
          f"{sum(sum(k.values()) for k in g_trace.values())} of "
          f"{2 * (3 * n_eff + 1)} flight kernels ({g_trace})", flush=True)
    print(f"phase17 one flush over {n_eff} slots (B="
          f"{hplan.delta[0].shape[0]}, "
          f"live={len(hplan.batch)}) wall_ms={wall:.3f}: {per_slot}; "
          f"carry_quorum per call ms={carry_ms:.6f} device_ms="
          f"{fmt_ms(carry_dev)} plain_ms={carry_plain_ms:.3f} "
          f"torch.stack(parts).sum(0) device_ms={fmt_ms(stack_dev)}",
          flush=True)
    return {"mesh_quorum_ms": quorum_ms}


def int_ops_per_s() -> tuple:
    """(clocks.max.sm in MHz, INT32 multiply-adds per second of the card)."""
    mhz = smi("clocks.max.sm").split()[0]
    return mhz, H100_SMS * IMAD_PER_CLK * float(mhz) * 1e6


def kernels_json(kernel_stats):
    from cometbft_tpu_torch.ops import ed25519_fused as kf

    mhz, imad_per_s = int_ops_per_s()
    products = kf.verify_products_per_signature()
    out = []
    v = kernel_stats["ed25519_verify"]
    ops_ms = v["n_checked"] * products / imad_per_s * 1e3
    bytes_ms = v["bytes"] / HBM_BYTES_PER_S * 1e3
    out.append(dict(
        name="ed25519_verify", route="cuda",
        source="cometbft_tpu_torch/csrc/ed25519_verify.cu",
        replaces="cometbft_tpu/ops/ed25519_pallas.py:171",
        launches=sum(v["launches_by_path"].values()),
        launches_by_path=v["launches_by_path"],
        max_abs_err=v["max_abs_err"], ms=v["ms"],
        plain_ms=v["plain_ms"], bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=None, device_ms=v["device_ms"],
        device_ms_by_live=v["device_ms_by_live"],
    ))
    t = kernel_stats["tally_quorum"]
    bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = t["cols"] * 6 / imad_per_s * 1e3
    out.append(dict(
        name="tally_quorum", route="cuda",
        source="cometbft_tpu_torch/csrc/tally_quorum.cu",
        replaces="cometbft_tpu/ops/ed25519_kernel.py:247",
        launches=sum(t["launches_by_path"].values()),
        launches_by_path=t["launches_by_path"],
        max_abs_err=t["max_abs_err"], ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms > bytes_ms else "bytes",
        library_ms=t["library_ms"], device_ms=t["device_ms"],
        library_device_ms=t["library_device_ms"],
    ))
    c = kernel_stats["carry_quorum"]
    bytes_ms = c["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = c["ops"] / imad_per_s * 1e3
    out.append(dict(
        name="carry_quorum", route="cuda",
        source="cometbft_tpu_torch/csrc/tally_quorum.cu",
        replaces="cometbft_tpu/parallel/mesh.py:123",
        launches=sum(c["launches_by_path"].values()),
        launches_by_path=c["launches_by_path"],
        max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms > bytes_ms else "bytes",
        library_ms=c["library_ms"], device_ms=c["device_ms"],
        library_device_ms=c["library_device_ms"],
    ))
    sources = {
        "sr25519_verify": ("sr25519_verify.cu",
                           "cometbft_tpu/ops/sr25519_kernel.py:92"),
        "ecdsa_verify": ("ecdsa_verify.cu",
                         "cometbft_tpu/ops/ecdsa_pallas.py:127"),
        "valset_table_build": ("valset_table.cu",
                               "cometbft_tpu/ops/ed25519_cached.py:110"),
        "ed25519_verify_cached": ("ed25519_cached_verify.cu",
                                  "cometbft_tpu/ops/ed25519_cached.py:849"),
        "tally_quorum_cached": ("tally_quorum.cu",
                                "cometbft_tpu/ops/ed25519_cached.py:987"),
        "stamp_rows": ("stamp_rows.cu",
                       "cometbft_tpu/ops/ed25519_cached.py:1495"),
    }
    for name, (src, replaces) in sources.items():
        k = kernel_stats[name]
        extra = {}
        ops_ms = k["ops"] / imad_per_s * 1e3
        bytes_ms = k["bytes"] / HBM_BYTES_PER_S * 1e3
        if "ops_by_shape" in k:
            extra["bound_ms_by_shape"] = {
                shape: ops / imad_per_s * 1e3
                for shape, ops in k["ops_by_shape"].items()}
        out.append(dict(
            name=name, route="cuda",
            source=f"cometbft_tpu_torch/csrc/{src}", replaces=replaces,
            launches=sum(k["launches_by_path"].values()),
            launches_by_path=k["launches_by_path"],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=k["library_ms"],
            device_ms=k["device_ms"],
            **{key: k[key] for key in ("library_device_ms",
                                       "device_ms_by_shape", "ms_by_shape",
                                       "device_ms_by_live", "entry_by_shape",
                                       "sweep_device_ms") if key in k},
            **extra,
        ))
    print(f"bound: {products} limb products/signature, clocks.max.sm={mhz} "
          f"MHz, {imad_per_s:.4e} INT32 multiply-adds/s", flush=True)
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs the card")
    try:
        import numpy as np

        import cometbft_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    from cometbft_tpu_torch.crypto import batch as cbatch

    t_start = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    dev = phase_card_and_build()
    kernel_stats: dict = {}
    ctx = mp.get_context("spawn")
    with ctx.Pool(os.cpu_count() or 4) as pool:
        t = time.perf_counter()
        phase_kernels_vs_plain(dev, pool, rng)
        print(f"phase2 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res = phase_main_path(dev, pool, rng, kernel_stats)
        print(f"phase3 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        phase_fused_step(dev, pool, rng, kernel_stats,
                         res["tally_launches"])
        print(f"phase4 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        phase_cached_kernels_vs_plain(dev, pool, rng)
        print(f"phase5 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_stream(dev, pool, rng, kernel_stats))
        print(f"phase6 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_cached_commit(dev, res, kernel_stats))
        print(f"phase7 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        phase_new_kernels_vs_plain(dev, pool, rng)
        print(f"phase8 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_mixed_commit(dev, pool, rng, kernel_stats))
        print(f"phase9 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_light_secp(dev, pool, rng, kernel_stats))
        print(f"phase10 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_plane(dev, res, kernel_stats))
        print(f"phase11 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_voteset(dev, pool, rng, res, kernel_stats))
        print(f"phase12 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_light_client(dev, pool, kernel_stats))
        print(f"phase13 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_catchup(dev, pool, res, kernel_stats))
        print(f"phase14 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_gateway(dev, pool, res, kernel_stats))
        print(f"phase15 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_app(dev, pool, rng, res, kernel_stats))
        print(f"phase16 s={time.perf_counter() - t:.3f}", flush=True)
        t = time.perf_counter()
        res.update(phase_mesh(dev, res, kernel_stats))
        print(f"phase17 s={time.perf_counter() - t:.3f}", flush=True)
    brk = cbatch.device_breaker()
    check(brk.trips == 0 and brk.faults == 0, "breaker recorded a fault")
    print(json.dumps(kernels_json(kernel_stats)), flush=True)
    print(f"summary VerifyCommitLight_p50_ms={res['light_p50_ms']:.3f} "
          f"VerifyCommit_sigs_per_s={res['full_sigs_per_s']:.1f} "
          f"stream_blocks_per_s={res['stream_blocks_per_s']:.1f} "
          f"stream_sigs_per_s={res['stream_sigs_per_s']:.1f} "
          f"cached_VerifyCommit_p50_ms={res['cached_p50_ms']:.3f} "
          f"cached_VerifyCommit_sigs_per_s={res['cached_sigs_per_s']:.1f} "
          f"mixed_VerifyCommitLight_p50_ms={res['mixed_light_p50_ms']:.3f} "
          f"mixed_VerifyCommit_sigs_per_s={res['mixed_sigs_per_s']:.1f} "
          f"secp_light_pair_p50_ms={res['lc_pair_p50_ms']:.3f} "
          f"plane_quorum_p50_ms={res['plane_quorum_p50_ms']:.3f} "
          f"voteset_quorum_p50_ms={res['vs_quorum_p50_ms']:.3f} "
          f"light_client_1_to_8_ms={res['lc_client_ms']:.3f} "
          f"catchup_blocks_per_s={res['catchup_blocks_per_s']:.1f} "
          f"gateway_64_clients_ms={res['gw_wave1_ms']:.3f} "
          f"checktx_per_s={res['app_checktx_per_s']:.1f} "
          f"lastcommit_validate_p50_ms={res['app_validate_p50_ms']:.3f} "
          f"mesh_plane_quorum_ms={res['mesh_quorum_ms']:.3f} "
          f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print("nvidia-smi:", smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
