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
     each flush's work ms.
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


def _traced(fn, name):
    """(device events, wall ms) of fn() under torch.profiler; the trace is
    kept under build/traces/<name>."""
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
    return [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")], wall


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
    return jobs, sets, n_sigs, np.asarray(powers)


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
    jobs, sets, n_sigs, powers = _stream_fixture(pool, rng)
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
            "stream_sigs_per_s": n_sigs / warm_s}


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
    return {"vs_quorum_p50_ms": statistics.median(quorum_ms)}


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
    return {"lc_client_ms": wall_ms}


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
          f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print("nvidia-smi:", smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
