#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cometbft_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result line):
  1. card and build: the card's name and power limit, capability 9.0, and
     the nvcc build of every kernel from csrc/ (seconds printed);
  2. each kernel against its plain PyTorch version on the card, exactly:
     ed25519_verify on 256 columns (valid, flipped bit, tampered message,
     S >= L, garbage, ZIP-215 edge cases; both must equal the ed25519_ref
     oracle) and tally_quorum on 8 commits with random masks, large powers
     and one commit that misses quorum by exactly 1;
  3. the main path at full size: a 10,000-validator ValidatorSet and one
     signed commit through verify_commit_light (6,667 signatures) and
     verify_commit (10,000), both padded to 16,384 columns, with
     device_batch_fn(); a tampered signature 4,321 must be blamed; prints
     the VerifyCommitLight p50 and verify_commit sigs/s;
  4. the fused verify + tally step on a blocksync-shaped chunk: 16 commits
     x 1,000 validators through verify_tally_rows, one commit short of
     quorum; tallies must equal the host integer sums exactly;
  5. the cached-path kernels against their plain versions on the card,
     exactly: valset_table_build at M = 128 (bad and edge keys included),
     ed25519_verify_cached on 256 columns (also against the oracle),
     stamp_rows over every fuzzed timestamp width with two templates (also
     against pack_rows_cached of a host pack) and tally_quorum_cached on 8
     commits;
  6. blocksync at BASELINE config 4's width: make_stream_verifier() over 80
     heights of a 1,000-validator set (64 under V0, 16 under V1 = V0 with 8
     rotated keys), one tampered signature and one commit short of quorum;
     outcomes must match the oracle, every chunk must be device-stamped,
     launch counts exact; then each cached kernel at the stream's shapes
     (B = 65,536 columns, M = 1,024) against its plain version;
  7. verify_commit on phase 3's 10k commit with device_batch_fn(cached=True):
     a cold table build, then warm calls; tampered signature 4,321 blamed;
     then ed25519_verify_cached on the rows that path verified (10,240
     columns, M = 16,384) and valset_table_build at M = 16,384 against their
     plain versions;
  8. sr25519_verify and ecdsa_verify against their plain versions on the
     card, exactly, 256 columns each over every edge case (edge_cases.py);
     both sides must also equal the sr25519_ref / secp256k1_ref oracles;
  9. BASELINE config 3 at full width: a 10,000-validator set, 5,000 ed25519
     and 5,000 sr25519, one signed commit through verify_commit_light and
     verify_commit with device_batch_fn() (two groups, two launches a call;
     a tampered sr25519 signature must be blamed), then the fused form, each
     group through its verify_tally_rows, tallies summed to the total power
     exactly and each group's (tally, quorum) equal to tally_quorum_plain on
     the same verdicts and rows; then ed25519_verify and sr25519_verify on
     the rows the light and full calls launched them on (4,096 and 16,384
     columns, clean and tampered) against plain;
 10. BASELINE config 5's verification core at full width: a 10,000-validator
     secp256k1 set, one signed commit through verify_commit_light_trusting
     (1/3) and verify_commit_light, the two calls verify_non_adjacent makes;
     a tampered signature must be blamed; then ecdsa_verify on the rows both
     calls launched it on (4,096 and 16,384 columns, clean and tampered)
     against plain.
Before the last line it prints the `kernels` JSON (launches on the main
paths, in all and by path; times; bounds); the last line is
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
# timestamps that cross every varint width boundary, the zero-skipping
# cases and the 10-byte two's-complement negatives
FUZZ_SECS = [0, 1, 127, 128, 16383, 16384, 1_700_000_000, 2**31 - 1,
             2**31, 2**40, 2**62, -1, -2**33]
FUZZ_NANOS = [0, 1, 127, 128, 999_999_999, 5, 42, -7]
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


def trace_device_ms(fn, name):
    """(kernel ms, memcpy ms, wall ms) of one call under torch.profiler,
    summed from the exported trace's device events (the trace is kept under
    build/traces/), or None when the trace holds no device events."""
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
    kern = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel")
    copy = sum(e.get("dur", 0) for e in events
               if e.get("cat") in ("gpu_memcpy", "gpu_memset"))
    if kern <= 0:
        return None
    return kern / 1e3, copy / 1e3, wall


def split_times(dev, vs, commit, n, runs):
    """Host pack ms (host clock) and device ms (CUDA events around upload,
    kernel and download) of `runs` verify batches of the commit's first n
    signatures, through the same calls verify_batch makes."""
    import torch

    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    idxs = list(range(n))
    pubs = [vs.validators[i].pub_key.data for i in idxs]
    msgs = commit.sign_bytes_rows(CHAIN_ID, idxs)
    sigs = [commit.signatures[i].signature for i in idxs]
    pack_ms, dev_ms = [], []
    for _ in range(runs):
        t = time.perf_counter()
        rows = kf.pack_rows(ek.pack_batch(pubs, msgs, sigs,
                                          pad_to=kf.pad_to_tile(n)))
        pack_ms.append((time.perf_counter() - t) * 1e3)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        valid = kf.verify_rows(rows, dev).cpu().numpy()
        b.record()
        b.synchronize()
        dev_ms.append(a.elapsed_time(b))
        check(valid[:n].all() and not valid[n:].any(),
              f"split-time batch of {n} verified wrongly")
    return pack_ms, dev_ms


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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "bytes stack" in line:
            print("ptxas:", line.strip())
    from cometbft_tpu_torch.crypto import secp256k1_ref

    print(f"phase1 build_s={time.perf_counter() - t0:.3f} "
          f"device={torch.cuda.get_device_name(0)} kernel_sources="
          f"{len(_build.KERNELS)} ripemd160="
          f"{secp256k1_ref.ripemd160_source()}", flush=True)
    return dev


def zip215_cases(pool):
    from cometbft_tpu_torch.crypto import ed25519_ref as ed

    ident = ed.pt_compress(ed.IDENT)
    cases = [(ident, b"m", ident + b"\x00" * 32)]
    for y in range(19):
        u, v = (y * y - 1) % ed.P, (ed.D * y * y + 1) % ed.P
        ok, x = ed._sqrt_ratio(u, v)
        if ok:
            enc_nc = int.to_bytes((y + ed.P) | ((x & 1) << 255), 32, "little")
            break
    pub, (sig,) = ed.sign_many(bytes(32), [b"x"])
    cases.append((pub, b"x", enc_nc + sig[32:]))
    cases.append((enc_nc, b"x", sig))
    neg_zero = int.to_bytes(1 | (1 << 255), 32, "little")
    cases.append((neg_zero, b"m", neg_zero + b"\x00" * 32))
    # small-order A (order 4 point (sqrt(-1)-ish y = 0)) with s = 0, R = 0
    zero_y = bytes(32)
    cases.append((zero_y, b"s", ident + b"\x00" * 32))
    cases.append((ident, b"s", zero_y + b"\x00" * 32))
    return cases


def phase_kernels_vs_plain(dev, pool, rng):
    import numpy as np
    import torch

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
    zip_cases = zip215_cases(pool)
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
    light_pack, light_dev = split_times(dev, vs, commit, n_light, LIGHT_RUNS)
    full_pack, full_dev = split_times(dev, vs, commit, N_VALS, FULL_RUNS)
    kf.ed25519_verify.launches = saved
    print(f"phase3 launches {json.dumps(launches)} breaker_trips=0 faults=0 "
          f"blamed_idx={TAMPER_IDX}", flush=True)
    print(f"phase3 VerifyCommitLight n_sigs={n_light} "
          f"padded={kf.pad_to_tile(n_light)} "
          f"p50_ms={statistics.median(light_ms):.3f} "
          f"host_pack_p50_ms={statistics.median(light_pack):.3f} "
          f"device_p50_ms={statistics.median(light_dev):.3f} "
          f"runs={LIGHT_RUNS} all_ms={[round(x, 3) for x in light_ms]}",
          flush=True)
    print(f"phase3 VerifyCommit n_sigs={N_VALS} p50_ms={full_p50:.3f} "
          f"sigs_per_s={N_VALS / (full_p50 / 1e3):.1f} "
          f"host_pack_p50_ms={statistics.median(full_pack):.3f} "
          f"device_p50_ms={statistics.median(full_dev):.3f}", flush=True)

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
    kernel_stats["ed25519_verify"] = dict(
        launches_by_path={"verify_commit": launches["ed25519_verify"]},
        ms=ms, plain_ms=plain_ms,
        n_checked=int(pb.precheck.sum()), cols=int(rows.shape[1]),
        max_abs_err=err,
        bytes=rows.shape[1] * (kf.C_KROWS + 1) * 4 + 8192 * 3 * 10 * 4,
        library_ms=None,
    )
    print(f"phase3 ed25519_verify cols={rows.shape[1]} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.1f} kernel==plain", flush=True)
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
    verdicts = kf.ed25519_verify(r)
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
    library_ms = cuda_ms(lambda: acc.index_add_(0, cids, contrib), 50)
    kernel_stats["tally_quorum"] = dict(
        launches_by_path={"verify_commit": tally_on_commit_path,
                          "fused_step": launches["tally_quorum"]},
        ms=ms, plain_ms=plain_ms,
        cols=B, bytes=B * 6 * 4 + CHUNK_COMMITS * (6 * 4 * 2 + 1),
        max_abs_err=err,
        library_ms=library_ms,
    )
    kernel_stats["ed25519_verify"]["launches_by_path"]["fused_step"] = (
        launches["ed25519_verify"])
    print(f"phase4 tally_quorum cols={B} commits={CHUNK_COMMITS} "
          f"kernel_ms={ms:.5f} plain_ms={plain_ms:.4f} "
          f"index_add_ms={library_ms:.5f}", flush=True)


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
    print("phase5 valset_table_build M=128 keys=124 kernel==plain (bytes) "
          f"ok={int(okv.sum())}", flush=True)

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
    for p, m, s in zip215_cases(pool):
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
    """pack_rows_cached over a host pack of one cached stream chunk: the
    for-block signature of validator i in commit c at column c * M + i,
    dead columns zero."""
    import numpy as np

    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    pubs, msgs, sigs, pos = [], [], [], []
    for c, job in enumerate(jobs):
        for i, (cs, m) in enumerate(zip(job.commit.signatures,
                                        job.commit.sign_bytes_rows(
                                            job.chain_id))):
            if cs.for_block():
                pubs.append(job.vals.validators[i].pub_key.data)
                msgs.append(m)
                sigs.append(cs.signature)
                pos.append(c * M + i)
    n = len(pos)
    pos = np.asarray(pos)
    pb = ek.pack_batch(pubs, msgs, sigs, pad_to=n)

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
    real_pack = ek.pack_batch
    packs = []

    def counting_pack(*a, **k):
        packs.append(len(a[0]))
        return real_pack(*a, **k)

    runs = []  # (seconds, launches, stats, host_ms)
    captured = {}
    real_delta = es.verify_tally_delta_cached

    def capture_delta(sig, ts, flags, ent, table, n_commits, thresh=None):
        if not captured:
            captured.update(sig=sig.copy(), ts=ts.copy(), flags=flags.copy(),
                            ent=ent, table=table, n_commits=n_commits,
                            thresh=np.asarray(thresh).copy())
        return real_delta(sig, ts, flags, ent, table, n_commits, thresh)

    ek.pack_batch = counting_pack
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
    check(not packs, f"pack_batch ran on the stamped path ({packs})")
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
          f"pack_batch_calls=0 breaker_trips=0 faults=0 blamed_height="
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

    # the kernels at the stream's shapes, against their plain versions
    table = captured["table"]
    ent = captured["ent"]
    cap = captured["n_commits"]
    M = table.n_vals
    B = captured["sig"].shape[0]
    t_rows = ec.packed_rows_shape(B, cap)[0] - ec.V_THRESH
    sig_t, ts_t, fl_t = (torch.from_numpy(captured[k]).to(dev)
                         for k in ("sig", "ts", "flags"))
    thr_t = torch.from_numpy(captured["thresh"]).to(dev)
    stamp = lambda: es.stamp_rows(sig_t, ts_t, fl_t, ent,  # noqa: E731
                                  table.pub_raw, thr_t, t_rows)
    stamp_ms = cuda_ms(stamp, 10)
    rows = stamp()
    t = time.perf_counter()
    rows_p = es.stamp_rows_plain(sig_t, ts_t, fl_t, ent.pre_mat, ent.pre_len,
                                 ent.suf_mat, ent.suf_len, ent.ts_tag,
                                 table.pub_raw, thr_t, ent.msg_max, t_rows)
    torch.cuda.synchronize()
    stamp_plain_ms = (time.perf_counter() - t) * 1e3
    stamp_err = int((rows.to(torch.int64) - rows_p.to(torch.int64))
                    .abs().max())
    check(stamp_err == 0, "stamp_rows != plain at the stream's shape")
    # the same chunk through the host pack: stamped rows are its bytes
    check(np.array_equal(rows.cpu().numpy(), _host_pack_chunk(
        jobs[:cap], M, B, captured["thresh"])),
        "stamped chunk != pack_rows_cached of the host pack")
    live = int((captured["flags"] & 1).sum())
    blocks = sum(
        es.sha512_blocks(len(m)) for job in jobs[:cap]
        for m, cs in zip(job.commit.sign_bytes_rows(CHAIN_ID),
                         job.commit.signatures) if cs.for_block())
    print(f"phase6 stamp_rows cols={B} live={live} sha512_blocks={blocks} "
          f"kernel_ms={stamp_ms:.4f} plain_ms={stamp_plain_ms:.1f} "
          "kernel==plain==host pack (bytes)", flush=True)

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
    print(f"phase6 ed25519_verify_cached cols={B} M={M} live={live} "
          f"kernel_ms={verify_ms:.4f} plain_ms={verify_plain_ms:.1f} "
          "kernel==plain", flush=True)

    tq = lambda: ec.tally_quorum_cached(verdicts, rows,  # noqa: E731
                                        table.power5, cap)
    tally_ms = cuda_ms(tq, 50)
    tally_plain_ms = cuda_ms(lambda: ec.tally_quorum_cached_plain(
        verdicts, rows, table.power5, cap), 3)
    tk, qk = tq()
    tp, qp = ec.tally_quorum_cached_plain(verdicts, rows, table.power5, cap)
    tally_err = max(int((tk - tp).abs().max()), int((qk != qp).sum()))
    check(tally_err == 0, "tally_quorum_cached != plain at the chunk shape")
    flags = rows[ec.V_FLAGS].to(torch.int64)
    pw = table.power5[torch.arange(B, device=dev) % M].to(torch.int64)
    contrib = pw * ((verdicts != 0) & (((flags >> 2) & 1) != 0)).to(
        torch.int64)[:, None]
    acc = torch.zeros((cap, 5), dtype=torch.int64, device=dev)
    cids = flags >> 3
    tally_lib_ms = cuda_ms(lambda: acc.index_add_(0, cids, contrib), 50)
    print(f"phase6 tally_quorum_cached cols={B} commits={cap} "
          f"kernel_ms={tally_ms:.5f} plain_ms={tally_plain_ms:.3f} "
          f"index_add_ms={tally_lib_ms:.5f}", flush=True)

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
    print(f"phase6 valset_table_build M={M} kernel_ms={build_ms:.3f} "
          f"plain_ms={build_plain_ms:.1f} update_table_8_keys_ms="
          f"{[round(x, 3) for x in update_ms]}", flush=True)
    restore_launches(saved)

    kernel_stats["valset_table_build"] = dict(
        launches_by_path={"stream": cold[1]["valset_table_build"]},
        ms=build_ms, plain_ms=build_plain_ms, max_abs_err=build_err,
        ops=M * ec.build_products_per_validator(),
        bytes=M * (32 + 1) + M * (ec.ENT_PER_VAL * 120 + 1), library_ms=None)
    kernel_stats["ed25519_verify_cached"] = dict(
        launches_by_path={"stream": cold[1]["ed25519_verify_cached"]},
        ms=verify_ms, plain_ms=verify_plain_ms, max_abs_err=verify_err,
        ops=live * ec.verify_cached_products_per_signature(),
        bytes=(B * (ec.V_KROWS * 4 + 4) + M * (ec.ENT_PER_VAL * 120 + 1)
               + 8192 * 120),
        library_ms=None)
    kernel_stats["tally_quorum_cached"] = dict(
        launches_by_path={"stream": cold[1]["tally_quorum_cached"]},
        ms=tally_ms, plain_ms=tally_plain_ms, max_abs_err=tally_err,
        ops=B * 6, bytes=B * 8 + M * 20 + cap * (6 * 4 * 2 + 1),
        library_ms=tally_lib_ms)
    kernel_stats["stamp_rows"] = dict(
        launches_by_path={"stream": cold[1]["stamp_rows"]},
        ms=stamp_ms, plain_ms=stamp_plain_ms, max_abs_err=stamp_err,
        ops=blocks * es.SHA512_OPS_PER_BLOCK,
        bytes=B * (64 + 12 + 4) + M * 32 + (ec.V_THRESH + t_rows) * B * 4,
        library_ms=None)
    return {"stream_blocks_per_s": STREAM_HEIGHTS / warm_s,
            "stream_sigs_per_s": n_sigs / warm_s}


def phase_cached_commit(dev, res, kernel_stats):
    import torch

    from cometbft_tpu_torch.crypto import batch as cbatch
    from cometbft_tpu_torch.ops import ed25519_cached as ec
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
    verify_ms = cuda_ms(lambda: ec.ed25519_verify_cached(
        rows, table.tab, table.ok), 5)
    # the M = 16,384 table build, kernel and plain, against the cached table
    lenok = torch.ones((M,), dtype=torch.bool, device=dev)
    lenok[N_VALS:] = False
    build16k_ms = cuda_ms(lambda: ec.valset_table_build(table.pub_raw,
                                                        lenok), 2)
    tab_k, ok_k = ec.valset_table_build(table.pub_raw, lenok)
    tab_p, ok_p = ec.valset_table_build_plain(table.pub_raw, lenok)
    build_err = int((tab_k - tab_p).abs().max())
    check(build_err == 0 and torch.equal(ok_k, ok_p)
          and torch.equal(tab_k, table.tab),
          "valset_table_build != plain (or != the cached table) at M=16,384")
    del tab_k, tab_p
    restore_launches(launches)
    for name, err in (("valset_table_build", build_err),
                      ("ed25519_verify_cached", verify_err)):
        k = kernel_stats[name]
        k["launches_by_path"]["verify_commit_cached"] = launches[name]
        k["max_abs_err"] = max(k["max_abs_err"], err)
    print(f"phase7 launches {json.dumps(launches)} breaker_trips=0 faults=0 "
          f"blamed_idx={TAMPER_IDX}", flush=True)
    rate = int_ops_per_s()[1]
    verify_bound = (N_VALS * ec.verify_cached_products_per_signature()
                    / rate * 1e3)
    build_bound = M * ec.build_products_per_validator() / rate * 1e3
    print(f"phase7 ed25519_verify_cached cols={rows.shape[1]} M={M} "
          f"kernel_ms={verify_ms:.4f} ops_bound_ms={verify_bound:.4f} "
          "kernel==plain (clean and tampered rows); valset_table_build "
          f"M={M} kernel_ms={build16k_ms:.3f} ops_bound_ms={build_bound:.4f} "
          "kernel==plain==cached table", flush=True)
    print(f"phase7 cached VerifyCommit n_sigs={N_VALS} M={M} "
          f"cold_ms={cold_ms:.3f} p50_ms={p50:.3f} sigs_per_s="
          f"{N_VALS / (p50 / 1e3):.1f} runs={CACHED_RUNS} "
          f"all_ms={[round(x, 3) for x in warm_ms]}", flush=True)
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
    the calls its verify_batch makes."""
    import torch

    from cometbft_tpu_torch.ops import ecdsa_fused as ef
    from cometbft_tpu_torch.ops import ecdsa_kernel as eck
    from cometbft_tpu_torch.ops import ed25519_fused as kf
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import sr25519_kernel as srk

    n = len(pubs)
    pack_ms, dev_ms = [], []
    for _ in range(runs):
        t = time.perf_counter()
        if kind == "sr25519":
            rows, verify = srk.pack_batch_sr(pubs, msgs, sigs), srk.verify_rows
        elif kind == "secp256k1":
            rows = ef.pack_rows(eck.pack_batch(pubs, msgs, sigs,
                                               pad_to=ef.pad_to_tile(n)))
            verify = ef.verify_rows
        else:
            rows = kf.pack_rows(ek.pack_batch(pubs, msgs, sigs,
                                              pad_to=kf.pad_to_tile(n)))
            verify = kf.verify_rows
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
    return pack_ms, dev_ms, rows


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
        pack, devt, rows = group_split_times(
            dev, kind, [vs.validators[i].pub_key.data for i in idxs],
            [msgs_all[i] for i in idxs],
            [commit.signatures[i].signature for i in idxs], MIXED_RUNS)
        print(f"phase9 group {kind} n_sigs={len(idxs)} padded="
              f"{rows.shape[1]} host_pack_p50_ms={statistics.median(pack):.3f}"
              f" device_p50_ms={statistics.median(devt):.3f}", flush=True)
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
    # sr25519_verify timed at this path's widest shape
    rows = torch.as_tensor(path_rows["sr25519"][MIXED_RUNS]).to(dev)
    ms = cuda_ms(lambda: srk.sr25519_verify(rows), 10)
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
        library_ms=None)
    for name, e in (("ed25519_verify", ed_err), ("tally_quorum", tally_err)):
        k = kernel_stats[name]
        k["launches_by_path"]["mixed_commit"] = launches[name]
        k["launches_by_path"]["mixed_fused"] = fused_launches[name]
        k["max_abs_err"] = max(k["max_abs_err"], e)
    print(f"phase9 sr25519_verify cols={rows.shape[1]} live={n_sr} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.1f}; kernel==plain for "
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
        pack, devt, rows = group_split_times(
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
    # tampered), against its plain version; timed at the widest shape
    points = ef.base_points(dev)
    err, ec_cols = hold_shapes_against_plain(
        dev, ef.ecdsa_verify, lambda r: ef.ecdsa_verify_plain(r, points),
        path_rows["secp256k1"])
    check(err == 0, f"ecdsa_verify != plain at {ec_cols} cols")
    check(len(path_rows["secp256k1"]) == launches["ecdsa_verify"],
          "phase10 captured rows do not match the launches")
    rows = torch.as_tensor(path_rows["secp256k1"][1]).to(dev)
    ms = cuda_ms(lambda: ef.ecdsa_verify(rows), 10)
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
        library_ms=None)
    print(f"phase10 ecdsa_verify cols={rows.shape[1]} live={n_light} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.1f}; kernel==plain at "
          f"cols={ec_cols} (clean and tampered rows of the path)", flush=True)
    return {"lc_pair_p50_ms": p50}


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
        library_ms=None,
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
        library_ms=t["library_ms"],
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
                                "cometbft_tpu/ops/ed25519_cached.py:948"),
        "stamp_rows": ("stamp_rows.cu",
                       "cometbft_tpu/ops/ed25519_cached.py:1495"),
    }
    for name, (src, replaces) in sources.items():
        k = kernel_stats[name]
        ops_ms = k["ops"] / imad_per_s * 1e3
        bytes_ms = k["bytes"] / HBM_BYTES_PER_S * 1e3
        out.append(dict(
            name=name, route="cuda",
            source=f"cometbft_tpu_torch/csrc/{src}", replaces=replaces,
            launches=sum(k["launches_by_path"].values()),
            launches_by_path=k["launches_by_path"],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=k["library_ms"],
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
          f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print("nvidia-smi:", smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
