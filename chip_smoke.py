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
     quorum; tallies must equal the host integer sums exactly.
Before the last line it prints the `kernels` JSON (launches on the main
paths, in all and by path; times; bounds); the last line is
{"ok": true, "device": {...}}.

Launch counters are set to 0 just before each main-path phase and read just
after; the circuit breaker must record no fault.
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
CHUNK_COMMITS = 16
CHUNK_VALS = 1000
SHORT_COMMIT = 9             # the chunk's commit that misses quorum
LIGHT_RUNS = 7
FULL_RUNS = 5
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
    print(f"phase1 build_s={time.perf_counter() - t0:.3f} "
          f"device={torch.cuda.get_device_name(0)}", flush=True)
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
            "tally_launches": launches["tally_quorum"]}


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


def kernels_json(kernel_stats):
    from cometbft_tpu_torch.ops import ed25519_fused as kf

    mhz = smi("clocks.max.sm").split()[0]
    imad_per_s = H100_SMS * IMAD_PER_CLK * float(mhz) * 1e6
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
    brk = cbatch.device_breaker()
    check(brk.trips == 0 and brk.faults == 0, "breaker recorded a fault")
    print(json.dumps(kernels_json(kernel_stats)), flush=True)
    print(f"summary VerifyCommitLight_p50_ms={res['light_p50_ms']:.3f} "
          f"VerifyCommit_sigs_per_s={res['full_sigs_per_s']:.1f} "
          f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print("nvidia-smi:", smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
