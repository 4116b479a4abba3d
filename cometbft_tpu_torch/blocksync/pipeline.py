"""Streaming multi-commit verification pipeline: the blocksync core.

Counterpart of the JAX package's blocksync/pipeline.py. Reference shape:
blocksync/reactor.go:463 verifies each streamed block's commit serially
(`state.Validators.VerifyCommitLight(...)` once per block, ~1k signatures
each). Here many consecutive commits go through one fused device pass:
every signature row carries a commit id, the kernels verify all rows in
parallel and compute each commit's voting-power quorum bit, so a
64k-signature pass retires 64 blocks of 1k validators at once.

Two chunk branches:
  * cached: every commit of the chunk shares one ed25519 valset, so the
    chunk verifies against its device-resident window table
    (ops/ed25519_cached.py). Commit c occupies columns [c*M, (c+1)*M).
    The host stages only per-row deltas (signature, timestamp words,
    flags) and the stamp kernel builds the packed rows on the device
    (ops/ed25519_stamp.py); a chunk that cannot be staged so (timestamps
    outside the staged words, too many heights) is packed on the host.
  * general: mixed valsets, through the general verify and tally kernels
    (ops/ed25519_fused.py). The host stages the same per-row deltas plus
    each row's key and power, and the general stamp kernel builds the
    packed rows on the device (ops/ed25519_stamp.py stamp_rows_general);
    a chunk that cannot be staged so is packed on the host.

A host pack builds each row's sign-bytes in C from its commit's template
and its timestamp (native.ed25519_pack_commits); a chunk with a malformed
key or signature goes through the numpy screen of
ed25519_kernel.pack_batch, and `native=False` makes every host pack the
numpy plain version.

Kernel launches return at once, so the host stages chunk k+1 while the
device works on chunk k; at most 2 chunks are in flight, and fetching
chunk k's results (`_collect`, the one synchronisation point) overlaps
the next dispatch.

A call's stages, always timed into `StreamVerifier.stats` and each a
`blocksync.*` span (libs/tracing.py) with the call's and the chunk's
index: `precheck` a call; then a chunk's `rows` (valset arrays, per-row
lists, thresholds), `pack` (the host pack), `layout` (the packed rows
or the stamping deltas; after the launches, the chunk's row arrays),
`dispatch` (upload and launches), all inside its `blocksync.chunk` span
and its `host_ms` bracket; and in `_collect` its `wait` (the host
blocked on the card) and `verdicts`.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from cometbft_tpu_torch import native as _native
from cometbft_tpu_torch.device import resolve
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.libs.staging import StagingPool
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.types.commit import Commit
from cometbft_tpu_torch.types.validation import (
    InvalidSignatureError,
    NotEnoughPowerError,
    VerificationError,
    _verify_basic,
)
from cometbft_tpu_torch.types.validator import ValidatorSet

# Fixed commit-axis padding: a chunk's commit count never exceeds it.
MAX_COMMITS_PER_CHUNK = 64

# A chunk's stages: the first four inside its host_ms bracket, the last
# two in _collect. stats["stage_ms"][stage] runs parallel to host_ms.
CHUNK_STAGES = ("rows", "pack", "layout", "dispatch")
STAGES = CHUNK_STAGES + ("wait", "verdicts")
_ROWS, _PACK, _LAYOUT, _DISPATCH = range(len(CHUNK_STAGES))
_SPANS = tuple(f"blocksync.{s}" for s in CHUNK_STAGES)

# every live verifier, weakly held, so a reader of its stage readings
# (a benchmark metric, an operator's tool) needs no handle to it
_VERIFIERS: "weakref.WeakSet" = weakref.WeakSet()


def live_verifiers() -> List["StreamVerifier"]:
    """Snapshot of every StreamVerifier still alive in this process."""
    return list(_VERIFIERS)


@dataclass
class CommitJob:
    """One block's commit to verify (the VerifyCommitLight arguments)."""

    vals: ValidatorSet
    block_id: object
    height: int
    commit: Commit
    chain_id: str


@dataclass
class _Chunk:
    jobs: List  # [(global_idx, CommitJob)]
    row_job: np.ndarray   # (n,) job index per signature row
    row_idx: np.ndarray   # (n,) commit-signature index per row (blame)
    pending: tuple        # device tensors in flight (valid, tally, quorum)
    row_pos: Optional[np.ndarray] = None  # device column per packed sig
    # (None = rows are dense 0..n-1; cached-table chunks stride commits
    # to the valset table period so column b mod M == validator index)
    # or "general_stamped", "stamped", "host_packed_cached"
    branch: str = "general"
    call: int = 0             # the verify call's sequence number
    index: int = 0            # the chunk's index in stats["host_ms"]


class _StageClock:
    """A chunk's four host stages inside its host_ms bracket. Each stage
    boundary reads the clock once and charges the time since the last
    reading to the stage that ran, so the stages sum to the bracket; the
    boundary also opens the stage's span. A stage may run more than once
    in a chunk: the chunk's row arrays are built in `layout` after the
    launches, while the card verifies."""

    __slots__ = ("call", "chunk", "cur", "t0", "t", "s")

    def __init__(self):
        self.call = self.chunk = self.cur = 0
        self.t0 = self.t = 0.0
        self.s = [0.0] * len(CHUNK_STAGES)   # seconds by stage

    def start(self, call: int, chunk: int) -> None:
        self.call, self.chunk, self.cur = call, chunk, _ROWS
        self.s[:] = (0.0,) * len(CHUNK_STAGES)
        self.t0 = self.t = time.perf_counter()

    def stage(self, i: int):
        now = time.perf_counter()
        self.s[self.cur] += now - self.t
        self.t, self.cur = now, i
        return tracing.span(_SPANS[i], "blocksync", call=self.call,
                            chunk=self.chunk)

    def stop(self) -> float:
        """The bracket's milliseconds."""
        now = time.perf_counter()
        self.s[self.cur] += now - self.t
        return (now - self.t0) * 1e3


class StreamVerifier:
    """Packs CommitJobs into fused multi-commit device passes.

    verify(jobs) returns a list of Optional[VerificationError]: None for a
    commit that verified with quorum, the failure otherwise (bad signature
    rows get InvalidSignatureError with the exact commit-sig index, like
    the reference's per-sig blame fallback, types/validation.go:243-250).

    `device` is where the kernels run (None: the CUDA card; "cpu": the
    plain PyTorch versions). `native=False` packs on the host with the
    numpy plain version instead of the native host packer, where a chunk
    packs on the host. `stats` counts chunks by branch (`general_chunks`
    counts every general chunk, `general_stamped_chunks` those stamped on
    the device) and records, always, the host wall time of staging and
    dispatching each chunk (`host_ms`), each chunk's stages
    (`stage_ms`: a list a stage, parallel to `host_ms`), and each call's
    precheck (`precheck_ms`: (index of the call's first chunk in
    `host_ms`, ms) a call)."""

    def __init__(self, max_sigs: int = 65536, device=None,
                 min_device_sigs: int = 129, native: bool = True):
        self.max_sigs = max_sigs
        self.device = resolve(device)
        self.native = native
        self._vs_cache = {}
        # below this many rows the device pass loses to a host verify
        # loop (the shouldBatchVerify gate, types/validation.go:13-17,
        # applied to the streaming path)
        self.min_device_sigs = min_device_sigs
        # private staging pool, 3 deep: up to 2 chunks fly while a 3rd
        # packs
        self._staging = StagingPool(slots=3)
        self.stats = {"stamped_chunks": 0, "host_packed_cached_chunks": 0,
                      "general_chunks": 0, "general_stamped_chunks": 0,
                      "host_ms": [],
                      "stage_ms": {s: [] for s in STAGES},
                      "precheck_ms": []}
        self._calls = 0
        self._vs_misses = 0
        self._clock = _StageClock()
        _VERIFIERS.add(self)

    # -- packing -----------------------------------------------------------

    @staticmethod
    def _template_msgs(jobs, job_idxs):
        """Sign-bytes of the chunk's rows: one vectorized template patch
        per commit."""
        from cometbft_tpu_torch.types import validation as tv

        msgs = []
        for j, idxs in job_idxs:
            job = jobs[j][1]
            msgs += tv._commit_msgs(job.chain_id, job.commit, idxs)
        return msgs

    @staticmethod
    def _templates(jobs):
        """(prefix, suffix) sign-bytes template of each job's for-block
        precommit, in job order (the native pack's row_tmpl indexes it)."""
        from cometbft_tpu_torch.types import canonical

        return [canonical.CanonicalVoteEncoder(
            job.chain_id, canonical.PRECOMMIT_TYPE, job.commit.height,
            job.commit.round, job.commit.block_id).template
            for _, job in jobs]

    def _host_pack(self, jobs, job_idxs, pubs, sigs, row_job, secs, nanos,
                   pad: int) -> ek.PackedBatch:
        """The dense host pack of a chunk of well-formed rows, padded to
        `pad`: the native commit pack, or with native=False the numpy
        plain version over the template sign-bytes."""
        if not self.native:
            return ek.pack_batch(pubs, self._template_msgs(jobs, job_idxs),
                                 sigs, pad_to=pad, native=False)
        n = len(pubs)
        packed = _native.ed25519_pack_commits(
            b"".join(pubs), b"".join(sigs), self._templates(jobs),
            np.asarray(row_job, np.int32),
            np.asarray(secs, np.int64), np.asarray(nanos, np.int64), pad)
        return ek.PackedBatch(n, pad, *packed)

    def _valset_arrays(self, vs):
        """(pub_bytes tuple, power tuple, all_32B) per ValidatorSet, cached
        by identity: the streaming loop re-reads one set for hundreds of
        consecutive commits."""
        cached = self._vs_cache.get(id(vs))
        if cached is not None and cached[3] is vs:
            return cached[:3]
        self._vs_misses += 1
        keys = tuple(v.pub_key.data for v in vs.validators)
        powers = tuple(v.voting_power for v in vs.validators)
        keys_ok = all(len(k) == 32 for k in keys)
        if len(self._vs_cache) > 8:
            self._vs_cache.clear()
        # the valset itself rides in the entry so an id() collision with
        # a garbage-collected set can never alias
        self._vs_cache[id(vs)] = (keys, powers, keys_ok, vs)
        return keys, powers, keys_ok

    def _cached_table(self, jobs):
        """The valset window table when every job in the chunk shares one
        ed25519 valset (the dominant blocksync shape), else None."""
        vs0 = jobs[0][1].vals
        if any(job.vals is not vs0 for _, job in jobs[1:]):
            return None
        keys, _, keys_ok = self._valset_arrays(vs0)
        if not keys_ok or len(keys) < 2:
            return None
        from cometbft_tpu_torch.ops import ed25519_cached as ec

        return ec.table_for_valset(vs0, self.device)

    def _cap(self, table) -> int:
        """Static jobs-per-chunk of the strided cached layout."""
        return min(MAX_COMMITS_PER_CHUNK, max(1, self.max_sigs // table.n_vals))

    def _pack_chunk_cached(self, jobs, table) -> Optional[_Chunk]:
        """Strided pack for the cached-table kernels: commit c occupies
        device columns [c*M, (c+1)*M) with validator i's signature at
        column c*M + i (the kernels derive the table key as column mod M).
        Columns with no countable signature stay dead (precheck=0,
        counted=0)."""
        from cometbft_tpu_torch.ops import ed25519_cached as ec

        clk = self._clock
        with clk.stage(_ROWS):
            M = table.n_vals
            cap = self._cap(table)
            assert len(jobs) <= cap
            B = cap * M

            pubs: List[bytes] = []
            sigs: List[bytes] = []
            row_job: List[int] = []
            row_idx: List[int] = []
            row_pos: List[int] = []
            secs: List[int] = []
            nanos: List[int] = []
            job_idxs: List[tuple] = []  # (j, idxs) for the plain host pack
            keys, _, _ = self._valset_arrays(jobs[0][1].vals)
            nvals = len(keys)
            for j, (_, job) in enumerate(jobs):
                css = job.commit.signatures
                idxs = [i for i, cs in enumerate(css)
                        if cs.for_block() and i < nvals]
                if not idxs:
                    continue
                pubs += [keys[i] for i in idxs]
                sigs += [css[i].signature for i in idxs]
                tss = [css[i].timestamp for i in idxs]
                secs += [t.seconds for t in tss]
                nanos += [t.nanos for t in tss]
                row_job += [j] * len(idxs)
                row_idx += idxs
                row_pos += [j * M + i for i in idxs]
                job_idxs.append((j, idxs))
            if not pubs:
                return None
            n = len(pubs)
            if any(len(s) != 64 for s in sigs):
                return None  # malformed rows: the general path screens them
            pos = np.asarray(row_pos, np.int64)
            thresh = np.zeros((cap, ek.TALLY_LIMBS), np.int32)
            thresh[:, -1] = ek.POWER_MASK  # unreachable for padded job slots
            for j, (_, job) in enumerate(jobs):
                thresh[j] = ek.threshold_limbs(
                    job.vals.total_voting_power() * 2 // 3
                )[0]
        # delta staging first: when every job stamps, the host pack below
        # (SHA-512 + mod-L per row) never runs
        pending = self._stamp_chunk(jobs, sigs, secs, nanos, row_job, pos,
                                    B, cap, table, thresh)
        if pending is not None:
            self.stats["stamped_chunks"] += 1
            with clk.stage(_LAYOUT):
                return _Chunk(list(jobs), np.asarray(row_job),
                              np.asarray(row_idx), pending, row_pos=pos,
                              branch="stamped")
        # dense pack (keys and signatures are well formed here), then
        # scatter to the strided layout
        with clk.stage(_PACK):
            pbd = self._host_pack(jobs, job_idxs, pubs, sigs, row_job,
                                  secs, nanos, n)
        with clk.stage(_LAYOUT):
            pool = self._staging
            ry = pool.get("chunk.ry", (B, pbd.ry.shape[1]), pbd.ry.dtype)
            ry[pos] = pbd.ry[:n]
            rsign = pool.get("chunk.rsign", (B,), np.int32)
            rsign[pos] = np.asarray(pbd.rsign[:n], np.int32)
            sdig = pool.get("chunk.sdig", (B, pbd.sdig.shape[1]),
                            pbd.sdig.dtype)
            sdig[pos] = pbd.sdig[:n]
            hdig = pool.get("chunk.hdig", (B, pbd.hdig.shape[1]),
                            pbd.hdig.dtype)
            hdig[pos] = pbd.hdig[:n]
            precheck = pool.get("chunk.precheck", (B,), np.bool_)
            precheck[pos] = np.asarray(pbd.precheck[:n], np.bool_)
            counted = pool.get("chunk.counted", (B,), np.bool_)
            counted[pos] = True
            commit_ids = pool.get("chunk.cid", (B,), np.int32)
            for j in range(cap):
                commit_ids[j * M:(j + 1) * M] = j
            pb = ek.PackedBatch(n, B, None, None, ry, rsign, sdig, hdig,
                                precheck)
            out = pool.get("chunk.rows", ec.packed_rows_shape(B, cap),
                           np.int32)
            rows = ec.pack_rows_cached(pb, counted, commit_ids, thresh,
                                       out=out)
        with clk.stage(_DISPATCH):
            pending = ec.verify_tally_rows_cached(rows, table, cap)
        self.stats["host_packed_cached_chunks"] += 1
        with clk.stage(_LAYOUT):
            return _Chunk(list(jobs), np.asarray(row_job),
                          np.asarray(row_idx), pending, row_pos=pos,
                          branch="host_packed_cached")

    def _stage_deltas(self, jobs, sigs, secs, nanos, row_job, pos, B,
                      dead_cid: int = 0):
        """The stamp kernels' per-row deltas of a chunk whose rows sit at
        device columns `pos` of B: the template entry of its heights
        (template id == commit id == the job index) and the staged (B, 64)
        signatures, (B, 3) timestamp words and (B,) flags; a dead column
        stages zeros and the commit id `dead_cid`. Returns (entry, sig,
        ts, flags), or None when the chunk cannot be staged so: more
        heights than the template matrix holds, timestamp words outside
        the staged int32 layout, or a template too large for one entry."""
        from cometbft_tpu_torch.ops import ed25519_stamp as es
        from cometbft_tpu_torch.types import canonical

        if len(jobs) > es.MAX_TEMPLATE_SITES:
            return None
        try:
            sec_a = np.asarray(secs, np.int64)
            nan_a = np.asarray(nanos, np.int64)
        except OverflowError:  # past int64: the host pack raises it
            return None
        if nan_a.size and not -2**31 <= nan_a.min() <= nan_a.max() < 2**31:
            return None
        sites = []
        for _, job in jobs:
            tpl = canonical.VoteRowTemplate(
                job.chain_id, canonical.PRECOMMIT_TYPE,
                job.commit.height, job.commit.round, job.commit.block_id)
            sites.append(tpl.stamp_site())
        try:
            ent = es.template_entry(sites, self.device)
        except ValueError:  # oversized site list: host pack
            return None
        pool = self._staging
        dsig = pool.get("chunk.dsig", (B, 64), np.uint8)
        dsig[pos] = np.frombuffer(b"".join(sigs), np.uint8).reshape(-1, 64)
        dts = pool.get("chunk.dts", (B, 3), np.int32)
        dts[pos] = canonical.split_ts_words(sec_a, nan_a)
        dfl = pool.get("chunk.dflags", (B,), np.int32)
        dfl[:] = dead_cid << 10
        rj = np.asarray(row_job, np.int64)
        # live | counted | tmpl_id<<2 | cid<<10: every packed chunk row is
        # countable (the for_block filter already ran); a dead lane
        # (live = 0) stamps a zero column, in the general layout but its
        # commit id
        dfl[pos] = (3 | (rj << 2) | (rj << 10)).astype(np.int32)
        return ent, dsig, dts, dfl

    def _stamp_chunk(self, jobs, sigs, secs, nanos, row_job, pos, B, cap,
                     table, thresh):
        """Delta staging for the cached chunk: stage only (sig, ts words,
        flags) per row and let the stamp kernel expand each row against
        its height's resident template. Returns the pending device
        tensors, or None when the chunk must host-pack: a table without
        pub_raw, or deltas `_stage_deltas` cannot stage."""
        if getattr(table, "pub_raw", None) is None:
            return None
        from cometbft_tpu_torch.ops import ed25519_stamp as es

        clk = self._clock
        with clk.stage(_LAYOUT):
            staged = self._stage_deltas(jobs, sigs, secs, nanos, row_job,
                                        pos, B)
        if staged is None:
            return None
        ent, dsig, dts, dfl = staged
        with clk.stage(_DISPATCH):
            return es.verify_tally_delta_cached(dsig, dts, dfl, ent, table,
                                                cap, thresh)

    def _stamp_general(self, jobs, pubs, sigs, secs, nanos, row_job, powers,
                       pad, c_pad, thresh):
        """Delta staging for the general chunk: the dense rows' deltas
        (the padding columns dead, with the sink commit id c_pad - 1),
        plus each row's key and power; the general stamp kernel builds the
        packed rows on the device. Returns the pending device tensors, or
        None when the chunk must host-pack (deltas `_stage_deltas` cannot
        stage)."""
        from cometbft_tpu_torch.ops import ed25519_stamp as es

        clk = self._clock
        n = len(pubs)
        with clk.stage(_LAYOUT):
            staged = self._stage_deltas(jobs, sigs, secs, nanos, row_job,
                                        slice(0, n), pad, c_pad - 1)
            if staged is None:
                return None
            pool = self._staging
            dkey = pool.get("chunk.dkey", (pad, 32), np.uint8)
            dkey[:n] = np.frombuffer(b"".join(pubs), np.uint8).reshape(n, 32)
            dpow = pool.get("chunk.dpow", (pad,), np.int64)
            dpow[:n] = powers
            if dpow.min() < 0:  # as ek.power_limbs refuses them
                raise ValueError("voting powers must be non-negative")
        ent, dsig, dts, dfl = staged
        with clk.stage(_DISPATCH):
            return es.verify_tally_delta_general(dsig, dkey, dts, dfl, dpow,
                                                 ent, c_pad, thresh,
                                                 self.device)

    def _pack_chunk(self, jobs) -> Optional[_Chunk]:
        """The general chunk (jobs: [(global_idx, CommitJob)]): dense rows
        with per-row keys and powers through the general kernels, stamped
        on the device when the chunk is well formed and stages, else
        packed on the host."""
        from cometbft_tpu_torch.ops import ed25519_fused as kf

        clk = self._clock
        with clk.stage(_ROWS):
            pubs: List[bytes] = []
            sigs: List[bytes] = []
            row_job: List[int] = []
            row_idx: List[int] = []
            powers: List[int] = []
            secs: List[int] = []
            nanos: List[int] = []
            job_idxs: List[tuple] = []  # (j, idxs) for the plain host pack
            well_formed = True
            for j, (_, job) in enumerate(jobs):
                keys, vpowers, keys_ok = self._valset_arrays(job.vals)
                css = job.commit.signatures
                nvals = len(keys)
                idxs = [i for i, cs in enumerate(css)
                        if cs.for_block() and i < nvals]
                if not idxs:
                    continue
                pubs += [keys[i] for i in idxs]
                sigs += [css[i].signature for i in idxs]
                tss = [css[i].timestamp for i in idxs]
                secs += [t.seconds for t in tss]
                nanos += [t.nanos for t in tss]
                row_job += [j] * len(idxs)
                row_idx += idxs
                powers += [vpowers[i] for i in idxs]
                job_idxs.append((j, idxs))
                if not keys_ok or any(len(css[i].signature) != 64
                                      for i in idxs):
                    well_formed = False  # the numpy screen takes bad rows
            if not pubs:
                return None
            n = len(pubs)
            pad = kf.pad_to_tile(n)
            # a fixed commit axis plus one sink id for the padding rows, so
            # they can't pollute job 0's quorum
            c_pad = MAX_COMMITS_PER_CHUNK + 1
            thresh = np.zeros((c_pad, ek.TALLY_LIMBS), np.int32)
            thresh[:, -1] = ek.POWER_MASK  # unused/sink: unreachable
            for j, (_, job) in enumerate(jobs):
                thresh[j] = ek.threshold_limbs(
                    job.vals.total_voting_power() * 2 // 3
                )[0]
        # delta staging first: when the chunk stamps, the host pack below
        # (SHA-512 + mod-L per row) and pack_rows never run
        if well_formed:
            pending = self._stamp_general(jobs, pubs, sigs, secs, nanos,
                                          row_job, powers, pad, c_pad,
                                          thresh)
            if pending is not None:
                self.stats["general_chunks"] += 1
                self.stats["general_stamped_chunks"] += 1
                with clk.stage(_LAYOUT):
                    return _Chunk(jobs, np.asarray(row_job),
                                  np.asarray(row_idx), pending,
                                  branch="general_stamped")
        with clk.stage(_PACK):
            if well_formed:
                pb = self._host_pack(jobs, job_idxs, pubs, sigs, row_job,
                                     secs, nanos, pad)
            else:
                pb = ek.pack_batch(pubs, self._template_msgs(jobs, job_idxs),
                                   sigs, pad_to=pad, native=self.native)
        with clk.stage(_LAYOUT):
            power5 = np.zeros((pad, ek.POWER_LIMBS), np.int32)
            power5[:n] = ek.power_limbs(np.asarray(powers, np.int64))
            counted = np.zeros((pad,), np.bool_)
            counted[:n] = True
            commit_ids = np.zeros((pad,), np.int32)
            commit_ids[:n] = np.asarray(row_job, np.int32)
            commit_ids[n:] = c_pad - 1
            rows = kf.pack_rows(pb, power5, counted, commit_ids, thresh)
        with clk.stage(_DISPATCH):
            pending = kf.verify_tally_rows(rows, c_pad, self.device)
        self.stats["general_chunks"] += 1
        with clk.stage(_LAYOUT):
            return _Chunk(jobs, np.asarray(row_job), np.asarray(row_idx),
                          pending)

    # -- the streaming loop ------------------------------------------------

    def _chunk_indexed(self, indexed):
        """Split [(global_idx, job)] into chunks of <= max_sigs rows."""
        cur, cur_sigs = [], 0
        for gi, job in indexed:
            n = len(job.commit.signatures)
            if cur and (cur_sigs + n > self.max_sigs
                        or len(cur) >= MAX_COMMITS_PER_CHUNK):
                yield cur
                cur, cur_sigs = [], 0
            cur.append((gi, job))
            cur_sigs += n
        if cur:
            yield cur

    def verify(
        self, jobs: Sequence[CommitJob]
    ) -> List[Optional[VerificationError]]:
        from cometbft_tpu_torch.types import validation as tv

        stats = self.stats
        call, self._calls = self._calls, self._calls + 1
        first = len(stats["host_ms"])
        t0 = time.perf_counter()
        with tracing.span("blocksync.precheck", "blocksync", call=call,
                          chunk=first):
            results: List[Optional[VerificationError]] = [None] * len(jobs)
            done = set()
            # structural prechecks stay host-side (cheap, no device round
            # trip)
            for i, job in enumerate(jobs):
                try:
                    _verify_basic(job.vals, job.block_id, job.height,
                                  job.commit)
                except VerificationError as e:
                    results[i] = e
                    done.add(i)

            # commits with non-ed25519 validators route to the grouped
            # batch dispatch; the fused multi-commit pass assumes ed25519
            # rows
            for i, job in enumerate(jobs):
                if i in done:
                    continue
                if any(v.pub_key.key_type != "ed25519"
                       for v in job.vals.validators):
                    try:
                        tv.verify_commit_light(
                            job.chain_id, job.vals, job.block_id, job.height,
                            job.commit, tv.device_batch_fn(self.device),
                        )
                    except VerificationError as e:
                        results[i] = e
                    done.add(i)

            indexed = [(i, j) for i, j in enumerate(jobs) if i not in done]
            total_rows = sum(
                len(j.commit.signatures) for _, j in indexed
            )
        stats["precheck_ms"].append((first,
                                     (time.perf_counter() - t0) * 1e3))
        if total_rows < self.min_device_sigs:
            for gi, job in indexed:
                try:
                    tv.verify_commit_light(
                        job.chain_id, job.vals, job.block_id, job.height,
                        job.commit, batch_fn=None,
                    )
                except VerificationError as e:
                    results[gi] = e
            return results

        in_flight: List[_Chunk] = []
        clk, stage_ms = self._clock, stats["stage_ms"]
        for chunk_pairs in self._split_for_tables(indexed):
            k = len(stats["host_ms"])
            misses = self._vs_misses
            with tracing.span("blocksync.chunk", "blocksync", call=call,
                              chunk=k) as sp:
                clk.start(call, k)
                chunk = self._pack_any(chunk_pairs)
                ms = clk.stop()
                if sp is not None:
                    sp.args.update(
                        rows=0 if chunk is None else len(chunk.row_job),
                        jobs=len(chunk_pairs),
                        branch=None if chunk is None else chunk.branch,
                        valset_misses=self._vs_misses - misses)
            stats["host_ms"].append(ms)
            for name, sec in zip(CHUNK_STAGES, clk.s):
                stage_ms[name].append(sec * 1e3)
            stage_ms["wait"].append(0.0)      # _collect fills these in
            stage_ms["verdicts"].append(0.0)
            if chunk is None:
                # zero packable rows (e.g. every signature ABSENT): fail
                # CLOSED, these commits tallied no power at all
                for gi, job in chunk_pairs:
                    results[gi] = NotEnoughPowerError(
                        0, job.vals.total_voting_power() * 2 // 3
                    )
            else:
                chunk.call, chunk.index = call, k
                in_flight.append(chunk)
            # keep at most 2 chunks in flight: fetch the oldest while the
            # newest computes (double buffering)
            if len(in_flight) > 2:
                self._collect(in_flight.pop(0), results)
        for chunk in in_flight:
            self._collect(chunk, results)
        return results

    def _split_for_tables(self, indexed):
        """Chunk, then sub-split cached-table chunks to the static
        jobs-per-chunk capacity of the strided layout."""
        for chunk_pairs in self._chunk_indexed(indexed):
            table = self._cached_table(chunk_pairs)
            if table is None:
                yield chunk_pairs
                continue
            cap = self._cap(table)
            for k in range(0, len(chunk_pairs), cap):
                yield chunk_pairs[k:k + cap]

    def _pack_any(self, jobs) -> Optional[_Chunk]:
        with self._clock.stage(_ROWS):
            table = self._cached_table(jobs)
        if table is not None:
            chunk = self._pack_chunk_cached(jobs, table)
            if chunk is not None:
                return chunk  # malformed rows fall through to the screen
        return self._pack_chunk(jobs)

    def _collect(self, chunk: _Chunk, results) -> None:
        valid, _, quorum = chunk.pending
        t0 = time.perf_counter()
        with tracing.span("blocksync.wait", "blocksync", call=chunk.call,
                          chunk=chunk.index):
            valid = valid.cpu().numpy()
            quorum = quorum.cpu().numpy()
        t1 = time.perf_counter()
        with tracing.span("blocksync.verdicts", "blocksync",
                          call=chunk.call, chunk=chunk.index):
            for j, (gi, job) in enumerate(chunk.jobs):
                rows = chunk.row_job == j
                if chunk.row_pos is not None:
                    row_valid = valid[chunk.row_pos[rows]]
                else:
                    row_valid = valid[: len(chunk.row_job)][rows]
                if not row_valid.all():
                    bad = chunk.row_idx[rows][~row_valid][0]
                    results[gi] = InvalidSignatureError(int(bad))
                elif not bool(quorum[j]):
                    needed = job.vals.total_voting_power() * 2 // 3
                    results[gi] = NotEnoughPowerError(-1, needed)
        t2 = time.perf_counter()
        stage_ms = self.stats["stage_ms"]
        stage_ms["wait"][chunk.index] = (t1 - t0) * 1e3
        stage_ms["verdicts"][chunk.index] = (t2 - t1) * 1e3


def make_stream_verifier(device=None,
                         max_sigs: int = 65536) -> StreamVerifier:
    """A StreamVerifier on `device` (default: the CUDA card)."""
    return StreamVerifier(max_sigs=max_sigs, device=device)
