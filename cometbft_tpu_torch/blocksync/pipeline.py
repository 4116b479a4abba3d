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
  * general: mixed valsets; the host packs the rows and the general verify
    and tally kernels run (ops/ed25519_fused.py).

A host pack builds each row's sign-bytes in C from its commit's template
and its timestamp (native.ed25519_pack_commits); a chunk with a malformed
key or signature goes through the numpy screen of
ed25519_kernel.pack_batch, and `native=False` packs every chunk through
the numpy plain version.

Kernel launches return at once, so the host stages chunk k+1 while the
device works on chunk k; at most 2 chunks are in flight, and fetching
chunk k's results (`_collect`, the one synchronisation point) overlaps
the next dispatch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from cometbft_tpu_torch import native as _native
from cometbft_tpu_torch.device import resolve
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


class StreamVerifier:
    """Packs CommitJobs into fused multi-commit device passes.

    verify(jobs) returns a list of Optional[VerificationError]: None for a
    commit that verified with quorum, the failure otherwise (bad signature
    rows get InvalidSignatureError with the exact commit-sig index, like
    the reference's per-sig blame fallback, types/validation.go:243-250).

    `device` is where the kernels run (None: the CUDA card; "cpu": the
    plain PyTorch versions). `native=False` packs on the host with the
    numpy plain version instead of the native host packer. `stats` counts
    chunks by branch and records the host wall time of staging and
    dispatching each chunk."""

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
                      "general_chunks": 0, "host_ms": []}

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

    def _host_pack(self, jobs, job_idxs, pubs, sigs, row_job, row_ts,
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
            np.fromiter((t for t, _ in row_ts), np.int64, n),
            np.fromiter((t for _, t in row_ts), np.int64, n), pad)
        return ek.PackedBatch(n, pad, *packed)

    def _valset_arrays(self, vs):
        """(pub_bytes tuple, power tuple, all_32B) per ValidatorSet, cached
        by identity: the streaming loop re-reads one set for hundreds of
        consecutive commits."""
        cached = self._vs_cache.get(id(vs))
        if cached is not None and cached[3] is vs:
            return cached[:3]
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

        M = table.n_vals
        cap = self._cap(table)
        assert len(jobs) <= cap
        B = cap * M

        pubs: List[bytes] = []
        sigs: List[bytes] = []
        row_job: List[int] = []
        row_idx: List[int] = []
        row_pos: List[int] = []
        row_ts: List[tuple] = []
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
            row_ts += [(css[i].timestamp.seconds, css[i].timestamp.nanos)
                       for i in idxs]
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
        pending = self._stamp_chunk(jobs, sigs, row_ts, row_job, pos,
                                    B, cap, table, thresh)
        if pending is not None:
            self.stats["stamped_chunks"] += 1
            return _Chunk(list(jobs), np.asarray(row_job),
                          np.asarray(row_idx), pending, row_pos=pos)
        # dense pack (keys and signatures are well formed here), then
        # scatter to the strided layout
        pbd = self._host_pack(jobs, job_idxs, pubs, sigs, row_job, row_ts,
                              n)
        pool = self._staging
        ry = pool.get("chunk.ry", (B, pbd.ry.shape[1]), pbd.ry.dtype)
        ry[pos] = pbd.ry[:n]
        rsign = pool.get("chunk.rsign", (B,), np.int32)
        rsign[pos] = np.asarray(pbd.rsign[:n], np.int32)
        sdig = pool.get("chunk.sdig", (B, pbd.sdig.shape[1]), pbd.sdig.dtype)
        sdig[pos] = pbd.sdig[:n]
        hdig = pool.get("chunk.hdig", (B, pbd.hdig.shape[1]), pbd.hdig.dtype)
        hdig[pos] = pbd.hdig[:n]
        precheck = pool.get("chunk.precheck", (B,), np.bool_)
        precheck[pos] = np.asarray(pbd.precheck[:n], np.bool_)
        counted = pool.get("chunk.counted", (B,), np.bool_)
        counted[pos] = True
        commit_ids = pool.get("chunk.cid", (B,), np.int32)
        for j in range(cap):
            commit_ids[j * M:(j + 1) * M] = j
        pb = ek.PackedBatch(n, B, None, None, ry, rsign, sdig, hdig, precheck)
        out = pool.get("chunk.rows", ec.packed_rows_shape(B, cap), np.int32)
        rows = ec.pack_rows_cached(pb, counted, commit_ids, thresh, out=out)
        pending = ec.verify_tally_rows_cached(rows, table, cap)
        self.stats["host_packed_cached_chunks"] += 1
        return _Chunk(list(jobs), np.asarray(row_job),
                      np.asarray(row_idx), pending, row_pos=pos)

    def _stamp_chunk(self, jobs, sigs, row_ts, row_job, pos, B, cap,
                     table, thresh):
        """Delta staging for the cached chunk: stage only (sig, ts words,
        flags) per row and let the stamp kernel expand each row against
        its height's resident template (template id == commit id == the
        job index). Returns the pending device tensors, or None when the
        chunk must host-pack: a table without pub_raw, more heights than
        the template matrix holds, timestamp words outside the staged
        int32 layout, or a template too large for one entry."""
        if getattr(table, "pub_raw", None) is None:
            return None
        from cometbft_tpu_torch.ops import ed25519_stamp as es
        from cometbft_tpu_torch.types import canonical

        if len(jobs) > es.MAX_TEMPLATE_SITES:
            return None
        if any(not (-2**63 <= s < 2**63 and -2**31 <= nn < 2**31)
               for s, nn in row_ts):
            return None
        sites = []
        for _, job in jobs:
            tpl = canonical.VoteRowTemplate(
                job.chain_id, canonical.PRECOMMIT_TYPE,
                job.commit.height, job.commit.round,
                job.commit.block_id)
            sites.append(tpl.stamp_site())
        try:
            ent = es.template_entry(sites, self.device)
        except ValueError:  # oversized site list: host pack
            return None
        sec_a = np.fromiter((s for s, _ in row_ts), np.int64,
                            count=len(row_ts))
        nan_a = np.fromiter((nn for _, nn in row_ts), np.int64,
                            count=len(row_ts))
        pool = self._staging
        dsig = pool.get("chunk.dsig", (B, 64), np.uint8)
        dsig[pos] = np.frombuffer(b"".join(sigs),
                                  np.uint8).reshape(-1, 64)
        dts = pool.get("chunk.dts", (B, 3), np.int32)
        dts[pos] = canonical.split_ts_words(sec_a, nan_a)
        dfl = pool.get("chunk.dflags", (B,), np.int32)
        rj = np.asarray(row_job, np.int64)
        # live | counted | tmpl_id<<2 | cid<<10: every packed chunk row is
        # countable (the for_block filter already ran); dead lanes keep
        # the pool's zero fill (live=0 -> zero column)
        dfl[pos] = (3 | (rj << 2) | (rj << 10)).astype(np.int32)
        return es.verify_tally_delta_cached(dsig, dts, dfl, ent, table,
                                            cap, thresh)

    def _pack_chunk(self, jobs) -> Optional[_Chunk]:
        """The general chunk (jobs: [(global_idx, CommitJob)]): dense rows
        with per-row keys and powers through the general kernels."""
        pubs: List[bytes] = []
        sigs: List[bytes] = []
        row_job: List[int] = []
        row_idx: List[int] = []
        powers: List[int] = []
        row_ts: List[tuple] = []
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
            row_ts += [(css[i].timestamp.seconds, css[i].timestamp.nanos)
                       for i in idxs]
            row_job += [j] * len(idxs)
            row_idx += idxs
            powers += [vpowers[i] for i in idxs]
            job_idxs.append((j, idxs))
            if not keys_ok or any(len(css[i].signature) != 64
                                  for i in idxs):
                well_formed = False  # the numpy screen takes bad rows
        if not pubs:
            return None
        from cometbft_tpu_torch.ops import ed25519_fused as kf

        n = len(pubs)
        pad = kf.pad_to_tile(n)
        if well_formed:
            pb = self._host_pack(jobs, job_idxs, pubs, sigs, row_job, row_ts,
                                 pad)
        else:
            pb = ek.pack_batch(pubs, self._template_msgs(jobs, job_idxs),
                               sigs, pad_to=pad, native=self.native)
        power5 = np.zeros((pad, ek.POWER_LIMBS), np.int32)
        power5[:n] = ek.power_limbs(np.asarray(powers, np.int64))
        counted = np.zeros((pad,), np.bool_)
        counted[:n] = True
        # a fixed commit axis plus one sink id for the padding rows, so
        # they can't pollute job 0's quorum
        c_pad = MAX_COMMITS_PER_CHUNK + 1
        commit_ids = np.zeros((pad,), np.int32)
        commit_ids[:n] = np.asarray(row_job, np.int32)
        commit_ids[n:] = c_pad - 1
        thresh = np.zeros((c_pad, ek.TALLY_LIMBS), np.int32)
        thresh[:, -1] = ek.POWER_MASK  # unused/sink: unreachable threshold
        for j, (_, job) in enumerate(jobs):
            thresh[j] = ek.threshold_limbs(
                job.vals.total_voting_power() * 2 // 3
            )[0]
        rows = kf.pack_rows(pb, power5, counted, commit_ids, thresh)
        pending = kf.verify_tally_rows(rows, c_pad, self.device)
        self.stats["general_chunks"] += 1
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

        results: List[Optional[VerificationError]] = [None] * len(jobs)
        done = set()
        # structural prechecks stay host-side (cheap, no device round trip)
        for i, job in enumerate(jobs):
            try:
                _verify_basic(job.vals, job.block_id, job.height, job.commit)
            except VerificationError as e:
                results[i] = e
                done.add(i)

        # commits with non-ed25519 validators route to the grouped batch
        # dispatch; the fused multi-commit pass assumes ed25519 rows
        for i, job in enumerate(jobs):
            if i in done:
                continue
            if any(
                v.pub_key.key_type != "ed25519" for v in job.vals.validators
            ):
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
        for chunk_pairs in self._split_for_tables(indexed):
            t0 = time.perf_counter()
            chunk = self._pack_any(chunk_pairs)
            self.stats["host_ms"].append((time.perf_counter() - t0) * 1e3)
            if chunk is None:
                # zero packable rows (e.g. every signature ABSENT): fail
                # CLOSED, these commits tallied no power at all
                for gi, job in chunk_pairs:
                    results[gi] = NotEnoughPowerError(
                        0, job.vals.total_voting_power() * 2 // 3
                    )
            else:
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
        table = self._cached_table(jobs)
        if table is not None:
            chunk = self._pack_chunk_cached(jobs, table)
            if chunk is not None:
                return chunk  # malformed rows fall through to the screen
        return self._pack_chunk(jobs)

    def _collect(self, chunk: _Chunk, results) -> None:
        valid, _, quorum = chunk.pending
        valid = valid.cpu().numpy()
        quorum = quorum.cpu().numpy()
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


def make_stream_verifier(device=None,
                         max_sigs: int = 65536) -> StreamVerifier:
    """A StreamVerifier on `device` (default: the CUDA card)."""
    return StreamVerifier(max_sigs=max_sigs, device=device)
