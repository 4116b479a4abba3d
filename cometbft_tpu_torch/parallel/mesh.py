"""Slot meshes for the sharded verification steps.

Counterpart of the JAX package's parallel/mesh.py. CometBFT's scale
dimensions are validator-set size (up to 10k signatures a commit) x commits
in flight, and both map to data parallelism: a batch's columns shard over
a mesh, each member verifies its slice and tallies its partial voting
power, and the partial tallies are summed, re-carried and compared with
the thresholds once.

A mesh here is a tuple of **slots**. A slot is a torch device and, on
CUDA, its own stream; several slots may share one device. On a host with
n cards the mesh's slots are `cuda:0 .. cuda:n-1`; with the environment
variable ``CBT_TORCH_DEVICE_SLOTS=n`` set, `local_devices` returns n slots
of the caller's device instead, the port's counterpart of XLA's
``--xla_force_host_platform_device_count`` (the tests set it for slots of
the CPU, chip_smoke.py for eight slots of one card). Slots are told apart
by their index, so two slots of one device are two members of a mesh.

A builder returns a step (a launch plan) memoized per (builder, slots,
width), as the JAX package memoizes one compiled program. A step runs, for
each slot on its stream, the port's kernels on the slot's slice
(`ed25519_verify`, `ed25519_verify_cached` with `tally_quorum_cached`,
`stamp_rows`, `tally_quorum`), then gathers the partial tallies on the
first slot's device (an event wait on one card, a peer copy across cards;
one process, so no NCCL) and launches `carry_quorum` (csrc/tally_quorum.cu
`cbt_carry_quorum`), the psum + `_carry_tally` + `quorum_core` of the JAX
step. Verdicts come back as one tensor on the first slot's device. On CPU
slots the same steps run the kernels' plain versions one slot after the
other.

The flight deck's two halves (verifyplane/fused.half_meshes) are meshes of
disjoint slots, so each half's steps and tables are memoized apart, and a
half's flush completes within its slots.
"""
from __future__ import annotations

import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from cometbft_tpu_torch.ops import ed25519_kernel as ek

SLOTS_ENV = "CBT_TORCH_DEVICE_SLOTS"


class Slot(NamedTuple):
    """A member of a mesh: its index among the host's slots and its
    device."""

    index: int
    device: torch.device


class Mesh:
    """A tuple of slots (the JAX package's one-axis `batch` mesh)."""

    __slots__ = ("slots",)

    def __init__(self, slots):
        self.slots = tuple(slots)
        if not self.slots:
            raise ValueError("a mesh needs at least one slot")

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def indices(self) -> tuple:
        return tuple(s.index for s in self.slots)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(f'{s.index}:{s.device}' for s in self.slots)})"


def local_devices(device=None) -> tuple:
    """The host's slots for a plane on `device` (None: the CUDA card): n
    slots of that device when CBT_TORCH_DEVICE_SLOTS=n is set, else the
    CUDA devices 0..n-1 for a CUDA device, else the one device."""
    from cometbft_tpu_torch.device import resolve

    dev = resolve(device)
    forced = os.environ.get(SLOTS_ENV)
    if forced:
        n = int(forced)
        if n < 1:
            raise ValueError(f"{SLOTS_ENV}={forced}: need at least 1 slot")
        return tuple(Slot(i, dev) for i in range(n))
    if dev.type == "cuda":
        return tuple(Slot(i, torch.device("cuda", i))
                     for i in range(torch.cuda.device_count()))
    return (Slot(0, dev),)


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices`: Slots, or devices (slot i is the i-th);
    None is `local_devices()`."""
    devices = local_devices() if devices is None else devices
    return Mesh(d if isinstance(d, Slot) else Slot(i, torch.device(d))
                for i, d in enumerate(devices))


def _mesh_key(mesh: Mesh):
    return tuple((s.index, str(s.device)) for s in mesh.slots)


# each CUDA slot's stream, created once: two meshes sharing a slot share
# its stream, as two JAX meshes share a device's queue
_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def slot_stream(slot: Slot) -> Optional[torch.cuda.Stream]:
    """The CUDA stream of `slot` (None for a CPU slot)."""
    if slot.device.type != "cuda":
        return None
    key = (slot.index, str(slot.device))
    with _STREAMS_LOCK:
        s = _STREAMS.get(key)
        if s is None:
            s = _STREAMS[key] = torch.cuda.Stream(slot.device)
        return s


# --------------------------------------------------------------------------
# the step memo
# --------------------------------------------------------------------------

# Step memo: a builder returns the same step for the same (builder,
# slots, width), and its counters show steady-state calls as hits. The
# counters are bumped from the verify plane's dispatcher thread and from
# probes concurrently, so they ride one lock.
_STEP_CACHE: dict = {}
_CACHE_STATS = {"hits": 0, "misses": 0}
_STATS_LOCK = threading.Lock()


def cache_stats() -> dict:
    with _STATS_LOCK:
        return dict(_CACHE_STATS)


def _cache_get(key):
    fn = _STEP_CACHE.get(key)
    with _STATS_LOCK:
        if fn is not None:
            _CACHE_STATS["hits"] += 1
        else:
            _CACHE_STATS["misses"] += 1
    return fn


def _cache_put(key, fn):
    """Memoize a new step, wrapped so that its first call attributes what
    it pays (the kernels' first build) to ``mesh.step:<builder>`` in the
    device ledger (libs/deviceledger), unless a richer frame (the verify
    plane's per-flush attribution) is active on the calling thread. After
    the first call the wrapper is a list check."""
    from cometbft_tpu_torch.libs import deviceledger

    site = f"mesh.step:{key[0]}"
    done: list = []

    def wrapped(*args):
        if done:
            return fn(*args)
        fr = deviceledger.attr_begin_fallback(site)
        try:
            return fn(*args)
        finally:
            done.append(1)
            if fr is not None:
                deviceledger.attr_end(fr)

    _STEP_CACHE[key] = wrapped
    return wrapped


# --------------------------------------------------------------------------
# lane-sharded operands and the slot runner
# --------------------------------------------------------------------------


class Sharded:
    """A lane-sharded array: `parts[d]` is slot d's slice, on slot d's
    device (the JAX package's array with a NamedSharding over the batch
    axis). It has no `__array__`: `numpy()` gathers it to the host, and a
    step that meets one where it expects a whole array raises rather than
    copying it back in the middle of a flight."""

    __slots__ = ("parts", "axis")

    def __init__(self, parts, axis: int = 0):
        self.parts = tuple(parts)
        self.axis = axis

    def numpy(self) -> np.ndarray:
        return np.concatenate([p.cpu().numpy() for p in self.parts],
                              self.axis)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _lanes(mesh: Mesh, x, axis: int = 0, dtype=None) -> list:
    """Slot d's slice of `x` along `axis`, contiguous, on slot d's device
    (as `dtype` where given): a Sharded array's parts where they lie, or
    an array (numpy or tensor) cut into mesh.size equal slices."""
    if isinstance(x, Sharded):
        if len(x.parts) != mesh.size:
            raise ValueError(f"{len(x.parts)} shards for {mesh.size} slots")
        return [p if dtype is None else p.to(dtype) for p in x.parts]
    t = _tensor(x)
    if dtype is not None:
        t = t.to(dtype)
    n = t.shape[axis]
    if n % mesh.size:
        raise ValueError(f"{n} lanes do not split over {mesh.size} slots")
    return [p.contiguous().to(s.device) for p, s in
            zip(torch.chunk(t, mesh.size, axis), mesh.slots)]


def shard(mesh: Mesh, x, axis: int = 0) -> Sharded:
    """`x` (numpy or tensor) cut into mesh.size equal slices along `axis`,
    slice d put on slot d's device (the JAX package's device_put with the
    batch sharding)."""
    return Sharded(_lanes(mesh, x, axis), axis)


def _replicated(mesh: Mesh, x) -> list:
    """`x` on each slot's device (one copy a device, none where it lies)."""
    t = _tensor(x)
    return [t.to(s.device) for s in mesh.slots]


def _run_slots(mesh: Mesh, job) -> list:
    """job(d) for each slot d on its own stream; -> the jobs' results.

    The caller's current stream orders the step: a direct call's is the
    device's default stream; the verify plane makes it the flight's lead
    stream (the first slot's), so a flight on one half of the deck never
    waits for one on the other. A CUDA slot's stream first waits for the
    ordering stream (the operands were made there or are awaited there);
    after the jobs the ordering stream waits for every slot's work, so
    what the caller enqueues next (the gather, the reduce, its end event)
    follows all of it, and a freed operand is not reused while a slot
    still reads it. The jobs' outputs are marked used by the ordering
    stream, so a slot stream does not reuse their memory before the
    reduce has read them."""
    # every slot waits for the ordering stream as it stands before any
    # job: a slot sharing the lead's stream enqueues its job there, and a
    # wait recorded after it would hold the other slots behind that job
    ready = {}
    for slot in mesh.slots:
        if slot.device.type == "cuda" and slot.device not in ready:
            ready[slot.device] = torch.cuda.current_stream(
                slot.device).record_event()
    out, events = [], []
    for d, slot in enumerate(mesh.slots):
        s = slot_stream(slot)
        if s is None:
            out.append(job(d))
            continue
        order = torch.cuda.current_stream(slot.device)
        if s != order:
            s.wait_event(ready[slot.device])
        with torch.cuda.device(slot.device), torch.cuda.stream(s):
            res = job(d)
            ev = torch.cuda.Event()
            ev.record(s)
        if s != order:
            for t in res if isinstance(res, tuple) else (res,):
                t.record_stream(order)
        out.append(res)
        events.append((slot.device, ev))
    for dev, ev in events:
        torch.cuda.current_stream(dev).wait_event(ev)
    return out


def _gather(mesh: Mesh, parts, dim: int = 0) -> torch.Tensor:
    """The slots' parts as one tensor on the first slot's device."""
    lead = mesh.slots[0].device
    return torch.cat([p.to(lead, non_blocking=True) for p in parts], dim)


def _reduce(mesh: Mesh, tallies, threshold):
    """The cross-slot reduce: the (C, 6) partial tallies gathered on the
    first slot's device and one `carry_quorum` launch (the psum, the limb
    re-carry and the quorum compare) -> (total, quorum)."""
    lead = mesh.slots[0].device
    partials = torch.stack([t.to(lead, non_blocking=True) for t in tallies])
    thr = _tensor(threshold).to(device=lead, dtype=torch.int32)
    thr = thr.reshape(partials.shape[1], ek.TALLY_LIMBS).contiguous()
    return ek.carry_quorum(partials, thr)


def _lane_rows(mesh: Mesh, rows, k_rows: int, t_rows_of) -> list:
    """Slot d's column slice of packed (R, B) rows: its first `k_rows`
    rows (what the kernels read) and t_rows_of(b) zero threshold rows,
    on slot d's device (the thresholds ride the step's own argument). A
    Sharded (axis 1) whose parts already have those rows is used as it
    is."""
    if isinstance(rows, Sharded):
        parts = list(rows.parts)
        if len(parts) != mesh.size or any(
                p.shape[0] < k_rows + t_rows_of(p.shape[1]) for p in parts):
            raise ValueError("sharded rows lack the slots' threshold rows")
        return parts
    t = _tensor(rows)
    B = t.shape[1]
    if B % mesh.size:
        raise ValueError(f"{B} columns do not split over {mesh.size} slots")
    b = B // mesh.size
    out = []
    for d, s in enumerate(mesh.slots):
        part = torch.zeros((k_rows + t_rows_of(b), b), dtype=torch.int32,
                           device=s.device)
        part[:k_rows] = t[:k_rows, d * b:(d + 1) * b].to(s.device)
        out.append(part)
    return out


def _t_rows(n_commits: int):
    return lambda b: max(1, -(-(n_commits * ek.TALLY_LIMBS) // b))


# --------------------------------------------------------------------------
# the builders
# --------------------------------------------------------------------------


def _slot_tally(valid, power5, counted, commit_ids, n_commits: int):
    """One slot's partial tally: its columns' tally inputs packed into
    rows on its device, then the tally kernel (whose quorum output the
    reduce replaces)."""
    from cometbft_tpu_torch.ops import ed25519_fused as kf

    b = valid.shape[0]
    rows = kf.pack_rows_torch(b, valid.device, power5=power5,
                              counted=counted, commit_ids=commit_ids,
                              t_rows=_t_rows(n_commits)(b))
    tally, _ = kf.tally_quorum(valid.to(torch.int32).contiguous(), rows,
                               n_commits)
    return tally


def sharded_verify_tally(mesh: Mesh, n_commits: int):
    """The sharded verify + tally step over PackedBatch arrays.

    Returns step(ay, asign, ry, rsign, sdig, hdig, precheck, power5,
    counted, commit_ids, threshold) -> (valid (B,) bool, total (C, 6),
    quorum (C,)): each slot packs its slice into rows on its device,
    verifies it (`ed25519_verify`) and tallies it (`tally_quorum`), then
    the partials reduce. The arrays are Sharded (`shard_batch_arrays`) or
    whole arrays whose length splits over the mesh. Memoized per (mesh,
    n_commits)."""
    key = ("xla", _mesh_key(mesh), int(n_commits))
    cached = _cache_get(key)
    if cached is not None:
        return cached
    from cometbft_tpu_torch.ops import ed25519_fused as kf

    def step(ay, asign, ry, rsign, sdig, hdig, precheck, power5, counted,
             commit_ids, threshold):
        parts = [_lanes(mesh, a) for a in (ay, asign, ry, rsign, sdig, hdig,
                                           precheck, power5, counted,
                                           commit_ids)]

        def job(d):
            pb = tuple(p[d] for p in parts[:7])
            p5, cnt, cid = (p[d] for p in parts[7:])
            b = pb[0].shape[0]
            rows = kf.pack_rows_torch(b, pb[0].device, pb, p5, cnt, cid,
                                      _t_rows(n_commits)(b))
            valid = kf.ed25519_verify(rows)
            tally, _ = kf.tally_quorum(valid, rows, n_commits)
            return valid, tally

        out = _run_slots(mesh, job)
        total, quorum = _reduce(mesh, [t for _, t in out], threshold)
        return _gather(mesh, [v for v, _ in out]) != 0, total, quorum

    return _cache_put(key, step)


def _sharded_verify_rows_step(mesh: Mesh):
    """The JAX package's verify half of the rows path, with its signature:
    the general verify kernel on each slot's column slice of the packed
    rows, plus the slice's tally columns (`sharded_verify_tally_rows`
    runs verify and tally in one step instead).

    step(rows, base) -> Sharded (valid bool, power5 (b, 5) int32,
    counted bool, commit_ids int32), each part on its slot's device.
    `base` is the JAX step's comb table argument; each slot's kernel reads
    its own device's (`ed25519_fused.base_table`)."""
    key = ("pallas-verify", _mesh_key(mesh))
    cached = _cache_get(key)
    if cached is not None:
        return cached
    from cometbft_tpu_torch.ops import ed25519_fused as kf

    def vstep(rows, base):
        parts = _lane_rows(mesh, rows, kf.C_THRESH, lambda b: 1)

        def job(d):
            r = parts[d]
            valid = kf.ed25519_verify(r) != 0
            power5, counted, cids, _ = kf.tally_inputs(r, 0)
            return valid, power5.to(torch.int32), counted, \
                cids.to(torch.int32)

        out = _run_slots(mesh, job)
        return tuple(Sharded(p) for p in zip(*out))

    return _cache_put(key, vstep)


def _sharded_tally_step(mesh: Mesh, n_commits: int):
    """The JAX package's tally half, with its signature: each slot packs
    its columns' tally inputs into rows (`pack_rows_torch`) and tallies
    them, then the reduce. step(valid, power5, counted, commit_ids,
    threshold) -> (total (C, 6) int32, quorum (C,) bool) on the first
    slot's device."""
    key = ("pallas-tally", _mesh_key(mesh), int(n_commits))
    cached = _cache_get(key)
    if cached is not None:
        return cached

    def tstep(valid, power5, counted, commit_ids, threshold):
        parts = [_lanes(mesh, a) for a in (valid, power5, counted,
                                           commit_ids)]
        tallies = _run_slots(mesh, lambda d: _slot_tally(
            *(p[d] for p in parts), n_commits))
        return _reduce(mesh, tallies, threshold)

    return _cache_put(key, tstep)


def sharded_verify_tally_rows(mesh: Mesh, n_commits: int):
    """The general verify + tally over packed (R, B) rows, lane-sharded:
    each slot verifies its B / n_dev columns and tallies the same rows in
    one job (`ed25519_verify`, `tally_quorum`), and the partial tallies
    reduce. Thresholds ride the `threshold` argument, not the rows (they
    are per commit, not per column).

    step(rows, base, threshold) -> (valid (B,) bool, total, quorum). The
    JAX package composes it from its two compiled halves
    (`_sharded_verify_rows_step`, `_sharded_tally_step`); a launch plan
    has no compile boundary to share, so here one step runs both kernels
    on each slot's rows."""
    key = ("rows", _mesh_key(mesh), int(n_commits))
    cached = _cache_get(key)
    if cached is not None:
        return cached
    from cometbft_tpu_torch.ops import ed25519_fused as kf

    def fn(rows, base, threshold):
        parts = _lane_rows(mesh, rows, kf.C_THRESH, _t_rows(n_commits))

        def job(d):
            valid = kf.ed25519_verify(parts[d])
            tally, _ = kf.tally_quorum(valid, parts[d], n_commits)
            return valid, tally

        out = _run_slots(mesh, job)
        total, quorum = _reduce(mesh, [t for _, t in out], threshold)
        return _gather(mesh, [v for v, _ in out]) != 0, total, quorum

    return _cache_put(key, fn)


def shard_batch_arrays(mesh: Mesh, pb: ek.PackedBatch, power5, counted,
                       commit_ids):
    """Pad the batch arrays to a multiple of the mesh size and put each
    slot's slice on its device (Sharded), so the step moves nothing.

    Padding columns carry commit id 0 (there is no "no commit" id); they
    are kept out of every tally by construction: counted is cast to bool
    and set False over the padding explicitly, and precheck pads False so
    the verify kernel rejects those columns too."""
    n_dev = mesh.size
    padded = pb.padded
    counted = np.asarray(counted, np.bool_)
    power5 = np.asarray(power5)
    commit_ids = np.asarray(commit_ids)
    if padded % n_dev:
        extra = n_dev - padded % n_dev

        def pad1(a):
            return np.pad(np.asarray(a), [(0, extra)]
                          + [(0, 0)] * (np.ndim(a) - 1))

        pb = pb._replace(
            padded=padded + extra, ay=pad1(pb.ay), asign=pad1(pb.asign),
            ry=pad1(pb.ry), rsign=pad1(pb.rsign), sdig=pad1(pb.sdig),
            hdig=pad1(pb.hdig), precheck=pad1(pb.precheck),
        )
        power5 = pad1(power5)
        counted = pad1(counted)
        counted[padded:] = False  # padding columns are never counted
        commit_ids = pad1(commit_ids)

    def put(a):
        return Sharded(_lanes(mesh, np.asarray(a)))

    return pb, (
        put(pb.ay), put(pb.asign), put(pb.ry), put(pb.rsign), put(pb.sdig),
        put(pb.hdig), put(pb.precheck), put(power5), put(counted),
        put(commit_ids),
    )


def _cached_step(mesh: Mesh, n_commits: int, tables):
    """The cached verify + tally of each slot's rows against its table,
    then the reduce; tables(d) -> (tab, ok, power5) of slot d."""
    from cometbft_tpu_torch.ops import ed25519_cached as ec

    def run(rows_parts, threshold):
        def job(d):
            tab, ok, power5 = tables(d)
            valid = ec.ed25519_verify_cached(rows_parts[d], tab, ok)
            tally, _ = ec.tally_quorum_cached(valid, rows_parts[d], power5,
                                              n_commits)
            return valid, tally

        out = _run_slots(mesh, job)
        total, quorum = _reduce(mesh, [t for _, t in out], threshold)
        return _gather(mesh, [v for v, _ in out]) != 0, total, quorum

    return run


def sharded_stream_verify(mesh: Mesh, n_commits: int):
    """The blocksync stream's cached verify + tally, sharded by whole
    commits: commit c occupies columns [c*M, (c+1)*M) of the (R, C*M)
    rows, so each slot's C/n_dev commits keep the kernels' `column mod M
    -> validator` map; the valset table is replicated (one valset for
    every commit of the chunk) and the columns carry global commit ids.

    step(rows, tab, ok, power5, base, threshold) -> (valid, total,
    quorum). Memoized per (mesh, n_commits)."""
    key = ("stream", _mesh_key(mesh), int(n_commits))
    cached = _cache_get(key)
    if cached is not None:
        return cached
    from cometbft_tpu_torch.ops import ed25519_cached as ec

    def step(rows, tab, ok, power5, base, threshold):
        rep = [_replicated(mesh, a) for a in (tab, ok, power5)]
        parts = _lane_rows(mesh, rows, ec.V_KROWS, _t_rows(n_commits))
        return _cached_step(mesh, n_commits, lambda d: tuple(
            r[d] for r in rep))(parts, threshold)

    return _cache_put(key, step)


def sharded_fused_verify(mesh: Mesh, n_commits: int):
    """The verify plane's fused flush with the validator set sharded: slot
    d holds the table of validators [d*M_s, (d+1)*M_s)
    (ed25519_cached.sharded_table_for_pubs) and its column slice carries
    exactly those validators' signatures (verifyplane/fused
    shard_positions lays row ``d*B_loc + s*M_s + (v mod M_s)`` out as
    validator v's stride-s slot), so the kernels' `column mod M_s` map
    resolves local indices. Columns carry global commit ids, so each
    slot's partial tally lands in the right commit.

    step(rows, tab, ok, power5, base, threshold): tab, ok and power5 are
    the sharded table's per-slot tuples (or Sharded). Memoized per (mesh,
    n_commits)."""
    key = ("fused", _mesh_key(mesh), int(n_commits))
    cached = _cache_get(key)
    if cached is not None:
        return cached
    from cometbft_tpu_torch.ops import ed25519_cached as ec

    def step(rows, tab, ok, power5, base, threshold):
        shards = [_table_parts(mesh, a) for a in (tab, ok, power5)]
        parts = _lane_rows(mesh, rows, ec.V_KROWS, _t_rows(n_commits))
        return _cached_step(mesh, n_commits, lambda d: tuple(
            s[d] for s in shards))(parts, threshold)

    return _cache_put(key, step)


def _table_parts(mesh: Mesh, x) -> list:
    """A sharded table field (a per-slot tuple, or Sharded, or one array
    over the mesh's validators) as its per-slot parts."""
    if isinstance(x, (tuple, list)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} table shards for {mesh.size} slots")
        return list(x)
    return _lanes(mesh, x)


def _slot_templates(mesh: Mesh, pre_mat, pre_len, suf_mat, suf_len,
                    ts_tag, msg_max: int) -> list:
    """The template tensors on each slot's device, as stamp entries."""
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    reps = [_replicated(mesh, a) for a in (pre_mat, pre_len, suf_mat,
                                           suf_len, ts_tag)]
    out = []
    for d in range(mesh.size):
        ent = es.TemplateEntry()
        (ent.pre_mat, ent.pre_len, ent.suf_mat, ent.suf_len,
         ent.ts_tag) = (r[d] for r in reps)
        ent.msg_max = int(msg_max)
        out.append(ent)
    return out


def _stamp_slots(mesh: Mesh, msg_max: int, n_commits: int, sig, ts, flags,
                 pre_mat, pre_len, suf_mat, suf_len, ts_tag, pub_raw):
    """-> job(d) stamping slot d's rows from its deltas, the replicated
    template and its own pub_raw shard (zero thresholds, rows for
    n_commits of them)."""
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    sigs = _lanes(mesh, sig, dtype=torch.uint8)
    tss = _lanes(mesh, ts, dtype=torch.int32)
    fls = _lanes(mesh, flags, dtype=torch.int32)
    pubs = _table_parts(mesh, pub_raw)
    ents = _slot_templates(mesh, pre_mat, pre_len, suf_mat, suf_len, ts_tag,
                           msg_max)
    t_rows = _t_rows(n_commits)

    def stamp(d):
        b = sigs[d].shape[0]
        thr0 = torch.zeros((1, ek.TALLY_LIMBS), dtype=torch.int32,
                           device=sigs[d].device)
        return es.stamp_rows(sigs[d], tss[d], fls[d], ents[d], pubs[d], thr0,
                             t_rows(b))

    return stamp


def sharded_stamped_verify(mesh: Mesh, n_commits: int, msg_max: int):
    """sharded_fused_verify's delta twin: each slot stamps its own rows
    from its slice of the per-row deltas (`stamp_rows`) against its
    pub_raw shard (column mod M_s -> validator), then runs the cached
    verify and tally on them.

    step(sig, ts, flags, pre_mat, pre_len, suf_mat, suf_len, ts_tag,
    pub_raw, tab, ok, power5, base, threshold) -> (valid, total, quorum).
    Memoized per (mesh, n_commits, msg_max)."""
    key = ("stamped", _mesh_key(mesh), int(n_commits), int(msg_max))
    cached = _cache_get(key)
    if cached is not None:
        return cached
    from cometbft_tpu_torch.ops import ed25519_cached as ec

    def step(sig, ts, flags, pre_mat, pre_len, suf_mat, suf_len, ts_tag,
             pub_raw, tab, ok, power5, base, threshold):
        stamp = _stamp_slots(mesh, msg_max, n_commits, sig, ts, flags,
                             pre_mat, pre_len, suf_mat, suf_len, ts_tag,
                             pub_raw)
        shards = [_table_parts(mesh, a) for a in (tab, ok, power5)]

        def job(d):
            rows = stamp(d)
            tab_d, ok_d, p5_d = (s[d] for s in shards)
            valid = ec.ed25519_verify_cached(rows, tab_d, ok_d)
            tally, _ = ec.tally_quorum_cached(valid, rows, p5_d, n_commits)
            return valid, tally

        out = _run_slots(mesh, job)
        total, quorum = _reduce(mesh, [t for _, t in out], threshold)
        return _gather(mesh, [v for v, _ in out]) != 0, total, quorum

    return _cache_put(key, step)


def sharded_stamp_rows(mesh: Mesh, msg_max: int):
    """Only the per-slot stamping, the rows gathered along the lane axis:
    the check that each slot's stamped slice equals the single-device
    expansion's, without the verify kernel.

    step(sig, ts, flags, pre_mat, pre_len, suf_mat, suf_len, ts_tag,
    pub_raw) -> (V_THRESH + 1, B) int32 rows on the first slot's device."""
    key = ("stamp-rows", _mesh_key(mesh), int(msg_max))
    cached = _cache_get(key)
    if cached is not None:
        return cached

    def step(sig, ts, flags, pre_mat, pre_len, suf_mat, suf_len, ts_tag,
             pub_raw):
        stamp = _stamp_slots(mesh, msg_max, 0, sig, ts, flags, pre_mat,
                             pre_len, suf_mat, suf_len, ts_tag, pub_raw)
        return _gather(mesh, _run_slots(mesh, stamp), dim=1)

    return _cache_put(key, step)
