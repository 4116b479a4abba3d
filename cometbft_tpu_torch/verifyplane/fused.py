"""Device-fused flush: cached valset table + in-pass quorum tally, on CUDA.

The port's counterpart of the JAX package's verifyplane/fused.py, with its
API: `plan_fused` stages a flush on the host, `dispatch_fused` enqueues its
kernels on the card and returns without synchronizing, `plan_ready` probes
the flush's CUDA event, and `collect_fused` copies the verdicts and tallies
to the host and gates the tallies per submission.

When a flush's submissions all come from quorum groups backed by one
shared validator set (the gossiped-vote burst shape: many validators'
precommits for the same height, grouped per candidate block), the plane
skips the generic grouped dispatch and reuses the cached-valset window
table (ops/ed25519_cached.py): each signature is scattered to column
``stride*M + validator_index``, so column b is validator b mod M as the
cached verify kernel expects, and the per-group voting-power tally is
computed by the tally kernel on the same device pass — the quorum bit a
VoteSet waits on is a kernel output, not a host reduction.

A flush runs these kernels (csrc/):

  stamp_rows            device-stamped flushes: sign-bytes from the
                        resident template and the per-row deltas, SHA-512,
                        mod L, the packed rows (ops/ed25519_stamp.py);
  valset_table_build    the first flush of a valset (cold), or none;
  ed25519_verify_cached one verdict per column;
  tally_quorum_cached   per-commit tally and quorum bit.

On a CPU device the same calls run the kernels' plain PyTorch versions
(the wrappers pick them for CPU tensors), so the CPU tests drive plan ->
dispatch -> collect end to end; there the outputs are computed when
dispatch returns and `plan_ready` is True.

Sharded flushes (the plane's mesh knobs): over a mesh of device slots
(parallel/mesh.py), plan_fused lays the scattered rows out in per-slot
blocks (validator v of stride s lands at ``d*B_loc + s*M_s + (v mod
M_s)`` with d = v // M_s; shard_positions is the one home of that math),
the valset's window table lives per slot (ed25519_cached
.sharded_table_for_pubs), and dispatch_fused runs the mesh's
sharded_stamped_verify (or sharded_fused_verify): each slot stamps,
verifies and tallies its validators' signatures against its own table
shard on its own stream, and `carry_quorum` reduces the partial tallies on
the first slot's device, so the quorum bit is still a kernel output. A
sharded flight is ordered on its lead stream (its first slot's), not on
the device's shared default stream, so the deck's two halves never wait
for each other on the device.

The flight deck ([verify_plane] pipeline_flights): half_meshes splits the
flush mesh into two disjoint halves on the same slot-prefix seam
effective_mesh clamps through, and plan_fused carries the size-aware
fan-out policy: a small flush rides the free half, while a flush past the
half's per-slot budget (or over the half_mesh_rows knob) takes the full
mesh and sets ``drain_first`` so the dispatcher lands the airborne deck
before dispatching it.

Staging is the JAX package's, byte for byte: the same pool slots with the
same layouts (`delta_slot_specs`, `legacy_slot_specs`). The pool's buffers
are pageable host memory; the upload copies them before dispatch returns
(libs/staging.py says why that makes the rotation safe).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from cometbft_tpu_torch.libs import failpoints as fp

MAX_FUSED_ROWS = 65536  # per-device rows budget

fp.register("verifyplane.collect",
            "a dispatched fused flush about to fetch its results (raise "
            "= in-flight device fault; the flush's futures fail with "
            "DeviceError and the fault counts on the breaker)")

# Device-side sign-bytes stamping: template-eligible flushes ship
# (device-resident template, per-row deltas) and the stamp_rows kernel
# rebuilds the packed rows on the device. Module-level toggle + setter so
# the config plumbs it and the differential tests force either path.
DEVICE_STAMP = True


def set_device_stamping(on: bool) -> None:
    global DEVICE_STAMP
    DEVICE_STAMP = bool(on)


# replicas of the packed-row layout constants, for the staging byte-budget
# arithmetic below without importing torch (the tests cross-check them
# against ed25519_cached.V_THRESH / ed25519_kernel.TALLY_LIMBS)
_V_THRESH_REPLICA = 27
_TALLY_LIMBS_REPLICA = 6


def delta_slot_specs(B: int) -> dict:
    """name -> (shape, itemsize) of the staging slots a DEVICE-STAMPED
    flush of B rows occupies: raw signatures, the (secs_lo, secs_hi,
    nanos) timestamp words, and the packed live/counted/template/commit
    flags."""
    return {"fused.dsig": ((B, 64), 1),
            "fused.dts": ((B, 3), 4),
            "fused.dflags": ((B,), 4)}


def legacy_slot_specs(B: int, n_commits: int = 1) -> dict:
    """name -> (shape, itemsize) of the staging slots a HOST-PACKED
    flush of B rows occupies (the scatter buffers plus the packed rows
    the device actually reads)."""
    t_rows = max(1, -(-(n_commits * _TALLY_LIMBS_REPLICA) // B))
    return {"fused.ry": ((B, 20), 4),
            "fused.rsign": ((B,), 4),
            "fused.sdig": ((B, 64), 4),
            "fused.hdig": ((B, 64), 4),
            "fused.precheck": ((B,), 1),
            "fused.counted": ((B,), 1),
            "fused.cid": ((B,), 4),
            "fused.rows": ((_V_THRESH_REPLICA + t_rows, B), 4)}


def specs_bytes(specs: dict) -> int:
    total = 0
    for shape, itemsize in specs.values():
        n = itemsize
        for d in shape:
            n *= d
        total += n
    return total


class _Plan:
    """A fully host-side staged fused flush: everything up to (but not
    including) the device dispatch. Splitting plan from execution lets
    the plane consume a circuit-breaker probe slot only when a device
    attempt actually happens (an ineligible flush must not burn the
    breaker's half-open probe). dispatch_fused() then enqueues the
    kernels WITHOUT synchronizing (pending holds the output tensors,
    `event` the CUDA event recorded after the last launch), and
    collect_fused() copies the verdicts to the host — the split that lets
    the plane pack flush k+1 while flush k flies."""

    __slots__ = ("rows", "pos", "batch", "groups", "sub_gid",
                 "counted_pos", "n_commits", "pubs_v", "powers_v",
                 "pending", "mesh", "n_dev", "thresh", "devs",
                 "drain_first", "warm", "util",
                 # a sharded host-packed flush's per-slot column slices
                 # of `rows`, in staging buffers of the pool
                 "slot_rows",
                 # device-stamped delta staging: `stamped` selects the
                 # path, `delta` holds the (sig, ts, flags) staging
                 # buffers, `sites` the StampSites in template-id
                 # order, `delta_bytes` the staged delta footprint
                 # (rows is None on this path)
                 "stamped", "delta", "sites", "delta_bytes",
                 # the torch device the flush runs on (a sharded
                 # flush's first slot's), and the CUDA events recorded
                 # on it just before the first launch and after the
                 # last (None on a CPU device); a sharded CUDA flight's
                 # uploads, held until collect_fused
                 "device", "start", "event", "up")


def _eligible(batch):
    """All submissions carry validator indices, ed25519 keys only, and
    share ONE valset-backed group family; returns (valset_pubs,
    valset_powers) or None."""
    pubs0 = powers0 = None
    for sub in batch:
        g = sub.group
        if g is None or sub.vidx is None or g.valset_pubs is None:
            return None
        if len(sub.vidx) != len(sub.rows):
            return None
        # the cached window table is ed25519-only; secp/sr valsets take
        # the generic grouped dispatch
        if any(r[0].key_type != "ed25519" or len(r[0].data) != 32
               for r in sub.rows):
            return None
        if pubs0 is None:
            pubs0, powers0 = g.valset_pubs, g.valset_powers
        elif g.valset_pubs is not pubs0 and g.valset_pubs != pubs0:
            return None
    if pubs0 is None:
        return None
    return pubs0, powers0


def _stamp_sites(stamp_meta, row_gid, max_sites: int):
    """Template-id assignment + device-stamp eligibility for a flush.

    Returns (StampSites in template-id order, per-row template ids) or
    None when the flush must fall back to host packing: a row without
    stamp metadata (non-vote rows — e.g. extension rows), timestamp
    words outside the staged int32 layout, more than the
    for-block/for-nil template pair among one commit's rows, or more
    template families than the staged flags' 8-bit id field."""
    ids: List[int] = []
    sites: List[object] = []
    idx_of: Dict[object, int] = {}
    per_gid: Dict[int, set] = {}
    for st, gid in zip(stamp_meta, row_gid):
        if st is None:
            return None
        tpl, secs, nanos = st
        if not (-2**31 <= nanos < 2**31 and -2**63 <= secs < 2**63):
            return None
        site = tpl.stamp_site()
        key = site.key
        tid = idx_of.get(key)
        if tid is None:
            if len(sites) >= max_sites:
                return None
            tid = idx_of[key] = len(sites)
            sites.append(site)
        gset = per_gid.setdefault(gid, set())
        gset.add(key)
        if len(gset) > 2:
            return None  # mixed block_ids past the for-block/nil pair
        ids.append(tid)
    return tuple(sites), ids


def shard_positions(vidx, strides, m_shard: int,
                    n_strides: int) -> np.ndarray:
    """Row positions for the fused flush layout, one slot or many.

    Validator v of stride s lands at ``d*B_loc + s*m_shard + (v mod
    m_shard)`` where d = v // m_shard owns the validator's table shard and
    B_loc = n_strides*m_shard is one slot's slice width. With one slot
    m_shard is the whole padded valset and this is the classic
    ``s*M + v``."""
    v = np.asarray(vidx, np.int64)
    s = np.asarray(strides, np.int64)
    b_loc = n_strides * m_shard
    return (v // m_shard) * b_loc + s * m_shard + (v % m_shard)


# the plane's flush mesh, memoized per (slots, requested count): mesh
# identity feeds the step and table memos downstream, so a fresh Mesh a
# flush would defeat them
_MESH_MEMO: dict = {}


def plane_mesh(devices: int, device=None):
    """The verify plane's flush mesh over the slots of `device` (None: the
    CUDA card; parallel/mesh.local_devices): 0 = every slot, N caps at the
    first N. None when fewer than 2 slots are usable: one device's
    dispatch is strictly better then."""
    from cometbft_tpu_torch.parallel import mesh as pm

    slots = pm.local_devices(device)
    n = len(slots) if not devices else min(int(devices), len(slots))
    if n < 2:
        return None
    key = slots[:n]
    m = _MESH_MEMO.get(key)
    if m is None:
        m = _MESH_MEMO[key] = pm.make_mesh(slots[:n])
    return m


# sub-meshes over a mesh's slots, memoized by the exact slot tuple
# (effective_mesh clamps through prefixes; half_meshes slices the same
# memo into the deck's disjoint halves)
_SUBMESH_MEMO: dict = {}


def _sub_mesh_devs(slots: tuple):
    from cometbft_tpu_torch.parallel import mesh as pm

    m = _SUBMESH_MEMO.get(slots)
    if m is None:
        m = _SUBMESH_MEMO[slots] = pm.make_mesh(list(slots))
    return m


def _sub_mesh(mesh, n_eff: int):
    return _sub_mesh_devs(mesh.slots[:n_eff])


def half_meshes(mesh) -> list:
    """The flush mesh split into two DISJOINT halves for the pipelined
    flight deck: lower half = slot prefix, upper half = the rest. Each
    half needs >= 2 slots to run the sharded program on its own slots,
    so meshes under 4 slots return [] and the deck stays single-flight
    on the mesh."""
    if mesh is None or mesh.size < 4:
        return []
    slots = mesh.slots
    mid = len(slots) // 2
    return [_sub_mesh_devs(slots[:mid]), _sub_mesh_devs(slots[mid:])]


def effective_mesh(mesh, nvals: int):
    """Clamp a flush mesh to the slots this valset actually fills.

    shard_stride rounds the per-shard slice up to a table_pad bucket, and
    the coarse buckets can leave trailing shards EMPTY: 10k validators
    over 8 slots take a 4,096-slot stride, so slots 3-7 would stage and
    verify pure padding on every flush. Shrinks the fan-out until every
    shard holds validators (the fixpoint of n_eff = ceil(nvals / m_s)).

    Returns (mesh-or-None, n_dev, m_shard); None means one device's
    dispatch is strictly better (the whole valset fits one stride).
    Raises ValueError when the valset exceeds even the full mesh's table
    budget."""
    from cometbft_tpu_torch.ops import ed25519_cached as ec

    if mesh is None:
        return None, 1, ec.shard_stride(nvals, 1)
    n_eff = mesh.size
    while True:
        m_s = ec.shard_stride(nvals, n_eff)
        need = -(-max(nvals, 1) // m_s)
        if need >= n_eff:
            break
        n_eff = need
    if n_eff < 2:
        return None, 1, ec.shard_stride(nvals, 1)
    if n_eff < mesh.size:
        mesh = _sub_mesh(mesh, n_eff)
    return mesh, n_eff, m_s


def plan_fused(batch, pool=None, device=None, mesh=None, half=None,
               half_max_rows: int = 0) -> Optional[_Plan]:
    """Host-side staging of the fused cached-table dispatch for a
    flush. Returns a _Plan, or None when the flush shape is ineligible
    — the caller then runs the generic grouped path. No device work
    happens here (dispatch_fused/collect_fused do that, under the
    breaker). `device` is where the flush will run (None: the CUDA card,
    raising without one); `mesh` (a >1-slot parallel.mesh Mesh) selects
    the sharded layout, None the one device.

    `half` is the flight deck's fan-out offer: a free sub-mesh half the
    flush should prefer so it can fly while the other half carries an
    airborne flight. The half is taken when the valset and stride count
    fit its per-slot budget AND the flush is under `half_max_rows` (0 =
    budget only); otherwise the flush takes the full `mesh` and the
    plan's ``drain_first`` tells the dispatcher to land the airborne deck
    before dispatching it."""
    from cometbft_tpu_torch.device import resolve

    dev = resolve(device)
    valset = _eligible(batch)
    if valset is None:
        return None
    pubs_v, powers_v = valset
    nvals = len(pubs_v)

    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_stamp as es
    from cometbft_tpu_torch.types import canonical

    # slot assignment: first free stride wins (a validator's vote and
    # its extension land in different strides); positions are computed
    # after the walk, since a slot's slice width depends on the final
    # stride count when the valset is sharded
    pubs: List[bytes] = []
    msgs: List[bytes] = []
    sigs: List[bytes] = []
    row_v: List[int] = []
    row_s: List[int] = []
    row_gid: List[int] = []
    stamp_meta: List[Optional[tuple]] = []  # (template, secs, nanos)
    counted_ridx: List[Optional[int]] = []  # per submission: row index
    occupied: List[set] = []
    groups: List[object] = []
    gid_of: Dict[int, int] = {}
    sub_gid: List[int] = []
    for sub in batch:
        g = sub.group
        gid = gid_of.get(id(g))
        if gid is None:
            gid = gid_of[id(g)] = len(groups)
            groups.append(g)
        sub_gid.append(gid)
        cidx = None
        stamps = getattr(sub, "stamp", None)
        for k, ((pub, msg, sig), v) in enumerate(zip(sub.rows, sub.vidx)):
            if not (0 <= v < nvals) or pub.data != pubs_v[v] \
                    or len(sig) != 64:
                return None  # wrong key/slot claim: generic path decides
            s = 0
            while s < len(occupied) and v in occupied[s]:
                s += 1
            if s == len(occupied):
                occupied.append(set())
            occupied[s].add(v)
            pubs.append(pub.data)
            msgs.append(msg)
            sigs.append(sig)
            row_v.append(v)
            row_s.append(s)
            row_gid.append(gid)
            stamp_meta.append(stamps[k] if stamps is not None
                              and k < len(stamps) else None)
            if k == 0 and sub.counted:
                if sub.power != powers_v[v]:
                    return None  # tally rides the table's power column
                cidx = len(row_v) - 1
        counted_ridx.append(cidx)
    n = len(pubs)
    n_strides = len(occupied)
    if n == 0:
        return None
    # fan-out policy. The rows budget is PER SLOT: each slot runs the
    # kernels on its B/n_dev slice, so a sharded flush scales the cap
    # with the mesh. effective_mesh clamps either choice to the slots
    # the valset actually fills.
    def _fit(m):
        m2, nd, ms = effective_mesh(m, nvals)
        if n_strides * ms > MAX_FUSED_ROWS:
            raise ValueError("flush over the per-slot rows budget")
        return m2, nd, ms

    chosen = None
    took_full = False
    if half is not None and (not half_max_rows or n <= half_max_rows):
        try:
            chosen = _fit(half)
        except ValueError:
            chosen = None  # giant flush: the full mesh decides below
    if chosen is None:
        took_full = half is not None
        try:
            chosen = _fit(mesh)
        except ValueError:
            return None  # over even the full mesh's table budget
    mesh, n_dev, M = chosen
    B = n_dev * n_strides * M

    n_commits = len(groups)
    pos = shard_positions(row_v, row_s, M, n_strides)
    counted_pos = [None if ci is None else int(pos[ci])
                   for ci in counted_ridx]
    # rotating staging: the scatter targets and the final packed rows
    # rotate through persistent host buffers per shape (the CALLER's
    # pool — one writer per key; the plane passes its private pool)
    if pool is None:
        from cometbft_tpu_torch.crypto.batch import staging_pool

        pool = staging_pool()
    thresh = np.zeros((n_commits, ek.TALLY_LIMBS), np.int32)
    for gid, g in enumerate(groups):
        thresh[gid] = ek.threshold_limbs(max(g.threshold - 1, 0))[0]

    plan = _Plan()
    stamp = (_stamp_sites(stamp_meta, row_gid, es.MAX_TEMPLATE_SITES)
             if DEVICE_STAMP else None)
    if stamp is not None:
        # device-stamped delta staging: ship 80 B/row — raw signature,
        # (secs_lo, secs_hi, nanos) words, packed flags — and let the
        # stamp kernel rebuild the packed rows next to the resident
        # template. Slot layout mirrors delta_slot_specs; the pool's
        # zero fill makes unoccupied lanes live=0, which the kernel
        # expands to the same all-zero columns host packing pads with.
        sites, site_ids = stamp
        sec_a = np.fromiter((st[1] for st in stamp_meta), np.int64,
                            count=n)
        nan_a = np.fromiter((st[2] for st in stamp_meta), np.int64,
                            count=n)
        ts_rows = canonical.split_ts_words(sec_a, nan_a)
        fl_rows = np.ones((n,), np.int32)
        fl_rows |= np.asarray(site_ids, np.int32) << 2
        fl_rows |= np.asarray(row_gid, np.int32) << 10
        for ci in counted_ridx:
            if ci is not None:
                fl_rows[ci] |= 2
        dsig = pool.get("fused.dsig", (B, 64), np.uint8)
        dsig[pos] = np.frombuffer(b"".join(sigs), np.uint8) \
            .reshape(n, 64)
        dts = pool.get("fused.dts", (B, 3), np.int32)
        dts[pos] = ts_rows
        dfl = pool.get("fused.dflags", (B,), np.int32)
        dfl[pos] = fl_rows
        plan.rows = None
        plan.slot_rows = None
        plan.stamped = True
        plan.delta = (dsig, dts, dfl)
        plan.sites = sites
        plan.delta_bytes = int(dsig.nbytes + dts.nbytes + dfl.nbytes)
    else:
        # full-row host pack — the differential oracle and the fallback
        # for flushes that are not template-eligible
        pbd = ek.pack_batch(pubs, msgs, sigs, pad_to=n)
        ry = pool.get("fused.ry", (B, pbd.ry.shape[1]), pbd.ry.dtype)
        ry[pos] = pbd.ry[:n]
        rsign = pool.get("fused.rsign", (B,), np.int32)
        rsign[pos] = np.asarray(pbd.rsign[:n], np.int32)
        sdig = pool.get("fused.sdig", (B, pbd.sdig.shape[1]),
                        pbd.sdig.dtype)
        sdig[pos] = pbd.sdig[:n]
        hdig = pool.get("fused.hdig", (B, pbd.hdig.shape[1]),
                        pbd.hdig.dtype)
        hdig[pos] = pbd.hdig[:n]
        precheck = pool.get("fused.precheck", (B,), np.bool_)
        precheck[pos] = np.asarray(pbd.precheck[:n], np.bool_)
        counted = pool.get("fused.counted", (B,), np.bool_)
        commit_ids = pool.get("fused.cid", (B,), np.int32)
        cur = 0
        for sub, gid, cpos in zip(batch, sub_gid, counted_pos):
            for p in pos[cur:cur + len(sub.rows)]:
                commit_ids[p] = gid
            cur += len(sub.rows)
            if cpos is not None:
                counted[cpos] = True

        pb = ek.PackedBatch(n, B, None, None, ry, rsign, sdig, hdig,
                            precheck)
        # sharded: thresholds ride the step's own argument (in-rows
        # threshold rows would split into per-slot fragments), so the
        # packed rows carry a zero threshold row; one device keeps them
        # in the rows
        out = pool.get(
            "fused.rows",
            ec.packed_rows_shape(B, 1 if mesh is not None else n_commits),
            np.int32)
        plan.rows = ec.pack_rows_cached(
            pb, counted, commit_ids, None if mesh is not None else thresh,
            out=out)
        plan.slot_rows = None
        if mesh is not None:
            # per-slot staging: each slot's column slice, with zero
            # threshold rows for n_commits, in its own pool buffer
            b = B // n_dev
            plan.slot_rows = []
            for d in range(n_dev):
                buf = pool.get(f"fused.rows.{d}",
                               ec.packed_rows_shape(b, n_commits), np.int32)
                buf[:ec.V_KROWS] = plan.rows[:ec.V_KROWS, d * b:(d + 1) * b]
                plan.slot_rows.append(buf)
        plan.stamped = False
        plan.delta = None
        plan.sites = None
        plan.delta_bytes = 0
    plan.pos = pos
    plan.batch = batch
    plan.groups = groups
    plan.sub_gid = sub_gid
    plan.counted_pos = counted_pos
    plan.n_commits = n_commits
    plan.pubs_v = pubs_v
    plan.powers_v = powers_v
    plan.pending = None
    plan.mesh = mesh
    plan.n_dev = n_dev
    plan.thresh = thresh
    # slot indices this flush occupies (None = one device): the deck's
    # disjointness bookkeeping and the ledger's dev0 column
    plan.devs = None if mesh is None else mesh.indices
    plan.drain_first = took_full
    # did the dispatch find its valset table cached? (set by
    # dispatch_fused; the plane stamps it into the ledger's warm column)
    plan.warm = False
    # rows-x-cost utilization: the fraction of the staged device pass
    # doing real work (n live rows over the B padded columns the kernel
    # sweeps across the whole fan-out) — the ledger's util column
    plan.util = round(n / B, 4) if B else 0.0
    plan.device = dev if mesh is None else mesh.slots[0].device
    plan.start = None
    plan.event = None
    plan.up = None
    return plan


def plan_ready(plan: _Plan) -> bool:
    """Non-blocking landing probe for a dispatched plan: True when the
    CUDA event recorded after its last launch has completed (on a CPU
    device the outputs exist when dispatch returns, so always True). The
    deck lands ready flights out of order."""
    if plan.pending is None or plan.event is None:
        return True
    return bool(plan.event.query())


def plan_device_ms(plan: _Plan) -> Optional[float]:
    """Milliseconds on the device's clock between the CUDA events
    recorded just before the flush's first launch and after its last:
    its kernels, and the stream's waits for the host to enqueue them (the
    table fetch and the uploads come before), once the flush has
    completed; None on a CPU device or before completion."""
    if plan.start is None or not plan.event.query():
        return None
    return float(plan.start.elapsed_time(plan.event))


def plan_h2d_bytes(plan: _Plan) -> int:
    """Bytes this flush stages to the device (the packed rows, or the
    per-row delta buffers when device-stamped; the valset table and
    template are device-resident and upload once per valset/family)."""
    if plan.stamped:
        return int(plan.delta_bytes)
    return int(plan.rows.nbytes)


def dispatch_fused(plan: _Plan) -> None:
    """Launch a staged plan on its device WITHOUT synchronizing: fetch
    the (device-resident, valset-keyed) window table, upload the rows or
    deltas, then record the plan's start event, enqueue stamp_rows
    (device-stamped plans), the cached verify and the cached tally on the
    current stream, and record the plan's end event. Raises on
    dispatch-time faults (the caller's breaker handles those). The
    uploads copy the staging buffers before they return, so the pool may
    rotate them at once.

    A mesh plan takes its per-slot tables from the sharded cache, uploads
    each slot's slice of the staging to the slot's device, and runs the
    mesh's sharded step on its lead stream (the first slot's stream),
    which first waits for an event recorded after the uploads: every slot
    stream waits for the lead, the lead waits for the slots before the
    `carry_quorum` reduce, and the plan's two events, on the lead stream,
    bracket all of it. Nothing of the flight is enqueued on the device's
    shared stream after the uploads, so a flight on the deck's other half
    does not queue behind it. The plan keeps the uploads until
    collect_fused, since the shared stream no longer waits for the slots
    that read them."""
    import torch

    from cometbft_tpu_torch.ops import ed25519_cached as ec
    from cometbft_tpu_torch.ops import ed25519_stamp as es

    dev = plan.device
    mesh = plan.mesh
    if mesh is None:
        # pubs_v/powers_v are the QuorumGroup's immutable tuples, so the
        # content-key digest is identity-memoized (no per-flush O(valset)
        # hashing) and a steady-state flush never re-uploads the valset
        table, plan.warm = ec.table_for_pubs_info(plan.pubs_v,
                                                  plan.powers_v, device=dev)
        if plan.stamped:
            ent = es.template_entry(plan.sites, device=dev)
            up = [torch.from_numpy(a).to(dev) for a in (*plan.delta,
                                                        plan.thresh)]
        else:
            up = [torch.from_numpy(plan.rows).to(dev)]
    else:
        from cometbft_tpu_torch.parallel import mesh as pm

        table, plan.warm = ec.sharded_table_for_pubs_info(
            plan.pubs_v, plan.powers_v, mesh)
        # each slot device's comb table, uploaded here (once a device)
        # rather than inside the bracketed launches
        base = ec.base60_repl(mesh)
        thresh = torch.from_numpy(plan.thresh).to(dev)
        if plan.stamped:
            ent = es.template_entry(plan.sites, device=dev)
            step = pm.sharded_stamped_verify(mesh, plan.n_commits,
                                             ent.msg_max)
            up = [pm.shard(mesh, a) for a in plan.delta]
        else:
            step = pm.sharded_fused_verify(mesh, plan.n_commits)
            up = [pm.Sharded([torch.from_numpy(r).to(s.device) for r, s in
                              zip(plan.slot_rows, mesh.slots)], axis=1)]
    # the events bracket the launches only, not the table fetch or the
    # uploads above
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        if mesh is not None:
            uploaded = torch.cuda.Event()
            uploaded.record(stream)
            stream = pm.slot_stream(mesh.slots[0])
            stream.wait_event(uploaded)
            plan.up = (up, thresh)
        plan.start = torch.cuda.Event(enable_timing=True)
        plan.start.record(stream)
    if mesh is None and plan.stamped:
        dsig, dts, dfl, thresh = up
        plan.pending = es.verify_tally_delta_cached(
            dsig, dts, dfl, ent, table, plan.n_commits, thresh)
    elif mesh is None:
        plan.pending = ec.verify_tally_rows_cached(up[0], table,
                                                   plan.n_commits)
    else:
        with torch.cuda.stream(stream) if dev.type == "cuda" \
                else contextlib.nullcontext():
            if plan.stamped:
                dsig, dts, dfl = up
                plan.pending = step(dsig, dts, dfl, ent.pre_mat,
                                    ent.pre_len, ent.suf_mat, ent.suf_len,
                                    ent.ts_tag, table.pub_raw, table.tab,
                                    table.ok, table.power5, base, thresh)
            else:
                plan.pending = step(up[0], table.tab, table.ok,
                                    table.power5, base, thresh)
    if dev.type == "cuda":
        plan.event = torch.cuda.Event(enable_timing=True)
        plan.event.record(stream)


def collect_fused(plan: _Plan) -> Tuple[List[bool], Dict[object, int]]:
    """Copy a dispatched plan's results to the host (waiting for its
    kernels) and gate the tallies per submission. Raises on in-flight
    device faults.

    Returns (per-row verdicts in flush order, {group: verified power
    tallied by the device this flush})."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    fp.fail_point("verifyplane.collect")
    if plan.up is not None:
        # a sharded flight's outputs come from its lead stream, which the
        # copies below (on the shared stream) do not wait for
        plan.event.synchronize()
        plan.up = None
    valid, tally, _quorum = plan.pending
    valid = valid.cpu().numpy()
    tallies_raw = ek.tally_to_int(tally.cpu().numpy())

    verdicts = [bool(v) for v in valid[plan.pos]]
    tallies: Dict[object, int] = {
        g: int(tallies_raw[gid]) for gid, g in enumerate(plan.groups)
    }
    # submission gating: power counts only when EVERY row of a counted
    # submission verified (a valid vote with a forged extension is
    # rejected by the caller, so its power must not stand in the tally)
    off = 0
    for sub, gid, cpos in zip(plan.batch, plan.sub_gid,
                              plan.counted_pos):
        sl = verdicts[off:off + len(sub.rows)]
        off += len(sub.rows)
        if cpos is not None and sl[0] and not all(sl):
            tallies[plan.groups[gid]] -= sub.power
    return verdicts, tallies
