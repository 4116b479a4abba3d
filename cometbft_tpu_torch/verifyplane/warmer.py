"""Async next-epoch valset table warmer.

The cached-table verify path amortizes the expensive A-side curve work
over a long-lived validator set (ops/ed25519_cached) — which means the
FIRST commit after an epoch rotation pays the whole table build
(~seconds at 10k validators) inline on the verify path: a visible
post-rotation stall on a chain that re-elects every few hours
(PAPERS.md arXiv 2004.12990; arXiv 2302.00418's per-epoch signer set
is exactly what the batch verifier amortizes over).

The warmer closes that gap: when state/execution.py applies validator
updates and computes the epoch e+1 set (`_update_state` ->
:func:`notify_next_valset`), a background thread builds e+1's window
table while epoch e is still live. The build lands
in the same bounded caches every verifier reads (ops/table_cache), so
the first post-rotation flush is a straight LRU hit; table_cache marks
the key and the hit is attributed honestly (``warmed_hits``).

The port's copy of the JAX package's verifyplane/warmer.py. The seams
that differ: the warmer builds on a torch device (``device=None`` is the
CUDA card and raises DeviceError without a Hopper card, as the verify
plane does; ``device="cpu"`` builds with the kernels' plain versions, for
tests; ``use_device=False`` skips every build, as the JAX warmer does
without an accelerator); tables and templates are keyed by that device
(ops/ed25519_cached, ops/ed25519_stamp); and the sharded per-device
tables wait for the multi-device slice: the JAX warmer's ``mesh_fn`` and
its mesh targets are not here, so only the plain table is warmed.

Failure containment (the warmer is an OPTIMIZATION and must never be
load-bearing):

  * the ``warmer.build`` failpoint (and any build exception) degrades
    to the cold path — the failure is counted, nothing is inserted,
    live-epoch verdicts are untouched;
  * a device breaker already OPEN skips the build (a faulting device
    must not be hammered with a multi-second table program while the
    breaker rests it; the port has no host fallback behind it, so the
    live epoch's flushes fail with DeviceError until a probe succeeds);
  * ``stop()`` mid-warm abandons cleanly — the dispatcher never waits
    on the warmer, so a wedged build can at worst waste its own
    thread;
  * the build path uses the table cache's build only — it NEVER touches
    the verify plane's private staging pool (one-writer-per-key
    rotation contract), so a warm can't race the dispatcher's buffers;
  * requests are a latest-wins slot of depth 1: back-to-back rotations
    supersede an unstarted older request instead of queueing stale
    epochs.

No torch work at import: the warmer object (and everything the tests
drive with an injected build_fn) is host-only until a real build runs.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.libs import tracing

_log = logging.getLogger(__name__)

fp.register("warmer.build",
            "top of a next-epoch table-warmer build (raise = build "
            "fault; the warm is abandoned and the first post-rotation "
            "flush takes the cold path — live verdicts unaffected)")


class TableWarmer:
    """Background builder of next-epoch valset tables.

    `build_fn(pubs, powers)` overrides the real device build (tests);
    the default builds through ed25519_cached into the shared bounded
    caches on `device` (None: the CUDA card, raising DeviceError without
    one; "cpu": the plain versions), resolved here as the verify plane
    resolves its own. `use_device=False` skips every build that has no
    injected build_fn, and resolves no device. `breaker` defaults to the
    process device breaker."""

    def __init__(self, build_fn: Optional[Callable] = None,
                 breaker=None, use_device: Optional[bool] = None,
                 device=None):
        from cometbft_tpu_torch.device import resolve

        self._build_fn = build_fn
        self._breaker = breaker
        self._use_device = True if use_device is None else bool(use_device)
        self.device = resolve(device) if self._use_device else None
        self._cv = threading.Condition()
        self._req: Optional[tuple] = None   # latest-wins (pubs, powers)
        self._building = False
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # accounting (sampled into /metrics at scrape time).
        # builds_incremental counts the ok-builds the cache satisfied
        # by patching a near-miss table's delta rows (ed25519_cached
        # update_table) instead of the full next-epoch build — the
        # epoch-churn fast path; always <= builds_ok.
        self.builds_ok = 0
        self.builds_failed = 0
        self.builds_skipped = 0
        # the subset of skips refused by a tenant's HBM residency
        # budget (verifyplane/tenants.py warm gate); always <= skipped
        self.builds_skipped_quota = 0
        self.builds_incremental = 0
        self.superseded = 0
        self.last_build_ms = 0.0
        # device stamping templates actually BUILT here:
        # warm_template is a no-op on a cached entry, so this counts
        # real prefetches only — same honesty rule as table marks
        self.tmpl_warms = 0
        self._tmpl_req: Optional[tuple] = None  # latest-wins sites

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._cv:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(
            target=self._run, name="valset-warmer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop accepting requests and join. A build in flight is
        abandoned to its own (daemon) thread rather than waited out —
        node shutdown must never block on a device table program."""
        with self._cv:
            if not self._running:
                return
            self._running = False
            self._req = None
            self._tmpl_req = None
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def is_running(self) -> bool:
        return self._running

    # -- requests ----------------------------------------------------------

    def request(self, pubs, powers,
                chain_id: Optional[str] = None) -> None:
        """Warm the table for (pubs, powers). Latest-wins: an unstarted
        older request is superseded (epoch e+2 announced before e+1's
        build began means e+1's table would be dead on arrival).
        `chain_id` attributes the warm to the owning tenant
        (verifyplane/tenants.py): the build is gated on the tenant's
        HBM residency budget and the built table's owner is recorded
        for per-tenant residency accounting."""
        pubs = tuple(pubs)
        powers = None if powers is None else tuple(powers)
        with self._cv:
            if not self._running:
                return
            if self._req is not None:
                self.superseded += 1
            self._req = (pubs, powers, chain_id)
            self._cv.notify_all()

    def request_template(self, sites) -> None:
        """Warm the device stamping template for `sites` (a tuple of
        canonical.StampSite). Latest-wins like table
        requests, built on the warmer thread through
        ed25519_cached.warm_template, which inserts into the bounded
        template cache and warm-marks ONLY when the entry was absent
        (the honest-mark rule: a flush that already paid the
        build inline must not credit the warmer). Best-effort by
        design — a flush racing the same cold entry just builds it
        itself."""
        sites = tuple(sites)
        with self._cv:
            if not self._running or not sites:
                return
            self._tmpl_req = sites
            self._cv.notify_all()

    def request_valset(self, vals,
                       chain_id: Optional[str] = None) -> None:
        """Warm for a types.validator.ValidatorSet. Column extraction
        happens HERE on the caller's thread (O(n), ~ms at 10k): the set
        keeps mutating (proposer-priority rotation) after apply_block
        returns, but keys and powers — all the table depends on — do
        not."""
        self.request(tuple(v.pub_key.data for v in vals.validators),
                     tuple(v.voting_power for v in vals.validators),
                     chain_id=chain_id)

    # -- the build loop ----------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._running and self._req is None \
                        and self._tmpl_req is None:
                    self._cv.wait(timeout=0.25)
                if not self._running:
                    return
                # tables first: a template entry is a few KB of encode
                # work, the table is the multi-second program the
                # rotation stall is made of
                req, self._req = self._req, None
                tmpl_req, self._tmpl_req = self._tmpl_req, None
                self._building = True
            try:
                if req is not None:
                    self._build(*req)
                if tmpl_req is not None:
                    self._warm_template(tmpl_req)
            finally:
                with self._cv:
                    self._building = False
                    self._cv.notify_all()

    def _warm_template(self, sites: tuple) -> None:
        """Template prefetch (never load-bearing: any failure is a
        cold-path degrade, and a breaker-open device is left alone
        exactly like table builds)."""
        if self._breaker_open() or not self._use_device:
            self.builds_skipped += 1
            return
        try:
            from cometbft_tpu_torch.ops import ed25519_stamp as es

            if es.warm_template(sites, device=self.device):
                self.tmpl_warms += 1
        except Exception:  # noqa: BLE001 - prefetch fault: cold path
            self.builds_failed += 1
            _log.exception(
                "stamping-template warm failed (%d sites); the next "
                "delta flush builds it inline", len(sites))

    def _breaker_open(self) -> bool:
        brk = self._breaker
        if brk is None:
            try:
                from cometbft_tpu_torch.crypto import batch as cbatch

                brk = cbatch.device_breaker()
            except Exception:  # noqa: BLE001 - no crypto stack: skip
                return False
        return brk.state == "open"

    def _build(self, pubs: tuple, powers: Optional[tuple],
               chain_id: Optional[str] = None) -> None:
        try:
            fp.fail_point("warmer.build")
        except Exception:  # noqa: BLE001 - injected fault: cold path
            self.builds_failed += 1
            _log.exception(
                "valset warmer build fault (%d validators); next "
                "rotation takes the cold path", len(pubs))
            return
        if self._breaker_open():
            # the device is already degraded: a table build would
            # hammer the very device the breaker is resting
            self.builds_skipped += 1
            return
        if not self._tenant_allows(chain_id, len(pubs)):
            # residency-budget refusal: the tenant's cold tables were
            # already evicted (its own retired epochs go first) and the
            # warm STILL would not fit — skip, count, cold path. The
            # live epoch keeps verifying; only the prefetch is denied.
            self.builds_skipped += 1
            self.builds_skipped_quota += 1
            return
        t0 = time.perf_counter()
        try:
            if self._build_fn is not None:
                self._build_fn(pubs, powers)
            elif self._use_device:
                self._build_default(pubs, powers, chain_id)
            else:
                self.builds_skipped += 1
                return
        except Exception:  # noqa: BLE001 - build fault: cold path
            self.builds_failed += 1
            _log.exception(
                "valset warmer build failed (%d validators); next "
                "rotation takes the cold path", len(pubs))
            return
        self.last_build_ms = round((time.perf_counter() - t0) * 1000, 3)
        self.builds_ok += 1
        tracing.instant("warmer.built", cat="verifyplane",
                        vals=len(pubs), ms=self.last_build_ms)

    def _tenant_allows(self, chain_id: Optional[str],
                       nvals: int) -> bool:
        """The tenant residency gate: a warm for a budgeted tenant that
        would breach its HBM residency budget is refused — AFTER one
        attempt to make room by evicting the tenant's own cold tables
        (the noisy-neighbor contract: a tenant over budget loses its
        retired epochs first, never another tenant's tables). No
        registry / no chain_id / unbudgeted tenant = always allowed."""
        if chain_id is None:
            return True
        from cometbft_tpu_torch.verifyplane import tenants as vtenants

        reg = vtenants.global_registry()
        if reg is None:
            return True
        est = vtenants.estimate_table_bytes(nvals)
        if reg.warm_allowed(chain_id, est):
            return True
        reg.evict_cold_tables(chain_id)
        if reg.warm_allowed(chain_id, est):
            return True
        reg.note_warm_skip(chain_id)
        return False

    def _build_default(self, pubs: tuple, powers: Optional[tuple],
                       chain_id: Optional[str] = None) -> None:
        """The real device build: the plain table (the sharded per-device
        tables of the JAX warmer wait for the multi-device slice).
        Inserts ride the
        shared bounded caches (LRU: the LIVE epoch's table is the most
        recently used, so this insert can only evict retired epochs).

        Warm marks are only set for tables this warmer actually BUILT:
        if consensus already paid the cold build inline (the rotation
        landed before the warm ran), the lookup here is a hit and
        marking it would falsely credit the warmer for a stall that
        happened (warmed_hits is the honest signal the rotation
        measurements and /metrics attribution rely on). Best-effort:
        when a dispatcher flush and this warm race the SAME cold build
        concurrently (both miss, both build), the warmer's miss still
        marks — a single-flight build lock isn't worth buying for a
        stats counter's once-per-rotation race window."""
        from cometbft_tpu_torch.ops import ed25519_cached as ec
        from cometbft_tpu_torch.ops import table_cache as tcache

        # the table cache's key: content digest and device
        key = (ec._cache_key(pubs, powers), str(self.device))
        if chain_id is not None:
            # residency attribution: the registry's read-time walk of
            # the live caches resolves this content key to its tenant
            from cometbft_tpu_torch.verifyplane import tenants as vtenants

            reg = vtenants.global_registry()
            if reg is not None:
                reg.note_table_owner(key, chain_id)
        # PEEK before looking up: the consuming hit path would pop a
        # still-pending warm mark (a repeat notify for an identical
        # valset — e.g. a power re-set to its current value — must not
        # let the warmer consume its own mark and count a warmed_hit
        # no verifier ever saw)
        with tcache.LOCK:
            present = key in tcache.TABLES
        if not present:
            # the lookup itself prefers the incremental path: a small
            # change set patches a cached near-miss table's delta rows
            # (update_table) instead of the full build. The stat delta
            # attributes it — this warm was an epoch-churn patch, not
            # a from-scratch table program.
            with tcache.LOCK:
                inc0 = tcache.STATS["incremental_patches"]
            _, hit = ec.table_for_pubs_info(pubs, powers,
                                            device=self.device)
            if not hit:
                ec.note_warmed(key)
                with tcache.LOCK:
                    if tcache.STATS["incremental_patches"] > inc0:
                        self.builds_incremental += 1

    # -- observability -----------------------------------------------------

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until no request is pending or building (tests and the
        card's rotation phase use this to measure the warmed path
        honestly)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._req is not None or self._tmpl_req is not None \
                    or self._building:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=left)
        return True

    def stats(self) -> dict:
        with self._cv:
            pending = self._req is not None \
                or self._tmpl_req is not None or self._building
        return {
            "running": self._running,
            "pending": pending,
            "builds_ok": self.builds_ok,
            "builds_failed": self.builds_failed,
            "builds_skipped": self.builds_skipped,
            "builds_skipped_quota": self.builds_skipped_quota,
            "builds_incremental": self.builds_incremental,
            "superseded": self.superseded,
            "last_build_ms": self.last_build_ms,
            "tmpl_warms": self.tmpl_warms,
        }


# --------------------------------------------------------------------------
# the process-global warmer (node lifecycle owns it)
# --------------------------------------------------------------------------

_GLOBAL: Optional[TableWarmer] = None
# the last warmer ever global: /metrics samples its counters after the
# node stopped it (post-mortems read history) — the _LAST-plane pattern
_LAST: Optional[TableWarmer] = None
_LOCK = threading.Lock()


def set_global_warmer(w: Optional[TableWarmer]) -> None:
    global _GLOBAL, _LAST
    with _LOCK:
        _GLOBAL = w
        if w is not None:
            _LAST = w


def clear_global_warmer(w: TableWarmer) -> None:
    """Unregister `w` iff it is the current global — a stopping node
    must not tear down another node's warmer."""
    global _GLOBAL
    with _LOCK:
        if _GLOBAL is w:
            _GLOBAL = None


def global_warmer() -> Optional[TableWarmer]:
    w = _GLOBAL
    if w is None or not w.is_running():
        return None
    return w


def last_warmer() -> Optional[TableWarmer]:
    return _GLOBAL or _LAST


def notify_next_valset(vals, chain_id: Optional[str] = None) -> None:
    """state/execution.py's seam: called with the epoch e+1 validator
    set whenever a block's validator updates produced one. A cheap
    no-op when no warmer is registered (simnet determinism: no warmer
    runs there unless a test mounts one). `chain_id` attributes the
    warm to the owning tenant on a shared multi-chain plane."""
    w = global_warmer()
    if w is not None:
        w.request_valset(vals, chain_id=chain_id)
