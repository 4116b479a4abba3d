"""Mempool: CheckTx-gated tx queue with cache, QoS verify, admission.

Reference: mempool/clist_mempool.go:26 (CListMempool) — CheckTx via ABCI
with an LRU dedup cache (:117), ReapMaxBytesMaxGas (:519), post-block
Update + recheck (:577/:631/:646). The concurrent-linked-list machinery
exists for lock-free gossip iteration; a deque + lock provides the same
semantics for the in-process build (the p2p reactor iterates snapshots).

Beyond the reference (overload resilience, ROADMAP item 5):

  * signed-tx envelopes (mempool/sigtx.py) are signature-checked by the
    NODE through the verify plane's BULK lane — CheckTx signature work
    coalesces into the same device flushes as votes instead of
    single-verifying on the host, and a shed BULK verification surfaces
    as an explicit CODE_TYPE_OVERLOADED CheckTx response with a
    retry-after hint, never a silent drop;
  * an optional AdmissionController (mempool/admission.py) gates
    CheckTx in front of ABCI: bounded in-flight calls, mempool-fill
    watermarks with hysteresis, tightened limits while the device
    breaker is open;
  * hygiene: every drop path (full queue, recheck, commit) clears the
    tx's cache/gas entries atomically — `_tx_gas` can never leak for a
    tx the pool no longer holds.

The port's copy of the JAX package's mempool/mempool.py. One seam
differs (ROADMAP C1): where the JAX mempool answers a signature from the
host (a plane error other than a shed, or no plane), the port verifies it
where the plane would have: a device plane's row, or one whose flush
faulted on the device, on that plane's device
(crypto/batch.verify_batch_direct); a host plane's (use_device=False) on
the host; with no plane, on the card, or through `batch_fn` when one is
given (a node's: its device, or the host for [crypto] verifier = "cpu").
A DeviceError propagates out of
check_tx, and the tx leaves the dedup cache first, so a retry once the
device recovers is checked again.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import List, Optional

from cometbft_tpu_torch import verifyplane as vp
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.crypto.keys import PubKey
from cometbft_tpu_torch.device import DeviceError
from cometbft_tpu_torch.mempool import sigtx
from cometbft_tpu_torch.verifyplane.plane import verify_off_plane

CACHE_SIZE = 10000  # config.mempool.cache_size default


class Mempool:
    def __init__(self, app: abci.Application, max_txs: int = 5000,
                 cache_size: int = CACHE_SIZE, recheck: bool = True,
                 verify_sigs: bool = True, admission=None, metrics=None,
                 chain_id: Optional[str] = None, batch_fn=None):
        self.app = app
        self.max_txs = max_txs
        self.cache_size = max(1, int(cache_size))
        # post-block recheck of surviving txs (clist_mempool.go:577
        # Update -> :631/:646 recheckTxs), config [mempool] recheck
        self.recheck = bool(recheck)
        # node-side sigtx envelope verification through the verify
        # plane's BULK lane (config [mempool] verify_sigs)
        self.verify_sigs = bool(verify_sigs)
        self.admission = admission  # AdmissionController or None
        self.metrics = metrics
        # tenant key for plane submissions (verifyplane/tenants.py):
        # BULK rows attribute to the hosting chain, None = "default"
        self.chain_id = chain_id
        # batch_fn(pubs, msgs, sigs) for a signature when no plane runs
        # (None: the card)
        self.batch_fn = batch_fn
        self._txs: deque = deque()
        self._tx_set = set()
        self._tx_gas = {}  # tx -> gas_wanted from its CheckTx
        self._cache: "OrderedDict[bytes, None]" = OrderedDict()
        self._lock = threading.Lock()

    def size(self) -> int:
        with self._lock:
            return len(self._txs)

    def fill_fraction(self) -> float:
        """Pool fullness in [0, 1] — the admission watermark input."""
        with self._lock:
            return len(self._txs) / self.max_txs if self.max_txs else 1.0

    # -- CheckTx -----------------------------------------------------------

    def _overloaded(self, reason: str, retry_after_ms: float
                    ) -> abci.ResponseCheckTx:
        if self.metrics is not None:
            self.metrics.mempool_overloaded.inc()
        return abci.ResponseCheckTx(
            code=abci.CODE_TYPE_OVERLOADED,
            log=f"{reason}; retry_after_ms={round(retry_after_ms, 1)}",
            retry_after_ms=round(retry_after_ms, 1),
        )

    def _verify_envelope(self, tx: bytes) -> Optional[abci.ResponseCheckTx]:
        """Node-side sigtx check; None = proceed to the app (valid
        envelope, or no envelope at all). Runs through the verify
        plane's BULK lane when one is running (cross-caller device
        coalescing); on the card otherwise. BULK sheds and queue-bound
        rejections come back as explicit OVERLOADED responses carrying
        the plane's retry hint."""
        try:
            parsed = sigtx.parse(tx)
        except sigtx.SigTxError as e:
            return abci.ResponseCheckTx(
                code=abci.CODE_TYPE_BAD_SIGNATURE, log=str(e))
        if parsed is None:
            return None  # unsigned tx: app-level auth applies
        try:
            pub = PubKey(parsed.pub, "ed25519")
        except Exception as e:  # noqa: BLE001 - hostile bytes
            return abci.ResponseCheckTx(
                code=abci.CODE_TYPE_BAD_SIGNATURE,
                log=f"bad sigtx pubkey: {e}")
        msg = sigtx.sign_bytes(parsed.payload)
        plane = vp.global_plane()
        if plane is not None:
            try:
                fut = plane.submit(pub, msg, parsed.signature,
                                   lane=vp.LANE_BULK, block=False,
                                   chain_id=self.chain_id)
                ok = fut.result()[0]
            except vp.PlaneOverloaded as e:
                return self._overloaded(
                    "verify plane bulk lane overloaded",
                    e.retry_after_ms)
            except (vp.PlaneError, DeviceError):
                # the plane stopped or filled mid-call, or its flush
                # faulted on the device: verify where it would have
                ok = self._off_plane_verify(plane, pub, msg,
                                            parsed.signature)
        elif self.batch_fn is not None:
            ok = bool(self.batch_fn([pub], [msg], [parsed.signature])[0])
        else:
            ok = self._off_plane_verify(None, pub, msg, parsed.signature)
        if not ok:
            return abci.ResponseCheckTx(
                code=abci.CODE_TYPE_BAD_SIGNATURE,
                log="invalid sigtx signature")
        return None

    @classmethod
    def _off_plane_verify(cls, plane, pub, msg: bytes, sig: bytes) -> bool:
        """A host plane's row on the host (as upstream); a device plane's
        on its device, and with no plane on the card (verify_off_plane;
        a DeviceError propagates)."""
        if plane is not None and plane.device is None:
            return cls._host_verify(pub, msg, sig)
        return bool(verify_off_plane(plane, [pub], [msg], [sig])[0])

    @staticmethod
    def _host_verify(pub, msg: bytes, sig: bytes) -> bool:
        try:
            return bool(pub.verify_signature(msg, sig))
        except ValueError:
            return False

    def check_tx(self, tx: bytes) -> abci.ResponseCheckTx:
        """CheckTx + add (clist_mempool.go:117), with the overload
        gates in front: cache dedup (cheapest first), admission
        control, node-side signature check, then the app."""
        with self._lock:
            if tx in self._cache:
                return abci.ResponseCheckTx(code=1,
                                            log="tx already in cache")
            self._cache[tx] = None
            if len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        dec = None
        if self.admission is not None:
            dec = self.admission.try_acquire()
            if self.metrics is not None:
                self.metrics.mempool_admission.inc(outcome=dec.outcome)
            if not dec.admitted:
                # rejected txs leave the cache: the client was TOLD to
                # retry, so the retry must not be swallowed by dedup
                with self._lock:
                    self._cache.pop(tx, None)
                return self._overloaded(
                    f"mempool admission: {dec.outcome}",
                    dec.retry_after_ms)
        try:
            return self._check_tx_admitted(tx)
        except DeviceError:
            # no verdict was reached: the retry must not be swallowed
            # by dedup once the device recovers
            with self._lock:
                self._cache.pop(tx, None)
            raise
        finally:
            if dec is not None:
                self.admission.release()

    def _check_tx_admitted(self, tx: bytes) -> abci.ResponseCheckTx:
        if self.verify_sigs:
            rej = self._verify_envelope(tx)
            if rej is not None:
                # signature rejections and sheds leave the cache too —
                # a shed tx is explicitly resubmittable after backoff
                with self._lock:
                    self._cache.pop(tx, None)
                return rej
        resp = self.app.check_tx(abci.RequestCheckTx(tx=tx))
        if resp.code == abci.CODE_TYPE_OK:
            with self._lock:
                if tx in self._tx_set:
                    pass
                elif len(self._txs) < self.max_txs:
                    self._txs.append(tx)
                    self._tx_set.add(tx)
                    self._tx_gas[tx] = resp.gas_wanted
                else:
                    # mempool full: drop AND un-cache so a resubmission
                    # isn't silently swallowed forever (clist_mempool.go
                    # removes err'd txs from the cache); the gas entry
                    # must go with it (it was never added here, but a
                    # racing update() may have dropped the tx between
                    # our set check and now — pop defensively)
                    self._cache.pop(tx, None)
                    self._tx_gas.pop(tx, None)
                    return abci.ResponseCheckTx(
                        code=1, log="mempool is full"
                    )
                if self.metrics is not None:
                    self.metrics.mempool_size.set(float(len(self._txs)))
        else:
            # rejected txs leave the cache so they can be resubmitted once
            # valid (clist_mempool.go: KeepInvalidTxsInCache=false default)
            with self._lock:
                self._cache.pop(tx, None)
        return resp

    # -- reap / update -----------------------------------------------------

    def reap(self, max_bytes: int = -1, max_txs: int = -1,
             max_gas: int = -1) -> List[bytes]:
        """ReapMaxBytesMaxGas (clist_mempool.go:519): byte, count, and
        gas caps; a tx whose gas_wanted would push past max_gas stops
        the reap (same early-break as the reference)."""
        out, total, gas = [], 0, 0
        with self._lock:
            for tx in self._txs:
                if max_txs >= 0 and len(out) >= max_txs:
                    break
                if max_bytes >= 0 and total + len(tx) > max_bytes:
                    break
                g = self._tx_gas.get(tx, 0)
                if max_gas >= 0 and gas + g > max_gas:
                    break
                out.append(tx)
                total += len(tx)
                gas += g
        return out

    def update(self, height: int, committed: List[bytes],
               recheck: Optional[bool] = None) -> None:
        """Remove committed txs, then re-run CheckTx on the survivors
        (clist_mempool.go:577 Update + :631/:646 recheckTxs): a tx whose
        validity depended on state the block just changed must not be
        re-proposed forever. `recheck=None` follows the pool's config
        flag ([mempool] recheck)."""
        if recheck is None:
            recheck = self.recheck
        with self._lock:
            committed_set = set(committed)
            survivors = [t for t in self._txs if t not in committed_set]
            self._txs = deque(survivors)
            self._tx_set -= committed_set
            for t in committed_set:
                # committed txs leave gas tracking whether or not they
                # were in OUR pool (a block may commit txs we never saw
                # — popping unconditionally can't leak, not popping can)
                self._tx_gas.pop(t, None)
            if self.metrics is not None:
                self.metrics.mempool_size.set(float(len(self._txs)))
        if not recheck or not survivors:
            return
        keep = []
        for tx in survivors:
            resp = self.app.check_tx(
                abci.RequestCheckTx(tx=tx, recheck=True)
            )
            if resp.code == abci.CODE_TYPE_OK:
                keep.append(tx)
        with self._lock:
            dropped = set(survivors) - set(keep)
            if dropped:
                self._txs = deque(
                    t for t in self._txs if t not in dropped
                )
                self._tx_set -= dropped
                for t in dropped:
                    # invalid txs leave the cache (resubmittable later)
                    # AND gas tracking (the recheck-drop leak)
                    self._cache.pop(t, None)
                    self._tx_gas.pop(t, None)
            if self.metrics is not None:
                self.metrics.mempool_size.set(float(len(self._txs)))

    def flush(self) -> None:
        with self._lock:
            self._txs.clear()
            self._tx_set.clear()
            self._tx_gas.clear()
            self._cache.clear()
            if self.metrics is not None:
                self.metrics.mempool_size.set(0.0)

    def gas_entries(self) -> int:
        """Test/ops hook: _tx_gas must track the pool exactly — any
        excess is a leak."""
        with self._lock:
            return len(self._tx_gas)
