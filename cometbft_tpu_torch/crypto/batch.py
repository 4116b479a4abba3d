"""Batch-verifier dispatch: group rows by key type and verify each group on
the device under a circuit breaker.

Reference: crypto/batch/batch.go:12-32 (CreateBatchVerifier switches on key
type). Counterpart of the JAX package's crypto/batch.py: ed25519 rows go to
the CUDA verify kernel (ops/ed25519_fused.py), or, with `cached=True`,
groups of at least `CACHED_MIN_ROWS` rows go to the cached-valset kernel
(ops/ed25519_cached.py `verify_batch_cached`); sr25519 rows go to the
sr25519 kernel (ops/sr25519_kernel.py) and secp256k1 rows to the ECDSA
kernel (ops/ecdsa_fused.py). A mixed commit is one call that makes one
kernel launch per key-type group. Rows of a key type with no batch
verifier are verified one by one through `PubKey.verify_signature`, and
rows it cannot verify are marked invalid, as the JAX package does: that is
the semantics of an unknown key, not a device fallback.

Every kernel dispatch runs under a circuit breaker, behind the
`crypto.device_dispatch` failpoint. A device fault is logged, counted and
raised to the caller as `DeviceError`: the port never re-verifies on the
host behind the caller's back, here or in the verify plane (a device
plane's flush that faults fails its futures with `DeviceError`; the JAX
package's host-verifies). After `failure_threshold` consecutive faults the
breaker opens and batches fail fast with `DeviceError`; every `cooldown`
seconds one batch probes the device again, and a success closes the
breaker. `faults` counts every recorded fault.

While a verify plane runs (verifyplane.set_global_plane), a default
`verify_batch` call becomes a submission to it, so independent callers
coalesce into shared device passes, as in the JAX package.

Each `verify_batch_direct` call is timed, always, by key-type group and
by stage, never by row: a `batch.group` span a group (args `key_type`,
`rows`, `cols`) around the kernel's stages (`stage`: `challenges` for
sr25519, then `pack`, `dispatch`, `wait`), each a `batch.<stage>` span
(libs/tracing.py), and a record a call in the bounded ring
`call_stats()`. `rows_verified()` counts the rows handed to kernels, by
key type (libs/metrics.py scrapes it).
"""
from __future__ import annotations

import functools
import logging
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Callable, Sequence

import numpy as np

from cometbft_tpu_torch.crypto.keys import (
    ED25519_KEY_TYPE,
    SECP256K1_KEY_TYPE,
    SR25519_KEY_TYPE,
    PubKey,
)
from cometbft_tpu_torch.device import DeviceError, default_device, resolve
from cometbft_tpu_torch.libs import failpoints as fp
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.libs.staging import StagingPool

_log = logging.getLogger(__name__)

_BATCHABLE = {ED25519_KEY_TYPE, SECP256K1_KEY_TYPE, SR25519_KEY_TYPE}

fp.register("crypto.device_dispatch",
            "device kernel about to run (raise = device fault; the "
            "breaker counts it and the caller gets DeviceError)")


def supports_batch_verifier(key_type: str) -> bool:
    """crypto/batch/batch.go:24-32 analog (plus secp256k1): whether a
    key type has a batch verifier (a kernel) here."""
    return key_type in _BATCHABLE


class CircuitBreaker:
    """Consecutive-failure breaker with timed half-open probes.

    closed  — device healthy, every batch dispatches to it.
    open    — device sick: batches fail fast; once per `cooldown`
              seconds a single batch is let through as a probe. Probe
              success -> closed; probe failure -> stay open.
    """

    def __init__(self, failure_threshold: int = 2,
                 cooldown: float = 30.0, name: str = "device"):
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown = cooldown
        self.name = name
        self._lock = threading.Lock()
        self._failures = 0
        self._open_until = 0.0
        self._is_open = False
        self.trips = 0        # times the breaker opened
        self.closes = 0       # open -> closed recoveries
        self.probes = 0       # half-open probes attempted
        self.faults = 0       # device faults recorded, in total

    @property
    def state(self) -> str:
        with self._lock:
            return "open" if self._is_open else "closed"

    def allow(self) -> bool:
        """True -> caller may try the device (normal or probe)."""
        with self._lock:
            if not self._is_open:
                return True
            now = time.monotonic()
            if now >= self._open_until:
                self._open_until = now + self.cooldown
                self.probes += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            was_open = self._is_open
            self._failures = 0
            self._is_open = False
            if was_open:
                self.closes += 1
        if was_open:
            _log.warning("circuit breaker %s: device recovered, "
                         "breaker CLOSED", self.name)

    def record_failure(self) -> None:
        with self._lock:
            self.faults += 1
            self._failures += 1
            now_tripping = (not self._is_open
                            and self._failures >= self.failure_threshold)
            if now_tripping:
                self._is_open = True
                self.trips += 1
            if self._is_open:
                self._open_until = time.monotonic() + self.cooldown
        if now_tripping:
            _log.error(
                "circuit breaker %s: OPEN after %d consecutive device "
                "faults; failing fast, re-probing every %.1fs", self.name, self._failures, self.cooldown,
            )

    def reset(self) -> None:
        """Close the breaker and forget its consecutive faults, as the
        JAX package's reset does; the counters (trips, closes, probes,
        faults) keep their totals."""
        with self._lock:
            self._failures = 0
            self._is_open = False
            self._open_until = 0.0


# One breaker for THE device: every kernel shares the card.
_DEVICE_BREAKER = CircuitBreaker(name="verify-device")


def device_breaker() -> CircuitBreaker:
    return _DEVICE_BREAKER


def configure_breaker(failure_threshold: int, cooldown: float) -> None:
    """Apply [crypto] breaker knobs (config/config.py) to the global
    breaker."""
    _DEVICE_BREAKER.failure_threshold = max(1, failure_threshold)
    _DEVICE_BREAKER.cooldown = cooldown


# One staging pool for THE device, mirroring the breaker: callers that pack
# rows for upload without a pool of their own (fused.plan_fused without
# the plane's private pool) rotate through the same two persistent host
# buffers per shape (libs/staging.py).
_STAGING = StagingPool(slots=2)


def staging_pool() -> StagingPool:
    return _STAGING


# A group's host stages, in the order a kernel's verify_batch runs them:
# the sr25519 merlin challenges and k mod L, the pack into rows, the
# upload and launch, and the wait for the validity on the host.
GROUP_STAGES = ("challenges", "pack", "dispatch", "wait")
_STAGE_SPANS = {s: f"batch.{s}" for s in GROUP_STAGES}

# One record a verify_batch_direct call, newest last: {"ms": the call,
# "split": its rows split by key type, "groups": [{"key_type", "rows",
# "cols", "ms": the group, and each of GROUP_STAGES: ms}]}. A reader (a
# benchmark metric, an operator's tool) keeps the records of its own
# calls, whose identity it knows.
_CALLS: deque = deque(maxlen=4096)
_GROUP = threading.local()   # .rec: the group record this thread fills
_ROWS: dict = defaultdict(int)
_ROWS_LOCK = threading.Lock()


def call_stats() -> deque:
    """The bounded ring of verify_batch_direct's call records."""
    return _CALLS


def rows_verified() -> dict:
    """{key type: rows handed to its kernel} in this process."""
    with _ROWS_LOCK:
        return dict(_ROWS)


@contextmanager
def stage(name: str):
    """A host stage (GROUP_STAGES) of the key-type group this thread is
    verifying: its `batch.<name>` span, and its milliseconds added to the
    group's record. The kernels' verify_batch run their stages in it;
    outside a group it is the span alone."""
    rec = getattr(_GROUP, "rec", None)
    t0 = time.perf_counter()
    with tracing.span(_STAGE_SPANS[name], "crypto"):
        yield
    if rec is not None:
        rec[name] += (time.perf_counter() - t0) * 1e3


# The cached-valset kernel keys its window table on the EXACT pubkey list,
# so it pays off for whole-valset batches; below one lane tile the general
# kernel serves (the JAX package's `device_batch_fn(cached=True)` gate).
CACHED_MIN_ROWS = 128


def _ed25519_cached(pubs, msgs, sigs, device=None):
    from cometbft_tpu_torch.ops import ed25519_cached, ed25519_fused

    if len(pubs) >= CACHED_MIN_ROWS:
        return ed25519_cached.verify_batch_cached(pubs, msgs, sigs,
                                                  device=device)
    return ed25519_fused.verify_batch(pubs, msgs, sigs, device=device)


def _ed25519_cached_cols(n: int) -> int:
    from cometbft_tpu_torch.ops import ed25519_cached, ed25519_fused

    if n >= CACHED_MIN_ROWS:
        return ed25519_cached.pad_rows(n)
    return ed25519_fused.pad_to_tile(n)


# a kernel's `cols(n)`: the columns it pads n rows to
_ed25519_cached.cols = _ed25519_cached_cols


def _kernel_for(key_type: str) -> Callable | None:
    """The batch verifier of a key type, or None for a key type with
    none (its rows stay invalid)."""
    if key_type == ED25519_KEY_TYPE:
        from cometbft_tpu_torch.ops import ed25519_fused

        return ed25519_fused.verify_batch
    if key_type == SECP256K1_KEY_TYPE:
        from cometbft_tpu_torch.ops import ecdsa_fused

        return ecdsa_fused.verify_batch
    if key_type == SR25519_KEY_TYPE:
        from cometbft_tpu_torch.ops import sr25519_kernel

        return sr25519_kernel.verify_batch
    return None


def _cached_kernel_for(key_type: str) -> Callable:
    if key_type == ED25519_KEY_TYPE:
        return _ed25519_cached
    return _kernel_for(key_type)


def verify_batch_direct(
    pubs: Sequence[PubKey],
    msgs: Sequence[bytes],
    sigs: Sequence[bytes],
    device=None,
    breaker: CircuitBreaker = None,
    cached: bool = False,
    kernels: dict = None,
) -> np.ndarray:
    """Group rows by key type and dispatch each group to its kernel under
    the circuit breaker; (n,) bool validity. Rows of a key type with no
    batch verifier are invalid (PubKey.verify_signature cannot verify them
    either).

    `device` is passed to the kernel (None: the CUDA card; "cpu": the plain
    PyTorch version); `cached` routes ed25519 groups through the
    cached-valset kernel. A device fault (the kernel raised, or the
    `crypto.device_dispatch` failpoint fired) is recorded on the breaker
    and raised as `DeviceError`; while the breaker is open, groups raise
    `DeviceError` without touching the device. `breaker` overrides the
    global device breaker (tests); `kernels` ({key type: fn(pubs, msgs,
    sigs, device=...)}) overrides the kernel of a key type (tests)."""
    n = len(pubs)
    valid = np.zeros((n,), np.bool_)
    brk = breaker if breaker is not None else _DEVICE_BREAKER
    call = {"ms": 0.0, "split": 0.0, "groups": []}
    _CALLS.append(call)
    t0 = time.perf_counter()
    try:
        groups: dict = defaultdict(list)
        for i, p in enumerate(pubs):
            groups[p.key_type].append(i)
        call["split"] = (time.perf_counter() - t0) * 1e3
        for kt, idxs in groups.items():
            kernel = (kernels or {}).get(kt) or (
                _cached_kernel_for(kt) if cached else _kernel_for(kt))
            if kernel is None:
                continue
            if not brk.allow():
                raise DeviceError(
                    f"circuit breaker {brk.name} is open; {len(idxs)} {kt} "
                    f"signatures not verified")
            valid[np.asarray(idxs)] = _verify_group(
                kt, kernel, idxs, pubs, msgs, sigs, device, brk, call)
    finally:
        call["ms"] = (time.perf_counter() - t0) * 1e3
    return valid


def _verify_group(kt, kernel, idxs, pubs, msgs, sigs, device, brk, call):
    """Rows `idxs`, one key type's, on its kernel under the breaker, in
    the group's `batch.group` span and record; gathering the rows counts
    as packing them."""
    n = len(idxs)
    pad = getattr(kernel, "cols", None)   # a kernel a test put in: n
    cols = pad(n) if pad is not None else n
    rec = {"key_type": kt, "rows": n, "cols": cols, "ms": 0.0,
           **dict.fromkeys(GROUP_STAGES, 0.0)}
    call["groups"].append(rec)
    _GROUP.rec = rec
    t0 = time.perf_counter()
    try:
        with tracing.span("batch.group", "crypto", key_type=kt, rows=n,
                          cols=cols):
            with stage("pack"):
                rows = ([pubs[i].data for i in idxs], [msgs[i] for i in idxs],
                        [sigs[i] for i in idxs])
            fp.fail_point("crypto.device_dispatch")
            sub = kernel(*rows, device=device)
    except Exception as exc:
        brk.record_failure()
        _log.exception("device batch verify failed for %s (%d sigs)", kt, n)
        if isinstance(exc, DeviceError):
            raise
        raise DeviceError(f"device batch verify failed for {n} "
                          f"{kt} signatures: {exc!r}") from exc
    finally:
        _GROUP.rec = None
        rec["ms"] = (time.perf_counter() - t0) * 1e3
    brk.record_success()
    with _ROWS_LOCK:
        _ROWS[kt] += n
    return np.asarray(sub)


def verify_batch(pubs, msgs, sigs, device=None,
                 breaker: CircuitBreaker = None,
                 cached: bool = False, kernels: dict = None) -> np.ndarray:
    """The batch_fn validation.py consumes. While the verify plane runs,
    a default call (no device, breaker, cached or kernels pinned) is a
    submit-and-wait over the plane, so independent callers coalesce into
    shared device passes; it goes direct when the plane stops, overflows
    or sheds mid-call (PlaneError), and raises the plane's DeviceError
    when its flush faults on the device. Pinned calls go direct."""
    if device is None and breaker is None and not cached and not kernels:
        from cometbft_tpu_torch.verifyplane import plane as _vp

        p = _vp.global_plane()
        if p is not None:
            try:
                return p.submit_and_wait(pubs, msgs, sigs)
            except _vp.PlaneError:
                pass  # plane stopped/overflowed mid-call: go direct
    return verify_batch_direct(pubs, msgs, sigs, device, breaker, cached,
                               kernels)


def batch_fn(device=None) -> Callable:
    """The batch_fn validation.py consumes (CreateBatchVerifier analog):
    `verify_batch` on `device`. None is the card, checked here (DeviceError
    without one), and the function then rides a running verify plane as
    a default `verify_batch` call does; "cpu" runs the plain versions."""
    if device is None:
        default_device()
        return verify_batch
    return functools.partial(verify_batch, device=resolve(device))
