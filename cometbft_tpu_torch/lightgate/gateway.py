"""Light-client gateway: coalesced skipping verification as a service.

A full node that serves light-client sync to thousands of concurrent
clients faces a workload the light client alone cannot amortize: every
client independently runs skipping verification over largely the SAME
header ranges ("Practical Light Clients for Committee-Based
Blockchains" analyzes exactly this committee-scale serving problem).
The gateway turns the node into a verification service with three
compounding layers of sharing:

  1. request coalescing — N clients asking to verify the same
     (trusted_height, target_height) pair produce ONE verification
     (one leader runs it, everyone gets the result fanned out), so the
     verify plane sees one submission stream instead of N;
  2. a shared trusted store — one `light.Client` (now internally
     locked) backs every request, so a height verified for one client
     is a store hit for every later client, whatever their trust root;
  3. a verified-pair LRU — popular (trusted_hash, target_hash) pairs
     short-circuit to pure cache hits that never touch the client at
     all (expiry-checked: stale trust is never served).

Device traffic rides the verify plane's dedicated GATEWAY QoS lane:
client-serving header verifies drain after the node's own CONSENSUS
traffic and ahead of mempool BULK, and under overload they are SHED
with explicit retry-hinted `GatewayOverloaded` verdicts — never silent
drops, and never at the expense of the node's own liveness (README
"Overload behavior"; the lane-choice rationale lives in the README's
"Light-client gateway" section).

Attack handling: a client may attach the signed header IT was served
by its own primary. When that header diverges from the gateway's
verified view, the gateway drives the light client's existing
`_make_attack_evidence` path and submits the resulting
`LightClientAttackEvidence` to the node's evidence pool — one
malicious feed yields committed evidence while every other client
keeps syncing ("Polynomial Multiproofs" motivates hardening exactly
this serving edge).

The port's copy of the JAX package's lightgate/gateway.py. The seams that
differ (ROADMAP C1): a device plane that cannot take a flush's rows
verifies them on its own device (crypto/batch.verify_batch_direct), only
a host plane (use_device=False) answers from the host, and with no plane
the rows verify on the card; a DeviceError reaches every coalesced waiter
as itself.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Tuple

from cometbft_tpu_torch.device import DeviceError
from cometbft_tpu_torch.light.client import Client, NoSuchBlockError, Provider
from cometbft_tpu_torch.light.verifier import (
    LightBlock,
    LightClientError,
    SignedHeader,
    header_expired,
)
from cometbft_tpu_torch.lightgate.cache import CacheEntry, VerifiedLRU
from cometbft_tpu_torch.types import serde
from cometbft_tpu_torch.types.timestamp import Timestamp

_log = logging.getLogger(__name__)

DEFAULT_TRUSTING_PERIOD = 14 * 24 * 3600.0
DEFAULT_COALESCE_TIMEOUT = 30.0
DEFAULT_MAX_BATCH_HEADERS = 64


class GatewayError(Exception):
    """Gateway-side failure (bad request, no trust root, provider
    gap); RPC surfaces it as an error verdict."""


class GatewayOverloaded(GatewayError):
    """The verify plane shed this request's header verification (the
    GATEWAY lane aged it past its deadline or the lane is full). An
    explicit verdict with an honest backoff hint — every coalesced
    waiter on the shed flight receives it; nothing is dropped
    silently."""

    def __init__(self, msg: str, retry_after_ms: float = 0.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


def gateway_batch_fn(chain_id: Optional[str] = None) -> Callable:
    """batch_fn(pubs, msgs, sigs) -> (n,) bool riding the verify
    plane's GATEWAY lane when a plane runs. A PlaneOverloaded shed is
    re-raised as GatewayOverloaded (hint preserved) so it surfaces to
    the RPC client. Any other PlaneError (a plane stopping or full
    mid-call) sends the rows to the plane's own device
    (verify_batch_direct), or to the host's per-row reference path on
    a host plane; with no plane they verify on the card. A DeviceError
    propagates. `chain_id` keys GATEWAY rows to their tenant so a shared
    plane attributes (and quota-gates) them per hosted chain."""

    def fn(pubs, msgs, sigs):
        from cometbft_tpu_torch import verifyplane as vp
        from cometbft_tpu_torch.verifyplane.plane import verify_off_plane

        p = vp.global_plane()
        if p is not None:
            try:
                return p.submit_and_wait(pubs, msgs, sigs,
                                         lane=vp.LANE_GATEWAY,
                                         chain_id=chain_id)
            except vp.PlaneOverloaded as e:
                raise GatewayOverloaded(
                    str(e), retry_after_ms=e.retry_after_ms) from e
            except vp.PlaneError:
                pass
        return verify_off_plane(p, pubs, msgs, sigs)

    return fn


def node_light_provider(node) -> Provider:
    """Light blocks straight from the node's own stores — the gateway
    is MOUNTED on the full node, so there is no RPC hop: header +
    commit from the block store, the validator set from the state
    store's history."""
    chain_id = node.consensus.state.chain_id
    block_store = node.block_store
    state_store = node.state_store

    def fetch(height: int) -> Optional[LightBlock]:
        blk = block_store.load_block(height)
        if blk is None:
            return None
        commit = block_store.load_seen_commit(height) \
            or block_store.load_block_commit(height)
        if commit is None:
            return None
        vals = state_store.load_validators(height)
        if vals is None:
            return None
        return LightBlock(SignedHeader(blk.header, commit), vals)

    return Provider(chain_id, fetch)


class _Flight:
    """One in-progress coalesced verification: the leader resolves it,
    every follower waits on the event and reads the shared outcome."""

    __slots__ = ("ev", "result", "err")

    def __init__(self):
        self.ev = threading.Event()
        self.result = None
        self.err: Optional[BaseException] = None


class LightGateway:
    """The serving subsystem: coalescer + shared client + LRU.

    `provider` is the gateway's header source (the node's own stores
    via :func:`node_light_provider` when mounted; any LightBlock source
    in tests/benches). `root_fn` fetches the trust root the shared
    client self-roots on — for a mounted gateway that is the node's own
    earliest retained block, which the node already trusts by
    construction (it executed that chain)."""

    def __init__(self, chain_id: str, provider: Provider,
                 evidence_pool=None, *,
                 store=None,
                 cache_size: int = 4096,
                 trusting_period: float = DEFAULT_TRUSTING_PERIOD,
                 coalesce_timeout: float = DEFAULT_COALESCE_TIMEOUT,
                 max_batch_headers: int = DEFAULT_MAX_BATCH_HEADERS,
                 batch_fn: Optional[Callable] = None,
                 root_fn: Optional[Callable[[], LightBlock]] = None):
        self.chain_id = chain_id
        self.provider = provider
        self.evidence_pool = evidence_pool
        self.trusting_period = float(trusting_period)
        self.coalesce_timeout = float(coalesce_timeout)
        self.max_batch_headers = max(1, int(max_batch_headers))
        self.client = Client(
            chain_id, provider,
            trusting_period=self.trusting_period,
            batch_fn=batch_fn if batch_fn is not None
            else gateway_batch_fn(chain_id),
            store=store,
        )
        self.cache = VerifiedLRU(cache_size)
        self._root_fn = root_fn
        self._root_lock = threading.Lock()
        # coalescer: (trusted_height, target_height) -> _Flight
        self._flights: Dict[Tuple[int, int], _Flight] = {}
        self._flock = threading.Lock()
        # counters (scrape-safe under one small lock)
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.verifies = 0       # leader verifications actually run
        self.coalesced = 0      # requests that rode another's flight
        self.divergences = 0    # forged-header verdicts
        self.overloaded = 0     # explicit shed verdicts handed out
        self.evidence_submitted = 0
        self._running = False
        # post-evidence hook (simnet wires gossip here; a p2p node's
        # evidence reactor broadcasts on its own pull cycle)
        self.on_attack_evidence = None

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def for_node(cls, node, **kw) -> "LightGateway":
        """Mount on a full node: provider/evidence pool/root from the
        node's own stores."""
        provider = node_light_provider(node)
        kw.setdefault("root_fn", lambda: _node_root(node, provider))
        return cls(node.consensus.state.chain_id, provider,
                   evidence_pool=node.evidence_pool, **kw)

    def start(self, register: bool = True) -> None:
        """`register=False` serves without claiming the process-global
        mount (the simnet runs one gateway per scenario inside a shared
        test process — a global registration there would leak into
        unrelated proxies' "auto" resolution)."""
        self._running = True
        if register:
            set_global_gateway(self)

    def stop(self) -> None:
        self._running = False
        clear_global_gateway(self)

    def is_running(self) -> bool:
        return self._running

    # -- trust root --------------------------------------------------------

    def ensure_root(self, now: Optional[Timestamp] = None) -> None:
        """Self-root the shared client when its store is empty or its
        newest trust has expired. A MOUNTED gateway roots on its own
        node's chain — sound by construction (the node executed every
        block it serves), unlike a light proxy trusting a remote
        primary, which is why re-rooting here needs no pinned hash."""
        now = now or Timestamp.now()
        with self._root_lock:
            latest = self.client.store.latest()
            if latest is not None and not header_expired(
                latest.signed_header.header, self.trusting_period, now
            ):
                return
            if self._root_fn is None:
                if latest is not None:
                    return  # pre-seeded store (tests): serve as-is
                raise GatewayError(
                    "gateway has no trust root: seed the store or "
                    "provide root_fn"
                )
            lb = self._root_fn()
            if lb is None:
                raise GatewayError("gateway root_fn produced no block")
            self.client.trust_light_block(lb)

    # -- serving -----------------------------------------------------------

    def verify(self, trusted_height: int, target_height: int, *,
               trusted_hash: Optional[bytes] = None,
               claimed: Optional[dict] = None,
               now: Optional[Timestamp] = None,
               with_validators: bool = False) -> dict:
        """One client sync step: verify `target_height` from the
        client's `trusted_height` through the coalesced pipeline.

        `trusted_hash` pins the client's root (a mismatch means the
        client's trust is not on our chain — an error, not a silent
        re-root). `claimed` optionally carries the signed header the
        client's own primary served it ({"header": .., "commit": ..});
        a divergent claim drives the attack-evidence path."""
        now = now or Timestamp.now()
        with self._stats_lock:
            self.requests += 1
        trusted_height = int(trusted_height)
        target_height = int(target_height)
        if target_height < trusted_height:
            raise GatewayError(
                f"target {target_height} below trusted "
                f"{trusted_height}: nothing to verify forward"
            )
        self.ensure_root(now)
        t_lb = self._fetch(trusted_height)
        t_hash = t_lb.signed_header.header.hash()
        if trusted_hash and t_hash != trusted_hash:
            raise GatewayError(
                f"trust root mismatch at height {trusted_height}: "
                f"client pins {trusted_hash.hex()[:16]}, this chain "
                f"has {t_hash.hex()[:16]}"
            )
        tgt_lb = self._fetch(target_height)
        tgt_hash = tgt_lb.signed_header.header.hash()

        claimed_sh = self._parse_claim(claimed, target_height) \
            if claimed else None
        divergent = (claimed_sh is not None and
                     claimed_sh.header.hash() != tgt_hash)

        key = (t_hash, tgt_hash)
        ent = self.cache.get(key, now_ns=now.to_ns())
        if ent is not None:
            verdict = self._verdict(tgt_lb, cached=True, coalesced=False,
                                    steps=0,
                                    with_validators=with_validators)
        else:
            # expired trust is never served from ANY layer: the LRU
            # already refused (entry expiry == this same bound), and
            # this guard closes the shared-store path too — a target
            # past the trusting period is useless as the client's new
            # root, so a stale store hit must not masquerade as a
            # fresh verification
            if header_expired(tgt_lb.signed_header.header,
                              self.trusting_period, now):
                raise GatewayError(
                    f"target header {target_height} is past the "
                    f"trusting period; cannot serve it as a trust root"
                )
            verdict = self._verify_coalesced(
                t_lb, target_height, key, now,
                with_validators=with_validators)
        if divergent:
            # our own view is verified by now — only then accuse
            return self._handle_divergence(tgt_lb, claimed_sh, verdict)
        return verdict

    def headers(self, heights: List[int],
                with_validators: bool = False) -> dict:
        """Batched header/proof serving: signed headers (+ valsets on
        request) for up to max_batch_headers heights in one response —
        the proof-batching edge ("Polynomial Multiproofs" motivation)
        so a syncing client pulls its bisection pivots in one round
        trip instead of one per height."""
        # slice BEFORE the int() copy: the cap must bound allocation,
        # not just the response
        hs = [int(h) for h in list(heights)[: self.max_batch_headers]]
        out, missing = [], []
        for h in hs:
            try:
                lb = self.provider.light_block(h)
            except NoSuchBlockError:
                missing.append(h)
                continue
            out.append(self._lb_to_j(lb, with_validators))
        return {"headers": out, "missing": missing,
                "truncated": len(heights) > len(hs)}

    # -- internals ---------------------------------------------------------

    def _fetch(self, height: int) -> LightBlock:
        try:
            return self.provider.light_block(height)
        except NoSuchBlockError:
            raise GatewayError(f"no block at height {height}")

    def _parse_claim(self, claimed: dict, target_height: int
                     ) -> SignedHeader:
        try:
            sh = SignedHeader(
                header=serde.header_from_j(claimed["header"]),
                commit=serde.commit_from_j(claimed["commit"]),
            )
            sh.validate_basic(self.chain_id)
        except LightClientError:
            raise
        except Exception as e:  # noqa: BLE001 - client input
            raise GatewayError(f"malformed claimed header: {e}")
        if sh.height != target_height:
            raise GatewayError(
                f"claimed header height {sh.height} != target "
                f"{target_height}"
            )
        return sh

    def _verify_coalesced(self, t_lb: LightBlock, target_height: int,
                          key: Tuple[bytes, bytes], now: Timestamp,
                          with_validators: bool) -> dict:
        fkey = (t_lb.height, target_height)
        with self._flock:
            fl = self._flights.get(fkey)
            leader = fl is None
            if leader:
                fl = _Flight()
                self._flights[fkey] = fl
        if leader:
            try:
                fl.result = self._verify_leader(t_lb, target_height,
                                                key, now)
            except BaseException as e:  # noqa: BLE001 - fanned out
                fl.err = e
            finally:
                with self._flock:
                    self._flights.pop(fkey, None)
                fl.ev.set()
        else:
            with self._stats_lock:
                self.coalesced += 1
            if not fl.ev.wait(self.coalesce_timeout):
                raise GatewayError(
                    f"coalesced verification of {fkey} timed out"
                )
        if fl.err is not None:
            if isinstance(fl.err, GatewayOverloaded):
                # the shed fans out too: every waiter gets the explicit
                # retry-hinted verdict, not a hang or a silent drop
                with self._stats_lock:
                    self.overloaded += 1
                raise fl.err
            if isinstance(fl.err, (GatewayError, LightClientError,
                                   DeviceError)):
                raise fl.err
            raise GatewayError(f"verification failed: {fl.err}")
        lb, steps = fl.result
        return self._verdict(lb, cached=False, coalesced=not leader,
                             steps=steps,
                             with_validators=with_validators)

    def _verify_leader(self, t_lb: LightBlock, target_height: int,
                       key: Tuple[bytes, bytes], now: Timestamp
                       ) -> Tuple[LightBlock, int]:
        with self._stats_lock:
            self.verifies += 1
        # seed the shared store at the client's root (idempotent: the
        # root is a block of our own chain), then let the shared client
        # verify — an already-verified target is a store hit, and the
        # device wait happens with NO gateway lock held, so concurrent
        # leaders for different pairs coalesce inside the plane
        self.client.store.save(t_lb)
        # thread-local step window: a delta over the shared
        # verifications counter would absorb concurrent leaders' steps
        self.client.begin_step_count()
        try:
            lb = self.client.verify_light_block_at_height(target_height,
                                                          now=now)
        finally:
            steps = self.client.end_step_count()
        self.cache.put(key, CacheEntry(
            target_height=target_height,
            target_hash=lb.signed_header.header.hash(),
            expires_ns=lb.signed_header.header.time.to_ns()
            + int(self.trusting_period * 1e9),
            verify_steps=steps,
        ))
        return lb, steps

    def _handle_divergence(self, verified: LightBlock,
                           claimed_sh: SignedHeader,
                           verdict: dict) -> dict:
        """The client's primary served it a header that conflicts with
        our verified view: drive the light client's attack-evidence
        construction and feed the node's evidence pool. The serving
        verdict stays useful — the honest view rides along so the
        client can re-root on it."""
        with self._stats_lock:
            self.divergences += 1
        conflicting = LightBlock(claimed_sh, verified.validator_set)
        ev = self.client._make_attack_evidence(verified, conflicting)
        added = False
        if ev is not None and self.evidence_pool is not None:
            try:
                added = self.evidence_pool.add_evidence(ev)
            except Exception:  # noqa: BLE001 - forged-but-underpowered
                # commits fail pool verification; the client still gets
                # its divergence verdict
                _log.exception(
                    "lightgate: divergent header's evidence rejected "
                    "by the pool"
                )
        if added:
            with self._stats_lock:
                self.evidence_submitted += 1
            if self.on_attack_evidence is not None:
                try:
                    self.on_attack_evidence(ev)
                except Exception:  # noqa: BLE001 - reporter hook
                    pass
        out = dict(verdict)
        out["status"] = "divergent"
        out["evidence_hash"] = ev.hash().hex() if ev is not None else None
        out["evidence_added"] = added
        return out

    def _verdict(self, lb: LightBlock, *, cached: bool, coalesced: bool,
                 steps: int, with_validators: bool) -> dict:
        return {
            "status": "verified",
            "height": lb.height,
            "target_hash": lb.signed_header.header.hash().hex(),
            "cached": cached,
            "coalesced": coalesced,
            "verify_steps": steps,
            "target": self._lb_to_j(lb, with_validators),
        }

    @staticmethod
    def _lb_to_j(lb: LightBlock, with_validators: bool) -> dict:
        out = {
            "height": lb.height,
            "signed_header": {
                "header": serde.header_to_j(lb.signed_header.header),
                "commit": serde.commit_to_j(lb.signed_header.commit),
            },
        }
        if with_validators:
            out["validators"] = [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": {"type": v.pub_key.key_type,
                                "value": v.pub_key.data.hex()},
                    "voting_power": v.voting_power,
                    "proposer_priority": v.proposer_priority,
                }
                for v in lb.validator_set.validators
            ]
        return out

    # -- maintenance / observability ---------------------------------------

    def prune_expired(self, now: Optional[Timestamp] = None) -> dict:
        """Expire trust on both layers together: the shared client's
        store AND the verified-pair cache — so an LRU hit can never
        outlive the store trust it was derived from."""
        now = now or Timestamp.now()
        dropped = self.client.prune_expired(now)
        pruned = self.cache.prune_expired(now.to_ns())
        return {"store_dropped": dropped, "cache_dropped": pruned}

    def cache_stats(self) -> dict:
        """Scrape-safe LRU counters (/metrics samples this)."""
        return self.cache.stats()

    def stats(self) -> dict:
        with self._stats_lock:
            out = {
                "running": self._running,
                "requests": self.requests,
                "verifies": self.verifies,
                "coalesced": self.coalesced,
                "divergences": self.divergences,
                "overloaded": self.overloaded,
                "evidence_submitted": self.evidence_submitted,
            }
        out["cache"] = self.cache.stats()
        out["client_verifications"] = self.client.verifications
        out["store_heights"] = len(self.client.store.heights())
        with self._flock:
            out["inflight"] = len(self._flights)
        return out


def _node_root(node, provider: Provider) -> LightBlock:
    """The mounted gateway's self-root: the node's LATEST committed
    block. The latest block is the one header guaranteed inside the
    trusting period on a live chain — rooting on the earliest retained
    block would hand ensure_root an already-expired anchor on any
    full-history chain older than the trusting period, making the
    gateway unserviceable. Heights below the root are served by the
    backwards hash-walk (cheap, signature-free), and ensure_root
    re-invokes this whenever the stored root ages out, so the anchor
    tracks the chain tip."""
    tip = node.block_store.height() or 1
    return provider.light_block(max(1, tip))


# --------------------------------------------------------------------------
# the process-global gateway (node lifecycle owns it; /metrics sampling
# and the light proxy's shared-verifier path read it)
# --------------------------------------------------------------------------

_GLOBAL: Optional[LightGateway] = None
_LAST: Optional[LightGateway] = None
_GLOBAL_LOCK = threading.Lock()


def set_global_gateway(gw: Optional[LightGateway]) -> None:
    global _GLOBAL, _LAST
    with _GLOBAL_LOCK:
        _GLOBAL = gw
        if gw is not None:
            _LAST = gw


def clear_global_gateway(gw: LightGateway) -> None:
    """Unregister `gw` if (and only if) it is the current global — a
    stopping node must not unmount another node's gateway."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is gw:
            _GLOBAL = None


def global_gateway() -> Optional[LightGateway]:
    gw = _GLOBAL
    if gw is None or not gw.is_running():
        return None
    return gw


def last_gateway() -> Optional[LightGateway]:
    """The current global gateway — or, after a stop, the LAST one
    that was global (scrape-time /metrics sampling reads counters as
    history, like the verify plane's ledger)."""
    return _GLOBAL or _LAST
