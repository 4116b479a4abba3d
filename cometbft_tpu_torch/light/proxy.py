"""Light proxy: a verifying RPC server backed by a light client.

Reference: light/proxy/proxy.go + light/rpc/client.go — an RPC endpoint
that looks like a full node but verifies every header it returns
through the light client (bisection from a trusted root, witness
cross-checks) before handing it to the caller. Block data is checked
against the verified header's hashes, so a lying primary cannot feed
the caller fabricated blocks.

The port's copy of the JAX package's light/proxy.py. A proxy that rides a
mounted gateway verifies through the gateway's client (the GATEWAY lane
of the verify plane, or the card); the standalone client routes its
commits through the running plane as the port's light client does.
"""
from __future__ import annotations

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qsl, urlparse

from cometbft_tpu_torch.rpc.client import HTTPClient, light_provider
from cometbft_tpu_torch.types import serde


class LightProxyError(Exception):
    pass


class LightProxy:
    def __init__(self, chain_id: str, primary: str,
                 witnesses: Optional[List[str]] = None,
                 trusted_height: int = 0, trusted_hash: bytes = b"",
                 trusting_period: float = 14 * 24 * 3600.0,
                 host: str = "127.0.0.1", port: int = 0,
                 batch_fn=None, db_path: Optional[str] = None,
                 insecure_allow_reroot: bool = False,
                 gateway="auto"):
        """insecure_allow_reroot: permit trust-on-first-use RE-rooting
        when a persisted trust root has expired and no --trusted-hash
        is pinned. Off by default: silently letting the primary pick a
        fresh root after downtime is exactly the long-range attack the
        trusting period exists to stop (the reference errors out and
        demands fresh TrustOptions).

        gateway: "auto" (default) adopts the in-process light-client
        gateway's shared verifier whenever one is mounted — proxy and
        gateway then agree on ONE TrustedStore, so a height either of
        them verified is a store hit for the other, and proxy
        verification rides the gateway's coalescer/LRU. Pass an
        explicit LightGateway to pin one, or None/False for the legacy
        standalone path (own client, own store, remote-RPC providers)."""
        from cometbft_tpu_torch.light.client import Client

        self.chain_id = chain_id
        self.http = HTTPClient(primary)
        store = None
        if db_path:
            from cometbft_tpu_torch.light.store import DBStore

            store = DBStore(db_path)
        self._gateway_mode = gateway
        self._own_client = Client(
            chain_id,
            light_provider(chain_id, primary),
            witnesses=[light_provider(chain_id, w)
                       for w in (witnesses or [])],
            trusting_period=trusting_period,
            batch_fn=batch_fn,
            store=store,
        )
        if trusted_hash and trusted_height <= 0:
            raise LightProxyError(
                "trusted_hash requires trusted_height > 0: the hash "
                "pins a specific header, not whatever 'latest' is when "
                "the proxy boots"
            )
        self._trusted_height = trusted_height
        self._trusted_hash = trusted_hash
        self._pin_ok_gw = None  # gateway the pin was checked against
        self._insecure_allow_reroot = insecure_allow_reroot
        self._boot_lock = threading.Lock()
        self.httpd = ThreadingHTTPServer((host, port), _ProxyHandler)
        self.httpd.proxy = self  # type: ignore[attr-defined]
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- shared-verifier resolution ----------------------------------------

    def _resolve_gateway(self):
        """The LightGateway whose verifier this proxy rides, or None
        for the legacy standalone path. Resolved per call: a gateway
        mounted after the proxy started is adopted on the next
        request. Chain identity is REQUIRED to match — a chain-B proxy
        must never ride a chain-A gateway and hand out wrong-chain
        headers stamped verified."""
        gw = self._gateway_mode
        if gw in (None, False):
            return None
        if gw == "auto":
            from cometbft_tpu_torch.lightgate import global_gateway

            gw = global_gateway()
        elif not gw.is_running():
            gw = None
        if gw is not None and gw.chain_id != self.chain_id:
            return None
        return gw

    @property
    def client(self):
        """The verifying light client: the mounted gateway's shared
        client (single TrustedStore, coalesced verification) when one
        is available, the proxy's own standalone client otherwise."""
        gw = self._resolve_gateway()
        return gw.client if gw is not None else self._own_client

    # -- trust bootstrap ---------------------------------------------------

    def _ensure_trust(self):
        """initializeWithTrustOptions (light/client.go): fetch the block
        at the trusted height and pin it against the operator-supplied
        hash. Lazy so the proxy can start before the primary.

        Returns the CLIENT the calling route must serve with — the
        gateway is resolved exactly once here, so a mount/unmount
        racing the request can never bootstrap one client and serve
        from the other.

        With a gateway mounted, trust-root bookkeeping is the
        GATEWAY's: it self-roots on the chain it serves (sound — the
        node executed that chain), and the proxy only re-checks the
        operator's pinned hash against the shared view so a pin
        mismatch still fails loudly instead of being absorbed by the
        gateway's root."""
        gw = self._resolve_gateway()
        if gw is not None:
            gw.ensure_root()
            # the pin is immutable: one successful check per gateway
            # suffices (identity-keyed — a different gateway mounted
            # later re-checks)
            if self._trusted_hash and self._pin_ok_gw is not gw:
                lb = gw.client.primary.light_block(self._trusted_height)
                got = lb.signed_header.header.hash()
                if got != self._trusted_hash:
                    raise LightProxyError(
                        f"trusted hash mismatch at height "
                        f"{self._trusted_height}: got {got.hex()}, "
                        f"want {self._trusted_hash.hex()}"
                    )
                self._pin_ok_gw = gw
            return gw.client
        with self._boot_lock:
            client = self._own_client  # legacy standalone path
            latest = client.store.latest()
            if latest is not None:
                from cometbft_tpu_torch.light.verifier import header_expired
                from cometbft_tpu_torch.types.timestamp import Timestamp

                if not header_expired(
                    latest.signed_header.header,
                    client.trusting_period,
                    Timestamp.now(),
                ):
                    return client
                # persisted root older than the trusting period: it can
                # no longer anchor verification. Re-bootstrap from the
                # operator's TrustOptions if given (the reference's
                # restart-after-downtime path). Without a pinned hash
                # this is an ERROR — silently re-rooting on whatever
                # the primary serves would let a lying primary rewrite
                # history past the trusting period (round-5 advisory;
                # the reference requires fresh TrustOptions here).
                import logging

                if not self._trusted_hash and \
                        not self._insecure_allow_reroot:
                    raise LightProxyError(
                        f"persisted trust root at height "
                        f"{latest.height} is older than the trusting "
                        f"period and no --trusted-hash is pinned; "
                        f"refusing to re-root trust on the primary. "
                        f"Pin --trusted-height/--trusted-hash from an "
                        f"out-of-band source (or pass "
                        f"insecure_allow_reroot to accept the risk)."
                    )
                logging.getLogger(__name__).warning(
                    "light proxy: persisted trust root at height %d has "
                    "expired; re-bootstrapping from trust options",
                    latest.height,
                )
            if not self._trusted_hash:
                # trust-on-first-use: the primary picks the root — fine
                # for dev, a real deployment must pin the hash (the
                # reference REQUIRES TrustOptions for this reason)
                import logging

                logging.getLogger(__name__).warning(
                    "light proxy: NO --trusted-hash pinned; trusting "
                    "whatever the primary serves first (INSECURE against "
                    "a lying primary)"
                )
            h = self._trusted_height
            if h <= 0:
                h = int(self.http.status()["sync_info"]
                        ["latest_block_height"])
            lb = client.primary.light_block(h)
            got = lb.signed_header.header.hash()
            if self._trusted_hash and got != self._trusted_hash:
                raise LightProxyError(
                    f"trusted hash mismatch at height {h}: got "
                    f"{got.hex()}, want {self._trusted_hash.hex()}"
                )
            client.trust_light_block(lb)
            return client

    # -- verified routes (light/rpc/client.go) -----------------------------

    def commit(self, height=None):
        client = self._ensure_trust()  # one resolution per request
        if height is None:
            height = int(self.http.status()["sync_info"]
                         ["latest_block_height"])
        lb = client.verify_light_block_at_height(int(height))
        return {
            "signed_header": {
                "header": serde.header_to_j(lb.signed_header.header),
                "commit": serde.commit_to_j(lb.signed_header.commit),
            },
            "canonical": True,
            "verified": True,
        }

    def block(self, height=None):
        client = self._ensure_trust()
        if height is None:
            height = int(self.http.status()["sync_info"]
                         ["latest_block_height"])
        lb = client.verify_light_block_at_height(int(height))
        bj = self.http.block(int(height))
        block = serde.block_from_json(json.dumps(bj["block"]))
        if block.hash() != lb.signed_header.header.hash():
            raise LightProxyError(
                "primary returned a block that does not match the "
                "verified header"
            )
        bj["verified"] = True
        return bj

    def validators(self, height=None):
        client = self._ensure_trust()
        if height is None:
            height = int(self.http.status()["sync_info"]
                         ["latest_block_height"])
        lb = client.verify_light_block_at_height(int(height))
        return {
            "block_height": lb.height,
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": {"type": v.pub_key.key_type,
                                "value": v.pub_key.data.hex()},
                    "voting_power": v.voting_power,
                    "proposer_priority": v.proposer_priority,
                }
                for v in lb.validator_set.validators
            ],
            "verified": True,
        }

    def abci_query(self, path=None, data=None):
        """VERIFIED query (light/rpc/client.go:117 ABCIQueryWithOptions):
        the app must return a merkle proof, which is checked against the
        app_hash of the light-client-verified header at resp.height+1
        (the app hash for height H lands in header H+1). A missing or
        bad proof is an error, never silently-unverified data."""
        from cometbft_tpu_torch.crypto.proof_ops import (
            ProofError,
            ProofOp,
            default_runtime,
        )

        client = self._ensure_trust()
        resp = self.http.call("abci_query", path=path, data=data,
                              prove=True)["response"]
        if int(resp.get("code", 0)) != 0:
            return {"response": resp}  # app-level error; nothing to prove
        value = base64.b64decode(resp.get("value") or "")
        key = bytes.fromhex(resp.get("key") or "")
        ops_j = (resp.get("proof_ops") or {}).get("ops") or []
        if not value:
            raise LightProxyError(
                "proof of absence is not supported; empty result cannot "
                "be verified (light/rpc/client.go:168)"
            )
        if not ops_j:
            raise LightProxyError("primary returned no proof for query")
        h = int(resp.get("height") or 0)
        if h <= 0:
            raise LightProxyError("primary returned no proof height")
        # the app hash for height h lands in header h+1, which a live
        # chain produces within a block interval — wait briefly for
        # AVAILABILITY only; verification failures (a forged header)
        # must surface immediately, not be retried into a timeout
        from cometbft_tpu_torch.light.client import NoSuchBlockError

        lb = None
        deadline = time.time() + 10.0
        while True:
            try:
                lb = client.verify_light_block_at_height(h + 1)
                break
            except NoSuchBlockError:
                if time.time() > deadline:
                    raise LightProxyError(
                        f"header {h + 1} (carrying the queried app "
                        f"hash) never appeared"
                    )
                time.sleep(0.25)
        ops = [ProofOp.from_j(o) for o in ops_j]
        try:
            default_runtime().verify_value(
                ops, lb.signed_header.header.app_hash, key, value
            )
        except ProofError as e:
            raise LightProxyError(f"query proof verification failed: {e}")
        resp["verified"] = True
        return {"response": resp}

    def tx(self, hash, prove=None):
        """VERIFIED tx lookup (light/rpc/client.go Tx): the inclusion
        proof is validated against the verified header's data_hash."""
        from cometbft_tpu_torch.types.tx import TxProof

        client = self._ensure_trust()
        r = self.http.call("tx", hash=hash, prove=True)
        proof_j = r.get("proof")
        if not proof_j:
            raise LightProxyError("primary returned no tx proof")
        tp = TxProof.from_j(proof_j)
        lb = client.verify_light_block_at_height(int(r["height"]))
        if not tp.validate(lb.signed_header.header.data_hash):
            raise LightProxyError(
                "tx proof does not verify against the trusted header"
            )
        import hashlib as _hl

        if _hl.sha256(tp.data).hexdigest().upper() != hash.upper():
            raise LightProxyError("proof is for a different tx")
        r["verified"] = True
        return r

    def status(self):
        s = self.http.status()
        client = self.client
        latest = client.store.latest()
        s["light_client"] = {
            "trusted_height": latest.height if latest else 0,
            "witnesses": len(client.witnesses),
        }
        return s

    def health(self):
        return {}

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="light-proxy",
        )
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


_PROXY_ROUTES = ("health", "status", "block", "commit", "validators",
                 "abci_query", "tx")


class _ProxyHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet
        pass

    def _reply(self, result, rid=None, code: int = 200):
        body = json.dumps({
            "jsonrpc": "2.0", "id": rid, "result": result,
        }).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_error(self, code, msg, rid=None, http: int = 200):
        body = json.dumps({
            "jsonrpc": "2.0", "id": rid,
            "error": {"code": code, "message": msg},
        }).encode()
        self.send_response(http)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _dispatch(self, method: str, params: dict, rid):
        if method not in _PROXY_ROUTES:
            self._reply_error(-32601, f"method {method!r} not found", rid)
            return
        try:
            self._reply(getattr(self.server.proxy, method)(**params), rid)
        except TypeError as e:
            self._reply_error(-32602, f"invalid params: {e}", rid)
        except Exception as e:  # noqa: BLE001 - verification failures too
            self._reply_error(-32603, f"{e}", rid)

    def do_GET(self):
        url = urlparse(self.path)
        method = url.path.strip("/")
        params = dict(parse_qsl(url.query))
        self._dispatch(method, params, None)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(length).decode())
        except Exception:
            self._reply_error(-32700, "parse error")
            return
        if not isinstance(req, dict) or \
                not isinstance(req.get("params") or {}, dict):
            self._reply_error(-32600, "invalid request")
            return
        self._dispatch(req.get("method", ""), req.get("params") or {},
                       req.get("id"))
