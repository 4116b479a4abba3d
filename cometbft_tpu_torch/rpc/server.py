"""JSON-RPC server: HTTP POST/GET + WebSocket subscriptions.

Reference: rpc/jsonrpc/server (HTTP + WebSocket JSON-RPC 2.0),
rpc/core/routes.go:12-56 (route table: health, status, net_info,
blockchain, block, block_by_hash, commit, validators, genesis,
abci_info, abci_query, broadcast_tx_{sync,async,commit},
unconfirmed_txs, subscribe/unsubscribe), rpc/core/events.go
(subscriptions via the event bus).

Implementation: stdlib ThreadingHTTPServer; the WebSocket side is a
minimal RFC 6455 implementation (handshake + masked text frames) — no
external dependencies.

The port's copy of the JAX package's rpc/server.py: the same routes and
the same JSON (the `status` version string included), so a client cannot
tell the two packages' nodes apart on the wire. The routes that reach
the device go through the port's node: broadcast_tx_* and check_tx ride
the mempool's BULK lane, lightgate_* the gateway's lane, and
broadcast_evidence the evidence pool.
"""
from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qsl, urlparse

from cometbft_tpu_torch.types import serde
from cometbft_tpu_torch.types.event_bus import EVENT_TX, TX_HASH_KEY

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class RPCError(Exception):
    def __init__(self, code: int, message: str):
        self.code = code
        super().__init__(message)


# --------------------------------------------------------------------------
# route implementations (rpc/core/*)
# --------------------------------------------------------------------------


class Routes:
    """The rpccore.Environment analog: reads node internals."""

    def __init__(self, node):
        self.node = node

    # -- info ---------------------------------------------------------------

    def health(self):
        return {}

    def status(self):
        n = self.node
        latest = n.block_store.height()
        blk = n.block_store.load_block(latest) if latest else None
        pub = n.consensus.privval.pub_key() if n.consensus.privval else None
        return {
            "node_info": {
                "id": n.switch.node_key.node_id if n.switch else "",
                "network": n.consensus.state.chain_id,
                "version": "cometbft-tpu/0.3",
            },
            "sync_info": {
                "latest_block_height": latest,
                "latest_block_hash":
                    blk.hash().hex().upper() if blk else "",
                "latest_app_hash":
                    n.consensus.state.app_hash.hex().upper(),
                "catching_up": n.blocksync_engine.is_running()
                    if n.blocksync_engine else False,
            },
            "validator_info": {
                "address": pub.address().hex().upper() if pub else "",
                "pub_key": pub.data.hex() if pub else "",
                "voting_power": 0 if pub is None else next(
                    (v.voting_power
                     for v in n.consensus.state.validators.validators
                     if v.address == pub.address()), 0),
            },
        }

    def net_info(self):
        n = self.node
        peers = []
        if n.switch is not None:
            for p in n.switch.peers.values():
                peers.append({"node_id": p.peer_id})
        return {"listening": n.switch is not None,
                "n_peers": len(peers), "peers": peers}

    def _genesis_doc(self) -> dict:
        st = self.node.consensus.state
        doc = getattr(self.node, "genesis_doc", None)
        if doc:
            return doc
        return {"chain_id": st.chain_id,
                "initial_height": st.initial_height}

    def genesis(self):
        return {"genesis": self._genesis_doc()}

    GENESIS_CHUNK = 16 * 1024

    def genesis_chunked(self, chunk=None):
        """rpc/core/blocks.go GenesisChunked: base64 16KiB slices for
        genesis docs too big for one response."""
        blob = json.dumps(self._genesis_doc()).encode()
        n = max(1, -(-len(blob) // self.GENESIS_CHUNK))
        i = int(chunk) if chunk is not None else 0
        if not 0 <= i < n:
            raise RPCError(-32603, f"chunk {i} out of range (total {n})")
        part = blob[i * self.GENESIS_CHUNK:(i + 1) * self.GENESIS_CHUNK]
        return {"chunk": i, "total": n,
                "data": base64.b64encode(part).decode()}

    def consensus_params(self, height=None):
        """rpc/core/consensus.go ConsensusParams (historical via the
        state store's params history)."""
        h = self._height_arg(height)
        p = None
        if hasattr(self.node.state_store, "load_consensus_params"):
            p = self.node.state_store.load_consensus_params(h)
        if p is None:
            if height is not None:
                raise RPCError(
                    -32603, f"no consensus params recorded for {h}"
                )
            p = self.node.consensus.state.consensus_params
        return {"block_height": h, "consensus_params": p.to_j()}

    def consensus_state(self):
        """rpc/core/consensus.go GetConsensusState (the operator's
        round-progress view)."""
        return {"round_state": self.node.consensus.round_state_json()}

    def dump_consensus_state(self):
        """rpc/core/consensus.go DumpConsensusState: full round state +
        per-peer consensus positions."""
        peers = []
        cr = getattr(self.node, "consensus_reactor", None)
        if cr is not None:
            for peer, ps in list(cr._peer_states.items()):
                peers.append({
                    "node_id": getattr(peer, "peer_id", ""),
                    "height": ps.height,
                    "round": ps.round,
                    "step": ps.step,
                })
        return {"round_state": self.node.consensus.round_state_json(),
                "peers": peers}

    # -- blocks -------------------------------------------------------------

    def _height_arg(self, height) -> int:
        latest = self.node.block_store.height()
        if height is None or height == "":
            return latest
        h = int(height)
        if h <= 0 or h > latest:
            raise RPCError(-32603, f"height {h} not available "
                                   f"(latest {latest})")
        return h

    def block(self, height=None):
        h = self._height_arg(height)
        blk = self.node.block_store.load_block(h)
        if blk is None:
            raise RPCError(-32603, f"no block at height {h}")
        return {"block_id": serde.bid_to_j(blk.block_id()),
                "block": json.loads(serde.block_to_json(blk))}

    def block_by_hash(self, hash):
        blk = self.node.block_store.load_block_by_hash(bytes.fromhex(hash))
        if blk is None:
            raise RPCError(-32603, "block not found")
        return {"block_id": serde.bid_to_j(blk.block_id()),
                "block": json.loads(serde.block_to_json(blk))}

    def blockchain(self, min_height=None, max_height=None):
        latest = self.node.block_store.height()
        maxh = int(max_height) if max_height else latest
        minh = int(min_height) if min_height else max(1, maxh - 19)
        metas = []
        for h in range(min(maxh, latest), max(minh, 1) - 1, -1):
            blk = self.node.block_store.load_block(h)
            if blk is None:
                continue
            metas.append({
                "block_id": serde.bid_to_j(blk.block_id()),
                "header": serde.header_to_j(blk.header),
                "num_txs": len(blk.data.txs),
            })
        return {"last_height": latest, "block_metas": metas}

    def header(self, height=None):
        """rpc/core/blocks.go Header."""
        h = self._height_arg(height)
        blk = self.node.block_store.load_block(h)
        if blk is None:
            raise RPCError(-32603, f"no block at height {h}")
        return {"header": serde.header_to_j(blk.header)}

    def header_by_hash(self, hash):
        blk = self.node.block_store.load_block_by_hash(bytes.fromhex(hash))
        if blk is None:
            raise RPCError(-32603, "block not found")
        return {"header": serde.header_to_j(blk.header)}

    def block_results(self, height=None):
        """rpc/core/blocks.go BlockResults: the stored FinalizeBlock
        outcome for a height (state.Store.LoadFinalizeBlockResponse)."""
        h = self._height_arg(height)
        doc = self.node.state_store.load_abci_responses(h)
        if doc is None:
            raise RPCError(-32603, f"no results for height {h}")
        return {
            "height": h,
            "txs_results": doc.get("tx_results", []),
            "validator_updates": doc.get("validator_updates", []),
            "app_hash": doc.get("app_hash", ""),
            "finalize_block_events": doc.get("events", {}),
        }

    def commit(self, height=None):
        h = self._height_arg(height)
        blk = self.node.block_store.load_block(h)
        commit = self.node.block_store.load_seen_commit(h) or \
            self.node.block_store.load_block_commit(h)
        if blk is None or commit is None:
            raise RPCError(-32603, f"no commit at height {h}")
        return {
            "signed_header": {
                "header": serde.header_to_j(blk.header),
                "commit": serde.commit_to_j(commit),
            },
            "canonical": True,
        }

    @staticmethod
    def _paginate(items, page, per_page, max_per_page: int = 100):
        """rpc/core/env.go validatePage/validatePerPage semantics."""
        per = int(per_page) if per_page else 30
        per = max(1, min(per, max_per_page))
        total_pages = max(1, -(-len(items) // per))
        pg = int(page) if page else 1
        if not 1 <= pg <= total_pages:
            raise RPCError(
                -32603, f"page {pg} out of range [1, {total_pages}]"
            )
        return items[(pg - 1) * per: pg * per]

    def validators(self, height=None, page=None, per_page=None):
        h = self._height_arg(height)
        vals = self.node.state_store.load_validators(h)
        if vals is None:
            raise RPCError(-32603, f"no validator set at height {h}")
        window = self._paginate(vals.validators, page, per_page)
        return {
            "block_height": h,
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": {"type": v.pub_key.key_type,
                                "value": v.pub_key.data.hex()},
                    "voting_power": v.voting_power,
                    "proposer_priority": v.proposer_priority,
                }
                for v in window
            ],
            "count": len(window),
            "total": len(vals.validators),
        }

    # -- ABCI ---------------------------------------------------------------

    def abci_info(self):
        from cometbft_tpu_torch.abci import types as abci

        info = self.node.app_conns.query.info(abci.RequestInfo())
        return {"response": {
            "data": info.data,
            "last_block_height": info.last_block_height,
            "last_block_app_hash": info.last_block_app_hash.hex(),
        }}

    def abci_query(self, path=None, data=None, height=None, prove=None):
        from cometbft_tpu_torch.abci import types as abci

        want_proof = prove in (True, "true", "1", 1)
        if isinstance(data, str) and data.startswith("0x"):
            data = data[2:]  # URI form carries 0x-prefixed hex
        resp = self.node.app_conns.query.query(abci.RequestQuery(
            data=bytes.fromhex(data) if data else b"",
            path=path or "",
            height=int(height) if height else 0,
            prove=want_proof,
        ))
        out = {
            "code": resp.code,
            "key": resp.key.hex() if resp.key else "",
            "value": base64.b64encode(resp.value).decode()
            if resp.value else "",
            "height": resp.height,
            "log": resp.log,
        }
        if getattr(resp, "proof_ops", None):
            out["proof_ops"] = {"ops": [
                op.to_j() if hasattr(op, "to_j") else op
                for op in resp.proof_ops
            ]}
        return {"response": out}

    def check_tx(self, tx):
        """rpc/core/mempool.go CheckTx: run CheckTx WITHOUT adding the
        tx to the mempool (dry-run validity probe)."""
        from cometbft_tpu_torch.abci import types as abci

        raw = self._decode_tx(tx)
        # route through the mempool connection (rpc/core/mempool.go uses
        # mempool.CheckTx): stateful apps keep check-state there, so the
        # query conn would answer from stale sequence state
        resp = self.node.app_conns.mempool.check_tx(
            abci.RequestCheckTx(tx=raw)
        )
        return {"code": resp.code, "log": resp.log,
                "gas_wanted": getattr(resp, "gas_wanted", 0)}

    def broadcast_evidence(self, evidence):
        """rpc/core/evidence.go BroadcastEvidence: submit duplicate-vote
        or light-client-attack evidence found out-of-band."""
        from cometbft_tpu_torch.types.evidence import evidence_from_j

        if self.node.evidence_pool is None:
            raise RPCError(-32603, "node has no evidence pool")
        try:
            ev = evidence_from_j(
                evidence if isinstance(evidence, dict)
                else json.loads(evidence)
            )
        except Exception as e:  # noqa: BLE001 - operator input
            raise RPCError(-32602, f"malformed evidence: {e}")
        self.node.evidence_pool.add_evidence(ev)
        return {"hash": ev.hash().hex().upper()}

    # -- txs ----------------------------------------------------------------

    def _decode_tx(self, tx) -> bytes:
        # reference rule: JSON-RPC carries tx as base64; the URI form
        # takes 0x-prefixed hex. Guessing (try-base64-then-hex) garbles
        # even-length hex strings, which are also valid base64.
        if isinstance(tx, str) and tx.startswith("0x"):
            return bytes.fromhex(tx[2:])
        return base64.b64decode(tx)

    @staticmethod
    def _with_retry_hint(out: dict, resp) -> dict:
        """Surface the node's explicit overload verdict as a
        machine-readable Retry-After analog: OVERLOADED CheckTx
        responses carry the structured ResponseCheckTx.retry_after_ms
        (the log repeats it for humans); lift it into the JSON-RPC
        response so clients back off without parsing log strings."""
        from cometbft_tpu_torch.abci import types as abci

        if resp.code == abci.CODE_TYPE_OVERLOADED:
            out["retry_after_ms"] = (
                getattr(resp, "retry_after_ms", 0.0) or 1000.0)
        return out

    def broadcast_tx_sync(self, tx):
        raw = self._decode_tx(tx)
        resp = self.node.broadcast_tx(raw)
        return self._with_retry_hint(
            {"code": resp.code, "data": "", "log": resp.log,
             "hash": hashlib.sha256(raw).hexdigest().upper()}, resp)

    def broadcast_tx_async(self, tx):
        """Returns without waiting for a CheckTx RESULT, but the submit
        itself runs on this thread — a node that refuses txs outright
        (read-only inspect server, admission fast-reject) must not hand
        back phantom success."""
        raw = self._decode_tx(tx)
        resp = self.node.broadcast_tx(raw)
        return self._with_retry_hint(
            {"code": resp.code, "data": "", "log": resp.log,
             "hash": hashlib.sha256(raw).hexdigest().upper()}, resp)

    def broadcast_tx_commit(self, tx, timeout: float = 30.0):
        """CheckTx, then wait for the tx's DeliverTx event
        (rpc/core/mempool.go BroadcastTxCommit)."""
        raw = self._decode_tx(tx)
        txhash = hashlib.sha256(raw).hexdigest().upper()
        subscriber = f"btc-{txhash}-{time.time()}"
        sub = self.node.event_bus.subscribe(
            subscriber, f"{TX_HASH_KEY}='{txhash}'"
        )
        try:
            check = self.node.broadcast_tx(raw)
            if check.code != 0:
                return self._with_retry_hint(
                    {"check_tx": {"code": check.code, "log": check.log},
                     "deliver_tx": {}, "hash": txhash, "height": 0},
                    check)
            msg = sub.next(timeout=timeout)
            if msg is None:
                raise RPCError(-32603, "timed out waiting for tx commit")
            data = msg.data
            return {
                "check_tx": {"code": check.code, "log": check.log},
                "tx_result": {"code": data["result"].code,
                              "log": data["result"].log},
                "hash": txhash,
                "height": data["height"],
            }
        finally:
            self.node.event_bus.pubsub.unsubscribe_all(subscriber)

    def tx(self, hash, prove=None):
        """rpc/core/tx.go Tx: look up a committed tx by hash; with
        prove=true, attach the merkle inclusion proof against the
        block's data_hash (types/tx.go Txs.Proof)."""
        item = self.node.tx_indexer.get(bytes.fromhex(hash))
        if item is None:
            raise RPCError(-32603, f"tx {hash} not found")
        out = {
            "hash": item["hash"].hex().upper(),
            "height": item["height"],
            "index": item["index"],
            "tx": base64.b64encode(item["tx"]).decode(),
            "tx_result": {"code": item["code"],
                          "data": base64.b64encode(item["data"]).decode()
                          if item["data"] else "",
                          "log": item["log"]},
        }
        if prove in (True, "true", "1", 1):
            from cometbft_tpu_torch.types.tx import tx_proof

            blk = self.node.block_store.load_block(item["height"])
            if blk is None:
                raise RPCError(-32603, "block pruned; no proof")
            out["proof"] = tx_proof(blk.data.txs, item["index"]).to_j()
        return out

    def tx_search(self, query, limit=None, page=None, per_page=None,
                  order_by=None):
        """rpc/core/tx.go TxSearch over the event index, paginated."""
        if limit and not per_page:  # legacy param form
            per_page = limit
        order = "desc" if order_by == "desc" else "asc"
        try:
            total, items = self.node.tx_indexer.search_paged(
                query, page=int(page) if page else 1,
                per_page=int(per_page) if per_page else 30, order=order,
            )
        except ValueError as e:
            raise RPCError(-32603, str(e))
        return {
            "total_count": total,
            "txs": [
                {
                    "hash": it["hash"].hex().upper(),
                    "height": it["height"],
                    "index": it["index"],
                    "tx": base64.b64encode(it["tx"]).decode(),
                    "tx_result": {"code": it["code"], "log": it["log"]},
                }
                for it in items
            ],
        }

    def block_search(self, query, limit=None, page=None, per_page=None,
                     order_by=None):
        """rpc/core/blocks.go BlockSearch over the block-event index."""
        heights = self.node.block_indexer.search(
            query, int(limit) if limit else 10_000
        )
        if order_by == "desc":
            heights = list(reversed(heights))
        # drop heights whose blocks have been pruned BEFORE paginating,
        # so total_count matches what's retrievable and pages don't come
        # back silently short
        bs = self.node.block_store
        lo, hi = bs.base(), bs.height()
        heights = [h for h in heights if lo <= h <= hi]
        total = len(heights)
        window = self._paginate(heights, page, per_page)
        blocks = []
        for h in window:
            blk = self.node.block_store.load_block(h)
            if blk is not None:
                blocks.append({
                    "block_id": serde.bid_to_j(blk.block_id()),
                    "block": json.loads(serde.block_to_json(blk)),
                })
        return {"total_count": total, "blocks": blocks}

    def unconfirmed_txs(self, limit=None):
        txs = self.node.mempool.reap(-1)
        lim = int(limit) if limit else 30
        return {"n_txs": len(txs), "total": len(txs),
                "txs": [base64.b64encode(t).decode() for t in txs[:lim]]}

    def num_unconfirmed_txs(self):
        txs = self.node.mempool.reap(-1)
        return {"n_txs": len(txs), "total": len(txs)}

    # -- unsafe ops routes (rpc/core/routes.go:58-63, behind the
    # config's `unsafe` flag like the reference's --rpc.unsafe) --------------

    def _addrs_arg(self, lst):
        from cometbft_tpu_torch.p2p.key import NetAddress

        out = []
        for s in lst:
            nid, _, hostport = s.partition("@")
            host, _, port = hostport.rpartition(":")
            out.append(NetAddress(nid, host or "127.0.0.1", int(port)))
        return out

    def dial_seeds(self, seeds=None):
        """rpc/core/net.go UnsafeDialSeeds."""
        if self.node.switch is None:
            raise RPCError(-32603, "p2p is disabled")
        if isinstance(seeds, str):
            seeds = json.loads(seeds)
        for a in self._addrs_arg(seeds or []):
            # operator-supplied seeds are protected in the address book:
            # dial failures back them off but can never evict them
            book = getattr(self.node, "addr_book", None)
            if book is not None:
                book.add(a, seed=True)
            self.node.switch.dial_peer(a, persistent=False)
        return {"log": f"dialing seeds in progress: {seeds}"}

    def dial_peers(self, peers=None, persistent=False,
                   unconditional=False, private=False):
        """rpc/core/net.go UnsafeDialPeers. This switch has no
        unconditional/private peer classes (no peer-count eviction,
        and PEX gossips only book entries, not live peers), so those
        flags are accepted for API parity and reported as no-ops."""
        if self.node.switch is None:
            raise RPCError(-32603, "p2p is disabled")
        if isinstance(peers, str):
            peers = json.loads(peers)
        if isinstance(persistent, str):
            persistent = persistent.lower() == "true"
        for a in self._addrs_arg(peers or []):
            self.node.switch.dial_peer(a, persistent=bool(persistent))
        log = f"dialing peers in progress: {peers}"
        if unconditional or private:
            log += " (unconditional/private are no-ops here)"
        return {"log": log}

    def unsafe_flush_mempool(self):
        """rpc/core/mempool.go UnsafeFlushMempool."""
        self.node.mempool.flush()
        return {}

    # -- tracing (libs/tracing.py; also served as GET /dump_traces) ---------

    def dump_traces(self):
        """The current trace ring as Chrome trace-event JSON (empty
        when tracing is disabled). Save the result to a file and load
        it in https://ui.perfetto.dev — or curl the /dump_traces GET
        path, which serves the document directly."""
        from cometbft_tpu_torch.libs import tracing

        return tracing.export_chrome()

    def dump_flushes(self):
        """The verify plane's always-on flush ledger: per-flush stage
        costs + percentile summary (also served as GET /dump_flushes).
        Unlike /dump_traces this needs no knob — the ledger records
        every flush, and survives the plane being stopped."""
        from cometbft_tpu_torch import verifyplane

        plane = getattr(self.node, "verify_plane", None)
        if plane is not None:
            return plane.dump_flushes()
        return verifyplane.dump_flushes()

    def dump_heights(self):
        """The consensus height ledger: per-height commit-latency
        stage timeline, verify-plane join, and late-signer attribution
        (also served as GET /dump_heights). Always on like the flush
        ledger, and survives the consensus engine stopping — the
        module-global _LAST fallback serves post-mortem reads."""
        from cometbft_tpu_torch.consensus import heightledger

        cs = getattr(self.node, "consensus", None)
        led = getattr(cs, "height_ledger", None)
        if led is not None:
            return led.dump()
        return heightledger.dump_heights()

    def dump_incidents(self):
        """The incident flight recorder's frozen snapshots (also GET
        /dump_incidents): what tripped the watchdog (commit stall,
        round escalation, breaker flap, shed storm, peer starvation),
        with the height/flush/peer/trace tails and counter sample
        frozen AT trigger time."""
        from cometbft_tpu_torch.libs import incidents

        return incidents.dump_incidents()

    def dump_peers(self):
        """The gossip observatory (p2p/peerledger.py): per-peer traffic
        ledger — msgs/bytes per channel, send-queue depth/high-water,
        blocked puts, full-queue drops, throttle stalls, ping RTT,
        injected-fault attribution, lifecycle events, and the vote
        first-seen/relay counters (also served as GET /dump_peers).
        Always on like the flush and height ledgers; the module _LAST
        fallback serves post-mortem reads after the switch stopped."""
        from cometbft_tpu_torch.p2p import peerledger

        sw = getattr(self.node, "switch", None)
        led = getattr(sw, "peer_ledger", None)
        if led is not None:
            return led.dump()
        return peerledger.dump_peers()

    def dump_devices(self):
        """The device observatory (libs/deviceledger.py): the compile
        ledger (every kernel build with site/flush attribution
        and the steady-state flag), per-family/per-device HBM
        residency with headroom against the 65536-slot table budget,
        the exact-accounting cross-check, and the flush ledger's
        device-time summary (also served as GET /dump_devices). The
        ledger is process-global and always on — history survives the
        node stopping, like every other dump route."""
        from cometbft_tpu_torch.libs import deviceledger

        return deviceledger.dump_devices()

    def dump_controller(self):
        """The self-tuning control plane's decision ledger
        (libs/controller.py): every actuator move with its trigger
        sensor readings, the current/base/clamp value of every
        actuator, and the SLO + loop state (also served as GET
        /dump_controller). Prefers this node's mounted controller;
        falls back to the module global/_LAST so post-mortem reads
        work after the node stopped."""
        from cometbft_tpu_torch.libs import controller as controlplane

        ctl = getattr(self.node, "controller", None)
        if ctl is not None:
            return ctl.dump()
        return controlplane.dump_controller()

    def dump_tenants(self):
        """The multi-tenant verify plane's tenancy registry
        (verifyplane/tenants.py): registered chains with their
        pending-row quotas and HBM residency budgets, per-tenant
        rows/sheds per lane, warm skips, cold evictions, wait
        percentiles, live residency attribution, and the retired
        totals accumulator (also served as GET /dump_tenants). Serves
        the LAST plane's registry after a stop, like every other dump
        route."""
        from cometbft_tpu_torch.verifyplane import tenants as vtenants

        return vtenants.dump_tenants()

    def dump_catchup(self):
        """The catch-up firehose's always-on ledger
        (blocksync/catchup.py): one record per fused verify+apply
        flush — heights covered, signatures verified, read/verify/
        apply time, valset-boundary and warm-ahead flags, resume-skip
        counts — plus the cumulative counters and a windowed
        blocks/sec + sigs/sec summary (also served as GET
        /dump_catchup). The _LAST fallback serves post-mortem reads
        after the replay finished, like every other dump route."""
        from cometbft_tpu_torch.blocksync import catchup

        return catchup.dump_catchup()

    # -- light-client gateway (cometbft_tpu_torch.lightgate; config
    # [lightgate] mounts it on the node) -------------------------------------

    def _gateway(self):
        gw = getattr(self.node, "lightgate", None)
        if gw is None:
            raise RPCError(
                -32601, "no light-client gateway mounted (enable it "
                        "with [lightgate] enable = true)"
            )
        return gw

    def lightgate_verify(self, trusted_height, target_height,
                         trusted_hash=None, claimed=None,
                         with_validators=None):
        """Coalesced skipping verification on behalf of a light
        client: verify `target_height` from the client's
        `trusted_height` (optionally hash-pinned). `claimed` may carry
        the signed header the client's OWN primary served it
        ({"header": .., "commit": ..}); a divergent claim yields a
        "divergent" verdict and drives LightClientAttackEvidence into
        the node's evidence pool. Overload is an explicit verdict:
        {"status": "overloaded", "retry_after_ms": ...} — never a
        silent drop."""
        from cometbft_tpu_torch.light.client import NoSuchBlockError
        from cometbft_tpu_torch.light.verifier import LightClientError
        from cometbft_tpu_torch.lightgate import GatewayError, GatewayOverloaded

        gw = self._gateway()
        if isinstance(claimed, str):
            claimed = json.loads(claimed)
        pin = bytes.fromhex(trusted_hash) if trusted_hash else None
        try:
            return gw.verify(
                int(trusted_height), int(target_height),
                trusted_hash=pin, claimed=claimed,
                with_validators=with_validators in (True, "true", "1", 1),
            )
        except GatewayOverloaded as e:
            return {"status": "overloaded",
                    "retry_after_ms": e.retry_after_ms,
                    "log": str(e)}
        except NoSuchBlockError as e:
            raise RPCError(-32603, str(e))
        except (GatewayError, LightClientError) as e:
            raise RPCError(-32603, f"lightgate: {e}")

    def lightgate_headers(self, heights=None, min_height=None,
                          max_height=None, with_validators=None):
        """Batched signed-header serving: either an explicit `heights`
        list (JSON array, or comma-separated in the URI form) or a
        [min_height, max_height] range, capped at the gateway's
        max_batch_headers per call."""
        gw = self._gateway()
        if isinstance(heights, str):
            heights = [int(h) for h in heights.split(",") if h.strip()]
        if heights is None:
            if min_height is None or max_height is None:
                raise RPCError(
                    -32602, "pass heights=[...] or min_height+max_height"
                )
            lo, hi = int(min_height), int(max_height)
            if hi < lo:
                raise RPCError(-32602, "max_height < min_height")
            # clamp BEFORE materializing: a client-controlled range
            # must never allocate beyond the serving cap (the
            # `blockchain` route clamps for the same reason)
            hi = min(hi, lo + gw.max_batch_headers - 1)
            heights = list(range(lo, hi + 1))
        return gw.headers(
            heights,
            with_validators=with_validators in (True, "true", "1", 1),
        )

    def lightgate_status(self):
        """Gateway serving stats: coalescer/cache counters, trusted-
        store span, in-flight verifications (scrape-safe)."""
        return self._gateway().stats()


_ROUTES = [
    "health", "status", "net_info", "genesis", "genesis_chunked",
    "block", "block_by_hash", "block_results", "header",
    "header_by_hash", "blockchain", "commit", "validators",
    "consensus_params", "consensus_state", "dump_consensus_state",
    "abci_info", "abci_query", "check_tx", "broadcast_evidence",
    "broadcast_tx_sync", "broadcast_tx_async", "broadcast_tx_commit",
    "unconfirmed_txs", "num_unconfirmed_txs", "tx", "tx_search",
    "block_search", "dump_traces", "dump_flushes", "dump_heights",
    "dump_incidents", "dump_peers", "dump_devices", "dump_controller",
    "dump_tenants", "dump_catchup",
    "lightgate_verify", "lightgate_headers", "lightgate_status",
]

# only served when the server runs with unsafe=True
# (routes.go:58-63 AddUnsafeRoutes)
_UNSAFE_ROUTES = ["dial_seeds", "dial_peers", "unsafe_flush_mempool"]


# --------------------------------------------------------------------------
# HTTP + WebSocket plumbing
# --------------------------------------------------------------------------


def _event_to_json(msg):
    """Render a pubsub Message for the wire."""
    data = msg.data
    out = {}
    if isinstance(data, dict):
        for k, v in data.items():
            if hasattr(v, "hash") and hasattr(v, "header"):  # Block
                out[k] = json.loads(serde.block_to_json(v))
            elif hasattr(v, "chain_id") and hasattr(v, "height"):  # Header
                out[k] = serde.header_to_j(v)
            elif isinstance(v, bytes):
                out[k] = base64.b64encode(v).decode()
            elif hasattr(v, "__dict__"):
                out[k] = {a: (b.hex() if isinstance(b, bytes) else b)
                          for a, b in vars(v).items()
                          if isinstance(b, (int, str, bytes, float))}
            else:
                out[k] = v
    return {"query": None, "data": out,
            "events": {k: v for k, v in msg.tags.items()}}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "cometbft-tpu-rpc"

    def log_message(self, fmt, *args):  # quiet
        pass

    @property
    def routes(self) -> Routes:
        return self.server.routes  # type: ignore[attr-defined]

    def _send_json(self, obj) -> None:
        """Serve a bare JSON document (the GET dump endpoints — no
        JSON-RPC envelope)."""
        body = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply(self, obj, rid=None):
        body = json.dumps(
            {"jsonrpc": "2.0", "id": rid, "result": obj}
        ).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_error(self, code, message, rid=None, http=200):
        body = json.dumps({
            "jsonrpc": "2.0", "id": rid,
            "error": {"code": code, "message": message},
        }).encode()
        self.send_response(http)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _call(self, method: str, params: dict, rid):
        unsafe_on = getattr(self.server, "unsafe", False)
        if method in _UNSAFE_ROUTES and not unsafe_on:
            self._reply_error(
                -32601,
                f"{method!r} requires the RPC server's unsafe flag "
                f"(rpc/core/routes.go AddUnsafeRoutes)", rid,
            )
            return
        if method not in _ROUTES and method not in _UNSAFE_ROUTES:
            self._reply_error(-32601, f"method {method!r} not found", rid)
            return
        try:
            result = getattr(self.routes, method)(**(params or {}))
            self._reply(result, rid)
        except RPCError as e:
            self._reply_error(e.code, str(e), rid)
        except TypeError as e:
            self._reply_error(-32602, f"invalid params: {e}", rid)
        except Exception as e:  # noqa: BLE001
            self._reply_error(-32603, f"internal error: {e}", rid)

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/websocket":
            self._websocket()
            return
        if url.path == "/metrics":
            # prometheus text exposition (node/node.go:846 analog)
            m = getattr(self.routes.node, "metrics", None)
            body = (m.expose_text() if m else "").encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        # observability dumps served as bare GET paths (the curl
        # surface next to /metrics): traces (perfetto-loadable),
        # the always-on flush/height ledgers, incident snapshots
        if url.path in ("/dump_traces", "/dump_flushes",
                        "/dump_heights", "/dump_incidents",
                        "/dump_peers", "/dump_devices",
                        "/dump_controller", "/dump_tenants",
                        "/dump_catchup"):
            self._send_json(getattr(self.routes, url.path[1:])())
            return
        if url.path.startswith("/debug/pprof"):
            # profiling endpoints (node/node.go:867-881 pprof server +
            # rpc/core/dev.go unsafe profiling): Python analogs —
            # thread stack dump, CPU profile, heap profile. Gated by
            # the same unsafe flag as the ops routes.
            if not getattr(self.server, "unsafe", False):
                self._reply_error(
                    -32601, "profiling requires the unsafe flag",
                    http=403)
                return
            self._pprof(url)
            return
        method = url.path.strip("/")
        params = dict(parse_qsl(url.query))
        # URI params arrive quoted like the reference's URI form
        params = {k: v.strip('"') for k, v in params.items()}
        self._call(method, params, -1)

    def _pprof(self, url):
        import io
        from urllib.parse import parse_qsl as _pq

        q = dict(_pq(url.query))
        kind = url.path[len("/debug/pprof"):].strip("/") or "index"
        body = b""
        if kind in ("goroutine", "threads", "stacks"):
            import sys as _sys
            import traceback

            buf = io.StringIO()
            frames = _sys._current_frames()
            for t in threading.enumerate():
                buf.write(f"thread {t.name} (daemon={t.daemon})\n")
                fr = frames.get(t.ident)
                if fr:
                    traceback.print_stack(fr, file=buf)
                buf.write("\n")
            body = buf.getvalue().encode()
        elif kind == "profile":
            seconds = min(float(q.get("seconds", 2)), 30.0)
            # statistical whole-process sampler: walk every thread's
            # stack via sys._current_frames at ~100 Hz for the window
            # (cProfile can only instrument frames its own thread
            # enters — useless here; Go's pprof is signal-based for
            # the same reason)
            import sys as _sys
            from collections import Counter

            samples: Counter = Counter()
            deadline = time.monotonic() + seconds
            nsamp = 0
            me = threading.get_ident()
            while time.monotonic() < deadline:
                for tid, fr in _sys._current_frames().items():
                    if tid == me:
                        continue
                    co = fr.f_code
                    # co_qualname is 3.11+; this image runs 3.10
                    qn = getattr(co, "co_qualname", co.co_name)
                    samples[f"{qn} "
                            f"({co.co_filename.rsplit('/', 1)[-1]}:"
                            f"{fr.f_lineno})"] += 1
                nsamp += 1
                time.sleep(0.01)
            buf = io.StringIO()
            buf.write(f"statistical profile: {nsamp} samples over "
                      f"{seconds}s, all threads, innermost frame\n")
            for loc, cnt in samples.most_common(60):
                buf.write(f"{cnt / max(nsamp, 1) * 100:6.1f}%  {loc}\n")
            body = buf.getvalue().encode()
        elif kind == "heap":
            import tracemalloc

            trace = q.get("trace", "")
            if trace == "start" and not tracemalloc.is_tracing():
                tracemalloc.start()
                body = b"tracemalloc tracing started\n"
            elif trace == "stop" and tracemalloc.is_tracing():
                tracemalloc.stop()
                body = b"tracemalloc tracing stopped\n"
            elif tracemalloc.is_tracing():
                snap = tracemalloc.take_snapshot()
                buf = io.StringIO()
                for st in snap.statistics("lineno")[:60]:
                    buf.write(f"{st}\n")
                body = buf.getvalue().encode()
            else:
                # one-shot heap overview with NO standing overhead:
                # object counts by type (tracemalloc only sees allocs
                # made after start(), so a first-call start would hand
                # incident collectors an empty snapshot while taxing
                # the node forever; opt in via ?trace=start)
                import gc
                from collections import Counter

                counts = Counter(type(o).__name__
                                 for o in gc.get_objects())
                buf = io.StringIO()
                buf.write("live objects by type (gc view; pass "
                          "?trace=start for tracemalloc)\n")
                for name, cnt in counts.most_common(60):
                    buf.write(f"{cnt:10d}  {name}\n")
                body = buf.getvalue().encode()
        else:
            body = (b"pprof-analog endpoints: /debug/pprof/goroutine "
                    b"/debug/pprof/profile?seconds=N /debug/pprof/heap\n")
        self.send_response(200)
        self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(length).decode())
        except Exception:
            self._reply_error(-32700, "parse error")
            return
        if not isinstance(req, dict):
            # fuzz finding: a JSON array/scalar body crashed the handler
            # thread on req.get — JSON-RPC requires an object
            self._reply_error(-32600, "invalid request")
            return
        params = req.get("params") or {}
        if not isinstance(params, dict):
            self._reply_error(-32600, "params must be an object")
            return
        self._call(req.get("method", ""), params, req.get("id"))

    # -- WebSocket (RFC 6455 minimal) --------------------------------------

    def _websocket(self):
        key = self.headers.get("Sec-WebSocket-Key")
        if not key:
            self._reply_error(-32600, "not a websocket request", http=400)
            return
        accept = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        self.send_response(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", accept)
        self.end_headers()
        conn = self.connection
        conn.settimeout(0.2)
        subscriber = f"ws-{id(self)}"
        subs = []
        bus = self.server.routes.node.event_bus  # type: ignore
        try:
            while not self.server.stopping:  # type: ignore
                frame = self._ws_read(conn)
                if frame is _CLOSED:
                    break
                if frame is not None:
                    try:
                        req = json.loads(frame)
                        method = req.get("method")
                        params = req.get("params") or {}
                        if method == "subscribe":
                            q = params.get("query", "")
                            sub = bus.subscribe(subscriber, q)
                            subs.append(sub)
                            self._ws_send(conn, json.dumps({
                                "jsonrpc": "2.0", "id": req.get("id"),
                                "result": {},
                            }))
                        elif method == "unsubscribe_all":
                            bus.unsubscribe_all(subscriber)
                            subs.clear()
                            self._ws_send(conn, json.dumps({
                                "jsonrpc": "2.0", "id": req.get("id"),
                                "result": {},
                            }))
                        else:
                            self._ws_send(conn, json.dumps({
                                "jsonrpc": "2.0", "id": req.get("id"),
                                "error": {"code": -32601,
                                          "message": "unknown ws method"},
                            }))
                    except Exception as e:  # noqa: BLE001
                        self._ws_send(conn, json.dumps({
                            "jsonrpc": "2.0", "id": None,
                            "error": {"code": -32700, "message": str(e)},
                        }))
                for sub in subs:
                    msg = sub.next(timeout=0)
                    while msg is not None:
                        self._ws_send(conn, json.dumps({
                            "jsonrpc": "2.0", "id": -1,
                            "result": _event_to_json(msg),
                        }))
                        msg = sub.next(timeout=0)
        finally:
            bus.unsubscribe_all(subscriber)

    def _ws_read(self, conn):
        try:
            hdr = self._recv_exact(conn, 2)
        except socket.timeout:
            return None
        except OSError:
            return _CLOSED
        if hdr is None:
            return _CLOSED
        opcode = hdr[0] & 0x0F
        masked = hdr[1] & 0x80
        ln = hdr[1] & 0x7F
        if ln == 126:
            ln = struct.unpack(">H", self._recv_exact(conn, 2))[0]
        elif ln == 127:
            ln = struct.unpack(">Q", self._recv_exact(conn, 8))[0]
        mask = self._recv_exact(conn, 4) if masked else b"\x00" * 4
        data = self._recv_exact(conn, ln) if ln else b""
        if masked and data:
            data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        if opcode == 0x8:  # close
            return _CLOSED
        if opcode in (0x1, 0x2):
            return data.decode()
        return None  # ping/pong/continuation ignored

    @staticmethod
    def _recv_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    @staticmethod
    def _ws_send(conn, text: str):
        data = text.encode()
        hdr = bytes([0x81])
        n = len(data)
        if n < 126:
            hdr += bytes([n])
        elif n < 65536:
            hdr += bytes([126]) + struct.pack(">H", n)
        else:
            hdr += bytes([127]) + struct.pack(">Q", n)
        conn.sendall(hdr + data)


_CLOSED = object()


class RPCServer:
    """rpc/jsonrpc server lifecycle wrapper."""

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0,
                 unsafe: bool = False):
        self.node = node
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.routes = Routes(node)  # type: ignore[attr-defined]
        # serves dial_seeds/dial_peers/unsafe_flush_mempool + the
        # /debug/pprof endpoints (routes.go:58 AddUnsafeRoutes,
        # rpc/core/dev.go) only when set
        self.httpd.unsafe = unsafe  # type: ignore[attr-defined]
        self.httpd.stopping = False  # type: ignore[attr-defined]
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="rpc-http"
        )
        self._thread.start()

    def stop(self) -> None:
        self.httpd.stopping = True  # type: ignore[attr-defined]
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
