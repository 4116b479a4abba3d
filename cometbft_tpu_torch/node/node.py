"""Node: wires stores, ABCI app, mempool, and consensus into one unit.

Reference: node/node.go:263-525 NewNode (DBs -> stateStore -> proxyApp ->
handshake -> mempool -> blockExec -> consensus -> ...), OnStart (:527).
The p2p switch/reactors slot in where `broadcast` is today; an in-memory
hub (LocalNetwork) plays the transport for multi-node-in-process tests
(the p2p/test_util.go:315 analog).

The port's copy of the JAX package's node/node.py, over the port's
modules. Its seams:

  * `device` (None: the card, which raises DeviceError without one;
    "cpu": the kernels' plain versions) is where the node verifies what
    no running verify plane takes: each height's votes (the VoteSets
    get it), every LastCommit and evidence commit (the executor's and
    the evidence pool's batch_fn, verifyplane.consensus_batch_fn(device))
    and signed txs (the mempool's). With a running plane, which the
    node that takes a [verify_plane] config builds on this device and
    registers as the global plane, every node of the process rides it.
  * A batch_fn marked `on_host` ([crypto] verifier = "cpu",
    validation.oracle_batch_fn) makes a host node: no device is resolved,
    votes take the VoteSet's serial host path and every commit, evidence
    and tx signature the host callable, so the node launches nothing.
  * p2p=True builds the switch and its reactors (consensus, mempool,
    evidence, blocksync, statesync, PEX), as the JAX node does. The
    blocksync engine verifies each run of blocks in a
    StreamVerifier(device=node.device): the node's device, never a plain
    or host verifier behind its back (a run under its min_device_sigs
    rows verifies on the host, in both packages). A host node's engine
    gets HostCommitVerifier, the host path.
  * rpc_listen() serves the JSON-RPC server (rpc/server.py) over this
    node, and an AppConns from AppConns.socket/grpc/from_addr runs the
    app out of process, as in the JAX package.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.consensus.state import STEP_COMMIT, ConsensusState
from cometbft_tpu_torch.device import resolve
from cometbft_tpu_torch.consensus.ticker import TimeoutParams
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.mempool.mempool import Mempool
from cometbft_tpu_torch.privval.file_pv import FilePV
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.state import State, StateStore
from cometbft_tpu_torch.store.blockstore import BlockStore
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.verifyplane.plane import consensus_batch_fn


class Node(BaseService):
    def __init__(
        self,
        app: abci.Application,
        genesis_state: State,
        privval: Optional[FilePV] = None,
        home: Optional[str] = None,
        broadcast: Optional[Callable] = None,
        timeouts: Optional[TimeoutParams] = None,
        batch_fn: Optional[Callable] = None,
        p2p: bool = False,
        node_key=None,
        blocksync: bool = False,
        pex: bool = False,
        statesync_light_client=None,
        statesync_discovery: float = 45.0,
        app_state_bytes: bytes = b"",
        verify_plane=None,
        mempool_config=None,
        lightgate=None,
        controller=None,
        device=None,
    ):
        """statesync_light_client: a light.Client already trusting a root
        header; providing it turns on the statesync->blocksync->consensus
        start sequence (node/node.go:527, statesync/syncer.go:145) once
        p2p=True."""
        super().__init__("Node")
        # a host node ([crypto] verifier = "cpu") resolves no device;
        # any other node resolves its own, the card by default
        self.on_host = bool(getattr(batch_fn, "on_host", False))
        self.device = None if self.on_host else resolve(device)
        if batch_fn is None:
            batch_fn = consensus_batch_fn(device=self.device)
        # four logical ABCI connections over the one app
        # (proxy/multi_app_conn.go; node/node.go:302
        # createAndStartProxyAppConns) — callers may also hand in a
        # ready-made AppConns (e.g. AppConns.socket for an
        # out-of-process app)
        from cometbft_tpu_torch.abci.proxy import AppConns

        if isinstance(app, AppConns):
            self.app_conns = app
        else:
            self.app_conns = AppConns.in_process(app)
        app = self.app_conns.consensus
        self.app = app  # consensus conn: handshake/replay/apply path
        self.home = home
        db = lambda name: (
            os.path.join(home, name) if home else ":memory:"
        )
        if home:
            os.makedirs(home, exist_ok=True)
        self.block_store = BlockStore(db("blockstore.db"))
        self.state_store = StateStore(db("state.db"))

        # handshake: adopt persisted state if it exists
        # (consensus/replay.go:242 Handshaker)
        persisted = self.state_store.load()
        state = persisted if persisted is not None else genesis_state
        if persisted is None:
            ri = self.app.init_chain(abci.RequestInitChain(
                time_seconds=state.last_block_time.seconds,
                chain_id=state.chain_id,
                initial_height=state.initial_height,
                # genesis validators + app state reach the app
                # (abci InitChain contract; node/node.go handshake)
                validators=[
                    abci.ValidatorUpdate(v.pub_key.data, v.voting_power,
                                         v.pub_key.key_type)
                    for v in state.validators.validators
                ],
                app_state_bytes=app_state_bytes,
            ))
            # the app may amend the genesis validator set in its
            # InitChain response (abci spec); ours treats a non-empty
            # response as authoritative replacement
            if ri.validators:
                from cometbft_tpu_torch.crypto.keys import PubKey
                from cometbft_tpu_torch.types.validator import (
                    Validator,
                    ValidatorSet,
                )

                vs = ValidatorSet([
                    Validator(PubKey(u.pub_key, u.key_type), u.power)
                    for u in ri.validators
                ])
                from dataclasses import replace

                state = replace(
                    state, validators=vs,
                    next_validators=vs.copy_increment_proposer_priority(1),
                )
            if ri.app_hash:
                from dataclasses import replace

                state = replace(state, app_hash=ri.app_hash)
            self.state_store.save(state)
        else:
            # replay stored blocks the app hasn't seen
            # (consensus/replay.go:285 ReplayBlocks). The request must be
            # BIT-IDENTICAL to the live apply_block's: decided_last_commit
            # and misbehavior included — an app that hashes CommitInfo
            # (fee distribution, slashing) would otherwise compute a
            # different state on replay than it did live.
            from cometbft_tpu_torch.state.execution import (
                build_last_commit_info,
                build_misbehavior,
            )

            info = self.app.info(abci.RequestInfo())
            for h in range(
                info.last_block_height + 1, state.last_block_height + 1
            ):
                blk = self.block_store.load_block(h)
                if blk is None:
                    raise RuntimeError(f"missing block {h} for app replay")
                last_vals = self.state_store.load_validators(h - 1)
                self.app.finalize_block(abci.RequestFinalizeBlock(
                    txs=list(blk.data.txs), hash=blk.hash() or b"",
                    height=h, proposer_address=blk.header.proposer_address,
                    time_seconds=blk.header.time.seconds,
                    decided_last_commit=build_last_commit_info(
                        blk.last_commit, last_vals, h
                    ),
                    misbehavior=build_misbehavior(blk),
                ))
                self.app.commit()

        # mempool + CheckTx admission control (config [mempool]): the
        # admission gate reads the pool's fill fraction (watermarks)
        # and the device breaker state (tightened host-fallback bound)
        from cometbft_tpu_torch.config.config import MempoolConfig

        mcfg = mempool_config or MempoolConfig()

        def _breaker_open():
            from cometbft_tpu_torch.crypto import batch as cbatch

            return cbatch.device_breaker().state == "open"

        self.mempool = Mempool(
            self.app_conns.mempool, max_txs=mcfg.size,
            cache_size=mcfg.cache_size, recheck=mcfg.recheck,
            verify_sigs=mcfg.verify_sigs, chain_id=state.chain_id,
            batch_fn=batch_fn,
        )
        self.mempool.admission = mcfg.build_admission(
            fill_fn=self.mempool.fill_fraction,
            breaker_open_fn=_breaker_open,
        )
        # evidence pool backed by the state store's validator history
        # (node/node.go:369 createEvidenceReactor)
        from cometbft_tpu_torch.evidence.pool import EvidencePool

        self.evidence_pool = EvidencePool(
            state.chain_id, self.state_store.load_validators,
            batch_fn=batch_fn,
        )
        self.evidence_pool.height = state.last_block_height
        self.evidence_pool.time_s = state.last_block_time.seconds
        from cometbft_tpu_torch.libs.metrics import NodeMetrics
        from cometbft_tpu_torch.types.event_bus import EventBus

        self.metrics = NodeMetrics()
        self.mempool.metrics = self.metrics
        self.event_bus = EventBus()
        # verify plane (config [verify_plane]; the port's verifyplane):
        # accepts a VerifyPlaneConfig, a ready VerifyPlane, or None.
        # Started with the node; registered as THE global plane so every
        # verification consumer in-process coalesces through it.
        self.verify_plane = None
        # next-epoch table warmer ([verify_plane] warm_next_epoch):
        # builds the epoch e+1 valset's device window tables in the
        # background when a block's validator updates rotate the set,
        # so the first post-rotation commit verifies against a warm
        # cache (verifyplane/warmer.py). Lifecycle rides the plane's.
        self.valset_warmer = None
        if verify_plane is not None:
            if hasattr(verify_plane, "build"):
                self.verify_plane = verify_plane.build(
                    metrics=self.metrics, device=self.device)
                if hasattr(verify_plane, "build_warmer"):
                    self.valset_warmer = verify_plane.build_warmer(
                        device=self.device)
            else:
                self.verify_plane = verify_plane
                if self.verify_plane.metrics is None:
                    self.verify_plane.metrics = self.metrics
        # indexers + pruner (node/node.go:311-316 createAndStartIndexer,
        # state/pruner.go)
        from cometbft_tpu_torch.state.indexer import (
            BlockIndexer,
            IndexerService,
            TxIndexer,
        )
        from cometbft_tpu_torch.state.pruner import Pruner

        self.tx_indexer = TxIndexer(db("tx_index.db"))
        self.block_indexer = BlockIndexer(db("block_index.db"))
        self.indexer_service = IndexerService(
            self.event_bus, self.tx_indexer, self.block_indexer
        )
        self.pruner = Pruner(
            self.block_store, self.state_store, self.tx_indexer,
            self.block_indexer,
            evidence_safe_height=lambda: (
                self.block_store.height()
                - self.evidence_pool.max_age_blocks
            ),
        )
        self.block_exec = BlockExecutor(
            app, self.state_store, batch_fn=batch_fn, mempool=self.mempool,
            evidence_pool=self.evidence_pool, event_bus=self.event_bus,
        )
        self.consensus = ConsensusState(
            state,
            self.block_exec,
            self.block_store,
            privval=privval,
            wal_path=os.path.join(home, "cs.wal") if home else None,
            broadcast=broadcast,
            timeouts=timeouts,
            device=self.device,
        )
        self.consensus.evidence_pool = self.evidence_pool
        self.consensus.metrics = self.metrics
        self.block_exec.on_retain_height = self.pruner.set_retain_height

        # light-client gateway (config [lightgate];
        # cometbft_tpu_torch.lightgate): accepts a LightGateConfig, a ready
        # LightGateway, or None. Mounted on this node's stores/evidence
        # pool; started with the node and registered as THE global
        # gateway (the light proxy's shared-verifier path and /metrics
        # sampling find it there).
        self.lightgate = None
        if lightgate is not None:
            if hasattr(lightgate, "build"):
                self.lightgate = lightgate.build(self)
            else:
                self.lightgate = lightgate

        # self-tuning control plane (config [controller];
        # cometbft_tpu_torch.libs.controller): accepts a ControllerConfig, a
        # ready Controller, or None. The loop only ever moves sheddable
        # actuators (BULK/GATEWAY windows, admission watermarks, the
        # flight deck) — CONSENSUS lane bounds are structurally out of
        # its reach. Attached + registered in on_start, after the plane.
        self.controller = None
        self._controller_bounds = None
        if controller is not None:
            if hasattr(controller, "build"):
                self.controller = controller.build()
                if self.controller is not None \
                        and hasattr(verify_plane, "build"):
                    # config-validated clamp bounds, anchored at the
                    # static sections this node was actually built from
                    self._controller_bounds = controller.bounds(
                        verify_plane, mcfg)
            else:
                self.controller = controller

        # optional real p2p stack (node/node.go:443-447 createTransport/
        # createSwitch); when absent, `broadcast` (in-memory hub) rules
        self.switch = None
        self.mempool_reactor = None
        self.consensus_reactor = None
        self.blocksync_engine = None
        self.blocksync_reactor = None
        self._blocksync_first = blocksync
        self._statesync_discovery = statesync_discovery
        if p2p:
            from cometbft_tpu_torch.blocksync.p2p_reactor import (
                BlocksyncP2PReactor,
            )
            from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor
            from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
            from cometbft_tpu_torch.mempool.reactor import MempoolReactor
            from cometbft_tpu_torch.p2p.key import NodeKey
            from cometbft_tpu_torch.p2p.switch import Switch

            nk = node_key or NodeKey.load_or_gen(
                os.path.join(home, "node_key.json") if home else None
            )
            self.switch = Switch(nk, state.chain_id)
            # gossip observatory -> height ledger join: late-signer
            # rows name the delivering hop, and net_ms/sign_ms split
            # against THIS node's peer ledger (never the module global
            # — multi-node processes each join their own)
            self.consensus.height_ledger.peer_ledger = \
                self.switch.peer_ledger
            self.consensus_reactor = ConsensusReactor(self.consensus)
            self.switch.add_reactor(self.consensus_reactor)
            self.mempool_reactor = MempoolReactor(self.mempool)
            self.switch.add_reactor(self.mempool_reactor)
            if blocksync:
                # syncing node: blocksync drives first, consensus starts
                # at SwitchToConsensus (node.go:527 sequencing)
                self.blocksync_engine = BlocksyncReactor(
                    state, self.block_exec, self.block_store,
                    stream_verifier=self._stream_verifier(),
                    on_caught_up=self._switch_to_consensus,
                )
            # every p2p node SERVES blocks even when not syncing itself
            self.blocksync_reactor = BlocksyncP2PReactor(
                self.blocksync_engine, self.block_store
            )
            self.switch.add_reactor(self.blocksync_reactor)
            from cometbft_tpu_torch.evidence.reactor import EvidenceReactor

            self.evidence_reactor = EvidenceReactor(self.evidence_pool)
            self.switch.add_reactor(self.evidence_reactor)
            self.consensus.on_evidence = \
                self.evidence_reactor.broadcast_evidence

            # statesync (serve snapshots always; sync when a trusted
            # light client was provided and we are at genesis)
            from cometbft_tpu_torch.statesync.p2p_reactor import (
                StatesyncP2PReactor,
            )

            self.statesync_syncer = None
            if statesync_light_client is not None and \
                    state.last_block_height == 0:
                from cometbft_tpu_torch.statesync.syncer import (
                    LightStateProvider,
                    Syncer,
                )

                self.statesync_syncer = Syncer(
                    self.app_conns.snapshot, LightStateProvider(
                        statesync_light_client,
                        params=state.consensus_params,
                    )
                )
            self.statesync_reactor = StatesyncP2PReactor(
                self.app_conns.snapshot, self.statesync_syncer
            )
            self.switch.add_reactor(self.statesync_reactor)

            # PEX + address book (node/node.go:462-481)
            self.pex_reactor = None
            if pex:
                from cometbft_tpu_torch.p2p.pex import AddrBook, PEXReactor

                self.addr_book = AddrBook(
                    os.path.join(home, "addrbook.json") if home else None
                )
                self.pex_reactor = PEXReactor(self.addr_book)
                self.switch.add_reactor(self.pex_reactor)

    def listen(self, host: str = "127.0.0.1", port: int = 0):
        """Start the p2p listener; returns our NetAddress."""
        return self.switch.listen(host, port)

    def _stream_verifier(self):
        """The blocksync engine's verifier: the node's device, or the
        host path for a host node."""
        if self.on_host:
            from cometbft_tpu_torch.blocksync.catchup import (
                HostCommitVerifier,
            )

            return HostCommitVerifier()
        from cometbft_tpu_torch.blocksync.pipeline import StreamVerifier

        return StreamVerifier(device=self.device)

    def rpc_listen(self, host: str = "127.0.0.1", port: int = 0,
                   unsafe: bool = False) -> str:
        """Start the JSON-RPC server (node/node.go:527 RPC listeners);
        returns the base URL. unsafe=True adds the ops routes +
        profiling endpoints (rpc/core/routes.go:58)."""
        from cometbft_tpu_torch.rpc.server import RPCServer

        self.rpc_server = RPCServer(self, host, port, unsafe=unsafe)
        self.rpc_server.start()
        return self.rpc_server.address

    def dial(self, addr, persistent: bool = True) -> None:
        self.switch.dial_peer(addr, persistent=persistent)

    def on_start(self) -> None:
        # incident flight recorder: the real-clock watchdog ticker
        # covers total wedges (no step transitions => no pokes) on
        # live nodes; refcounted across nodes, inert under simnet
        from cometbft_tpu_torch.libs import incidents

        incidents.recorder().start_watchdog()
        # device observatory: arm the process-global compile listener
        # (kernel builds are recorded from here on; a host node builds
        # nothing)
        from cometbft_tpu_torch.libs import deviceledger

        deviceledger.arm_compile_listener()
        if self.verify_plane is not None:
            from cometbft_tpu_torch import verifyplane

            self.verify_plane.start()
            verifyplane.set_global_plane(self.verify_plane)
            if self.verify_plane._mesh_devices is not None:
                # resolve the flush mesh now so a misconfigured
                # multichip node reports its real fan-out at START,
                # not on the first 100k-validator commit (print, not
                # logging: the cmd/cli start lines are prints too, and
                # only mesh-configured nodes reach here)
                self.verify_plane._flush_mesh(
                    self.verify_plane.mesh_min_rows)
                deck = ""
                if self.verify_plane.mesh_ndev \
                        and self.verify_plane.flights > 1:
                    deck = (f", deck of {self.verify_plane.flights} "
                            f"flights over "
                            f"{len(self.verify_plane._halves)} halves"
                            if self.verify_plane._halves
                            else f", deck requested but <4 devices; "
                                 f"single-flight")
                print("verify plane mesh: "
                      + (f"{self.verify_plane.mesh_ndev}-device "
                         f"sharded dispatch"
                         if self.verify_plane.mesh_ndev
                         else "requested but <2 devices; "
                              "single-device")
                      + deck)
        if self.valset_warmer is not None:
            # after the plane: a warm build may shard over the plane's
            # freshly-resolved mesh
            from cometbft_tpu_torch.verifyplane import warmer as vp_warmer

            self.valset_warmer.start()
            vp_warmer.set_global_warmer(self.valset_warmer)
        if self.lightgate is not None:
            # after the plane: the gateway's batch_fn rides its GATEWAY
            # lane from the first request
            self.lightgate.start()
        if self.controller is not None:
            # after the plane: attach() snapshots the live actuator
            # bases (window/deadline/flights as configured) and the
            # pokes only start deciding once registered global
            from cometbft_tpu_torch.libs import controller as controlplane

            self.controller.attach(
                plane=self.verify_plane,
                admission=self.mempool.admission,
                height_ledger=self.consensus.height_ledger,
                bounds=self._controller_bounds,
            )
            controlplane.set_global_controller(self.controller)
        self.pruner.start()
        if self.switch is not None:
            self.switch.start()
        if getattr(self, "pex_reactor", None) is not None:
            # redial from the persisted book immediately (node/node.go
            # DialPeersAsync from the addrbook on start)
            self.pex_reactor.start_routines()
        if getattr(self, "statesync_syncer", None) is not None:
            import threading

            threading.Thread(target=self._run_statesync, daemon=True,
                             name="statesync").start()
        elif self.blocksync_engine is not None:
            self.blocksync_engine.start()
        else:
            self.consensus.start()

    def _run_statesync(self) -> None:
        """statesync -> blocksync -> consensus (node/node.go:527)."""
        try:
            synced = self.statesync_syncer.sync_any(
                discovery_time=self._statesync_discovery
            )
            if not self.is_running():
                return  # node stopped mid-sync: stores are closed
            # adopt: persist state + the restore height's commit, then
            # let blocksync close the remaining gap. Inside the try:
            # provider/light-client errors here must also fall back, not
            # silently kill this daemon thread.
            commit = self.statesync_syncer.state_provider.commit_at(
                synced.last_block_height
            )
            self.state_store.save(synced)
            self.block_store.save_seen_commit(
                synced.last_block_height, commit
            )
        except Exception:  # noqa: BLE001 - any sync failure -> fallback
            import logging

            if not self.is_running():
                return  # shutdown race, not a sync failure
            logging.getLogger(__name__).exception(
                "statesync failed; falling back to blocksync from genesis"
            )
            if self.blocksync_engine is not None:
                self.blocksync_engine.start()
            else:
                self.consensus.start()
            return
        if self.blocksync_engine is not None:
            self.blocksync_engine.state = synced
            self.blocksync_engine.pool.height = \
                synced.last_block_height + 1
            self.blocksync_engine.start()
        else:
            self._switch_to_consensus(synced)

    def _switch_to_consensus(self, synced_state: State) -> None:
        """Blocksync caught up: hand the synced state to consensus
        (blocksync/reactor.go:391-401 SwitchToConsensus)."""
        self.consensus.reset_to_state(synced_state)
        self.consensus.start()

    def on_stop(self) -> None:
        from cometbft_tpu_torch.libs import incidents

        incidents.recorder().stop_watchdog()
        if self.controller is not None:
            # before the plane stops: no actuator moves may race the
            # drain. _LAST keeps serving /dump_controller post-stop.
            from cometbft_tpu_torch.libs import controller as controlplane

            controlplane.clear_global_controller(self.controller)
        if self.lightgate is not None:
            # before the plane stops: in-flight gateway verifies fall
            # back to the direct host path instead of racing the drain
            self.lightgate.stop()
        if self.valset_warmer is not None:
            # before the plane: a mid-warm sharded build may still be
            # using the plane's mesh; stop() abandons it cleanly
            from cometbft_tpu_torch.verifyplane import warmer as vp_warmer

            vp_warmer.clear_global_warmer(self.valset_warmer)
            self.valset_warmer.stop()
        if self.verify_plane is not None:
            from cometbft_tpu_torch import verifyplane

            # unregister first: in-flight verifiers fall back to their
            # direct paths instead of racing the drain
            verifyplane.clear_global_plane(self.verify_plane)
            self.verify_plane.stop()
        if getattr(self, "rpc_server", None) is not None:
            self.rpc_server.stop()
        self.indexer_service.stop()
        if self.pruner.is_running():
            self.pruner.stop()
        if self.consensus.is_running():
            self.consensus.stop()
        if self.blocksync_engine is not None and \
                self.blocksync_engine.is_running():
            self.blocksync_engine.stop()
        if self.consensus_reactor is not None:
            self.consensus_reactor.stop_routines()
        if self.blocksync_reactor is not None:
            self.blocksync_reactor.stop_routines()
        if getattr(self, "pex_reactor", None) is not None:
            self.pex_reactor.stop_routines()
        if self.switch is not None:
            self.switch.stop()
        self.block_store.close()
        self.state_store.close()
        if self.indexer_service._thread.is_alive():
            # join timed out: leaking the connections beats closing them
            # under a live thread (sqlite segfaults, not raises)
            return
        self.tx_indexer.close()
        self.block_indexer.close()

    # convenience API (rpc/core analogs; the JSON-RPC server wraps these)
    def broadcast_tx(self, tx: bytes) -> abci.ResponseCheckTx:
        resp = self.mempool.check_tx(tx)
        if resp.code == abci.CODE_TYPE_OK and self.mempool_reactor:
            self.mempool_reactor.broadcast_tx(tx)
        return resp

    def height(self) -> int:
        return self.consensus.state.last_block_height

    def query(self, key: bytes) -> abci.ResponseQuery:
        return self.app_conns.query.query(
            abci.RequestQuery(data=key)
        )


class LocalNetwork:
    """In-memory message hub for multi-node-in-one-process tests
    (p2p/test_util.go:315 MakeConnectedSwitches analog).

    Each proposal and vote is delivered once to every other node, as in
    the JAX package, and the hub also does what the consensus reactor's
    gossip does for a peer over TCP: a node that was behind a message when
    it was sent gets it again once its consensus reaches it. The consensus
    state drops a vote of another height or more than a round ahead, and a
    proposal of another height or round, so without this a node that
    falls a height or a round behind at the wrong moment never sees those
    messages again and stalls (at COMMIT without the decided block, or a
    height behind). For the newest `HOLD_HEIGHTS` heights:
      * a message sent to a node behind it is kept for that node and
        delivered again when the node enters the message's height and
        round (its `on_step_change`);
      * the hub keeps every proposal, and a node that enters COMMIT
        without the decided block is sent its height's proposals (the
        commit-recovery path of `ConsensusState._set_proposal`).
    A height's messages are dropped once every node has passed it, or it
    leaves the newest `HOLD_HEIGHTS`; a node further behind needs the
    blocks themselves (`receive_commit_block`)."""

    HOLD_HEIGHTS = 2

    def __init__(self):
        self.nodes: List[Node] = []
        self._lock = threading.Lock()
        self._proposals = {}  # height -> [ProposalMsg]
        self._behind = {}     # ConsensusState -> [(kind, payload)]
        self._top = 0         # the newest height broadcast
        self.redelivered = 0

    def broadcaster(self, exclude_idx: int) -> Callable:
        def bcast(msg):
            kind, payload = msg
            if kind not in ("proposal", "vote"):
                return
            with self._lock:
                self._hold(kind, payload)
                targets = [n for i, n in enumerate(self.nodes)
                           if i != exclude_idx]
                for n in targets:
                    cs = self._attach(n.consensus)
                    if _behind(cs, kind, payload):
                        self._behind[cs].append((kind, payload))
            for n in targets:
                _deliver(n.consensus, kind, payload)

        return bcast

    def add(self, node: Node) -> None:
        with self._lock:
            self.nodes.append(node)
            self._attach(node.consensus)

    def _attach(self, cs: ConsensusState) -> ConsensusState:
        """Hook `cs` (a node added, or put in place of a restarted one)
        on first sight. Caller holds the lock."""
        if cs not in self._behind:
            self._behind[cs] = []
            prev = cs.on_step_change

            def on_step():
                if prev is not None:
                    prev()
                self._caught_up(cs)

            cs.on_step_change = on_step
        return cs

    def _hold(self, kind: str, payload) -> None:
        """Keep a broadcast proposal; drop the heights every node has
        passed or that left the window. Caller holds the lock."""
        h = _height(kind, payload)
        if kind == "proposal":
            self._proposals.setdefault(h, []).append(payload)
        self._top = max(self._top, h)
        floor = self._top - self.HOLD_HEIGHTS + 1
        if self.nodes:
            floor = max(floor, min(n.consensus.height for n in self.nodes))
        for old in [k for k in self._proposals if k < floor]:
            del self._proposals[old]
        for cs, msgs in self._behind.items():
            self._behind[cs] = [m for m in msgs
                                if _height(*m) >= floor]

    def _caught_up(self, cs: ConsensusState) -> None:
        """`cs` changed step: send it what it was sent too early, and at
        COMMIT without the decided block its height's proposals."""
        h, r = cs.height, cs.round
        commit = cs.step == STEP_COMMIT and cs.proposal_block is None
        with self._lock:
            msgs = self._behind.get(cs, [])
            self._behind[cs] = [m for m in msgs if _behind(cs, *m)]
            due = [m for m in msgs if not _behind(cs, *m)]
            if commit:
                due += [("proposal", p)
                        for p in self._proposals.get(h, ())]
            due = [(k, p) for k, p in due if _height(k, p) == h and (
                k == "vote" or commit or p.proposal.round == r)]
            self.redelivered += len(due)
        for kind, payload in due:
            _deliver(cs, kind, payload)


def _height(kind: str, payload) -> int:
    return payload.proposal.height if kind == "proposal" else payload.height


def _behind(cs: ConsensusState, kind: str, payload) -> bool:
    """True when `cs`, where it stands now, would drop the message for
    being ahead of it (ConsensusState._set_proposal, _vote_prefilter,
    HeightVoteSet.add_vote)."""
    if kind == "proposal":
        p = payload.proposal
        return (p.height, p.round) > (cs.height, cs.round)
    return payload.height > cs.height or (
        payload.height == cs.height and payload.round > cs.round + 1)


def _deliver(cs: ConsensusState, kind: str, payload) -> None:
    if kind == "proposal":
        cs.receive_proposal(payload)
    else:
        cs.receive_vote(payload)
