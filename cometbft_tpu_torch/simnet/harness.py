"""The simnet harness: schedules -> runs -> safety/liveness/evidence
assertions, with seed+schedule replay on every failure.

This is the scenario-coverage engine the ROADMAP's perf PRs validate
against: any consensus/evidence/verify-plane change can be driven
through partitions, byzantine actors, crashes, and failpoint faults in
deterministic, replayable simulated time.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.simnet import actors
from cometbft_tpu_torch.simnet.core import EVIDENCE_CHANNEL, SimNetwork
from cometbft_tpu_torch.simnet.schedule import (
    schedule_to_json,
    validate_schedule,
)


class SimnetFailure(AssertionError):
    """A simnet assertion failed. str() carries the replay blob — feed
    it back through Simnet(seed=...).run(schedule) (or
    tools/simnet_fuzz.py --replay). For single-run schedules (the
    fuzzer's shape) the rerun is byte-identical; a MULTI-phase scenario
    (several run() calls with mid-run assertions) additionally needs
    its phase boundaries — rerun the originating test, whose code IS
    that phase structure."""

    def __init__(self, msg: str, seed: int, schedule: List[Dict],
                 include_ledger: bool = True,
                 include_heights: bool = True,
                 include_incidents: bool = True,
                 include_peers: bool = True,
                 include_controller: bool = True):
        self.seed = seed
        self.schedule = schedule
        text = msg
        # when tracing is on, the tail of the span/event ring rides the
        # failure: the last thing the simulation did before wedging,
        # in order, on the virtual clock
        trace_tail = tracing.tail(40)
        if trace_tail:
            text += "\ntrace tail: " + " ".join(trace_tail)
        # the verify plane's always-on flush ledger needs no knob: if a
        # plane ran (or stopped) during this simulation, its last few
        # flushes ride the blob too — stage costs on the virtual clock.
        # The harness passes include_ledger=False when the ledger never
        # moved during ITS run (the module-global ledger survives
        # unrelated earlier planes in the same process — that history
        # would misdirect whoever debugs this blob).
        from cometbft_tpu_torch import verifyplane

        led_tail = verifyplane.ledger_tail(8) if include_ledger else []
        if led_tail:
            text += "\nflush ledger tail: " + " | ".join(led_tail)
        # the always-on height ledger: where the last commits' latency
        # went (stage timeline on the virtual clock) — same move-mark
        # gating as the flush ledger
        from cometbft_tpu_torch.consensus import heightledger
        from cometbft_tpu_torch.libs import incidents

        h_tail = heightledger.ledger_tail(8) if include_heights else []
        if h_tail:
            text += "\nheight ledger tail: " + " | ".join(h_tail)
        # the gossip observatory's per-peer tail: which links were
        # eating/queueing messages when the run failed (same move-mark
        # gating as the other always-on ledgers)
        from cometbft_tpu_torch.p2p import peerledger

        p_tail = peerledger.ledger_tail(8) if include_peers else []
        if p_tail:
            text += "\npeer ledger tail: " + " | ".join(p_tail)
        # the self-tuning control plane's decision tail: what the loop
        # moved (and in which direction) before the run failed — the
        # decisions are count-based on deterministic poke sites, so the
        # tail in a replayed blob matches the original byte for byte
        from cometbft_tpu_torch.libs import controller as controlplane

        c_tail = controlplane.controller_tail(8) \
            if include_controller else []
        if c_tail:
            text += "\ncontroller decisions: " + " | ".join(c_tail)
        # incidents frozen DURING this simulation (commit stalls, round
        # escalations, ...) are first-class replay evidence
        inc_tail = incidents.incident_tail(4) if include_incidents \
            else []
        if inc_tail:
            text += "\nincidents: " + " | ".join(inc_tail)
        # the replay blob stays LAST: consumers (and the fuzzer) parse
        # everything after "replay:" as one JSON document
        text += f"\nreplay: {schedule_to_json(seed, schedule)}"
        super().__init__(text)


class Simnet:
    """Build-run-assert wrapper around :class:`SimNetwork`."""

    def __init__(self, n_nodes: int, seed: int, basedir: str,
                 device=None, batch_fn=None, **kw):
        """`device` and `batch_fn` go to every Node the net builds
        (simnet/core.py): None is the card, "cpu" the plain kernels, an
        `on_host` batch_fn a host node."""
        self.net = SimNetwork(n_nodes, seed, basedir, device=device,
                              batch_fn=batch_fn, **kw)
        self.schedule: List[Dict] = []
        self._started = False
        # every flood-op CheckTx response, in injection order: the soak
        # scenarios assert overload verdicts are EXPLICIT (code +
        # retry hint), never silent drops
        self.flood_results: List[Dict] = []
        # every gateway_sync client verdict, in sync order — the
        # forged-header scenario asserts honest clients complete and
        # the whole verdict stream replays byte-identically
        self.gateway_results: List[Dict] = []
        # every epoch op's election outcome (who rotated out/in, how
        # many val txs were injected) — the churn soak asserts the
        # rotation stream replays byte-identically
        self.epoch_results: List[Dict] = []
        # flush-/height-ledger + incident positions at sim start:
        # failure blobs attach each tail only if it advanced during
        # THIS simulation
        from cometbft_tpu_torch import verifyplane
        from cometbft_tpu_torch.consensus import heightledger
        from cometbft_tpu_torch.libs import controller as controlplane
        from cometbft_tpu_torch.libs import incidents
        from cometbft_tpu_torch.p2p import peerledger

        self._ledger_mark = verifyplane.ledger_mark()
        self._height_mark = heightledger.ledger_mark()
        self._incident_mark = incidents.incident_mark()
        self._peer_mark = peerledger.ledger_mark()
        self._controller_mark = controlplane.controller_mark()

    # -- running -----------------------------------------------------------

    def run(self, schedule: List[Dict],
            until: Optional[Callable[[], bool]] = None,
            until_height: Optional[int] = None,
            max_time: float = 120.0) -> bool:
        """Apply `schedule` and run simulated time forward until the
        condition holds (or `max_time` more simulated seconds pass).
        Reentrant: later run() calls continue the same simulation with
        additional schedule ops."""
        net = self.net
        validate_schedule(schedule, len(net.nodes))
        self.schedule = sorted(
            self.schedule + [dict(op) for op in schedule],
            key=lambda o: float(o["at"]),
        )
        if not self._started:
            self._started = True
            net.start()
        for op in schedule:
            delay = max(0.0, float(op["at"]) - net.now)
            net.schedule(delay, lambda op=op: self._apply(op),
                         f"op:{op['op']}")
        if until is None and until_height is not None:
            target = until_height
            # an open-loop flood is SUSTAINED traffic: reaching the
            # target height mid-window must not end the run, or the
            # soak would assert overload behavior against a flood that
            # never fully fired
            horizon = max(
                (float(o["at"]) + float(o.get("duration", 0.0))
                 for o in self.schedule if o["op"] == "flood"),
                default=0.0,
            )
            until = lambda: net.now >= horizon and all(  # noqa: E731
                n.height() >= target for n in net.nodes if n.alive
            ) and any(n.alive for n in net.nodes)
        return net.run_until(until, max_time=net.now + max_time)

    def close(self) -> None:
        self.net.close()

    def __enter__(self) -> "Simnet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- schedule ops ------------------------------------------------------

    def _apply(self, op: Dict) -> None:
        net = self.net
        kind = op["op"]
        # every fault-schedule op becomes a trace instant, so a trace
        # of a wedged run shows the perturbation timeline inline with
        # the consensus/WAL spans it perturbed
        tracing.instant("simnet.op", cat="simnet", op=kind,
                        at=float(op["at"]))
        if kind == "partition":
            groups = [set(g) for g in op["groups"]]
            group_of = {}
            for gi, g in enumerate(groups):
                for i in g:
                    group_of[i] = gi
            for (i, j), link in net.links.items():
                link.up = (i in group_of and j in group_of
                           and group_of[i] == group_of[j])
        elif kind == "heal":
            for link in net.links.values():
                link.up = True
                link.drop = link.dup = link.reorder = 0.0
                link.jitter = 0.0
        elif kind == "link":
            frm = op.get("frm")
            to = op.get("to")
            for (i, j), link in net.links.items():
                if frm is not None and i not in frm:
                    continue
                if to is not None and j not in to:
                    continue
                for key in ("drop", "delay", "jitter", "dup", "reorder"):
                    if key in op:
                        setattr(link, key, float(op[key]))
        elif kind == "kill":
            net.nodes[op["node"]].halt("schedule kill")
        elif kind == "restart":
            node = net.nodes[op["node"]]
            if not node.alive:
                node.restart()
        elif kind == "failpoint":
            net.nodes[op["node"]].registry.arm_from_spec(op["spec"])
        elif kind == "equivocate":
            net.nodes[op["node"]].equivocate_budget += int(
                op.get("votes", 1)
            )
        elif kind == "garbage":
            net.nodes[op["node"]].garbage_budget += int(op.get("votes", 1))
        elif kind == "light_attack":
            self._launch_light_attack(op)
        elif kind == "gateway_sync":
            self._launch_gateway_sync(op)
        elif kind == "tx":
            node = net.nodes[op["node"]]
            if node.alive:
                node.node.mempool.check_tx(bytes.fromhex(op["data"]))
        elif kind == "flood":
            self._launch_flood(op)
        elif kind == "epoch":
            self._launch_epoch(op)
        elif kind == "controller":
            self._launch_controller(op)

    # flood txs are signed with ONE deterministic throwaway key (a
    # function of nothing but this constant), so the same (seed,
    # schedule) floods byte-identical txs
    _FLOOD_KEY_SEED = b"simnet-flood-key" + b"\x00" * 16

    def _launch_flood(self, op: Dict) -> None:
        """Open-loop tx stream: rate*duration injections at FIXED sim
        times (injection never waits on a response — the open-loop
        discipline of test/loadtime), through the target node's full
        broadcast_tx path (admission control + sigtx verify via the
        BULK lane when signed + ABCI CheckTx)."""
        net = self.net
        idx = int(op["node"])
        rate = float(op["rate"])
        count = int(round(rate * float(op["duration"])))
        size = int(op.get("size", 16))
        signed = bool(op.get("signed", False))
        priv = sigtx = None
        if signed:
            from cometbft_tpu_torch.crypto.keys import PrivKey
            from cometbft_tpu_torch.mempool import sigtx

            priv = PrivKey.generate(self._FLOOD_KEY_SEED)
        base = len(self.flood_results)

        def inject(k: int, tx: bytes) -> None:
            node = net.nodes[idx]
            if not node.alive:
                self.flood_results.append(
                    {"seq": base + k, "at": net.now, "code": None,
                     "log": "target dead"})
                return
            with net._node_scope(node):
                resp = node.node.broadcast_tx(tx)
            self.flood_results.append(
                {"seq": base + k, "at": net.now, "code": resp.code,
                 "log": resp.log})
            net._pump(node)

        for k in range(count):
            payload = (b"flood-%d-%d=" % (idx, base + k)).ljust(
                size, b"x")
            tx = sigtx.wrap(priv, payload) if signed else payload
            net.schedule(k / rate, lambda k=k, tx=tx: inject(k, tx),
                         f"flood n{idx}")

    def _launch_controller(self, op: Dict) -> None:
        """Mount the self-tuning control plane on the target node:
        attached to that node's admission gate + height ledger (and
        the process-global verify plane, when a scenario started one),
        registered as THE module-global controller so the consensus-
        step pokes start deciding. Decisions are count-based on
        deterministic poke sites (the dispatcher-drain seam only ever
        moves the flight deck, whose grow signal needs fused device
        flushes, which a host plane never produces), so over a host
        plane the decision stream is a pure function of (seed,
        schedule)."""
        from cometbft_tpu_torch import verifyplane
        from cometbft_tpu_torch.libs import controller as controlplane

        net = self.net
        snode = net.nodes[int(op["node"])]
        if not snode.alive:
            return
        kwargs = {k: v for k, v in op.items()
                  if k not in ("at", "op", "node", "bounds")}
        ctl = controlplane.Controller(**kwargs)
        plane = verifyplane.global_plane()
        # JSON bounds arrive as {actuator: [lo, hi]} — without them
        # every actuator clamps to (base, base) and the mounted loop
        # observes but never moves
        bounds = {name: (float(b[0]), float(b[1]))
                  for name, b in (op.get("bounds") or {}).items()}
        ctl.attach(
            plane=plane,
            admission=snode.node.mempool.admission,
            height_ledger=snode.node.consensus.height_ledger,
            bounds=bounds,
        )
        controlplane.set_global_controller(ctl)
        snode.node.controller = ctl

    def _launch_epoch(self, op: Dict) -> None:
        """One epoch of proportional committee re-election over the
        network's passive validator tail. The deterministic election
        (actors.proportional_election, a pure function of (seed, epoch
        index, committee)) picks who rotates; the change set becomes
        kvstore ``val:`` txs injected into EVERY alive node's mempool
        (simnet mempools don't gossip, and whichever node proposes next
        must carry the rotation), flowing through the real
        ABCI validator-update -> update_with_change_set ->
        state/execution.py path — the valset rotates at H+2 and
        commits stay byte-identical across replays."""
        import base64

        net = self.net
        rec: Dict = {"seq": len(self.epoch_results), "at": net.now}
        st = net.epoch_state
        if st is None:
            rec["error"] = ("no validator tail pool — build the "
                            "Simnet with extra_validators > 0")
            self.epoch_results.append(rec)
            return
        st["epoch"] += 1
        churn = float(op.get("churn", 0.25))
        committee, standby, out, inn = actors.proportional_election(
            net.seed, st["epoch"], st["committee"], st["standby"],
            net.tail_stakes, churn,
        )
        st["committee"], st["standby"] = committee, standby
        # the !e<epoch> nonce keeps repeat rotations of one validator
        # byte-distinct, so mempool replay protection can't swallow a
        # later epoch's change as a dup of an earlier one
        nonce = b"!e%d" % st["epoch"]
        txs = [b"val:" + base64.b64encode(net.tail_pubs[i]) + b"!0"
               + nonce for i in out]
        txs += [b"val:" + base64.b64encode(net.tail_pubs[i])
                + b"!%d" % net.tail_stakes[i][1] + nonce for i in inn]
        # the named node's verdicts ride the record; a dead target
        # falls to the next alive index (deterministic, so the replay
        # stream is too) — rotation-while-killed must still rotate
        codes: List = []
        target = int(op["node"])
        alive = [n.idx for n in net.nodes if n.alive]
        rec_idx = next((i for i in alive if i >= target),
                       alive[0] if alive else None)
        for node in net.nodes:
            if not node.alive:
                continue
            with net._node_scope(node):
                for tx in txs:
                    try:
                        r = node.node.mempool.check_tx(tx)
                        code = getattr(r, "code", 0)
                    except Exception as e:  # noqa: BLE001 - recorded
                        code = repr(e)[:80]
                    if node.idx == rec_idx:
                        codes.append(code)
            net._pump(node)
        rec.update({"epoch": st["epoch"], "churn": churn,
                    "out": list(out), "in": list(inn),
                    "txs": len(txs), "codes": codes,
                    "committee_size": len(committee)})
        self.epoch_results.append(rec)

    def _launch_gateway_sync(self, op: Dict) -> None:
        """Mount a light-client gateway on the target node and drive K
        client syncs through it at fixed sim times. Synchronous on the
        scheduler thread: the gateway's verification rides the global
        plane's GATEWAY lane when one runs and the node's own device
        (the host for a host node) when none does, and the call waits
        for its verdicts either way — same (seed, schedule) therefore
        yields a byte-identical verdict stream.
        Forged clients submit a lying-primary claim; the gateway's
        divergence path feeds the node's evidence pool and the evidence
        gossips like the node's own (consensus-found) evidence would."""
        net = self.net
        idx = int(op["node"])
        snode = net.nodes[idx]
        if not snode.alive:
            return
        from cometbft_tpu_torch.lightgate import LightGateway

        gw = getattr(snode, "lightgate", None)
        if gw is None:
            with net._node_scope(snode):
                gw = LightGateway.for_node(snode.node)
                gw.start(register=False)
            snode.lightgate = gw
            gw.on_attack_evidence = snode._gossip_own_evidence
        clients = int(op["clients"])
        trusted = int(op.get("trusted", 1))
        target = int(op["target"])
        forged = {int(i) for i in op.get("forged", [])}
        claim = None
        if forged:
            claim = actors.forged_claim(
                net.privs, net.genesis.validators, net.chain_id,
                [int(i) for i in op["byz"]], target, net._sim_now(),
            )
        base = len(self.gateway_results)

        def sync(k: int) -> None:
            if not snode.alive:
                self.gateway_results.append(
                    {"seq": base + k, "at": net.now, "status": None,
                     "log": "gateway node dead"})
                return
            with net._node_scope(snode):
                try:
                    v = gw.verify(trusted, target,
                                  claimed=claim if k in forged else None)
                    rec = {"seq": base + k, "at": net.now,
                           "status": v["status"],
                           "target_hash": v["target_hash"],
                           "cached": v["cached"],
                           "evidence_added": v.get("evidence_added")}
                except Exception as e:  # noqa: BLE001 - verdict stream
                    rec = {"seq": base + k, "at": net.now,
                           "status": "error", "log": repr(e)[:200]}
            self.gateway_results.append(rec)
            net._pump(snode)

        for k in range(clients):
            net.schedule(k * 0.002, lambda k=k: sync(k),
                         f"gateway_sync n{idx}")

    def _launch_light_attack(self, op: Dict) -> None:
        net = self.net
        target = net.nodes[op["target"]]
        if not target.alive:
            return
        height = int(op.get("height", 1))
        ev = actors.build_light_attack(
            net.privs, net.genesis.validators, net.chain_id,
            [int(i) for i in op["byz"]], height, net._sim_now(),
        )
        import json

        from cometbft_tpu_torch.types.evidence import evidence_to_j

        net._deliver(target.idx, EVIDENCE_CHANNEL,
                     json.dumps(evidence_to_j(ev)).encode())

    # -- assertions --------------------------------------------------------

    def _fail(self, msg: str) -> "SimnetFailure":
        from cometbft_tpu_torch import verifyplane
        from cometbft_tpu_torch.consensus import heightledger
        from cometbft_tpu_torch.libs import controller as controlplane
        from cometbft_tpu_torch.libs import incidents
        from cometbft_tpu_torch.p2p import peerledger

        return SimnetFailure(
            msg, self.net.seed, self.schedule,
            include_ledger=verifyplane.ledger_advanced(self._ledger_mark),
            include_heights=heightledger.ledger_advanced(
                self._height_mark),
            include_incidents=incidents.incident_advanced(
                self._incident_mark),
            include_peers=peerledger.ledger_advanced(self._peer_mark),
            include_controller=controlplane.controller_advanced(
                self._controller_mark),
        )

    def commit_hashes(self) -> List[Dict[int, bytes]]:
        """Per-node height -> committed block hash (incl. killed nodes'
        pre-crash history)."""
        for n in self.net.nodes:
            if n.alive:
                n._record_commits()
        return [dict(n.commit_hashes) for n in self.net.nodes]

    def assert_safety(self) -> None:
        """No two nodes ever committed different blocks at one height."""
        per_node = self.commit_hashes()
        agreed: Dict[int, bytes] = {}
        owner: Dict[int, int] = {}
        for idx, hashes in enumerate(per_node):
            for h, bh in hashes.items():
                if h in agreed and agreed[h] != bh:
                    raise self._fail(
                        f"SAFETY VIOLATION at height {h}: node "
                        f"{owner[h]} committed {agreed[h].hex()[:16]}, "
                        f"node {idx} committed {bh.hex()[:16]}"
                    )
                agreed.setdefault(h, bh)
                owner.setdefault(h, idx)

    def assert_liveness(self, min_new_heights: int = 2,
                        max_time: float = 30.0) -> None:
        """After the schedule (heal included), the chain must still
        grow: every ALIVE node gains >= min_new_heights. Requires a
        live quorum — with > 1/3 of power dead the assertion is
        vacuous and raises a schedule error instead."""
        net = self.net
        alive = [n for n in net.nodes if n.alive]
        if 3 * len(alive) <= 2 * len(net.nodes):
            raise self._fail(
                "liveness asserted without a live 2/3 quorum "
                f"({len(alive)}/{len(net.nodes)} alive)"
            )
        floor = min(n.height() for n in alive)
        target = floor + min_new_heights
        ok = net.run_until(
            lambda: all(n.height() >= target
                        for n in net.nodes if n.alive),
            max_time=net.now + max_time,
        )
        if not ok:
            heights = {n.idx: n.height() for n in net.nodes if n.alive}
            raise self._fail(
                f"LIVENESS failure: wanted height {target} on every "
                f"live node within {max_time}s sim time, got {heights}"
            )

    def assert_evidence_committed(self, predicate=None,
                                  max_time: float = 30.0) -> object:
        """Run until some node's committed chain contains evidence
        (optionally matching `predicate`); returns the evidence object.
        Every node must then reach that height with the same block."""
        net = self.net
        found: list = []
        scanned: Dict[int, int] = {}  # node idx -> last height scanned

        def scan() -> bool:
            for n in net.nodes:
                if not n.alive:
                    continue
                tip = n.height()
                for h in range(scanned.get(n.idx, 0) + 1, tip + 1):
                    scanned[n.idx] = h
                    blk = n.node.block_store.load_block(h)
                    if blk is None or not blk.evidence:
                        continue
                    for ev in blk.evidence:
                        if predicate is None or predicate(ev):
                            found.append((n.idx, h, ev))
                            return True
            return False

        if not net.run_until(scan, max_time=net.now + max_time):
            sizes = {n.idx: n.node.evidence_pool.size()
                     for n in net.nodes if n.alive}
            raise self._fail(
                f"EVIDENCE never committed (pending pools: {sizes})"
            )
        idx, h, ev = found[0]
        # committed on every live node, same block
        ref = self.net.nodes[idx].node.block_store.load_block(h).hash()
        ok = net.run_until(
            lambda: all(n.height() >= h for n in net.nodes if n.alive),
            max_time=net.now + max_time,
        )
        if not ok:
            raise self._fail(
                f"evidence block {h} not replicated to every live node"
            )
        for n in net.nodes:
            if not n.alive:
                continue
            blk = n.node.block_store.load_block(h)
            if blk is None or blk.hash() != ref:
                raise self._fail(
                    f"node {n.idx} disagrees on evidence block {h}"
                )
        # the pool moved it pending -> committed
        key = ev.hash()
        for n in net.nodes:
            if n.alive and key in n.node.evidence_pool._pending:
                raise self._fail(
                    f"node {n.idx} still holds committed evidence as "
                    f"pending"
                )
        return ev
