"""Declarative fault schedules for the simnet.

A schedule is a JSON-serializable list of timed ops — the analog of
CometBFT's e2e perturbation plans (test/e2e/runner/perturb.go), but
deterministic and replayable: `(seed, schedule)` fully determines a run,
and every harness assertion failure prints both.

Op catalog (each op is a plain dict, `at` in simulated seconds):

  {"at": t, "op": "partition", "groups": [[0,1],[2,3]]}
      Nodes communicate only within their group (links across groups go
      down). Unlisted nodes are isolated.
  {"at": t, "op": "heal"}
      All links up, fault probabilities reset to zero.
  {"at": t, "op": "link", "frm": [..], "to": [..], "drop": p,
   "delay": s, "jitter": s, "dup": p, "reorder": p}
      Set fault parameters on the selected directed links (omit
      frm/to for all links; only the keys present are changed).
  {"at": t, "op": "kill", "node": i}
      Crash-halt node i (no graceful teardown; stores/WAL stay on disk).
  {"at": t, "op": "restart", "node": i}
      Rebuild node i over its home dir (WAL recovery + handshake replay).
  {"at": t, "op": "failpoint", "node": i, "spec": "name=action[..]"}
      Arm a libs/failpoints spec on node i's PRIVATE registry.
  {"at": t, "op": "equivocate", "node": i, "votes": k}
      Node i double-signs its next k own non-nil votes.
  {"at": t, "op": "garbage", "node": i, "votes": k}
      Node i's next k own votes leave with garbage signatures.
  {"at": t, "op": "light_attack", "byz": [..], "target": i,
   "height": h}
      Deliver a forged-header LightClientAttackEvidence (signed by the
      byz validators at height h) to node i as evidence gossip.
  {"at": t, "op": "tx", "node": i, "data": "<hex>"}
      Inject a transaction into node i's mempool.
  {"at": t, "op": "gateway_sync", "node": i, "clients": k,
   "trusted": h0, "target": h, "forged": [..], "byz": [..]}
      Mount a light-client gateway on node i (cometbft_tpu_torch.lightgate)
      and drive k client syncs through it at fixed sim times: each
      client asks to verify `target` from `trusted`. Clients whose
      index is listed in "forged" submit a forged claimed header
      sealed by the "byz" validators (a lying-primary feed) — the
      gateway must answer them with divergent verdicts, push
      LightClientAttackEvidence through the node's evidence pool, and
      keep serving the honest clients. Every verdict is recorded on
      Simnet.gateway_results (replay-assertable).
  {"at": t, "op": "epoch", "node": i, "churn": k}
      One epoch of proportional committee re-election over the
      network's passive validator tail (SimNetwork extra_validators):
      the deterministic election (simnet/actors.proportional_election,
      seeded by (seed, epoch index)) rotates churn*committee_size
      members out/in, and the change set is injected as kvstore
      ``val:`` txs into every alive node's mempool starting at node i
      — so the rotation flows through the REAL ABCI validator-update
      -> ValidatorSet.update_with_change_set -> state/execution.py
      path and lands in the valset at H+2. Election outcomes are
      recorded on Simnet.epoch_results (replay-assertable); a network
      built without a tail records an error instead of perturbing
      nothing silently.
  {"at": t, "op": "flood", "node": i, "rate": txs_per_sim_second,
   "duration": s, "signed": bool, "size": payload_bytes}
      Open-loop sustained tx stream into node i's broadcast_tx path:
      rate*duration txs injected at FIXED simulated times (open-loop —
      injection never waits on responses, like test/loadtime). With
      "signed": true each tx rides a sigtx envelope (deterministic key)
      so CheckTx signature verification exercises the verify plane's
      BULK lane. Every CheckTx response is recorded on the harness
      (Simnet.flood_results) so overload verdicts are assertable.
  {"at": t, "op": "controller", "node": i, "slo_commit_p99_ms": ms,
   "decision_interval": k, "cooldown": c,
   "bounds": {actuator: [lo, hi]}, ...}
      Mount the self-tuning control plane (libs/controller.Controller)
      on node i: attached to that node's admission gate + height
      ledger and the process-global verify plane, registered as THE
      module-global controller so the consensus-step / dispatcher-
      drain pokes start deciding. Any Controller constructor kwarg may
      ride in the op. Decisions are count-based on deterministic poke
      sites, so the /dump_controller decision stream replays
      byte-identically for the same (seed, schedule); the decision
      tail rides every SimnetFailure replay blob.
"""
from __future__ import annotations

import json
from typing import Dict, List

OPS = ("partition", "heal", "link", "kill", "restart", "failpoint",
       "equivocate", "garbage", "light_attack", "gateway_sync", "tx",
       "flood", "epoch", "controller")

_LINK_KEYS = ("drop", "delay", "jitter", "dup", "reorder")


class ScheduleError(Exception):
    pass


def validate_schedule(schedule: List[Dict], n_nodes: int) -> None:
    """Structural validation so a typo'd schedule fails loudly up front
    instead of silently perturbing nothing."""
    for op in schedule:
        if not isinstance(op, dict) or "op" not in op or "at" not in op:
            raise ScheduleError(f"malformed op {op!r}")
        kind = op["op"]
        if kind not in OPS:
            raise ScheduleError(f"unknown op {kind!r}")
        if float(op["at"]) < 0:
            raise ScheduleError(f"negative time in {op!r}")
        for key in ("node", "target"):
            if key in op and not 0 <= int(op[key]) < n_nodes:
                raise ScheduleError(f"{key} out of range in {op!r}")
        for key in ("byz", "frm", "to"):
            sel = op.get(key, [])
            if not isinstance(sel, (list, tuple)):
                raise ScheduleError(
                    f"{key} must be a list of node ids in {op!r}"
                )
            for i in sel:
                if not 0 <= int(i) < n_nodes:
                    raise ScheduleError(
                        f"{key} node out of range in {op!r}"
                    )
        # node-targeting ops must NAME their target up front: a missing
        # selector otherwise validates fine and KeyErrors mid-simulation
        # (a replay-blob failure instead of this loud ScheduleError)
        if kind in ("kill", "restart", "failpoint", "equivocate",
                    "garbage", "tx", "flood", "gateway_sync",
                    "epoch", "controller") \
                and "node" not in op:
            raise ScheduleError(f"{kind} requires a node in {op!r}")
        if kind == "controller":
            for key in ("slo_commit_p99_ms", "slo_gateway_wait_ms",
                        "slo_bulk_wait_ms"):
                if key in op and float(op[key]) <= 0:
                    raise ScheduleError(
                        f"controller {key} must be > 0 in {op!r}")
            if int(op.get("decision_interval", 1)) < 1:
                raise ScheduleError(
                    f"controller decision_interval must be >= 1 "
                    f"in {op!r}")
            if int(op.get("cooldown", 0)) < 0:
                raise ScheduleError(
                    f"controller cooldown must be >= 0 in {op!r}")
            for name, b in (op.get("bounds") or {}).items():
                if (not isinstance(b, (list, tuple)) or len(b) != 2
                        or float(b[0]) > float(b[1])):
                    raise ScheduleError(
                        f"controller bounds[{name!r}] must be a "
                        f"[lo, hi] pair with lo <= hi in {op!r}")
        if kind == "epoch":
            churn = float(op.get("churn", 0.25))
            if not 0.0 < churn <= 1.0:
                raise ScheduleError(
                    f"epoch churn must be in (0, 1] in {op!r}")
        if kind == "gateway_sync":
            if int(op.get("clients", 0)) < 1:
                raise ScheduleError(
                    f"gateway_sync needs clients >= 1 in {op!r}")
            if int(op.get("target", 0)) < 1:
                raise ScheduleError(
                    f"gateway_sync needs target >= 1 in {op!r}")
            forged = op.get("forged", [])
            if not isinstance(forged, (list, tuple)):
                raise ScheduleError(
                    f"forged must be a list of client indices in {op!r}")
            for i in forged:
                if not 0 <= int(i) < int(op["clients"]):
                    raise ScheduleError(
                        f"forged client index out of range in {op!r}")
            if forged and not op.get("byz"):
                raise ScheduleError(
                    f"gateway_sync with forged clients needs byz "
                    f"signers in {op!r}")
        if kind == "light_attack" and "target" not in op:
            raise ScheduleError(
                f"light_attack requires a target in {op!r}")
        if kind == "partition":
            seen = set()
            for grp in op.get("groups", []):
                for i in grp:
                    if not 0 <= int(i) < n_nodes or i in seen:
                        raise ScheduleError(f"bad partition {op!r}")
                    seen.add(i)
        if kind == "failpoint":
            from cometbft_tpu_torch.libs.failpoints import parse_spec

            parse_spec(op.get("spec", ""))  # raises on malformed specs
        if kind == "flood":
            if float(op.get("rate", 0)) <= 0:
                raise ScheduleError(f"flood rate must be > 0 in {op!r}")
            if float(op.get("duration", 0)) <= 0:
                raise ScheduleError(
                    f"flood duration must be > 0 in {op!r}")
            if int(op.get("size", 16)) < 1:
                raise ScheduleError(f"flood size must be >= 1 in {op!r}")


def schedule_to_json(seed: int, schedule: List[Dict]) -> str:
    """The replay blob printed on every simnet failure."""
    return json.dumps({"seed": seed, "schedule": schedule}, sort_keys=True)


def schedule_from_json(blob: str):
    j = json.loads(blob)
    return j["seed"], j["schedule"]


def random_schedule(rng, n_nodes: int, horizon: float = 20.0,
                    n_ops: int = 6, epochs: bool = False) -> List[Dict]:
    """A seeded random schedule for the fuzzer (tools/simnet_fuzz.py):
    draws from the full op catalog, keeps kills bounded so quorum can
    survive, and always heals before the horizon so liveness is
    checkable afterwards. `epochs=True` adds the epoch-rotation op to
    the pool (only meaningful when the fuzzer built its Simnet with a
    validator tail — rotation then interleaves with partitions, kills
    and floods exactly like production re-election under faults)."""
    ops: List[Dict] = []
    killed: set = set()
    max_kill = max(0, (n_nodes - 1) // 3)
    pool = ["partition", "link", "kill_restart", "failpoint",
            "equivocate", "garbage", "tx"]
    if epochs:
        pool += ["epoch", "epoch"]  # rotation-heavy: churn is the point
    for _ in range(n_ops):
        at = round(rng.uniform(1.0, horizon * 0.6), 3)
        kind = rng.choice(pool)
        if kind == "partition":
            cut = rng.randrange(1, n_nodes)
            idxs = list(range(n_nodes))
            rng.shuffle(idxs)
            ops.append({"at": at, "op": "partition",
                        "groups": [sorted(idxs[:cut]),
                                   sorted(idxs[cut:])]})
            ops.append({"at": round(at + rng.uniform(1.0, 4.0), 3),
                        "op": "heal"})
        elif kind == "link":
            ops.append({
                "at": at, "op": "link",
                "drop": round(rng.uniform(0.0, 0.2), 3),
                "delay": round(rng.uniform(0.005, 0.05), 4),
                "jitter": round(rng.uniform(0.0, 0.02), 4),
                "dup": round(rng.uniform(0.0, 0.1), 3),
                "reorder": round(rng.uniform(0.0, 0.1), 3),
            })
        elif kind == "kill_restart":
            if len(killed) >= max_kill:
                continue
            victim = rng.randrange(n_nodes)
            killed.add(victim)
            ops.append({"at": at, "op": "kill", "node": victim})
            ops.append({"at": round(at + rng.uniform(1.0, 4.0), 3),
                        "op": "restart", "node": victim})
        elif kind == "failpoint":
            node = rng.randrange(n_nodes)
            point = rng.choice([
                "consensus.wal.pre_vote", "consensus.wal.post_vote",
                "consensus.wal.pre_proposal", "consensus.pre_finalize",
            ])
            action = rng.choice(["raise", "crash"])
            ops.append({"at": at, "op": "failpoint", "node": node,
                        "spec": f"{point}={action}*1"})
            if action == "crash":
                ops.append({"at": round(at + rng.uniform(1.0, 4.0), 3),
                            "op": "restart", "node": node})
        elif kind == "equivocate":
            ops.append({"at": at, "op": "equivocate",
                        "node": rng.randrange(n_nodes), "votes": 1})
        elif kind == "garbage":
            ops.append({"at": at, "op": "garbage",
                        "node": rng.randrange(n_nodes),
                        "votes": rng.randrange(1, 4)})
        elif kind == "epoch":
            ops.append({"at": at, "op": "epoch",
                        "node": rng.randrange(n_nodes),
                        "churn": round(rng.uniform(0.1, 0.5), 2)})
        else:
            ops.append({"at": at, "op": "tx",
                        "node": rng.randrange(n_nodes),
                        "data": bytes(
                            f"k{rng.randrange(1000)}=v", "ascii"
                        ).hex()})
    # terminal heal so post-schedule liveness is meaningful
    ops.append({"at": round(horizon * 0.7, 3), "op": "heal"})
    ops.sort(key=lambda o: o["at"])
    return ops
