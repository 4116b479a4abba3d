"""The port's simnet (cometbft_tpu_torch/simnet/) against the JAX
package's: the same (seed, schedule) through the JAX Simnet on the JAX
host verify plane and through the port's Simnet(device="cpu") on the
port's host plane (both use_device=False, window 0.5 ms, registered
global for the run), with the same node count and options.

Tolerance: byte-equal. Each scenario returns, per package, the geneses'
validator sets (address, key, power, hash), commit_hashes() at every
height on every node, the epoch results, the flood results' (seq, code)
pairs and the gateway results' verdicts; the two must be equal. The
scenarios: tests/test_simnet.py's quick run (seed 1), equivocator (11),
light attack (12), WAL crash and restart (21), garbage signer (22) and
gateway forged headers (37), the churn soak's schedule at 32 tail
members (tests/test_soak.py, with its verify-plane dispatch fault armed
process-globally) and a two-chain net."""
from types import SimpleNamespace

import pytest

from cometbft_tpu.libs import failpoints as jfp
from cometbft_tpu.simnet import Simnet as JaxSimnet
from cometbft_tpu.types.evidence import (
    DuplicateVoteEvidence as JaxDuplicateVote,
)
from cometbft_tpu.types.evidence import (
    LightClientAttackEvidence as JaxLightAttack,
)
from cometbft_tpu.verifyplane import VerifyPlane as JaxPlane
from cometbft_tpu.verifyplane import set_global_plane as jax_set_plane
from cometbft_tpu_torch.libs import failpoints as pfp
from cometbft_tpu_torch.simnet import Simnet as PortSimnet
from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence as PortDuplicateVote,
)
from cometbft_tpu_torch.types.evidence import (
    LightClientAttackEvidence as PortLightAttack,
)
from cometbft_tpu_torch.verifyplane import VerifyPlane as PortPlane
from cometbft_tpu_torch.verifyplane import set_global_plane as port_set_plane

pytestmark = pytest.mark.simnet

JAX = SimpleNamespace(name="jax", Simnet=JaxSimnet, Plane=JaxPlane,
                      set_plane=jax_set_plane, fp=jfp, kw={},
                      DuplicateVote=JaxDuplicateVote,
                      LightAttack=JaxLightAttack)
PORT = SimpleNamespace(name="port", Simnet=PortSimnet, Plane=PortPlane,
                       set_plane=port_set_plane, fp=pfp,
                       kw={"device": "cpu"},
                       DuplicateVote=PortDuplicateVote,
                       LightAttack=PortLightAttack)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    jfp.reset()
    pfp.reset()
    yield
    jfp.reset()
    pfp.reset()


def _valsets(sim):
    return [[(v.address.hex(), v.pub_key.data.hex(), v.voting_power)
             for v in g.validators.validators] + [g.validators.hash().hex()]
            for g in sim.net.geneses]


def _outputs(sim):
    return {
        "valsets": _valsets(sim),
        "hashes": sim.commit_hashes(),
        "epochs": [dict(r) for r in sim.epoch_results],
        "flood": [(r["seq"], r["code"]) for r in sim.flood_results],
        "gateway": [(r["seq"], r["status"], r.get("target_hash"),
                     r.get("cached"), r.get("evidence_added"))
                    for r in sim.gateway_results],
    }


def _simnet(P, tmp_path, n, seed, **kw):
    return P.Simnet(n, seed=seed, basedir=str(tmp_path / P.name),
                    **P.kw, **kw)


def _run(P, tmp_path, scenario):
    plane = P.Plane(window_ms=0.5, use_device=False,
                    bulk_deadline_ms=250.0)
    plane.start()
    P.set_plane(plane)
    try:
        out = scenario(P, tmp_path)
    finally:
        P.set_plane(None)
        plane.stop()
        P.fp.reset()
    assert plane.rows_verified > 0  # the votes rode the package's plane
    assert plane.stats()["breaker_state"] == "closed"
    return out


# -- the scenarios, as functions of a package namespace --------------------


def sc_quick(P, tmp_path):
    with _simnet(P, tmp_path, 4, 1) as sim:
        assert sim.run([], until_height=3, max_time=60.0)
        sim.assert_safety()
        return _outputs(sim)


def sc_equivocator(P, tmp_path):
    with _simnet(P, tmp_path, 4, 11) as sim:
        sim.run([{"at": 0.12, "op": "equivocate", "node": 3, "votes": 2}],
                until_height=2, max_time=60.0)
        ev = sim.assert_evidence_committed(
            predicate=lambda e: isinstance(e, P.DuplicateVote))
        sim.assert_safety()
        sim.assert_liveness(min_new_heights=2, max_time=30.0)
        return dict(_outputs(sim), evidence=ev.bytes().hex())


def sc_light_attack(P, tmp_path):
    with _simnet(P, tmp_path, 4, 12) as sim:
        sim.run([], until_height=2, max_time=60.0)
        sim.run([{"at": sim.net.now + 0.05, "op": "light_attack",
                  "byz": [2, 3], "target": 0, "height": 1}], max_time=1.0)
        ev = sim.assert_evidence_committed(
            predicate=lambda e: isinstance(e, P.LightAttack))
        sim.assert_safety()
        return dict(_outputs(sim), evidence=ev.bytes().hex())


def sc_garbage_signer(P, tmp_path):
    with _simnet(P, tmp_path, 4, 22) as sim:
        assert sim.run([{"at": 0.1, "op": "garbage", "node": 1,
                         "votes": 4}], until_height=4, max_time=60.0)
        sim.assert_safety()
        return _outputs(sim)


def sc_wal_crash_restart(P, tmp_path):
    with _simnet(P, tmp_path, 4, 21) as sim:
        sim.run([{"at": 0.15, "op": "failpoint", "node": 2,
                  "spec": "consensus.wal.post_vote=crash*1"},
                 {"at": 2.0, "op": "restart", "node": 2}],
                until_height=4, max_time=120.0)
        n2 = sim.net.nodes[2]
        tip = max(n.height() for n in sim.net.nodes if n.alive)
        assert sim.run([], until=lambda: n2.alive and n2.height() >= tip,
                       max_time=60.0)
        assert n2.restarts == 1
        sim.assert_safety()
        return dict(_outputs(sim), fires=n2.registry.stats(
            "consensus.wal.post_vote")["fires"])


def sc_gateway_forged(P, tmp_path):
    with _simnet(P, tmp_path, 4, 37) as sim:
        sim.run([], until_height=2, max_time=60.0)
        sim.run([{"at": sim.net.now + 0.05, "op": "gateway_sync",
                  "node": 0, "clients": 6, "trusted": 1, "target": 2,
                  "forged": [1, 4], "byz": [2, 3]}], max_time=2.0)
        ev = sim.assert_evidence_committed(
            predicate=lambda e: isinstance(e, P.LightAttack))
        sim.assert_safety()
        out = dict(_outputs(sim), evidence=ev.bytes().hex())
    assert [g[1] for g in out["gateway"]] == [
        "verified", "divergent", "verified", "verified", "divergent",
        "verified"]
    return out


# tests/test_soak.py:181-198 (_run_churn): CHAOS + EPOCHS + FLOOD over a
# 32-member passive tail, the dispatch fault armed process-globally
CHAOS = [
    {"at": 1.0, "op": "garbage", "node": 2, "votes": 2},
    {"at": 1.5, "op": "partition", "groups": [[0, 1, 2], [3]]},
    {"at": 3.0, "op": "heal"},
    {"at": 3.5, "op": "kill", "node": 1},
    {"at": 5.0, "op": "restart", "node": 1},
    {"at": 5.5, "op": "link", "drop": 0.05, "delay": 0.01,
     "jitter": 0.005},
    {"at": 7.0, "op": "heal"},
]
EPOCHS = [
    {"at": 1.0, "op": "epoch", "node": 0, "churn": 0.25},
    {"at": 2.2, "op": "epoch", "node": 3, "churn": 0.25},
    {"at": 4.2, "op": "epoch", "node": 1, "churn": 0.25},
]
FLOOD = {"at": 0.6, "op": "flood", "node": 0, "rate": 30.0,
         "duration": 6.0, "signed": True, "size": 24}


def sc_churn_soak(P, tmp_path):
    P.fp.registry().arm_from_spec("verifyplane.dispatch=raise*1")
    with _simnet(P, tmp_path, 4, 4242, power=100_000,
                 extra_validators=32) as sim:
        assert sim.run(list(CHAOS) + list(EPOCHS) + [dict(FLOOD)],
                       until_height=9, max_time=90.0)
        sim.assert_safety()
        out = _outputs(sim)
    assert len(out["epochs"]) == 3 and len(out["flood"]) == 180
    assert all("error" not in r for r in out["epochs"])
    return out


def sc_two_chains(P, tmp_path):
    with _simnet(P, tmp_path, 3, 505, n_chains=2) as sim:
        assert sim.run([
            {"at": 0.3, "op": "tx", "node": 1, "data": b"two=chains".hex()},
            {"at": 0.5, "op": "garbage", "node": 4, "votes": 2},
            {"at": 0.8, "op": "partition", "groups": [[0, 1, 3, 4], [2, 5]]},
            {"at": 1.6, "op": "heal"}], until_height=3, max_time=60.0)
        out = _outputs(sim)
        groups = [n.group for n in sim.net.nodes]
    # assert_safety compares every node's chain, across groups too: here
    # each group's nodes agree with one another
    for g in (0, 1):
        chains = [h for h, gi in zip(out["hashes"], groups) if gi == g]
        for h in set().union(*chains):
            assert len({c[h] for c in chains if h in c}) == 1, (g, h)
    assert out["valsets"][0] != out["valsets"][1]
    return out


# keyed by the test each scenario comes from
SCENARIOS = {
    "quick_consensus_no_faults": sc_quick,
    "equivocator_lands_in_committed_evidence": sc_equivocator,
    "light_client_attack_evidence_committed": sc_light_attack,
    "garbage_signer_does_not_poison_verify_plane": sc_garbage_signer,
    "failpoint_crash_and_wal_recovery": sc_wal_crash_restart,
    "gateway_forged_header_scenario": sc_gateway_forged,
    "churn_soak_32_tail_members": sc_churn_soak,
    "two_chain_net": sc_two_chains,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simnet_commits_equal_on_the_port_plane(tmp_path, name):
    want = _run(JAX, tmp_path, SCENARIOS[name])
    got = _run(PORT, tmp_path, SCENARIOS[name])
    assert got == want
    for hashes in got["hashes"]:
        assert len(hashes) >= 2  # every node committed a chain


def test_the_port_plane_under_jax_nodes(tmp_path):
    """The port's host plane mounted under JAX nodes (through the JAX
    package's set_global_plane): the JAX VoteSet hands it its own rows
    (PubKey objects, a QuorumGroup, stamp templates), the port's host
    path takes them as they are, and the commits equal the JAX plane's."""
    def run(plane_cls, tag):
        plane = plane_cls(window_ms=0.5, use_device=False)
        plane.start()
        jax_set_plane(plane)
        try:
            with JaxSimnet(4, seed=22, basedir=str(tmp_path / tag)) as sim:
                assert sim.run([{"at": 0.1, "op": "garbage", "node": 1,
                                 "votes": 4}], until_height=4,
                               max_time=60.0)
                sim.assert_safety()
                hashes = sim.commit_hashes()
        finally:
            jax_set_plane(None)
            plane.stop()
        return hashes, plane

    want, _ = run(JaxPlane, "jax")
    got, pplane = run(PortPlane, "port")
    assert got == want
    assert pplane.rows_verified > 0
    assert pplane.stats()["breaker_state"] == "closed"
    assert {r["path"] for r in pplane.dump_flushes()["flushes"]} <= {"host"}


def test_simnet_without_a_device_is_the_card(tmp_path):
    """Simnet() with no device resolves the card: with no card here its
    first node raises DeviceError, with no silent CPU path."""
    from cometbft_tpu_torch.device import DeviceError

    sim = PortSimnet(2, seed=3, basedir=str(tmp_path))
    with pytest.raises(DeviceError):
        sim.run([], until_height=1, max_time=1.0)
    sim.net._uninstall_clock()
