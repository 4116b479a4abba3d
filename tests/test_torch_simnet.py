"""The simnet gate of the port's verify plane: two scenarios of
tests/test_simnet.py run with the port's host-path plane
(`use_device=False`, as those scenarios use the JAX plane) mounted through
the JAX package's `verifyplane.set_global_plane`, so the JAX VoteSet,
crypto.batch and mempool submit to the port's plane. Safety holds, the
port's plane verified rows, and every node's commit hashes equal the same
seed's run on the JAX plane.

The JAX VoteSet hands the plane its own objects (PubKey rows, a
QuorumGroup, stamp templates); the port's host path takes them as they
are (it calls `pub.verify_signature` and `group.add`), so no adapter is
needed here."""
import pytest

from cometbft_tpu.libs import failpoints as jfp
from cometbft_tpu.simnet import Simnet
from cometbft_tpu.verifyplane import VerifyPlane as JaxPlane
from cometbft_tpu.verifyplane import set_global_plane
from cometbft_tpu_torch.verifyplane import VerifyPlane as PortPlane

pytestmark = pytest.mark.simnet


@pytest.fixture(autouse=True)
def _clean_failpoints():
    jfp.reset()
    yield
    jfp.reset()


def _run(tmp_path, tag, plane_cls, seed, schedule, until_height):
    plane = plane_cls(window_ms=0.5, use_device=False)
    plane.start()
    set_global_plane(plane)
    try:
        with Simnet(4, seed=seed, basedir=str(tmp_path / tag)) as sim:
            assert sim.run(schedule, until_height=until_height,
                           max_time=60.0)
            assert all(n.height() >= until_height for n in sim.net.nodes)
            sim.assert_safety()
            hashes = sim.commit_hashes()
    finally:
        set_global_plane(None)
        plane.stop()
    return hashes, plane


SCENARIOS = {
    # test_simnet.py::test_quick_consensus_no_faults
    "quick_consensus_no_faults": (1, [], 3),
    # test_simnet.py::test_garbage_signer_does_not_poison_verify_plane
    "garbage_signer_does_not_poison_verify_plane": (
        22, [{"at": 0.1, "op": "garbage", "node": 1, "votes": 4}], 4),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simnet_commits_equal_on_the_port_plane(tmp_path, name):
    seed, schedule, height = SCENARIOS[name]
    want, jplane = _run(tmp_path, "jax", JaxPlane, seed, schedule, height)
    got, pplane = _run(tmp_path, "port", PortPlane, seed, schedule, height)
    assert got == want
    assert len({h[2] for h in got}) == 1  # every node committed block 2
    assert jplane.rows_verified > 0
    assert pplane.rows_verified > 0  # votes really rode the port's plane
    stats = pplane.stats()
    assert stats["breaker_state"] == "closed", stats
    assert {r["path"] for r in pplane.dump_flushes()["flushes"]} <= {
        "host"}
