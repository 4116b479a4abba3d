"""tests/test_pex.py on the port (tests/torch_mirror.py): the address
book's persistence, buckets, backoff and pick bias, PEX discovery of a
third node, and a restarted node that redials from its persisted book.
The port's nodes run on device="cpu" over a host verify plane.

test_pex_discovers_third_node takes 4 s to 280 s on a loaded host, in
both packages: its three validators escalate their round timeouts while
the mesh forms, and it waits up to 280 s for height 2. Its port copy is
`slow`; the quick sibling below checks the discovery itself (A dials only
B, learns C through PEX and dials it) on nodes that hold no validator
key, so no round escalates: within DISCOVERY_TIMEOUT_S A is linked to
C, found by PEX either way round."""
import time

import pytest

import torch_mirror as tm

NAMES = [
    "test_addrbook_persistence_and_caps",
    "test_addrbook_buckets_promote_demote",
    "test_addrbook_backoff_and_seed_retention",
    "test_addrbook_pick_bias_and_new_eviction",
    "test_node_redials_from_persisted_book",
]
PORT = tm.load("test_pex.py")
DISCOVERY_TIMEOUT_S = 60.0


@pytest.mark.parametrize("mod,name", tm.cases(PORT, NAMES))
def test_pex(mod, name, request):
    tm.run(mod, name, request)


@pytest.mark.slow
@pytest.mark.parametrize("mod,name", tm.cases(
    PORT, ["test_pex_discovers_third_node"]))
def test_pex_slow(mod, name, request):
    tm.run(mod, name, request)


def _discovery(m, tmp_path):
    """m: the mirror module of tests/test_pex.py (its imports are the
    port's)."""
    val = m.PrivKey.generate(b"\x7f" * 32)
    state = m.State.make_genesis("pex-quick", m.ValidatorSet(
        [m.Validator(val.pub_key(), 10)]))
    nodes, addrs = [], []
    for i in range(3):
        n = m.Node(m.KVStoreApplication(), state.copy(),
                   home=str(tmp_path / f"q{i}"), timeouts=m.FAST,
                   p2p=True, pex=True,
                   node_key=m.NodeKey(m.PrivKey.generate(
                       bytes([0x78 + i]) * 32)))
        n.pex_reactor.ensure_interval = 0.3
        addrs.append(n.listen())
        nodes.append(n)
    for n in nodes:
        n.start()
    try:
        nodes[0].dial(addrs[1])
        nodes[2].dial(addrs[1])
        b_id, c_id = (n.switch.node_key.node_id for n in nodes[1:])
        deadline = time.time() + DISCOVERY_TIMEOUT_S
        # both links up at once (a crossed dial A->C / C->A may drop one
        # of the pair for a moment)
        while not {b_id, c_id} <= set(nodes[0].switch.peers):
            assert time.time() < deadline, \
                f"A peers: {list(nodes[0].switch.peers)}"
            time.sleep(0.1)
        # only A-B and C-B were dialed: the A-C link means one of the two
        # learned the other's address from B's PEX answer and dialed it
        a_id = nodes[0].switch.node_key.node_id
        assert c_id in nodes[0].addr_book._addrs \
            or a_id in nodes[2].addr_book._addrs
    finally:
        for n in nodes:
            n.stop()


def test_pex_discovers_third_node_quick(tmp_path):
    with tm.host_plane():
        _discovery(PORT, tmp_path)
