"""The 16-node LocalNetwork stall, on the JAX package's Node and hub and on
the port's.

Both packages' ConsensusState drop a vote of another height (or more than
a round ahead) and a proposal of another height or round. The JAX
LocalNetwork delivers each proposal and vote once, so a node that is
behind a message when it arrives never sees it again: it stalls at COMMIT
without the decided block, or a height behind, until a block is pushed to
it (chip_smoke.py phase 18's `catch_up`). The port's LocalNetwork sends
such a node those messages again when its consensus reaches them, as the
consensus reactor's gossip does over TCP (node/node.py LocalNetwork).

Each run starts 16 validators with tests/test_consensus.py's FAST
timeouts, host-verifying (the JAX Node's own path; the port's Node with
`oracle_batch_fn()`), and waits until one node has committed HEIGHTS,
then GRACE_S for the rest. A node still below HEIGHTS then has stalled:
it would need a push. Two schedules:
  * `free`: nothing is perturbed; whether a node stalls depends on
    thread timing;
  * `lagging`: node LAGGING's precommits of height 2 reach it only once
    every other node has committed height 3, so it processes (and drops)
    every height-3 message first. On the JAX hub it stalls every time.
The port's 16 nodes are held to zero stalled nodes in both, and in
`lagging` its hub must have sent the lagging node messages again; the
JAX counts are printed (run with -s). Every ed25519 verify is memoised per
(key, message, signature) in both packages for the run, as 16 nodes
verify each vote 15 times over (6 ms a pure-Python verify)."""
import functools
import importlib
import threading
import time

import pytest

N_VALS = 16
HEIGHTS = 4
LAGGING = 11
TOP_TIMEOUT_S = 40.0
GRACE_S = 8.0
PACKAGES = {"jax": "cometbft_tpu", "port": "cometbft_tpu_torch"}


def _ns(pkg):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return {k: m(v) for k, v in {
        "kv": "abci.kvstore", "ticker": "consensus.ticker",
        "keys": "crypto.keys", "ref": "crypto.ed25519_ref",
        "node": "node.node", "pv": "privval.file_pv",
        "state": "state.state", "val": "types.validator",
        "canonical": "types.canonical"}.items()}


def _build(P, pkg, tmp_path):
    FAST = P["ticker"].TimeoutParams(
        propose=0.4, propose_delta=0.1,
        prevote=0.2, prevote_delta=0.1,
        precommit=0.2, precommit_delta=0.1,
        commit=0.01,
    )
    privs = [P["keys"].PrivKey.generate(bytes([0x51, i + 1]) * 16)
             for i in range(N_VALS)]
    vals = P["val"].ValidatorSet(
        [P["val"].Validator(p.pub_key(), 10) for p in privs])
    state = P["state"].State.make_genesis("localnet-stall", vals)
    kw = {}
    if pkg == "cometbft_tpu_torch":
        from cometbft_tpu_torch.types.validation import oracle_batch_fn

        kw["batch_fn"] = oracle_batch_fn()
    net = P["node"].LocalNetwork()
    for i, priv in enumerate(privs):
        net.add(P["node"].Node(
            P["kv"].KVStoreApplication(), state.copy(),
            privval=P["pv"].FilePV(priv), home=str(tmp_path / f"n{i}"),
            broadcast=net.broadcaster(i), timeouts=FAST, **kw))
    return net


def _lag(P, nodes):
    """Hold node LAGGING's incoming precommits of height 2 until every
    other node has committed height 3."""
    cs = nodes[LAGGING].consensus
    real = cs.receive_vote
    held = []
    others = [n for i, n in enumerate(nodes) if i != LAGGING]
    precommit = P["canonical"].PRECOMMIT_TYPE

    def receive_vote(vote):
        if vote.height == 2 and vote.vote_type == precommit \
                and min(n.height() for n in others) < 3:
            held.append(vote)
        else:
            real(vote)

    def release():
        while min(n.height() for n in others) < 3:
            time.sleep(0.01)
        for v in held:
            real(v)

    cs.receive_vote = receive_vote
    threading.Thread(target=release, daemon=True).start()


def run_network(pkg, schedule, tmp_path):
    """-> (node heights once GRACE_S has passed, nodes below HEIGHTS,
    the hub's redelivered messages or None for the JAX hub)."""
    P = _ns(pkg)
    net = _build(P, pkg, tmp_path)
    nodes = net.nodes
    if schedule == "lagging":
        _lag(P, nodes)
    for n in nodes:
        n.start()
    try:
        deadline = time.time() + TOP_TIMEOUT_S
        while max(n.height() for n in nodes) < HEIGHTS:
            assert time.time() < deadline, \
                f"{pkg}: no node reached {HEIGHTS}: " \
                f"{[n.height() for n in nodes]}"
            time.sleep(0.02)
        deadline = time.time() + GRACE_S
        while min(n.height() for n in nodes) < HEIGHTS \
                and time.time() < deadline:
            time.sleep(0.02)
        heights = [n.height() for n in nodes]
    finally:
        for n in reversed(nodes):
            n.stop()
    return (heights, [i for i, h in enumerate(heights) if h < HEIGHTS],
            getattr(net, "redelivered", None))


@pytest.fixture
def memo_verify(monkeypatch):
    for pkg in PACKAGES.values():
        ref = importlib.import_module(f"{pkg}.crypto.ed25519_ref")
        monkeypatch.setattr(ref, "verify",
                            functools.lru_cache(maxsize=None)(ref.verify))


@pytest.mark.parametrize("schedule", ["free", "lagging"])
@pytest.mark.parametrize("side", ["jax", "port"])
def test_sixteen_nodes_stall(side, schedule, tmp_path, memo_verify):
    heights, stalled, resent = run_network(PACKAGES[side], schedule,
                                           tmp_path)
    print(f"{side} {schedule}: heights {heights}, stalled nodes "
          f"{stalled}, messages sent again {resent}")
    if side == "port":
        assert stalled == [], \
            f"the port's hub left nodes {stalled} behind: {heights}"
        if schedule == "lagging":
            assert resent > 0
    elif schedule == "lagging":
        # the reference's fault, reproduced: the lagging node dropped
        # every height-3 message and nothing sends them again
        assert LAGGING in stalled, heights
