"""The port's block execution (cometbft_tpu_torch/state/execution.py) over
its State and sqlite StateStore, BlockStore, genesis and mempool, against
the JAX package's.

A chain of real blocks runs on each package from one GenesisDoc built from
the same key seeds: each height's txs (signed envelopes, key/value txs and,
at the rotation height, `val:` txs that remove one validator and add a new
key) enter through Mempool.check_tx on a host plane, the executor proposes
the block (create_proposal_block reaps the pool under the genesis block
size), every validator of the height signs its commit, and apply_block
validates the block, its LastCommit at full power included, then applies
it to the kvstore. The JAX executor verifies each LastCommit on the host
(batch_fn=None); the port's with validation.device_batch_fn(device="cpu").
Block hashes, app hashes, results hashes, validator sets with proposer
priorities, every StateStore row, every BlockStore row and the valset the
warmer is told of must be equal, for 6 heights at 4 validators (BASELINE
config 1's kvstore) and at 16 with a rotation at height 3. A tampered
LastCommit and a wrong app hash must give the JAX error class and text and
leave the state and stores as they were. tests/test_warmer.py:483
(_update_state drops the updates it cannot apply) runs on both packages;
a StateStore file written by one package is read by the other. Then the
port's device seam: BlockExecutor(batch_fn=None) verifies on the running
plane's CONSENSUS lane (one grouped flush a LastCommit), and with no plane
on the card (DeviceError here)."""
import base64
import copy
import sqlite3
from types import SimpleNamespace

import pytest
import torch

from cometbft_tpu import verifyplane as jvp
from cometbft_tpu.abci import kvstore as jkv
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.mempool import mempool as jmp
from cometbft_tpu.mempool import sigtx as jsigtx
from cometbft_tpu.state import execution as jex
from cometbft_tpu.state import state as jstate
from cometbft_tpu.store import blockstore as jbs
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import block_id as jbid
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import genesis as jgen
from cometbft_tpu.types import params as jparams
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validation as jvalidation
from cometbft_tpu.types import validator as jval
from cometbft_tpu.verifyplane import warmer as jwarmer
from cometbft_tpu_torch import verifyplane as pvp
from cometbft_tpu_torch.abci import kvstore as pkv
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.device import DeviceError
from cometbft_tpu_torch.mempool import mempool as pmp
from cometbft_tpu_torch.mempool import sigtx as psigtx
from cometbft_tpu_torch.state import execution as pex
from cometbft_tpu_torch.state import state as pstate
from cometbft_tpu_torch.store import blockstore as pbs
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import block_id as pbid
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import commit as pcommit
from cometbft_tpu_torch.types import genesis as pgen
from cometbft_tpu_torch.types import params as pparams
from cometbft_tpu_torch.types import timestamp as pts
from cometbft_tpu_torch.types import validation as pvalidation
from cometbft_tpu_torch.types import validator as pval
from cometbft_tpu_torch.verifyplane import warmer as pwarmer

torch.set_num_threads(1)

JAX = SimpleNamespace(
    name="jax", abci=jabci, kv=jkv, keys=jkeys, mp=jmp, sigtx=jsigtx,
    ex=jex, state=jstate, bs=jbs, block=jblock, bid=jbid, canon=jcanon,
    commit=jcommit, gen=jgen, params=jparams, ts=jts,
    validation=jvalidation, val=jval, vp=jvp, warmer=jwarmer,
    batch_fn=lambda: None)
PORT = SimpleNamespace(
    name="port", abci=pabci, kv=pkv, keys=pkeys, mp=pmp, sigtx=psigtx,
    ex=pex, state=pstate, bs=pbs, block=pblock, bid=pbid, canon=pcanon,
    commit=pcommit, gen=pgen, params=pparams, ts=pts,
    validation=pvalidation, val=pval, vp=pvp, warmer=pwarmer,
    batch_fn=lambda: pvalidation.device_batch_fn(device="cpu"))
PACKAGES = (JAX, PORT)

CHAIN = "exec-chain"
T0 = 1_700_000_000
HEIGHTS = 6
ROTATE_AT = 3


class StubWarmer:
    """A running warmer that records the valsets it is told of."""

    def __init__(self):
        self.valsets = []

    def is_running(self):
        return True

    def request_valset(self, vals, chain_id=None):
        self.valsets.append((chain_id, [(v.address.hex(), v.voting_power)
                                        for v in vals.validators]))


class Chain:
    """A genesis of `n` validators of package P, its app, mempool,
    stores and executor; `run` produces and applies heights."""

    def __init__(self, P, n, tmp, batch_fn=None, rotate=False):
        self.P, self.n, self.rotate = P, n, rotate
        self.privs = [P.keys.PrivKey.generate(bytes([n, i + 1]) + b"\x0e" * 30)
                      for i in range(n)]
        self.new_priv = P.keys.PrivKey.generate(bytes([n, 0xEE]) + b"\x0f" * 30)
        self.by_addr = {p.pub_key().address(): p
                        for p in self.privs + [self.new_priv]}
        self.clients = [P.keys.PrivKey.generate(bytes([0xC0 + k]) * 32)
                        for k in range(3)]
        self.doc = P.gen.GenesisDoc(
            chain_id=CHAIN, genesis_time=P.ts.Timestamp(T0, 0),
            validators=[P.gen.GenesisValidator(p.pub_key(), 10 + 3 * i,
                                               f"v{i}")
                        for i, p in enumerate(self.privs)],
            consensus_params=P.params.ConsensusParams.from_j(
                {"block": {"max_bytes": 700}}))
        self.state = self.doc.make_state()
        self.app = P.kv.KVStoreApplication()
        self.mempool = P.mp.Mempool(self.app, verify_sigs=True)
        self.store = P.state.StateStore(str(tmp / f"{P.name}-state.db"))
        self.blocks = P.bs.BlockStore(str(tmp / f"{P.name}-blocks.db"))
        self.ex = P.ex.BlockExecutor(self.app, self.store,
                                     batch_fn=batch_fn,
                                     mempool=self.mempool)
        self.store.save(self.state)
        self.last_commit = None
        self.codes = []

    def txs(self, h):
        P = self.P
        out = [P.sigtx.wrap(c, b"h%d-c%d=%d" % (h, k, h * k))
               for k, c in enumerate(self.clients)]
        out += [b"plain-%d-%d=x" % (h, i) for i in range(3)]
        if self.rotate and h == ROTATE_AT:
            gone = self.state.validators.validators[-1].pub_key.data
            out += [b"val:" + base64.b64encode(gone) + b"!0",
                    b"val:" + base64.b64encode(
                        self.new_priv.pub_key().data) + b"!25"]
        return out

    def sign(self, vals, bid, h):
        P = self.P
        sigs = [P.commit.CommitSig(P.commit.BLOCK_ID_FLAG_COMMIT, v.address,
                                   P.ts.Timestamp(T0 + h, 1000 * i), b"")
                for i, v in enumerate(vals.validators)]
        commit = P.commit.Commit(h, 0, bid, sigs)
        for i, cs in enumerate(commit.signatures):
            cs.signature = self.by_addr[cs.validator_address].sign(
                commit.vote_sign_bytes(CHAIN, i))
        return commit

    def propose(self, h, last_commit=None):
        for tx in self.txs(h):
            self.codes.append(self.mempool.check_tx(tx).code)
        return self.ex.create_proposal_block(
            h, self.state, last_commit or self.last_commit,
            self.state.validators.get_proposer().address)

    def apply(self, block):
        bid = block.block_id()
        commit = self.sign(self.state.validators, bid, block.header.height)
        self.state = self.ex.apply_block(self.state, bid, block)
        self.blocks.save_block(block, commit)
        self.last_commit = commit

    def run(self, heights):
        for h in range(self.state.last_block_height + 1, heights + 1):
            self.apply(self.propose(h))


def valset_rows(vs):
    return None if vs is None else [
        (v.address.hex(), v.voting_power, v.proposer_priority)
        for v in vs.validators] + [
        vs.get_proposer().address.hex() if vs.validators else None]


def db_rows(path):
    db = sqlite3.connect(path)
    try:
        tables = [r[0] for r in db.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "ORDER BY name")]
        return {t: db.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in tables}
    finally:
        db.close()


def chain_outcome(c, tmp):
    P = c.P
    st = c.state
    heights = []
    for h in range(1, st.last_block_height + 1):
        b = c.blocks.load_block(h)
        heights.append({"hash": b.hash().hex(),
                        "txs": len(b.data.txs),
                        "time": (b.header.time.seconds, b.header.time.nanos),
                        "results": c.store.load_abci_responses(h)})
    return {
        "heights": heights, "codes": list(c.codes),
        "app_hash": st.app_hash.hex(), "app": c.app.app_hash.hex(),
        "results_hash": st.last_results_hash.hex(),
        "lhvc": st.last_height_validators_changed,
        "vals": valset_rows(st.validators),
        "next": valset_rows(st.next_validators),
        "last": valset_rows(st.last_validators),
        "pool": c.mempool.reap(),
        "state_db": db_rows(str(tmp / f"{P.name}-state.db")),
        "block_db": db_rows(str(tmp / f"{P.name}-blocks.db")),
    }


class mounted:
    """Package P's host plane as its global plane, and a StubWarmer as
    its global warmer."""

    def __init__(self, P):
        self.P = P

    def __enter__(self):
        self.plane = self.P.vp.VerifyPlane(window_ms=0.5, use_device=False)
        self.plane.start()
        self.P.vp.set_global_plane(self.plane)
        self.warmer = StubWarmer()
        self.P.warmer.set_global_warmer(self.warmer)
        return self

    def __exit__(self, *exc):
        self.P.warmer.set_global_warmer(None)
        self.P.vp.set_global_plane(None)
        self.plane.stop()


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The two chains on both packages: {(n, package): (Chain, outcome,
    warmer valsets, plane lane rows)}."""
    out = {}
    for n, rotate in ((4, False), (16, True)):
        for P in PACKAGES:
            tmp = tmp_path_factory.mktemp(f"{P.name}{n}")
            with mounted(P) as m:
                c = Chain(P, n, tmp, batch_fn=P.batch_fn(), rotate=rotate)
                c.run(HEIGHTS)
                lanes = m.plane.stats()["lane_rows"]
            out[n, P.name] = (c, chain_outcome(c, tmp), m.warmer.valsets,
                              lanes, tmp)
    return out


@pytest.mark.parametrize("n", [4, 16])
def test_a_chain_of_blocks_matches_the_jax_executor(chains, n):
    jc, jout, jwarm, jlanes, _ = chains[n, "jax"]
    pc, pout, pwarm, planes, _ = chains[n, "port"]
    assert pout == jout
    assert pwarm == jwarm
    assert len(pwarm) == (1 if n == 16 else 0)
    assert planes == jlanes and planes["bulk"] == 3 * HEIGHTS
    assert set(pout["codes"]) == {0}
    st = pc.state
    assert st.last_block_height == HEIGHTS
    # the pool holds none of the committed txs
    committed = {tx for h in range(1, HEIGHTS + 1)
                 for tx in pc.blocks.load_block(h).data.txs}
    assert committed and not committed & set(pout["pool"])
    # the app hash is the app's recompute from its state
    assert pc.app._compute_app_hash(pc.app.height) == st.app_hash
    # the store holds the final state
    loaded = pc.store.load()
    assert valset_rows(loaded.validators) == valset_rows(st.validators)
    assert (loaded.app_hash, loaded.last_block_id, loaded.last_block_height,
            loaded.last_results_hash) == (st.app_hash, st.last_block_id,
                                          st.last_block_height,
                                          st.last_results_hash)
    if n == 16:
        # the rotation at 3: the new key signs from height 5 on
        assert st.last_height_validators_changed == ROTATE_AT + 2
        assert pc.new_priv.pub_key().address() in {
            cs.validator_address for cs in pc.last_commit.signatures}
        assert pc.new_priv.pub_key().address() not in {
            cs.validator_address
            for cs in pc.blocks.load_block(ROTATE_AT + 2).last_commit
            .signatures}


def _failed_apply(c, block):
    """apply_block on a bad block: (error class, text), and the state,
    the state store and the block store must be as they were."""
    before = (valset_rows(c.state.validators), c.state.app_hash,
              c.store.load().last_block_height, c.blocks.height(),
              c.app.app_hash)
    with pytest.raises(Exception) as e:
        c.ex.apply_block(c.state, block.block_id(), block)
    after = (valset_rows(c.state.validators), c.state.app_hash,
             c.store.load().last_block_height, c.blocks.height(),
             c.app.app_hash)
    assert after == before
    return type(e.value).__name__, str(e.value)


def bad_blocks(c):
    """Height 7 proposed with one tampered LastCommit signature, then
    with a wrong app hash."""
    h = c.state.last_block_height + 1
    bad = copy.deepcopy(c.last_commit)
    sig = bad.signatures[2].signature
    bad.signatures[2].signature = sig[:9] + bytes([sig[9] ^ 4]) + sig[10:]
    out = [_failed_apply(c, c.propose(h, last_commit=bad))]
    blk = c.propose(h)
    blk.header.app_hash = b"\x09" * 32
    out.append(_failed_apply(c, blk))
    return out


def test_bad_blocks_give_the_jax_errors_and_change_nothing(chains):
    errs = {}
    for P in PACKAGES:
        with mounted(P):
            errs[P.name] = bad_blocks(chains[16, P.name][0])
    assert errs["port"] == errs["jax"]
    assert [cls for cls, _ in errs["port"]] == ["InvalidSignatureError",
                                                "ExecutionError"]
    assert errs["port"][0][1] == "wrong signature (#2)"
    assert errs["port"][1][1] == "wrong Header.AppHash"


def test_a_state_store_file_reads_in_both_packages(chains, tmp_path):
    """The StateStore file each package wrote loads in the other: the
    state, the valset history, params and results are equal, and saving
    what was read writes the same JSON."""
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        tmp = chains[16, src.name][4]
        path = str(tmp / f"{src.name}-state.db")
        read = dst.state.StateStore(path)
        st = read.load()
        want = chains[16, src.name][0].state
        assert valset_rows(st.next_validators) == valset_rows(
            want.next_validators)
        assert (st.app_hash, st.last_block_id.hash,
                st.consensus_params.hash()) == (
            want.app_hash, want.last_block_id.hash,
            want.consensus_params.hash())
        for h in range(1, HEIGHTS + 2):
            assert valset_rows(read.load_validators(h)) == valset_rows(
                chains[16, src.name][0].store.load_validators(h))
        assert read.load_abci_responses(HEIGHTS) == \
            chains[16, src.name][0].store.load_abci_responses(HEIGHTS)
        copy_path = str(tmp_path / f"{src.name}-to-{dst.name}.db")
        again = dst.state.StateStore(copy_path)
        again.save(st)
        again.close()
        read.close()
        assert db_rows(copy_path)["state"] == db_rows(path)["state"]
        blocks = dst.bs.BlockStore(str(tmp / f"{src.name}-blocks.db"))
        mine = chains[16, src.name][0].blocks
        for h in range(1, HEIGHTS + 1):
            assert blocks.load_block(h).hash() == mine.load_block(h).hash()
            assert blocks.load_seen_commit(h).hash() == \
                mine.load_seen_commit(h).hash()
        blocks.close()


def update_state_filters(P):
    privs = [P.keys.PrivKey.generate(bytes([50 + i]) * 32) for i in range(3)]
    vals = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                               for p in privs])
    state = P.state.State.make_genesis("filter-chain", vals,
                                       genesis_time=P.ts.Timestamp(T0, 0))
    ex = P.ex.BlockExecutor(None, None)
    header = P.block.Header(chain_id="filter-chain", height=1,
                            time=P.ts.Timestamp(T0, 0))
    block = P.block.Block(header, P.block.Data([]), None)
    bid = P.bid.BlockID(b"\x01" * 32, P.bid.PartSetHeader(1, b"\x02" * 32))
    ghost = P.keys.PrivKey.generate(b"\x77" * 32).pub_key()
    neg = P.keys.PrivKey.generate(b"\x78" * 32).pub_key()
    dup = privs[0].pub_key()
    resp = P.abci.ResponseFinalizeBlock(
        tx_results=[], app_hash=b"",
        validator_updates=[P.abci.ValidatorUpdate(dup.data, 0),
                           P.abci.ValidatorUpdate(dup.data, 17),
                           P.abci.ValidatorUpdate(ghost.data, 0),
                           P.abci.ValidatorUpdate(neg.data, -5)])
    nv = ex._update_state(state, bid, block, resp).next_validators
    assert nv.get_by_address(dup.address())[1].voting_power == 17
    assert not nv.has_address(ghost.address())
    assert not nv.has_address(neg.address()) and len(nv) == 3
    return valset_rows(nv)


def test_update_state_drops_the_updates_it_cannot_apply():
    """tests/test_warmer.py:483 on both packages (the port's executor
    built with batch_fn=None here, so resolving the card is deferred to
    the first verification)."""
    out = {P.name: update_state_filters(P) for P in PACKAGES}
    assert out["port"] == out["jax"]


# -- the port's device seam ---------------------------------------------------


def test_batch_fn_none_verifies_on_the_plane_consensus_lane(tmp_path):
    """A device="cpu" plane mounted: each LastCommit's rows ride the
    CONSENSUS lane as one submission with no validator indices, so its
    flush takes the grouped path (one ed25519_verify on the plain kernel),
    and the chain equals the JAX chain's."""
    plane = pvp.VerifyPlane(window_ms=0.5, device="cpu",
                            breaker=pbatch.CircuitBreaker(name="t-exec"))
    plane.start()
    pvp.set_global_plane(plane)
    try:
        c = Chain(PORT, 4, tmp_path, batch_fn=None)
        c.mempool.verify_sigs = False
        c.run(2)
        recs = plane.ledger.records()
        lanes = plane.stats()["lane_rows"]
    finally:
        pvp.set_global_plane(None)
        plane.stop()
    assert lanes["consensus"] == 4 and lanes["bulk"] == 0
    assert [r["path"] for r in recs[-1:]] == ["grouped"]
    with mounted(JAX):
        j = Chain(JAX, 4, tmp_path, batch_fn=None)
        j.mempool.verify_sigs = False
        j.run(2)
    assert c.state.app_hash == j.state.app_hash
    assert c.blocks.load_block(2).hash() == j.blocks.load_block(2).hash()


def test_batch_fn_none_without_a_plane_is_the_card(tmp_path, monkeypatch):
    """No plane: the LastCommit goes to the card, which raises
    DeviceError without one; nothing is applied or stored."""
    monkeypatch.setattr(pbatch, "_DEVICE_BREAKER",
                        pbatch.CircuitBreaker(name="t-exec-global"))
    assert pvp.global_plane() is None
    c = Chain(PORT, 4, tmp_path, batch_fn=None)
    c.mempool.verify_sigs = False
    c.run(1)
    block = c.propose(2)
    if torch.cuda.is_available():
        c.apply(block)
        assert c.state.last_block_height == 2
        return
    with pytest.raises(DeviceError):
        c.ex.apply_block(c.state, block.block_id(), block)
    assert c.state.last_block_height == 1
    assert c.store.load().last_block_height == 1 and c.blocks.height() == 1
