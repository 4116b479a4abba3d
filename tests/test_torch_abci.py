"""The port's application boundary (cometbft_tpu_torch/abci/), the
signed-tx envelope and admission controller (mempool/sigtx.py,
admission.py), and the genesis, params and BFT-time types against the JAX
package's.

tests/test_warmer.py:389 and :409 (the kvstore collapses two updates of one
validator, last wins; a negative power is malformed at every gate) run on
both packages. Then seeded scenarios, as functions of a package namespace
whose outputs must be equal: the kvstore over three heights of key/value,
bare, validator and malformed txs (every response, the app hash, info and
queries with proofs, each proof verified against the app hash by the
other package's proof runtime), its snapshots (chunks of one package
restore the other's app), the envelope's bytes and errors, the admission
controller's decisions over a scripted fill and breaker sequence,
ConsensusParams' hash and JSON, BFT time over seeded commits and the
GenesisDoc's JSON file (written by one package, read by the other)."""
import base64
import random
from dataclasses import asdict
from types import SimpleNamespace

import pytest

from cometbft_tpu.abci import kvstore as jkv
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import proof_ops as jproof
from cometbft_tpu.mempool import admission as jadm
from cometbft_tpu.mempool import sigtx as jsigtx
from cometbft_tpu.types import bft_time as jbft
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import genesis as jgen
from cometbft_tpu.types import params as jparams
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validator as jval
from cometbft_tpu_torch.abci import kvstore as pkv
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.crypto import proof_ops as pproof
from cometbft_tpu_torch.mempool import admission as padm
from cometbft_tpu_torch.mempool import sigtx as psigtx
from cometbft_tpu_torch.types import bft_time as pbft
from cometbft_tpu_torch.types import commit as pcommit
from cometbft_tpu_torch.types import genesis as pgen
from cometbft_tpu_torch.types import params as pparams
from cometbft_tpu_torch.types import timestamp as pts
from cometbft_tpu_torch.types import validator as pval

JAX = SimpleNamespace(name="jax", abci=jabci, kv=jkv, keys=jkeys,
                      proof=jproof, adm=jadm, sigtx=jsigtx, bft=jbft,
                      commit=jcommit, gen=jgen, params=jparams, ts=jts,
                      val=jval)
PORT = SimpleNamespace(name="port", abci=pabci, kv=pkv, keys=pkeys,
                       proof=pproof, adm=padm, sigtx=psigtx, bft=pbft,
                       commit=pcommit, gen=pgen, params=pparams, ts=pts,
                       val=pval)
PACKAGES = [JAX, PORT]


def both(scenario, *args):
    """scenario(P, *args) on both packages; their outputs must be equal."""
    out = {P.name: scenario(P, *args) for P in PACKAGES}
    assert out["port"] == out["jax"]
    return out["port"]


# -- tests/test_warmer.py:389 and :409 ---------------------------------------


def kvstore_dedups_validator_updates(P):
    app = P.kv.KVStoreApplication()
    b64 = base64.b64encode(b"\x10" * 32)
    resp = app.finalize_block(P.abci.RequestFinalizeBlock(
        txs=[b"val:" + b64 + b"!0!e1", b"val:" + b64 + b"!5!e2"], height=1))
    assert [r.code for r in resp.tx_results] == [0, 0]
    assert len(resp.validator_updates) == 1
    assert resp.validator_updates[0].power == 5
    return asdict(resp)


def kvstore_rejects_negative_power(P):
    app = P.kv.KVStoreApplication()
    tx = b"val:" + base64.b64encode(b"\x11" * 32) + b"!-1"
    ct = app.check_tx(P.abci.RequestCheckTx(tx=tx))
    assert ct.code == 1
    pp = app.process_proposal(P.abci.RequestProcessProposal(txs=[tx]))
    assert pp.status == P.abci.PROCESS_PROPOSAL_REJECT
    resp = app.finalize_block(P.abci.RequestFinalizeBlock(txs=[tx],
                                                          height=1))
    assert resp.tx_results[0].code == 1
    assert resp.validator_updates == []
    return asdict(ct), asdict(resp)


@pytest.mark.parametrize("scenario", [kvstore_dedups_validator_updates,
                                      kvstore_rejects_negative_power],
                         ids=lambda f: f.__name__)
def test_kvstore_validator_tx_scenario_matches_the_jax_app(scenario):
    both(scenario)


# -- the kvstore over seeded heights -----------------------------------------


def kv_heights(seed):
    """Three heights of txs: key=value, bare, validator updates (with a
    nonce, a removal and a repeat), and malformed validator txs."""
    rng = random.Random(seed)
    heights = []
    for h in range(3):
        txs = [b"k%d=v%d" % (rng.randrange(12), rng.randrange(1000))
               for _ in range(8)]
        txs.append(b"bare%d" % rng.randrange(100))
        pub = base64.b64encode(bytes([h + 1]) * 32)
        txs += [b"val:" + pub + b"!%d!n%d" % (h * 3, h),
                b"val:not-base64!1", b"val:" + pub]
        rng.shuffle(txs)
        heights.append(txs)
    return heights


def kvstore_heights(P, seed):
    app = P.kv.KVStoreApplication()
    out = {"init": app.init_chain(P.abci.RequestInitChain()).app_hash.hex()}
    for h, txs in enumerate(kv_heights(seed), start=1):
        out[f"check{h}"] = [asdict(app.check_tx(P.abci.RequestCheckTx(tx=t)))
                            for t in txs]
        out[f"process{h}"] = app.process_proposal(
            P.abci.RequestProcessProposal(txs=txs)).status
        resp = app.finalize_block(P.abci.RequestFinalizeBlock(
            txs=txs, height=h))
        app.commit()
        out[f"finalize{h}"] = asdict(resp)
    out["info"] = asdict(app.info(P.abci.RequestInfo()))
    queries = []
    for key in (b"k0", b"k3", b"k11", b"bare7", b"missing"):
        q = app.query(P.abci.RequestQuery(data=key, prove=True))
        queries.append({**asdict(q), "proof_ops": [op.to_j()
                                                   for op in q.proof_ops]})
    out["queries"] = queries
    return out


def test_kvstore_heights_and_proofs_match_the_jax_app():
    out = both(kvstore_heights, 7)
    app_hash = out["info"]["last_block_app_hash"]
    proved = 0
    for q in out["queries"]:
        if not q["proof_ops"]:
            continue
        for P in PACKAGES:
            ops = [P.proof.ProofOp.from_j(j) for j in q["proof_ops"]]
            P.proof.default_runtime().verify_value(
                ops, app_hash, q["key"], q["value"])
        proved += 1
    assert proved >= 2


def kvstore_snapshot_chunks(P, seed):
    app = P.kv.KVStoreApplication()
    app.enable_snapshots(2)
    for h, txs in enumerate(kv_heights(seed), start=1):
        app.finalize_block(P.abci.RequestFinalizeBlock(txs=txs, height=h))
        app.commit()
    snaps = app.list_snapshots()
    chunks = {s.height: [app.load_snapshot_chunk(s.height, 1, i)
                         for i in range(s.chunks)] for s in snaps}
    return [asdict(s) for s in snaps], chunks, app.app_hash


def test_kvstore_snapshot_restores_across_packages():
    """A snapshot listed and chunked by one package restores the other's
    app to the same state, height and app hash."""
    snaps, chunks, app_hash = both(kvstore_snapshot_chunks, 11)
    assert [s["height"] for s in snaps] == [2]
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        app = dst.kv.KVStoreApplication()
        snap = dst.abci.Snapshot(**snaps[0])
        assert app.offer_snapshot(snap)
        for i, c in enumerate(chunks[2]):
            assert app.apply_snapshot_chunk(i, c, "peer") is True
        assert app.height == 2
        ref = src.kv.KVStoreApplication()
        for h, txs in enumerate(kv_heights(11)[:2], start=1):
            ref.finalize_block(src.abci.RequestFinalizeBlock(txs=txs,
                                                             height=h))
            ref.commit()
        assert app.state == ref.state and app.app_hash == ref.app_hash
        assert app.app_hash != app_hash  # the snapshot is height 2's


# -- the signed-tx envelope and admission ------------------------------------


def sigtx_envelopes(P):
    priv = P.keys.PrivKey.generate(b"\x21" * 32)
    out = []
    for payload in (b"", b"a=1", b"x" * 300):
        tx = P.sigtx.wrap(priv, payload)
        parsed = P.sigtx.parse(tx)
        assert priv.pub_key().verify_signature(
            P.sigtx.sign_bytes(payload), parsed.signature)
        out.append((tx, tuple(parsed), P.sigtx.is_signed(tx)))
    out.append(P.sigtx.parse(b"plain=1"))
    for short in (P.sigtx.MAGIC, P.sigtx.MAGIC + b"\x00" * 95):
        with pytest.raises(P.sigtx.SigTxError) as e:
            P.sigtx.parse(short)
        out.append(str(e.value))
    return out, P.sigtx.HEADER_LEN, P.sigtx.SIGN_CONTEXT


def test_sigtx_envelopes_match_the_jax_package():
    both(sigtx_envelopes)


def admission_decisions(P):
    """A scripted fill and breaker sequence through try_acquire/release:
    the watermark latch, the inflight bound and its breaker tightening."""
    fill, brk = [0.0], [False]
    adm = P.adm.AdmissionController(
        max_inflight=3, breaker_inflight=1, high_watermark=0.8,
        low_watermark=0.5, retry_after_ms=75.0,
        fill_fn=lambda: fill[0], breaker_open_fn=lambda: brk[0])
    script = [("acq", 0.1, False), ("acq", 0.2, False), ("acq", 0.3, False),
              ("acq", 0.3, False), ("rel",), ("acq", 0.85, False),
              ("acq", 0.6, False), ("acq", 0.5, False), ("rel",), ("rel",),
              ("acq", 0.1, True), ("acq", 0.1, True), ("rel",),
              ("marks", 0.4, 0.9), ("acq", 0.45, False), ("rel",),
              ("acq", 0.2, False)]
    out = []
    for step in script:
        if step[0] == "acq":
            fill[0], brk[0] = step[1], step[2]
            out.append(tuple(adm.try_acquire()))
        elif step[0] == "rel":
            adm.release()
        else:
            out.append(adm.set_watermarks(step[1], step[2]))
        out.append((adm.inflight, adm.saturated))
    return out, adm.stats()


def test_admission_decisions_match_the_jax_controller():
    out, stats = both(admission_decisions)
    assert stats["counts"]["rejected_watermark"] >= 1
    assert stats["counts"]["rejected_breaker"] >= 1
    assert stats["counts"]["rejected_inflight"] >= 1


# -- params, BFT time and the genesis file -----------------------------------


def consensus_params(P):
    out = []
    for j in (None, {"block": {"max_bytes": 4096, "max_gas": 1000}},
              {"abci": {"vote_extensions_enable_height": 3},
               "validator": {"pub_key_types": ["ed25519", "secp256k1"]}}):
        cp = P.params.ConsensusParams.from_j(j)
        out.append((cp.hash(), cp.to_j(), cp.extensions_enabled(2),
                    cp.extensions_enabled(3)))
    return out


def test_consensus_params_hash_and_json_match_the_jax_package():
    both(consensus_params)


def median_times(P, seed):
    rng = random.Random(seed)
    out = []
    for n in (1, 4, 7, 16):
        privs = [P.keys.PrivKey.generate(bytes([seed, i + 1]) * 16)
                 for i in range(n)]
        vals = P.val.ValidatorSet([P.val.Validator(p.pub_key(),
                                                   rng.randrange(1, 50))
                                   for p in privs])
        sigs = []
        for v in vals.validators:
            if rng.random() < 0.2:
                sigs.append(P.commit.CommitSig())
                continue
            sigs.append(P.commit.CommitSig(
                P.commit.BLOCK_ID_FLAG_COMMIT, v.address,
                P.ts.Timestamp(1_700_000_000 + rng.randrange(30),
                               rng.randrange(10**9)), b"\x00" * 64))
        commit = P.commit.Commit(5, 0, None, sigs)
        t = P.bft.median_time(commit, vals)
        out.append((t.seconds, t.nanos))
    return out


def test_median_time_matches_the_jax_package():
    both(median_times, 3)


def genesis_doc(P, n=4):
    privs = [P.keys.PrivKey.generate(bytes([0x30 + i]) * 32)
             for i in range(n)]
    cp = P.params.ConsensusParams.from_j({"block": {"max_bytes": 65536}})
    return P.gen.GenesisDoc(
        chain_id="gen-chain", genesis_time=P.ts.Timestamp(1_700_000_000, 7),
        initial_height=1,
        validators=[P.gen.GenesisValidator(p.pub_key(), 10 * (i + 1),
                                           f"v{i}")
                    for i, p in enumerate(privs)],
        app_hash=b"\x05" * 32, app_state={"k": [1, 2]}, consensus_params=cp)


def genesis_errors(P):
    out = []
    for kw in ({"chain_id": ""}, {"chain_id": "c" * 51},
               {"initial_height": 0}):
        doc = genesis_doc(P)
        for k, v in kw.items():
            setattr(doc, k, v)
        with pytest.raises(P.gen.GenesisError) as e:
            doc.validate()
        out.append(str(e.value))
    doc = genesis_doc(P)
    doc.validators[1].power = -1
    with pytest.raises(P.gen.GenesisError) as e:
        doc.make_state()
    out.append(str(e.value))
    return out


def test_genesis_doc_json_matches_and_reads_across_packages(tmp_path):
    """to_json is byte-equal; a file saved by either package is read by
    the other into a doc whose JSON and genesis state are equal."""
    docs = {P.name: genesis_doc(P) for P in PACKAGES}
    assert docs["port"].to_json() == docs["jax"].to_json()
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        path = tmp_path / src.name / "genesis.json"
        docs[src.name].save_as(str(path))
        read = dst.gen.GenesisDoc.from_file(str(path))
        assert read.to_json() == docs[src.name].to_json()
        st = read.make_state()
        want = docs[dst.name].make_state()
        assert (st.validators.hash(), st.next_validators.hash(),
                st.consensus_params.hash(), st.app_hash,
                st.last_block_time.to_ns(),
                st.last_height_validators_changed) == (
            want.validators.hash(), want.next_validators.hash(),
            want.consensus_params.hash(), want.app_hash,
            want.last_block_time.to_ns(),
            want.last_height_validators_changed)
    both(genesis_errors)


def test_response_codes_match_the_jax_package():
    names = ("CODE_TYPE_OK", "CODE_TYPE_OVERLOADED",
             "CODE_TYPE_BAD_SIGNATURE", "PROCESS_PROPOSAL_ACCEPT",
             "PROCESS_PROPOSAL_REJECT", "VERIFY_VOTE_EXTENSION_ACCEPT",
             "VERIFY_VOTE_EXTENSION_REJECT", "APPLY_CHUNK_ACCEPT",
             "APPLY_CHUNK_RETRY_SNAPSHOT", "APPLY_CHUNK_REJECT_SNAPSHOT")
    assert {n: getattr(pabci, n) for n in names} == {
        n: getattr(jabci, n) for n in names}
    base = pabci.Application()
    assert asdict(base.check_tx(pabci.RequestCheckTx(tx=b"x"))) == asdict(
        jabci.Application().check_tx(jabci.RequestCheckTx(tx=b"x")))
    assert base.prepare_proposal(pabci.RequestPrepareProposal(
        txs=[b"a", b"b"])).txs == [b"a", b"b"]
