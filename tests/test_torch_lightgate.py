"""The port's light-client gateway (cometbft_tpu_torch/lightgate/) against
the JAX package's.

tests/test_lightgate.py's nine scenarios run on both packages over the
same deterministic chain (built per package from the same key seeds): the
JAX gateway over a host plane, the port's over a host plane
(use_device=False) and over a device plane on the kernels' plain versions
(device="cpu"). Verdict dicts, gateway and LRU stats, the flush ledger's
submissions and lane rows, evidence bytes and hashes, pool sizes, and
error classes and messages must be equal; where threads race, the
aggregates the JAX test asserts (one verification, coalesced + cached =
K - 1, one evidence) are compared. Then the port's face of ROADMAP C1: a
device plane that cannot take the rows verifies them on its own device,
a device fault reaches every waiter as DeviceError, and with no plane the
rows go to the card. Last, chip_smoke phase 15's three waves run on the
16-validator copy of its secp256k1 chain through a host plane: the era-B
pair is confirmed here before the card runs it at 10,000."""
import threading
from types import SimpleNamespace

import pytest
import torch

from cometbft_tpu import lightgate as jlg
from cometbft_tpu import verifyplane as jvp
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.evidence import pool as jpool
from cometbft_tpu.light import client as jlc
from cometbft_tpu.light import verifier as jlv
from cometbft_tpu.lightgate import cache as jcache
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import evidence as jev
from cometbft_tpu.types import serde as jserde
from cometbft_tpu.types import validator as jval
from cometbft_tpu.types import vote as jvote
from cometbft_tpu.types.block_id import BlockID as JBlockID
from cometbft_tpu.types.block_id import PartSetHeader as JPSH
from cometbft_tpu.types.timestamp import Timestamp as JTimestamp
from cometbft_tpu.verifyplane import plane as jplane
from cometbft_tpu_torch import lightgate as plg
from cometbft_tpu_torch import verifyplane as pvp
from cometbft_tpu_torch.crypto import batch as pbatch
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.device import DeviceError
from cometbft_tpu_torch.evidence import pool as ppool
from cometbft_tpu_torch.libs import failpoints as pfp
from cometbft_tpu_torch.light import client as plc
from cometbft_tpu_torch.light import verifier as plv
from cometbft_tpu_torch.lightgate import cache as pcache
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import commit as pcommit
from cometbft_tpu_torch.types import evidence as pev
from cometbft_tpu_torch.types import serde as pserde
from cometbft_tpu_torch.types import validator as pval
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.types.block_id import BlockID, PartSetHeader
from cometbft_tpu_torch.types.timestamp import Timestamp
from cometbft_tpu_torch.verifyplane import plane as pplane

torch.set_num_threads(1)

JAX = SimpleNamespace(
    name="jax", lg=jlg, vp=jvp, plane=jplane, keys=jkeys, pool=jpool,
    lc=jlc, lv=jlv, cache=jcache, block=jblock, canon=jcanon,
    commit=jcommit, ev=jev, serde=jserde, val=jval, vote=jvote,
    BlockID=JBlockID, PSH=JPSH, Timestamp=JTimestamp)
PORT = SimpleNamespace(
    name="port", lg=plg, vp=pvp, plane=pplane, keys=pkeys, pool=ppool,
    lc=plc, lv=plv, cache=pcache, block=pblock, canon=pcanon,
    commit=pcommit, ev=pev, serde=pserde, val=pval, vote=pvote,
    BlockID=BlockID, PSH=PartSetHeader, Timestamp=Timestamp)

CHAIN_ID = "lightgate-chain"
T0 = 1_700_000_000
# each side: (package, plane keywords); the JAX gateway runs on its host
# plane, the port's on a host plane and on a device plane on the CPU
SIDES = {"jax": (JAX, {"use_device": False}),
         "port_host": (PORT, {"use_device": False}),
         "port_device": (PORT, {"device": "cpu"})}


def _keys(P, tag, n):
    return [P.keys.PrivKey.generate(bytes([tag, i + 1]) + b"\x0b" * 30)
            for i in range(n)]


class Chain:
    """tests/test_lightgate.py's stable-valset chain for package P."""

    def __init__(self, P, n_heights, keys):
        self.P = P
        self.keys = keys
        vs = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                                 for p in keys])
        self.valset = vs
        by_addr = {p.pub_key().address(): p for p in keys}
        self.blocks = {}
        prev_bid = P.BlockID()
        for h in range(1, n_heights + 1):
            header = P.block.Header(
                chain_id=CHAIN_ID, height=h, time=P.Timestamp(T0 + h, 0),
                last_block_id=prev_bid, validators_hash=vs.hash(),
                next_validators_hash=vs.hash(),
                proposer_address=vs.validators[0].address,
                app_hash=b"\x01" * 32)
            bid = P.BlockID(header.hash(), P.PSH(1, header.hash()))
            sigs = []
            for v in vs.validators:
                ts = P.Timestamp(T0 + h, 42)
                sb = P.canon.canonical_vote_bytes(
                    CHAIN_ID, P.canon.PRECOMMIT_TYPE, h, 0, bid, ts)
                sigs.append(P.commit.CommitSig(
                    P.commit.BLOCK_ID_FLAG_COMMIT, v.address, ts,
                    by_addr[v.address].sign(sb)))
            self.blocks[h] = P.lv.LightBlock(
                P.lv.SignedHeader(header, P.commit.Commit(h, 0, bid, sigs)),
                vs)
            prev_bid = bid

    def provider(self):
        return self.P.lc.Provider(CHAIN_ID, lambda h: self.blocks.get(h))


def forged_claim(chain, height):
    """tests/test_lightgate.py's _forged_claim for the chain's package."""
    P = chain.P
    header = P.block.Header(
        chain_id=CHAIN_ID, height=height, time=P.Timestamp(T0 + height, 0),
        last_block_id=P.BlockID(), validators_hash=chain.valset.hash(),
        next_validators_hash=chain.valset.hash(),
        proposer_address=chain.valset.validators[0].address,
        app_hash=b"\x66" * 32)
    hh = header.hash()
    bid = P.BlockID(hh, P.PSH(1, hh))
    sigs = [P.commit.CommitSig.absent() for _ in range(len(chain.valset))]
    for priv in chain.keys:
        addr = priv.pub_key().address()
        vidx, _ = chain.valset.get_by_address(addr)
        v = P.vote.Vote(vote_type=P.canon.PRECOMMIT_TYPE, height=height,
                        round=0, block_id=bid,
                        timestamp=P.Timestamp(T0 + height, 0),
                        validator_address=addr, validator_index=vidx)
        sigs[vidx] = P.commit.CommitSig(
            P.commit.BLOCK_ID_FLAG_COMMIT, addr,
            P.Timestamp(T0 + height, 0), priv.sign(v.sign_bytes(CHAIN_ID)))
    return {"header": P.serde.header_to_j(header),
            "commit": P.serde.commit_to_j(P.commit.Commit(height, 0, bid,
                                                          sigs))}


class mounted_plane:
    """A started plane of package P mounted as the global plane, with a
    ledger deep enough for the scenarios."""

    def __init__(self, P, **kw):
        self.P = P
        self.kw = kw

    def __enter__(self):
        P = self.P
        self.plane = P.vp.VerifyPlane(window_ms=0.5, **self.kw)
        self.plane.ledger = P.plane.FlushLedger(capacity=2048)
        self.plane.start()
        P.vp.set_global_plane(self.plane)
        return self.plane

    def __exit__(self, *exc):
        self.P.vp.set_global_plane(None)
        self.plane.stop()


def _gateway(P, chain, **kw):
    gw = P.lg.LightGateway(CHAIN_ID, chain.provider(), **kw)
    gw.client.trust_light_block(chain.blocks[1])
    gw.start(register=False)
    return gw


def _now(P):
    return P.Timestamp(T0 + 1000, 0)


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))
    return None


def _lanes(plane):
    recs = plane.dump_flushes()["flushes"]
    return {k: sum(r[k] for r in recs)
            for k in ("subs", "c_rows", "g_rows", "b_rows")}


def _storm(gw, K, fn):
    """K threads released together, each calling fn(gw, k)."""
    barrier = threading.Barrier(K)
    out, errs = {}, []
    lock = threading.Lock()

    def worker(k):
        try:
            barrier.wait()
            v = fn(gw, k)
            with lock:
                out[k] = v
        except Exception as e:  # noqa: BLE001 - compared below
            with lock:
                errs.append((type(e).__name__, str(e)))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(K)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
        assert not t.is_alive()
    return out, errs


# -- tests/test_lightgate.py's scenarios, as functions of one side ----------


def sc_coalescer_one_submission_for_k_threads(P, plane_kw):
    chain = Chain(P, 16, _keys(P, 1, 4))
    with mounted_plane(P, **plane_kw) as plane:
        solo = _gateway(P, chain).verify(1, 16, now=_now(P))
        solo_lanes = _lanes(plane)
        plane.ledger = P.plane.FlushLedger(capacity=2048)
        gw = _gateway(P, chain)
        K = 8
        verdicts, errs = _storm(gw, K,
                                lambda g, k: g.verify(1, 16, now=_now(P)))
        st = gw.stats()
        lanes = _lanes(plane)
    assert not errs and len(verdicts) == K
    assert st["verifies"] == 1
    assert st["coalesced"] + st["cache"]["hits"] == K - 1
    assert lanes == solo_lanes and lanes["g_rows"] > 0
    return {"solo": solo, "lanes": lanes,
            "hashes": sorted({v["target_hash"] for v in verdicts.values()}),
            "verifies": st["verifies"],
            "coalesced_or_hit": st["coalesced"] + st["cache"]["hits"],
            "steps": sorted(v["verify_steps"] for v in verdicts.values()
                            if not v["cached"]),
            "store_heights": st["store_heights"],
            "client_verifications": st["client_verifications"]}


def sc_mixed_valid_forged_fanout(P, plane_kw):
    chain = Chain(P, 8, _keys(P, 2, 4))
    pool = P.pool.EvidencePool(CHAIN_ID, lambda h: chain.valset)
    pool.height = 8
    pool.time_s = T0 + 8
    claim = forged_claim(chain, 8)
    forged = {1, 3, 5, 7}
    with mounted_plane(P, **plane_kw):
        gw = _gateway(P, chain, evidence_pool=pool)
        results, errs = _storm(gw, 8, lambda g, k: g.verify(
            1, 8, claimed=claim if k in forged else None, now=_now(P)))
        st = gw.stats()
    assert not errs and len(results) == 8
    for k, v in results.items():
        assert v["status"] == ("divergent" if k in forged else "verified")
    ev = pool.pending_evidence()[0]
    return {"statuses": sorted((k, v["status"], v.get("evidence_hash"))
                               for k, v in results.items()),
            "pool_size": pool.size(), "evidence": ev.bytes().hex(),
            "evidence_hash": ev.hash().hex(), "ev_type": type(ev).__name__,
            "byzantine": len(ev.byzantine_validators),
            "verifies": st["verifies"], "divergences": st["divergences"],
            "evidence_submitted": st["evidence_submitted"]}


def sc_lru_eviction_refetches(P, plane_kw):
    chain = Chain(P, 12, _keys(P, 3, 3))
    with mounted_plane(P, **plane_kw):
        gw = _gateway(P, chain, cache_size=2)
        out = [gw.verify(1, 10, now=_now(P)), gw.verify(1, 10, now=_now(P))]
        before = gw.client.verifications
        out.append(gw.verify(1, 10, now=_now(P)))
        out.append(gw.client.verifications - before)
        out += [gw.verify(1, 11, now=_now(P)), gw.verify(1, 12, now=_now(P)),
                gw.cache.stats(), gw.verify(1, 10, now=_now(P)), gw.stats()]
    assert out[1]["cached"] is True and out[3] == 0
    assert out[-2]["cached"] is False and out[-2]["verify_steps"] == 0
    return out


def sc_expired_trust_never_served(P, plane_kw):
    chain = Chain(P, 6, _keys(P, 4, 3))
    fresh, late = P.Timestamp(T0 + 10, 0), P.Timestamp(T0 + 1000, 0)
    with mounted_plane(P, **plane_kw):
        gw = _gateway(P, chain, trusting_period=50.0)
        out = [gw.verify(1, 6, now=fresh), gw.cache.stats(),
               gw.verify(1, 6, now=fresh),
               _raised(lambda: gw.verify(1, 6, now=late)), gw.cache.stats(),
               gw.prune_expired(now=late), gw.cache.stats(),
               gw.client.store.heights()]
    assert out[3] is not None and out[4]["expired"] >= 1
    return out


def sc_verified_lru_unit(P, plane_kw):
    lru = P.cache.VerifiedLRU(capacity=2)

    def ent(h, exp):
        return P.cache.CacheEntry(target_height=h, target_hash=b"%d" % h,
                                  expires_ns=exp, verify_steps=1)

    lru.put((b"a", b"b"), ent(2, 100))
    lru.put((b"a", b"c"), ent(3, 100))
    out = [lru.get((b"a", b"b"), now_ns=50)]
    lru.put((b"a", b"d"), ent(4, 100))
    out += [lru.get((b"a", b"c"), now_ns=50), lru.get((b"a", b"b"), now_ns=50),
            lru.get((b"a", b"b"), now_ns=100), lru.stats(),
            lru.prune_expired(now_ns=1000), len(lru)]
    out = [(o.target_height, o.target_hash, o.expires_ns, o.verify_steps)
           if isinstance(o, P.cache.CacheEntry) else o for o in out]
    assert out[-1] == 0
    return out


def sc_overload_shed_fans_out_with_hint(P, plane_kw):
    class ShedPlane:
        device = None

        def is_running(self):
            return True

        def in_dispatcher(self):
            return False

        def submit_and_wait(self, pubs, msgs, sigs, timeout=None,
                            lane="consensus", chain_id=None):
            raise P.vp.PlaneOverloaded("gateway lane full",
                                       retry_after_ms=123.0)

    chain = Chain(P, 8, _keys(P, 5, 3))
    saved = (P.plane._GLOBAL, P.plane._LAST)
    P.plane._GLOBAL = ShedPlane()
    try:
        gw = _gateway(P, chain)
        out, errs = _storm(gw, 4, lambda g, k: g.verify(1, 8, now=_now(P)))
        st = gw.stats()
    finally:
        P.plane._GLOBAL, P.plane._LAST = saved
    assert out == {} and len(errs) == 4
    return {"errs": sorted(errs), "overloaded": st["overloaded"] >= 1}


def sc_gateway_lane_queue_bound_sheds_nonblocking(P, plane_kw):
    keys = _keys(P, 6, 2)
    rows = [(k.pub_key(), b"m%d" % i, k.sign(b"m%d" % i))
            for i, k in enumerate(keys)]
    plane = P.vp.VerifyPlane(window_ms=60.0, gateway_max_queue=1,
                             gateway_deadline_ms=0.0, **plane_kw)
    plane.start()
    try:
        futs = [plane.submit_many([rows[0]], lane=P.vp.LANE_GATEWAY)]
        err = None
        for _ in range(64):
            try:
                futs.append(plane.submit_many(
                    [rows[1]], lane=P.vp.LANE_GATEWAY, block=False))
            except P.vp.PlaneOverloaded as e:
                err = e
                break
        sheds = dict(plane.sheds)
    finally:
        plane.stop()
    assert err is not None and err.retry_after_ms > 0
    return {"err": type(err).__name__, "sheds": sheds,
            "results": [f.result(30) for f in futs]}


def sc_trust_root_pin_mismatch(P, plane_kw):
    chain = Chain(P, 6, _keys(P, 7, 3))
    pin = chain.blocks[1].signed_header.header.hash()
    with mounted_plane(P, **plane_kw):
        gw = _gateway(P, chain)
        return [_raised(lambda: gw.verify(1, 6, trusted_hash=b"\x13" * 32,
                                          now=_now(P))),
                gw.verify(1, 6, trusted_hash=pin, now=_now(P))]


def sc_batched_headers_serving(P, plane_kw):
    chain = Chain(P, 10, _keys(P, 8, 3))
    gw = _gateway(P, chain, max_batch_headers=4)
    out = gw.headers([2, 4, 6, 99])
    out2 = gw.headers(list(range(1, 11)), with_validators=True)
    assert out2["truncated"] and len(out2["headers"]) == 4
    return [out, out2]


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


def test_the_nine_scenarios_are_all_here():
    assert len(SCENARIOS) == 9


@pytest.mark.parametrize("side", ["port_host", "port_device"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_lightgate_scenario_matches_the_jax_gateway(name, side):
    JP, jkw = SIDES["jax"]
    P, kw = SIDES[side]
    assert SCENARIOS[name](P, kw) == SCENARIOS[name](JP, jkw)


# -- the port's face of ROADMAP C1 -------------------------------------------


def test_a_device_plane_that_cannot_take_the_rows_keeps_them_on_its_device(
        monkeypatch):
    """A running device plane that refuses the gateway's rows
    (PlaneQueueFull) sends them to verify_batch_direct on its device; the
    verdict equals the JAX gateway's, whose plane answers from the host."""
    seen = []
    real = pbatch.verify_batch_direct

    def spy(pubs, msgs, sigs, device=None, **kw):
        seen.append((len(pubs), str(device)))
        return real(pubs, msgs, sigs, device=device, **kw)

    monkeypatch.setattr(pbatch, "verify_batch_direct", spy)
    out = {}
    for P, kw in (SIDES["jax"], SIDES["port_device"]):
        chain = Chain(P, 8, _keys(P, 9, 4))
        with mounted_plane(P, **kw) as plane:
            def refuse(*a, **k):
                raise P.vp.PlaneQueueFull("plane full")

            plane.submit_many = refuse
            gw = _gateway(P, chain)
            out[P.name] = gw.verify(1, 8, now=_now(P))
            assert plane.rows_verified == 0
    assert out["port"] == out["jax"]
    assert seen and all(d == "cpu" for _, d in seen)


def test_a_device_fault_reaches_every_waiter_as_a_device_error():
    """verifyplane.dispatch raises once: the device plane fails the flush
    with DeviceError (no host answer), and the gateway hands it to the
    leader and every coalesced waiter unchanged (the JAX gateway would
    wrap a non-gateway error in GatewayError; its plane would have
    answered from the host)."""
    import time

    chain = Chain(PORT, 8, _keys(PORT, 10, 4))
    with mounted_plane(PORT, device="cpu") as plane:
        gw = _gateway(PORT, chain)
        real_submit = plane.submit_many

        def submit_when_all_wait(*a, **kw):
            # the leader's rows reach the plane once the other three
            # clients wait on its flight, so all four see its fault
            deadline = time.monotonic() + 120.0
            while gw.stats()["coalesced"] < 3:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            return real_submit(*a, **kw)

        plane.submit_many = submit_when_all_wait
        pfp.arm("verifyplane.dispatch", "raise", count=1)
        try:
            out, errs = _storm(gw, 4, lambda g, k: g.verify(1, 8,
                                                            now=_now(PORT)))
        finally:
            pfp.reset()
        paths = [r["path"] for r in plane.ledger.records()]
    assert out == {} and len(errs) == 4
    assert {e[0] for e in errs} == {"DeviceError"}
    assert paths[0] == "device_fault"
    assert gw.stats()["verifies"] == 1
    # the fault is gone: the same request now verifies on the device
    with mounted_plane(PORT, device="cpu"):
        assert gw.verify(1, 8, now=_now(PORT))["status"] == "verified"


def test_with_no_plane_the_gateway_verifies_on_the_card():
    chain = Chain(PORT, 8, _keys(PORT, 11, 4))
    gw = _gateway(PORT, chain)
    assert pvp.global_plane() is None
    if torch.cuda.is_available():
        assert gw.verify(1, 8, now=_now(PORT))["status"] == "verified"
    else:
        with pytest.raises(DeviceError):
            gw.verify(1, 8, now=_now(PORT))


# -- chip_smoke phase 15's waves at 16 secp256k1 validators ------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_15_waves_on_the_plan_copy_through_a_host_plane():
    """chip_smoke.light_plan at LCC_COPY_VALS through phase 15's
    gateway_waves on a port host plane: one verification for the first
    wave, with phase 13's heights and count; LRU hits and no flush for
    the second; on the era-B pair (6, 8) the honest clients verify, the
    lied-to ones get "divergent", and the pool holds one attack evidence
    naming every era-B validator (era B keeps under 1/3 of era A's power,
    so a pair reaching back into era A would fail the trusting check)."""
    cs = _chip_smoke()
    plan = cs.light_plan(cs.LCC_COPY_VALS)
    keys = {s: pkeys.Secp256k1PrivKey.generate(s)
            for vals in plan.values() for s, _ in vals}
    by_addr = {k.pub_key().address(): k for k in keys.values()}
    sets = {h: pval.ValidatorSet([pval.Validator(keys[s].pub_key(), w)
                                  for s, w in vals])
            for h, vals in plan.items()}

    def sign_commit(commit):
        for cs_, m in zip(commit.signatures,
                          commit.sign_bytes_rows(cs.CHAIN_ID)):
            cs_.signature = by_addr[cs_.validator_address].sign(m)

    blocks, headers, prev = {}, {}, BlockID()
    for h in sorted(plan):
        vs = sets[h]
        header = pblock.Header(
            chain_id=cs.CHAIN_ID, height=h, time=Timestamp(cs.LCC_T0 + h, 0),
            last_block_id=prev, validators_hash=vs.hash(),
            next_validators_hash=sets.get(h + 1, vs).hash(),
            proposer_address=vs.validators[0].address, app_hash=b"\x01" * 32)
        prev = BlockID(header.hash(), PartSetHeader(1, header.hash()))
        ts = Timestamp(cs.LCC_T0 + h, 42)
        commit = pcommit.Commit(h, 0, prev, [
            pcommit.CommitSig(pcommit.BLOCK_ID_FLAG_COMMIT, v.address, ts, b"")
            for v in vs.validators])
        sign_commit(commit)
        headers[h] = header
        blocks[h] = plv.LightBlock(plv.SignedHeader(header, commit), vs)
    t_h, g_h = cs.GW_ERA_B_PAIR
    claim = cs.forged_claim(headers[g_h], sets[g_h], sign_commit)
    pool = ppool.EvidencePool(cs.CHAIN_ID, sets.get)
    pool.height, pool.time_s = g_h, cs.LCC_T0 + g_h
    gw = plg.LightGateway(cs.CHAIN_ID, plc.Provider(cs.CHAIN_ID, blocks.get),
                          evidence_pool=pool, trusting_period=1e6)
    gw.client.trust_light_block(blocks[1])
    gw.start(register=False)
    with mounted_plane(PORT, use_device=False) as plane:
        marks, stats = [], []

        def mark():
            marks.append(len(plane.ledger.records()))
            stats.append(gw.stats())

        waves = cs.gateway_waves(gw, claim, Timestamp(cs.LCC_T0 + 1000, 0),
                                 8, 4, mark)
        recs = plane.ledger.records()
    (w1, e1, _), (w2, e2, _), (w3, e3, _) = waves
    assert not (e1 or e2 or e3)
    want_hash = headers[g_h].hash().hex()
    assert {v["target_hash"] for v in w1.values()} == {want_hash}
    assert stats[0]["verifies"] == 1
    assert stats[0]["coalesced"] + stats[0]["cache"]["hits"] == 7
    assert gw.client.store.heights() == [1, 4, 5, 6, 8]
    assert stats[0]["client_verifications"] == 7
    assert all(r["g_rows"] == r["rows"] for r in recs[:marks[0]])
    assert marks[1] == marks[0] and all(v["cached"] for v in w2.values())
    assert sorted((k, v["status"]) for k, v in w3.items()) == [
        (0, "verified"), (1, "divergent"), (2, "verified"),
        (3, "divergent")]
    ev = pool.pending_evidence()
    assert pool.size() == 1 and isinstance(ev[0],
                                           pev.LightClientAttackEvidence)
    assert len(ev[0].byzantine_validators) == len(sets[g_h])
    assert ev[0].common_height == t_h
    assert stats[2]["evidence_submitted"] == 1
    assert all(r["c_rows"] == r["rows"] for r in recs[marks[1]:])
    assert max(r["rows"] for r in recs[marks[1]:]) >= len(sets[g_h])
