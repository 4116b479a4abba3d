"""The port's catch-up engine (cometbft_tpu_torch/blocksync/catchup.py)
against the JAX package's.

Each of tests/test_catchup.py's 13 scenarios runs on both packages over
the same real-signed history, built per package from the same key seeds
(ed25519 signs deterministically, so both histories hold the same bytes).
Clocks are installed tickers, so ledger records compare exactly: the
heights replayed and verified, cursors, ledger records and counters, warm
requests, the /dump_catchup document, error classes and messages, and the
catchup_stall incident must be equal. Then the port alone: a catch-up over
make_stream_verifier(device="cpu") (the cached-valset kernels' plain
versions) ends where HostCommitVerifier's does, with the same ledger
counters and blame, and with a real TableWarmer on the CPU its second
epoch's segment hits the table the warmer built ahead of the cursor; the
default verifier is the card, and raises without one."""
import itertools
import json
from types import SimpleNamespace

import pytest
import torch

from cometbft_tpu.blocksync import catchup as jcu
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.libs import failpoints as jfp
from cometbft_tpu.libs import incidents as jinc
from cometbft_tpu.libs import tracing as jtr
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import canonical as jcanon
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import timestamp as jts
from cometbft_tpu.types import validator as jval
from cometbft_tpu_torch.blocksync import catchup as pcu
from cometbft_tpu_torch.blocksync import pipeline as pbp
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.device import DeviceError
from cometbft_tpu_torch.libs import failpoints as pfp
from cometbft_tpu_torch.libs import incidents as pinc
from cometbft_tpu_torch.libs import tracing as ptr
from cometbft_tpu_torch.ops import ed25519_cached as ec
from cometbft_tpu_torch.ops import table_cache as tcache
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import commit as pcommit
from cometbft_tpu_torch.types import timestamp as pts
from cometbft_tpu_torch.types import validator as pval
from cometbft_tpu_torch.verifyplane import warmer as pwarmer

torch.set_num_threads(1)

JAX = SimpleNamespace(name="jax", cu=jcu, keys=jkeys, fp=jfp, inc=jinc,
                      tr=jtr, block=jblock, canon=jcanon, commit=jcommit,
                      ts=jts, val=jval)
PORT = SimpleNamespace(name="port", cu=pcu, keys=pkeys, fp=pfp, inc=pinc,
                       tr=ptr, block=pblock, canon=pcanon, commit=pcommit,
                       ts=pts, val=pval)

CHAIN = "catchup-chain"
N_BLOCKS = 10
EPOCH_LEN = 4


def ticker(step: int = 1000):
    it = itertools.count(10 ** 12, step)
    return lambda: next(it)


@pytest.fixture(autouse=True)
def _clean():
    for P in (JAX, PORT):
        P.fp.reset()
        P.tr.set_clock(ticker())
    yield
    for P in (JAX, PORT):
        P.fp.reset()
        P.tr.set_clock(None)


def make_history(P, n_blocks=N_BLOCKS, n_vals=3, epoch_len=EPOCH_LEN,
                 chain_id=CHAIN):
    """tests/test_catchup.py's history for package P: real ed25519
    signatures, a valset rotated every epoch_len heights; returns
    (items={h: (block, commit)}, vals_at)."""
    n_epochs = n_blocks // epoch_len + 2
    epochs = []
    for e in range(n_epochs):
        privs = [P.keys.PrivKey.generate(bytes([60 + e, i + 1])
                                         + b"\x19" * 30)
                 for i in range(n_vals)]
        vs = P.val.ValidatorSet([P.val.Validator(p.pub_key(), 10)
                                 for p in privs])
        epochs.append((vs, {p.pub_key().address(): p for p in privs}))

    def vals_at(h):
        return epochs[min((h - 1) // epoch_len, n_epochs - 1)][0]

    items = {}
    last_bid = None
    for h in range(1, n_blocks + 1):
        vs, by_addr = epochs[min((h - 1) // epoch_len, n_epochs - 1)]
        hdr = P.block.Header(chain_id=chain_id, height=h,
                             time=P.ts.Timestamp(1700000000 + h, 0),
                             validators_hash=vs.hash(),
                             next_validators_hash=vals_at(h + 1).hash(),
                             proposer_address=vs.validators[0].address)
        if last_bid is not None:
            hdr.last_block_id = last_bid
        blk = P.block.Block(hdr, P.block.Data())
        blk.fill_header()
        bid = blk.block_id()
        sigs = []
        for v in vs.validators:
            ts = P.ts.Timestamp(1700000000 + h, 1)
            sb = P.canon.canonical_vote_bytes(
                chain_id, P.canon.PRECOMMIT_TYPE, h, 0, bid, ts)
            sigs.append(P.commit.CommitSig(
                P.commit.BLOCK_ID_FLAG_COMMIT, v.address, ts,
                by_addr[v.address].sign(sb)))
        items[h] = (blk, P.commit.Commit(h, 0, bid, sigs))
        last_bid = bid
    return items, vals_at


@pytest.fixture(scope="module")
def histories():
    return {P.name: make_history(P) for P in (JAX, PORT)}


class _Source:
    def __init__(self, P, items):
        self.P = P
        self.items = items

    def base(self):
        return min(self.items)

    def tip(self):
        return max(self.items)

    def load(self, h):
        if h not in self.items:
            raise self.P.cu.CatchupError(f"history missing block {h}")
        return self.items[h]


class _State:
    __slots__ = ("chain_id", "last_block_height", "validators",
                 "next_validators")

    def __init__(self, chain_id, h, validators, next_validators):
        self.chain_id = chain_id
        self.last_block_height = h
        self.validators = validators
        self.next_validators = next_validators


class _Warmer:
    def __init__(self, cursor=None):
        self.requests = []
        self.cursor = cursor

    def request_valset(self, vals, chain_id=None):
        self.requests.append((vals.hash().hex(), chain_id if self.cursor
                              is None else self.cursor[0]))


def _counting(P):
    class _CountingVerifier(P.cu.HostCommitVerifier):
        def __init__(self):
            self.heights = []

        def verify(self, jobs):
            self.heights.extend(j.height for j in jobs)
            return super().verify(jobs)

    return _CountingVerifier()


def _engine(P, items, vals_at, *, start=0, cursor_path=None,
            read_ahead=3, max_run=3, verifier=None, warmer=None,
            warm_ahead=True, on_apply=None):
    state = _State(CHAIN, start, vals_at(start + 1), vals_at(start + 2))

    def apply_fn(st, blk, commit):
        h = blk.header.height
        if on_apply is not None:
            on_apply(h)
        return _State(st.chain_id, h, vals_at(h + 1), vals_at(h + 2))

    return P.cu.CatchupEngine(
        _Source(P, items), state, apply_fn=apply_fn,
        verifier=verifier or P.cu.HostCommitVerifier(),
        cursor_path=cursor_path, read_ahead=read_ahead,
        max_run=max_run, warm_ahead=warm_ahead,
        warmer=warmer or _Warmer())


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))
    return None


def _run_summary(eng, final):
    return {"height": final.last_block_height,
            "counters": dict(eng.ledger.counters),
            "records": eng.ledger.records(),
            "cursor": eng.cursor.as_dict()}


# -- tests/test_catchup.py's scenarios, as functions of the package ---------


def sc_replays_history_to_tip(P, hist, tmp_path):
    items, vals_at = hist
    eng = _engine(P, items, vals_at)
    out = _run_summary(eng, eng.run())
    assert out["height"] == N_BLOCKS
    assert out["counters"]["sigs_verified"] == N_BLOCKS * 3
    return out


def sc_segments_never_cross_valset_boundaries(P, hist, tmp_path):
    items, vals_at = hist
    eng = _engine(P, items, vals_at, read_ahead=8, max_run=8)
    eng.run()
    recs = eng.ledger.records()
    for r in recs:
        assert (r["first"] - 1) // EPOCH_LEN == (r["last"] - 1) // EPOCH_LEN
    assert sorted(r["last"] for r in recs if r["boundary"]) == [4, 8]
    return {"records": recs, "counters": dict(eng.ledger.counters)}


def sc_warm_ahead_fires_before_the_boundary(P, hist, tmp_path):
    items, vals_at = hist
    cursor_h = [0]
    warmer = _Warmer(cursor=cursor_h)
    eng = _engine(P, items, vals_at, warmer=warmer,
                  on_apply=lambda h: cursor_h.__setitem__(0, h))
    eng.run()
    by_hash = dict(warmer.requests)
    assert by_hash[vals_at(5).hash().hex()] < 5
    assert by_hash[vals_at(9).hash().hex()] < 9
    return {"requests": warmer.requests,
            "counters": dict(eng.ledger.counters)}


def sc_warm_ahead_off_means_no_requests(P, hist, tmp_path):
    items, vals_at = hist
    warmer = _Warmer()
    eng = _engine(P, items, vals_at, warmer=warmer, warm_ahead=False)
    eng.run()
    assert warmer.requests == []
    return {"requests": warmer.requests,
            "counters": dict(eng.ledger.counters)}


def sc_kill_at_every_read_resumes_reverifying_zero(P, hist, tmp_path):
    items, vals_at = hist
    out = []
    for k in range(1, N_BLOCKS + 1):
        cpath = str(tmp_path / f"{P.name}-cursor-{k}.json")
        eng1 = _engine(P, items, vals_at, cursor_path=cpath)
        P.fp.arm("catchup.read_ahead", "flake", k, count=1)
        try:
            err = _raised(eng1.run)
        finally:
            P.fp.disarm("catchup.read_ahead")
        assert err is not None and err[0] == "FailpointError"
        verified1, applied1 = eng1.cursor.verified, eng1.cursor.applied
        assert applied1 <= verified1 < N_BLOCKS
        v2 = _counting(P)
        eng2 = _engine(P, items, vals_at, start=applied1,
                       cursor_path=cpath, verifier=v2)
        assert eng2.cursor.resumed
        final = eng2.run()
        assert [h for h in v2.heights if h <= verified1] == []
        assert eng2.ledger.counters["blocks_skipped"] == \
            verified1 - applied1
        out.append((k, err, verified1, applied1, v2.heights,
                    _run_summary(eng2, final)))
    return out


def sc_bad_signature_raises_with_height(P, hist, tmp_path):
    items, vals_at = make_history(P, n_blocks=6, epoch_len=100)
    sig = items[4][1].signatures[0]
    sig.signature = sig.signature[:10] + \
        bytes([sig.signature[10] ^ 1]) + sig.signature[11:]
    eng = _engine(P, items, vals_at)
    err = _raised(eng.run)
    assert err[0] == "CatchupError" and "height 4" in err[1]
    assert eng.cursor.verified < 4
    return {"err": err, "cursor": eng.cursor.as_dict(),
            "records": eng.ledger.records()}


def sc_wrong_resume_state_is_corrupt_history(P, hist, tmp_path):
    items, vals_at = hist
    state = _State(CHAIN, 2, vals_at(99), vals_at(99))
    eng = P.cu.CatchupEngine(_Source(P, items), state,
                             apply_fn=lambda s, b, c: s,
                             verifier=P.cu.HostCommitVerifier(),
                             warmer=_Warmer())
    err = _raised(eng.run)
    assert "corrupt history" in err[1]
    return err


def sc_history_gap_raises(P, hist, tmp_path):
    items, vals_at = hist
    gappy = dict(items)
    del gappy[7]
    eng = _engine(P, gappy, vals_at)
    err = _raised(eng.run)
    assert "missing block 7" in err[1]
    return {"err": err, "cursor": eng.cursor.as_dict()}


def sc_store_history_source_contract(P, hist, tmp_path):
    class _EmptyStore:
        def base(self):
            return 1

        def height(self):
            return 3

        def load_block(self, h):
            return None

        def load_block_commit(self, h):
            return None

    src = P.cu.StoreHistorySource(_EmptyStore())
    return (src.tip(), src.base(), _raised(lambda: src.load(1)))


def sc_cursor_roundtrip_and_corrupt_file(P, hist, tmp_path):
    path = str(tmp_path / f"{P.name}-cursor.json")
    c = P.cu.CatchupCursor(path)
    out = [(c.verified, c.applied, c.resumed)]
    c.verified, c.applied = 42, 40
    c.save()
    c2 = P.cu.CatchupCursor(path)
    out.append((c2.verified, c2.applied, c2.resumed))
    with open(path) as f:
        out.append(f.read())
    with open(path, "w") as f:
        f.write("{not json")
    c3 = P.cu.CatchupCursor(path)
    out.append((c3.verified, c3.applied, c3.resumed))
    P.cu.CatchupCursor(None).save()
    assert out[1] == (42, 40, True) and out[3] == (0, 0, False)
    return out


def sc_ledger_ring_bounded_and_summary(P, hist, tmp_path):
    led = P.cu.CatchupLedger(capacity=8)
    for i in range(20):
        led.record(first=i, last=i, blocks=1, sigs=3, skipped=0,
                   read_ms=1.0, verify_ms=2.0, apply_ms=0.5,
                   boundary=(i % 5 == 0), warmed=False)
    m = led.mark()
    before = led.advanced(m)
    led.record(first=99, last=99, blocks=1, sigs=0, skipped=0,
               read_ms=0, verify_ms=0, apply_ms=0,
               boundary=False, warmed=False)
    assert len(led) == 8 and not before and led.advanced(m)
    return {"len": len(led), "counters": dict(led.counters),
            "summary": led.summary(), "tail": led.tail(3),
            "records": led.records()}


def sc_dump_catchup_document(P, hist, tmp_path):
    items, vals_at = hist
    cu = P.cu
    old_g, old_l = cu._GLOBAL, cu._LAST
    try:
        cu.set_global_ledger(None)
        cu._LAST = None
        empty = cu.dump_catchup()
        eng = _engine(P, items, vals_at)
        eng.run()
        doc = cu.dump_catchup()
        json.dumps(doc)
        assert cu.ledger_tail(2) == doc["records"][-2:]
        return {"empty": empty, "doc": doc}
    finally:
        cu._GLOBAL, cu._LAST = old_g, old_l


def sc_catchup_stall_incident_fires_on_frozen_ledger(P, hist, tmp_path):
    now = [10 ** 12]
    P.tr.set_clock(lambda: now[0])
    cu = P.cu
    old_g, old_l = cu._GLOBAL, cu._LAST
    try:
        led = cu.CatchupLedger()
        led.record(first=1, last=2, blocks=2, sigs=6, skipped=0,
                   read_ms=0, verify_ms=0, apply_ms=0,
                   boundary=False, warmed=False)
        cu.set_global_ledger(led)
        rec = P.inc.IncidentRecorder(catchup_stall_s=5.0)
        rec.poke()
        rec.note_catchup(True)
        fired = []
        for step, active in ((4e9, None), (2e9, None), (3e9, True),
                             (60e9, False)):
            if active is not None:
                rec.note_catchup(active)
            now[0] += int(step)
            rec.poke()
            fired.append(rec.fired.get("catchup_stall"))
        snap = rec.incidents()[-1]
        assert fired == [None, 1, 1, 1]
        return {"fired": fired, "trigger": snap["trigger"],
                "detail": snap["detail"],
                "catchup_tail": snap["catchup_tail"]}
    finally:
        cu._GLOBAL, cu._LAST = old_g, old_l


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


def test_the_thirteen_scenarios_are_all_here():
    assert len(SCENARIOS) == 13


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_catchup_scenario_matches_the_jax_engine(name, histories, tmp_path):
    out = {}
    for P in (JAX, PORT):
        P.tr.set_clock(ticker())
        out[P.name] = SCENARIOS[name](P, histories[P.name], tmp_path)
    assert out["port"] == out["jax"]


# -- the port alone: the stream verifier on the CPU, the warmer ------------


def _stream_engine(items, vals_at, verifier, warmer=None):
    return _engine(PORT, items, vals_at, read_ahead=8, max_run=8,
                   verifier=verifier, warmer=warmer or _Warmer())


def _stream_verifier():
    """make_stream_verifier on the CPU (the kernels' plain versions) with
    4 commits a cached chunk, and every stream on the device path (the
    host loop takes streams under 129 rows by default)."""
    sv = pbp.make_stream_verifier(device="cpu", max_sigs=4 * 128)
    sv.min_device_sigs = 1
    return sv


def test_a_catchup_over_the_stream_verifier_on_the_cpu_equals_the_host():
    """Two epochs of 4 heights, one tampered signature at height 6: the
    stream verifier (device stamping, the cached verify and the fused
    tally, as on the card) stops where HostCommitVerifier stops, with the
    same cursor, counters, records and error."""
    tcache.reset_for_tests()
    items, vals_at = make_history(PORT, n_blocks=8, epoch_len=4)
    sig = items[6][1].signatures[1]
    sig.signature = sig.signature[:40] + \
        bytes([sig.signature[40] ^ 4]) + sig.signature[41:]
    out = {}
    for name, verifier in (("host", PORT.cu.HostCommitVerifier()),
                           ("stream", _stream_verifier())):
        PORT.tr.set_clock(ticker())
        eng = _stream_engine(items, vals_at, verifier)
        err = _raised(eng.run)
        out[name] = (err, eng.cursor.as_dict(), dict(eng.ledger.counters),
                     eng.ledger.records())
        if name == "stream":
            assert verifier.stats["stamped_chunks"] == 2
    assert out["stream"] == out["host"]
    assert out["host"][0][0] == "CatchupError"
    assert "height 6" in out["host"][0][1]
    assert out["host"][1]["verified"] == 4


def test_warm_ahead_builds_the_next_epoch_table_before_its_segment():
    """Phase 14's shape on the CPU: a TableWarmer(device="cpu") mounted
    as the global warmer gets the next epoch's valset while height 3 is
    applied; once it is idle, the segment of heights 5-8 reads the table
    it built (one warmed hit, no table build inside the verify)."""
    tcache.reset_for_tests()
    items, vals_at = make_history(PORT, n_blocks=8, epoch_len=4)
    w = pwarmer.TableWarmer(device="cpu")
    w.start()
    pwarmer.set_global_warmer(w)
    cursor = [0]
    warm_at = []
    real = w.request_valset

    def request_valset(vals, chain_id=None):
        warm_at.append(cursor[0])
        real(vals, chain_id=chain_id)

    w.request_valset = request_valset
    try:
        sv = _stream_verifier()
        state = _State(CHAIN, 0, vals_at(1), vals_at(2))

        def apply_fn(st, blk, commit):
            cursor[0] = h = blk.header.height
            return _State(st.chain_id, h, vals_at(h + 1), vals_at(h + 2))

        eng = PORT.cu.CatchupEngine(_Source(PORT, items), state,
                                    apply_fn=apply_fn, verifier=sv,
                                    read_ahead=8, max_run=8)
        eng.run(until=4)
        assert w.wait_idle(120.0)
        s0 = ec.table_cache_stats()
        eng.run()
        s1 = ec.table_cache_stats()
    finally:
        pwarmer.clear_global_warmer(w)
        w.stop()
    assert eng.state.last_block_height == 8
    assert warm_at == [3, 7]
    assert [r["warmed"] for r in eng.ledger.records()] == [True, True]
    assert s1["warmed_hits"] - s0["warmed_hits"] == 1
    assert s1["misses"] == s0["misses"]
    assert eng.ledger.counters["blocks_verified"] == 8


def test_the_default_verifier_is_the_card():
    items, vals_at = make_history(PORT, n_blocks=2, epoch_len=4)
    state = _State(CHAIN, 0, vals_at(1), vals_at(2))

    def build():
        return PORT.cu.CatchupEngine(_Source(PORT, items), state,
                                     apply_fn=lambda s, b, c: s)

    if torch.cuda.is_available():
        assert build().verifier.device.type == "cuda"
    else:
        with pytest.raises(DeviceError):
            build()
