"""The stream verifier's stage readings and spans (blocksync/pipeline.py,
libs/tracing.py) on the host, with the plain kernels (device="cpu"):
each chunk's four host stages sum to its `host_ms`; every `stage_ms`
list stays parallel to `host_ms`, a chunk with no packable rows reading
0 in `wait` and `verdicts`; `precheck_ms` keys each call to its first
chunk; the spans reach a recording torch profiler as `user_annotation`
events with the program's tracer off, and the tracer's ring with their
`call` and `chunk` args; with both off a span is the shared null span
and a chunk keeps nothing beyond its stage entries."""
import json
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cometbft_tpu_torch.blocksync import pipeline as bp
from cometbft_tpu_torch.crypto import ed25519_ref as ed
from cometbft_tpu_torch.crypto import keys as tkeys
from cometbft_tpu_torch.libs import tracing
from cometbft_tpu_torch.types import block_id as tbid
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import timestamp as tts
from cometbft_tpu_torch.types import validator as tval

CHAIN = "stage-chain"
N_VALS = 16
SPANS = ("blocksync.precheck", "blocksync.chunk", "blocksync.rows",
         "blocksync.pack", "blocksync.layout", "blocksync.dispatch",
         "blocksync.wait", "blocksync.verdicts")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _tracer_off():
    tracing.disable()
    yield
    tracing.disable()


class Valset:
    def __init__(self, rng):
        self.seeds = [rng.bytes(32) for _ in range(N_VALS)]
        pubs = [ed.sign_many(s, [])[0] for s in self.seeds]
        self.vs = tval.ValidatorSet(
            [tval.Validator(tkeys.PubKey(p), 1000 - 10 * i)
             for i, p in enumerate(pubs)])
        self.seed_of = {tkeys.PubKey(p).address(): s
                        for p, s in zip(pubs, self.seeds)}


def job(rng, v, height, absent=(), nanos=None):
    """A signed commit of `v` at `height`; `absent` slots sign nothing,
    `nanos` overrides every timestamp's nanoseconds."""
    bid = tbid.BlockID(rng.bytes(32), tbid.PartSetHeader(1, rng.bytes(32)))
    sigs = []
    for i, val in enumerate(v.vs.validators):
        if i in absent:
            sigs.append(tcommit.CommitSig())
            continue
        ns = int(rng.integers(0, 10**9)) if nanos is None else nanos
        sigs.append(tcommit.CommitSig(tcommit.BLOCK_ID_FLAG_COMMIT,
                                      val.address,
                                      tts.Timestamp(1_700_000_000 + height,
                                                    ns)))
    c = tcommit.Commit(height, 0, bid, sigs)
    for i, (cs, msg) in enumerate(zip(sigs, c.sign_bytes_rows(CHAIN))):
        if i not in absent:
            cs.signature = ed.sign(v.seed_of[cs.validator_address], msg)
    return bp.CommitJob(v.vs, bid, height, c, CHAIN)


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(71)
    return Valset(rng), Valset(rng)


def verifier(branch="general"):
    """Two commits a chunk on either branch: a cached chunk strides its
    commits 128 columns apart (the table's padded size), a general chunk
    packs them densely."""
    per_commit = (128 if branch in ("stamped", "host_packed_cached")
                  else N_VALS)
    return bp.StreamVerifier(max_sigs=2 * per_commit, device="cpu",
                             min_device_sigs=1)


def stream(sets, branch, n=4, seed=72):
    """`n` commits that take `branch`: one shared set (stamped), one
    shared set with a nanos word past int32 (packed on the host), two
    sets in turn (general_stamped), or two sets in turn with a nanos word
    past int32 (general, packed on the host)."""
    rng = np.random.default_rng(seed)
    a, b = sets
    if branch == "stamped":
        return [job(rng, a, h) for h in range(1, n + 1)]
    if branch == "host_packed_cached":
        return [job(rng, a, h, nanos=2**31) for h in range(1, n + 1)]
    if branch == "general_stamped":
        return [job(rng, (a, b)[h % 2], h) for h in range(1, n + 1)]
    return [job(rng, (a, b)[h % 2], h, nanos=2**31)
            for h in range(1, n + 1)]


def stage_lists(sv):
    return [sv.stats["stage_ms"][s] for s in bp.STAGES]


@pytest.mark.parametrize("branch", ["stamped", "host_packed_cached",
                                    "general", "general_stamped"])
def test_chunk_stages_sum_to_host_ms(sets, branch):
    sv = verifier(branch)
    assert sv.verify(stream(sets, branch)) == [None] * 4
    assert sv.stats[f"{branch}_chunks"] == 2
    host = sv.stats["host_ms"]
    assert len(host) == 2
    for k, ms in enumerate(host):
        parts = [sv.stats["stage_ms"][s][k] for s in bp.CHUNK_STAGES]
        assert min(parts) >= 0.0
        assert sum(parts) == pytest.approx(ms, rel=1e-9, abs=1e-9)
    # the stamped branches never pack on the host; the others do
    pack = sv.stats["stage_ms"]["pack"]
    assert (max(pack) == 0.0) == (branch in ("stamped", "general_stamped"))
    assert all(x > 0.0 for x in sv.stats["stage_ms"]["dispatch"])
    assert all(x > 0.0 for x in sv.stats["stage_ms"]["wait"])


def test_stage_lists_stay_parallel_across_a_chunk_with_no_rows(sets):
    rng = np.random.default_rng(73)
    a, _ = sets
    everyone = range(N_VALS)
    jobs = ([job(rng, a, h) for h in (1, 2)]
            + [job(rng, a, h, absent=everyone) for h in (3, 4)]
            + [job(rng, a, h) for h in (5, 6)])
    sv = verifier("stamped")
    got = sv.verify(jobs)
    assert got[:2] == [None] * 2 and got[4:] == [None] * 2
    assert all(type(e).__name__ == "NotEnoughPowerError" for e in got[2:4])
    n = len(sv.stats["host_ms"])
    assert n == 3
    assert [len(xs) for xs in stage_lists(sv)] == [n] * len(bp.STAGES)
    wait, verdicts = (sv.stats["stage_ms"][s] for s in ("wait", "verdicts"))
    assert wait[1] == verdicts[1] == 0.0          # no packable rows
    assert wait[0] > 0.0 and wait[2] > 0.0
    assert verdicts[0] > 0.0 and verdicts[2] > 0.0
    sv.verify(jobs[:2])
    assert [len(xs) for xs in stage_lists(sv)] == [n + 1] * len(bp.STAGES)


def test_precheck_keys_each_call_to_its_first_chunk(sets):
    sv = verifier()
    sv.verify(stream(sets, "general", n=3))               # chunks 0, 1
    sv.min_device_sigs = 10**6
    sv.verify(stream(sets, "general", n=2, seed=75))      # the host loop
    sv.min_device_sigs = 1
    sv.verify(stream(sets, "general", n=2, seed=76))      # chunk 2
    firsts = [k for k, _ in sv.stats["precheck_ms"]]
    assert firsts == [0, 2, 2]
    assert all(ms > 0.0 for _, ms in sv.stats["precheck_ms"])
    assert len(sv.stats["host_ms"]) == 3
    assert sv in bp.live_verifiers()


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"]


def test_spans_reach_the_profiler_with_the_tracer_off(sets, tmp_path):
    sv = verifier()
    jobs = stream(sets, "general", n=2)
    assert not tracing.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with record_function("caller"):
            sv.verify(jobs)
    p.export_chrome_trace(str(tmp_path / "trace.json"))
    anns = _annotations(tmp_path / "trace.json")
    (caller,) = [a for a in anns if a[0] == "caller"]
    ours = [a for a in anns if a[0].startswith("blocksync.")]
    assert {a[0] for a in ours} == set(SPANS)
    assert all(caller[1] <= a[1] and a[2] <= caller[2] for a in ours)
    chunks = [a for a in ours if a[0] == "blocksync.chunk"]
    assert len(chunks) == 1
    for name in ("blocksync.rows", "blocksync.pack", "blocksync.layout",
                 "blocksync.dispatch"):
        for a in (a for a in ours if a[0] == name):
            assert any(c[1] <= a[1] and a[2] <= c[2] for c in chunks)
    # outside the profiler nothing is mirrored
    assert tracing.span("blocksync.chunk") is tracing._NULL_SPAN


def test_spans_reach_the_ring_with_call_and_chunk(sets):
    sv = verifier()
    sv.verify(stream(sets, "general", n=1, seed=77))  # call 0, chunk 0
    tracing.enable(capacity=1024)
    sv.verify(stream(sets, "general"))                # call 1, chunks 1, 2
    evs = [e for e in tracing.export_chrome()["traceEvents"]
           if e.get("cat") == "blocksync"]
    tracing.disable()
    assert {e["name"] for e in evs} == set(SPANS)
    assert all(e["ph"] == "X" and e["args"]["call"] == 1 for e in evs)
    by = {}
    for e in evs:
        by.setdefault(e["name"], []).append(e["args"]["chunk"])
    assert by["blocksync.precheck"] == [1]
    for name in SPANS[1:]:
        assert sorted(set(by[name])) == [1, 2]
    chunk = [e["args"] for e in evs if e["name"] == "blocksync.chunk"]
    assert [(a["rows"], a["jobs"], a["branch"]) for a in chunk] == \
        [(32, 2, "general"), (32, 2, "general")]
    # the second set's arrays are cached since call 0; the first's are
    # built once, in chunk 1
    assert [a["valset_misses"] for a in chunk] == [1, 0]
    assert tracing.span("blocksync.chunk", "blocksync", call=0,
                        chunk=0) is tracing._NULL_SPAN


def test_stamped_general_chunks_open_no_pack_span(sets):
    sv = verifier()
    tracing.enable(capacity=1024)
    assert sv.verify(stream(sets, "general_stamped")) == [None] * 4
    evs = [e for e in tracing.export_chrome()["traceEvents"]
           if e.get("cat") == "blocksync"]
    tracing.disable()
    assert {e["name"] for e in evs} == set(SPANS) - {"blocksync.pack"}
    chunk = [e["args"] for e in evs if e["name"] == "blocksync.chunk"]
    assert [(a["rows"], a["branch"]) for a in chunk] == \
        [(32, "general_stamped")] * 2
    assert sv.stats["general_stamped_chunks"] == 2
    assert sv.stats["general_chunks"] == 2
    assert sv.stats["stage_ms"]["pack"] == [0.0, 0.0]


def test_a_chunk_keeps_nothing_but_its_stage_entries(sets, monkeypatch):
    _keeps_nothing(sets, monkeypatch, "general", 10)


def test_a_stamped_general_chunk_keeps_nothing_but_its_stage_entries(
        sets, monkeypatch):
    _keeps_nothing(sets, monkeypatch, "general_stamped", 8)


def _keeps_nothing(sets, monkeypatch, branch, spans):
    sv = verifier()
    jobs = stream(sets, branch, n=2)
    sv.verify(jobs)
    returned = []
    span = tracing.span

    def spy(*a, **kw):
        returned.append(span(*a, **kw))
        return returned[-1]

    monkeypatch.setattr(tracing, "span", spy)
    calls = chunks = 3
    n0 = len(sv.stats["host_ms"])
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(calls):
            sv.verify(jobs)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    # a call's precheck; a chunk's own span, rows twice (_pack_any's
    # table lookup, then the lists), layout (the delta staging, which a
    # host-packed chunk tries first), then on a host-packed chunk pack and
    # layout (pack_rows), dispatch, layout again (the chunk's row arrays),
    # wait, verdicts
    assert len(returned) == calls + spans * chunks
    assert all(s is tracing._NULL_SPAN for s in returned)
    assert len(sv.stats["host_ms"]) == n0 + chunks
    mine = [tracemalloc.Filter(True, bp.__file__),
            tracemalloc.Filter(True, tracing.__file__)]
    kept = sum(d.size_diff for d in after.filter_traces(mine).compare_to(
        before.filter_traces(mine), "filename"))
    # a float and a list slot for each of a chunk's 7 readings, a call's
    # (first chunk, ms) pair, and the lists' own growth
    owed = chunks * 7 * (24 + 8) + calls * (64 + 24 + 8)
    assert kept <= owed
