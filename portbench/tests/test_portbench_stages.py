"""The readers of the stream verifier's stages: each averages exactly the
window's chunks (or calls), found in a live verifier's `host_ms` as the
run of the record's own `chunk_host_ms` floats; they find nothing where
that run is missing or the program keeps no stage readings; and a traced
tiny run of the stream cell prints them, its four chunk stages summing
to `chunk_host_ms.stream`."""
import pytest

import _portbench_support as sup
from portbench import registry
from portbench.driver import Record

from cometbft_tpu_torch.blocksync import pipeline

CELL = "stream1k-powershift"
STAGE_METRICS = {f"chunk_{s}_ms.stream": s for s in pipeline.STAGES}
NEW = set(STAGE_METRICS) | {"call_precheck_ms.stream"}


def read(name, rec):
    return registry.reader(name)(rec)


def readings(sv, n, first, stage_of):
    """n chunks of made-up readings from index `first` on, a call a chunk:
    stage s of chunk k reads stage_of(s, k)."""
    st = sv.stats
    for k in range(first, first + n):
        st["precheck_ms"].append((k, stage_of("precheck", k)))
        for s in pipeline.STAGES:
            st["stage_ms"][s].append(stage_of(s, k))
        st["host_ms"].append(sum(stage_of(s, k)
                                 for s in pipeline.CHUNK_STAGES))


def window_verifier():
    """A verifier with 3 warm-up chunks, 4 of the window (what the
    traffic driver sliced into the record), then 2 of the profiled slice;
    outside the window every reading is 10**6."""
    sv = pipeline.StreamVerifier(device="cpu")
    stages = ("precheck",) + pipeline.STAGES
    inside = {s: i + 1.0 for i, s in enumerate(stages)}

    def stage_of(s, k):
        return inside[s] * (k - 2) if 3 <= k < 7 else 1e6

    readings(sv, 9, 0, stage_of)
    rec = Record(setup_s=1.0,
                 layer={"chunk_host_ms": sv.stats["host_ms"][3:7]})
    # chunks 3..6 of the window read inside[s] times 1, 2, 3, 4
    return sv, rec, {s: inside[s] * 2.5 for s in stages}


def test_each_reader_averages_the_window_alone():
    sv, rec, want = window_verifier()
    for name, s in STAGE_METRICS.items():
        assert read(name, rec) == pytest.approx(want[s])
    assert read("call_precheck_ms.stream", rec) == pytest.approx(
        want["precheck"])
    # the harness's own reading of the same chunks is unmoved
    host = sum(want[s] for s in pipeline.CHUNK_STAGES)
    assert read("chunk_host_ms.stream", rec) == pytest.approx(host)
    assert sv in pipeline.live_verifiers()


def test_no_reader_guesses_without_the_window_run():
    sv, rec, _ = window_verifier()
    # equal floats that are not the program's own objects
    copies = Record(setup_s=1.0, layer={"chunk_host_ms": [
        float(repr(x)) for x in rec.layer["chunk_host_ms"]]})
    assert copies.layer["chunk_host_ms"] == rec.layer["chunk_host_ms"]
    # the window's chunks out of order, or running past the readings
    host = sv.stats["host_ms"]
    shuffled = Record(setup_s=1.0, layer={"chunk_host_ms": host[4:7]
                                          + host[3:4]})
    past = Record(setup_s=1.0, layer={"chunk_host_ms": host[7:]
                                      + rec.layer["chunk_host_ms"]})
    for r in (copies, shuffled, past, Record(setup_s=1.0)):
        for name in NEW:
            assert read(name, r) is None, name
    # a program that keeps host_ms alone (before its stage readings)
    del sv.stats["stage_ms"], sv.stats["precheck_ms"]
    for name in NEW:
        assert read(name, rec) is None, name
    assert read("chunk_host_ms.stream", rec) is not None


def test_a_traced_tiny_run_prints_the_stages():
    line = sup.run_tiny(CELL, seconds=2.0, trace=1)
    assert line["correct"] is True
    got = line["metrics"]
    assert NEW <= set(got)
    host = got["chunk_host_ms.stream"]["value"]
    parts = sum(got[f"chunk_{s}_ms.stream"]["value"]
                for s in pipeline.CHUNK_STAGES)
    assert parts == pytest.approx(host, rel=1e-6)
    assert all(got[n]["unit"] == "ms" and got[n]["value"] >= 0 for n in NEW)
