"""The metric arithmetic: rates over the whole window, the 95th percentile
of all calls, rooflines from the frozen counts, and the reading of a
device trace."""
import pytest

from portbench import registry, stats
from portbench.driver import Record
from portbench.frozen import devtime, opcounts
from portbench.program import kernel_key


def read(name, rec):
    return registry.reader(name)(rec)


def test_rates_are_over_the_whole_window():
    rec = Record(setup_s=12.5, window_s=30.2, items=604,
                 op_ms=[1.0] * 10)
    assert read("commit_verify_ms", rec) == pytest.approx(50.0)
    assert read("blocks_per_s", rec) == pytest.approx(20.0)
    assert read("setup_s", rec) == 12.5
    rec.layer["quorum_ms"] = [500.0, 700.0, 900.0]
    assert read("quorum_ms", rec) == pytest.approx(700.0)
    assert read("commit_verify_ms", Record(setup_s=1.0)) is None


def test_p95_is_of_all_calls():
    xs = list(range(1, 101))          # nearest rank: the 95th value
    assert stats.p95(xs) == 95
    assert stats.p95([7.0]) == 7.0
    assert stats.p95([]) is None
    rec = Record(setup_s=0, op_ms=[float(x) for x in reversed(xs)])
    assert read("commit_verify_p95_ms", rec) == 95.0


def test_layer_means():
    rec = Record(setup_s=0, layer={
        "collect_ms": [20.0, 22.0], "batch_fn_ms": [30.0, 34.0],
        "chunk_host_ms": [80.0, 90.0, 100.0],
        "flush_rows": [40, 50, 0, 30], "flush_dev_ms": [1.0, 2.0]})
    assert read("collect_ms.commit", rec) == 21.0
    assert read("batch_fn_ms.commit", rec) == 32.0
    assert read("chunk_host_ms.stream", rec) == 90.0
    assert read("rows_per_flush.plane", rec) == 30.0
    assert read("flush_dev_ms.plane", rec) == 1.5


def test_roofline_from_the_frozen_counts():
    assert opcounts.MULADDS_PER_SIGNATURE == {"ed25519_verify": 257_950,
                                              "cached_verify": 100_845}
    assert opcounts.PEAK_MULADDS_PER_S == pytest.approx(1.67270e13, rel=1e-4)
    # 10,000 general verifies at the peak take 0.1542 ms
    bound_s = 10_000 * 257_950 / opcounts.PEAK_MULADDS_PER_S
    assert stats.roofline_pct("ed25519_verify", 10_000, bound_s) == \
        pytest.approx(100.0)
    assert stats.roofline_pct("ed25519_verify", 10_000, 4 * bound_s) == \
        pytest.approx(25.0)
    assert stats.roofline_pct("cached_verify", 0, 1.0) is None
    assert stats.idle_pct(0.25, 1.0) == 75.0


def _trace():
    """A synthetic chrome trace: a 100 us slice, two verify kernels (one
    of them running past the slice's end), a copy, and host spans."""
    k = "void (anonymous namespace)::ed25519_verify_kernel(int const*, int)"
    return [
        {"cat": "user_annotation", "name": devtime.SLICE, "ts": 1000,
         "dur": 100},
        {"cat": "user_annotation", "name": "batch_fn", "ts": 1000,
         "dur": 60},
        {"cat": "user_annotation", "name": "validation.verify_commit_light",
         "ts": 1000, "dur": 100},
        {"cat": "kernel", "name": k, "ts": 1010, "dur": 20},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
         "ts": 1025, "dur": 10},
        {"cat": "kernel", "name": k, "ts": 1090, "dur": 20},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 1000, "dur": 5},
    ]


def test_trace_reading():
    spans = ("batch_fn", "validation.verify_commit_light")
    p = devtime.analyse(_trace(), spans, kernel_key)
    assert p.window_s == pytest.approx(100e-6)
    # busy: 1010-1035 and 1090-1100 (clipped at the slice's end)
    assert p.busy_s == pytest.approx(35e-6)
    assert p.kernel_n == {"ed25519_verify": 2}
    assert p.kernel_s["ed25519_verify"] == pytest.approx(30e-6)
    assert [n for n, _ in p.device_ops] == ["ed25519_verify_kernel",
                                           "Memcpy HtoD"]
    # gaps 1000-1010 (its middle in batch_fn) and 1035-1090 (its middle
    # past batch_fn's end, inside the call)
    gaps = {(n, round(s * 1e6)) for n, s in p.idle_gaps}
    assert gaps == {("batch_fn", 10), ("validation.verify_commit_light", 55)}
    assert p.spans == {"batch_fn": 1, "validation.verify_commit_light": 1}
    rec = Record(setup_s=0, profile=p)
    assert read("idle_pct.commit", rec) == pytest.approx(65.0)
    p.rows = {"ed25519_verify": 2}
    assert read("ed25519_verify_roofline.commit", rec) == pytest.approx(
        stats.roofline_pct("ed25519_verify", 2, 30e-6))
    # the cached kernel ran in no event: its share is left out, never 0
    assert read("cached_verify_roofline.stream", rec) is None


def test_lost_events_scale_by_launches():
    p = devtime.analyse(_trace(), (), kernel_key)
    p.launches = 4                   # the trace kept 2 of 4 launches
    assert p.kernel_seconds("ed25519_verify") == pytest.approx(60e-6)
    assert devtime.analyse(_trace()[1:], (), kernel_key) is None


def test_every_metric_has_a_reader_that_finds_nothing_in_an_empty_run():
    bench = registry.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        value = registry.reader(m["name"])(Record(setup_s=3.0))
        assert value is None or m["name"] == "setup_s"
