"""chunk_host_ms.stream: the stream verifier's host time to stage and
dispatch a chunk (its stats["host_ms"]), the mean over the window."""
from portbench import stats


def read(rec):
    return stats.mean(rec.layer.get("chunk_host_ms", []))
