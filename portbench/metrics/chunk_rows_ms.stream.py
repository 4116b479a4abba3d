"""chunk_rows_ms.stream: the rows stage of a chunk: the valset arrays, the
per-row Python lists and the quorum thresholds (blocksync/pipeline.py);
the stream verifier's stats["stage_ms"]["rows"], the mean over the
window's chunks."""
from portbench import stages


def read(rec):
    return stages.chunk_mean(rec, "rows")
