"""chunk_wait_ms.stream: the wait of a chunk: the host blocked on the card
in _collect until the chunk's validity and quorum bits reach the host;
the stream verifier's stats["stage_ms"]["wait"], the mean over the
window's chunks."""
from portbench import stages


def read(rec):
    return stages.chunk_mean(rec, "wait")
