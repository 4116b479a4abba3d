"""chunk_dispatch_ms.stream: the dispatch stage of a chunk: the pageable
upload of its rows and the kernel launches (verify_tally_rows and its
cached counterparts); the stream verifier's
stats["stage_ms"]["dispatch"], the mean over the window's chunks."""
from portbench import stages


def read(rec):
    return stages.chunk_mean(rec, "dispatch")
