"""chunk_layout_ms.stream: the layout stage of a chunk: the packed rows
built from the pack (ops/ed25519_fused.py pack_rows), or the cached
branch's strided scatter or stamping deltas; the stream verifier's
stats["stage_ms"]["layout"], the mean over the window's chunks."""
from portbench import stages


def read(rec):
    return stages.chunk_mean(rec, "layout")
