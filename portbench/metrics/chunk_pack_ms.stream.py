"""chunk_pack_ms.stream: the pack stage of a chunk: the host pack of its
rows, the native ed25519_pack_commits (csrc/hostaccel.cpp through
native/), or the numpy screen; the stream verifier's
stats["stage_ms"]["pack"], the mean over the window's chunks."""
from portbench import stages


def read(rec):
    return stages.chunk_mean(rec, "pack")
