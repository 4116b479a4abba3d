"""chunk_verdicts_ms.stream: the verdicts stage of a chunk: the per-commit
verdict and blame loop in _collect; the stream verifier's
stats["stage_ms"]["verdicts"], the mean over the window's chunks."""
from portbench import stages


def read(rec):
    return stages.chunk_mean(rec, "verdicts")
