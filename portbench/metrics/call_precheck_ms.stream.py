"""call_precheck_ms.stream: a verify call's prechecks before its chunks:
the structural checks of each commit, the key-type screen and the row
count (blocksync/pipeline.py); the stream verifier's
stats["precheck_ms"], the mean over the window's calls."""
from portbench import stages


def read(rec):
    return stages.precheck_mean(rec)
