"""commit_verify_p95_ms: the 95th percentile of all the window's
VerifyCommitLight calls (host clock)."""
from portbench import stats


def read(rec):
    return stats.p95(rec.op_ms)
