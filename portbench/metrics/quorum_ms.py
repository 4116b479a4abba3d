"""quorum_ms: each height's time from its first precommit submission to
its quorum event, summed over the window's heights and divided by their
number."""
from portbench import stats


def read(rec):
    return stats.mean(rec.layer.get("quorum_ms", []))
