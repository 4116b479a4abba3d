"""collect_ms.commit: a call's time outside its batch_fn (the collection
loop and the sign-bytes), the mean over the window's calls."""
from portbench import stats


def read(rec):
    return stats.mean(rec.layer.get("collect_ms", []))
