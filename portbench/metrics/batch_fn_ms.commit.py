"""batch_fn_ms.commit: a call's time inside its batch_fn (dispatch, host
pack, upload, kernel, download), the mean over the window's calls."""
from portbench import stats


def read(rec):
    return stats.mean(rec.layer.get("batch_fn_ms", []))
