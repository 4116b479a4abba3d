"""collect_ms.mixed: a call's collection loop in types/validation.py
`_verify_batch` (its `validation.collect` span, the record's "collect"),
the mean over the window's calls."""
from portbench import stats


def read(rec):
    return stats.mean(rec.layer.get("collect_ms", []))
