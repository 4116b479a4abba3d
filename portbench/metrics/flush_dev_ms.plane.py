"""flush_dev_ms.plane: the mean of the flush ledger's dev_ms (one CUDA event
pair around a flush's launches) over the window's flushes."""
from portbench import stats


def read(rec):
    return stats.mean(rec.layer.get("flush_dev_ms", []))
