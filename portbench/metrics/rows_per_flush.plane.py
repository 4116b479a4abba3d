"""rows_per_flush.plane: the flush ledger's rows over its flushes in the
window."""


def read(rec):
    rows = rec.layer.get("flush_rows", [])
    return sum(rows) / len(rows) if rows else None
