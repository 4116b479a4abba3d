"""blocks_per_s: commits verified in the window over its seconds."""


def read(rec):
    return rec.items / rec.window_s if rec.window_s > 0 else None
