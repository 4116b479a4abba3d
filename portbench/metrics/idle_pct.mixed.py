"""idle_pct.mixed: the share of the profiled slice in which no kernel, copy or
memset ran on the card."""
from portbench import stats


def read(rec):
    p = rec.profile
    return stats.idle_pct(p.busy_s, p.window_s) if p else None
