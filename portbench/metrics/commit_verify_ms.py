"""commit_verify_ms: the window's milliseconds over the VerifyCommitLight
calls it completed."""


def read(rec):
    return rec.window_s * 1e3 / rec.items if rec.items else None
