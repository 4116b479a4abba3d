"""setup_s: seconds from the process's start to the window's start."""


def read(rec):
    return rec.setup_s
