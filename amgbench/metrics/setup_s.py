"""Process start to the window's first request: imports, builds, inputs,
the constructor and a warm request (host clock)."""


def read(record):
    return record.setup_s
