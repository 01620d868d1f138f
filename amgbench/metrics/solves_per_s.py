"""Requests answered over the window's whole time, from its start to the
last answer (host clock)."""


def read(record):
    if not record.window_s or record.window_s <= 0:
        return None
    return record.answers / record.window_s
