"""The share of a request's time in which no kernel, copy or set runs on
the device: 1 - (device-busy time a request in the traced stretch: the
union of the device's intervals over the requests traced) / (host time a
request over the window's first half, before the stretch, which no
profiler slowed: the profiler slows the host's launches, also once it
has stopped).  Both count whole requests (generate, solve, sample)."""


def read(record):
    tr = record.trace
    if tr is None or not record.traced or not record.untraced:
        return None
    busy = tr.busy_us() * 1e-6
    if busy <= 0 or record.untraced_s <= 0:
        return None
    per_request = record.untraced_s / record.untraced
    return 100.0 * (1.0 - busy / record.traced / per_request)
