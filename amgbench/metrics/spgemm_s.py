"""Device seconds of the served solver's set-up in its masked products
(K4' and K5'): the ``device_us`` of its ``spgemm`` spans, summed
(``amgbench/spgemm.py``)."""

from amgbench import program_spans, spgemm

HOOKS = program_spans.HOOKS


def read(record):
    timed = spgemm.timed_products(record)
    if timed is None:
        return None
    return sum(p["device_us"] for p in timed) * 1e-6
