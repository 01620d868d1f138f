"""The set-up's masked products (K4' and K5') over their roofline: the sum
of each product's bound over the sum of its device time, both over the
served solver's set-up ``spgemm`` spans that carry a device time
(``amgbench/spgemm.py``: each byte counted once)."""

from amgbench import program_spans, spgemm

HOOKS = program_spans.HOOKS


def read(record):
    timed = spgemm.timed_products(record)
    if timed is None:
        return None
    busy = sum(p["device_us"] for p in timed) * 1e-6
    if busy <= 0:
        return None
    return 100.0 * sum(spgemm.bound_seconds(p) for p in timed) / busy
