"""The masked products of the served solver's set-up: their bytes,
operations and device time.

``pyamg_tpu_torch`` runs each masked product of a set-up (``S T``, ``A P``
and ``R (A P)`` of every level; the energy CG's ``A D``) in the program
span ``spgemm`` (``sparse/spgemm_device.py``, ``util/profiling.py``) with
the attributes ``route``, ``n`` and ``nb`` (A's and B's rows), ``w_a``,
``w_b``, ``w_out`` and ``dtype``, and on a card ``device_us``: CUDA events
that the kernel's launcher records around the kernel alone.  The records
sit in the set-up part of the served solver's span log
(``program_spans.served_log``).

A product's bound counts each byte once: A's values and int32 columns,
B's values and int32 columns, the pattern's int32 columns read, and the
output's values written; its operations are a multiply and an add for
each pair of an A slot and a B slot.  A program without these spans, or
one that timed none of them, gives None.
"""

from __future__ import annotations

from amgbench import program_spans, roofline

ITEMSIZE = {"float32": 4, "float64": 8}
INDEX_BYTES = 4


def spgemm_bytes(n: int, nb: int, w_a: int, w_b: int, w_out: int,
                 itemsize: int) -> int:
    """A masked product of an ``(n, w_a)`` A, an ``(nb, w_b)`` B and an
    ``(n, w_out)`` pattern: A, B and the pattern's columns read once, the
    output written once."""
    return (n * w_a * (itemsize + INDEX_BYTES)
            + nb * w_b * (itemsize + INDEX_BYTES)
            + n * w_out * (INDEX_BYTES + itemsize))


def spgemm_flops(n: int, w_a: int, w_b: int) -> int:
    """A multiply and an add for each A slot and each slot of the B row it
    names."""
    return 2 * n * w_a * w_b


def bound_seconds(attrs: dict) -> float:
    """The least time of the product whose span attributes are ``attrs``
    (``roofline.bound_seconds``)."""
    size = ITEMSIZE[attrs["dtype"]]
    return roofline.bound_seconds(
        spgemm_bytes(attrs["n"], attrs["nb"], attrs["w_a"], attrs["w_b"],
                     attrs["w_out"], size),
        spgemm_flops(attrs["n"], attrs["w_a"], attrs["w_b"]),
        attrs["dtype"])


def timed_products(record):
    """The attributes of the served solver's set-up ``spgemm`` spans that
    carry ``device_us``, or None where there are none."""
    log = program_spans.served_log(record)
    if log is None:
        return None
    timed = [r[5] for r in log.setup
             if r[2] == "spgemm" and "device_us" in r[5]]
    return timed or None
