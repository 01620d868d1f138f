"""The share of the traced stretch's device-idle time (``Trace.idle_gaps``)
in gaps that open while the host is inside a program ``sync`` span, a
device read (``util.profiling.read_back``): idle time the read-backs
cost.  The program's spans are put on the trace's clock by the stretch's
``solve`` spans (``program_spans.py``)."""

from amgbench import program_spans

HOOKS = program_spans.HOOKS


def read(record):
    shares = program_spans.idle_shares(record)
    return None if shares is None else shares["sync"]
