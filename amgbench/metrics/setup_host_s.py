"""Seconds of the served solver's set-up spent in the host's own stages:
the program's set-up spans with ``host=True`` (structured: the probe
tables, the color masks, the coarsest level's host matrix; general:
strength, aggregation, ``fit_candidates``, the symbolic patterns and the
coloring), summed; they never nest in one another
(``util/profiling.py``, ``program_spans.py``)."""

from amgbench import program_spans

HOOKS = program_spans.HOOKS


def read(record):
    return program_spans.setup_seconds(
        record, lambda r: r[5].get("host") is True)
