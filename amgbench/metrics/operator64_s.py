"""Seconds the warm request's ``solve_mp`` spent building its float64
operator: the program's span ``solve_mp.operator64`` of the served
solver (with ``host_A``, the device operator converted to a host matrix,
where the hierarchy kept none), part of ``setup_s``."""

from amgbench import program_spans

HOOKS = program_spans.HOOKS


def read(record):
    return program_spans.setup_seconds(
        record, lambda r: r[2] == "solve_mp.operator64")
