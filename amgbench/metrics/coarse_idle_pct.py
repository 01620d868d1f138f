"""The share of the traced stretch's device-idle time in gaps that open
while the host is inside a program ``cycle`` span of level 1 or below and
outside every ``sync`` span: idle time the host's launches on the coarse
levels cost.  With ``sync_idle_pct`` and the rest (level 0, the Krylov
vector updates, the benchmark's own steps) it makes 100%."""

from amgbench import program_spans

HOOKS = program_spans.HOOKS


def read(record):
    shares = program_spans.idle_shares(record)
    return None if shares is None else shares["coarse"]
