"""Seconds of the program's constructor in the warm set-up: host clock
around the call, ending in ``torch.cuda.synchronize()``."""


def read(record):
    return record.amg_setup_s
