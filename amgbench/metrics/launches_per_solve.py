"""Kernel launches a solve: the profiler's kernels that ran on the device
within the stretch's ``solve`` spans (each ends in a synchronize), over
the number of those spans."""


def read(record):
    tr = record.trace
    if tr is None or not tr.spans.get("solve"):
        return None
    kernels = tr.kernels_during("solve")
    if not kernels:
        return None
    return len(kernels) / len(tr.spans["solve"])
