"""K1' (``csrc/dia_matvec.cu``, every entry) over its roofline: the sum
of each launch's bound over the sum of K1' device time in the stretch.

A launch's bound is its diagonals and x read once and y written once over
HBM bandwidth (``roofline.dia_bytes``), or its operations over the peak
rate of its type where that is larger.  The shapes come from a hook on
``dia_kernel.dia_matvec`` during the stretch, the times from the
profiler's kernels of that name; a count that differs gives nothing."""

from amgbench import roofline

KERNEL = "dia_matvec"


def _record(diags, offsets, x, m):
    k, n = diags.shape
    if n == 0:
        return None
    return (roofline.dia_bytes(k, n, int(m), diags.element_size(),
                               x.element_size()),
            roofline.dia_flops(k, n), str(x.dtype).replace("torch.", ""))


HOOKS = [{"name": "k1", "target": "pyamg_tpu_torch.sparse.dia_kernel:dia_matvec",
          "record": _record}]


def read(record):
    tr = record.trace
    calls = [c for c in record.calls.get("k1", []) if c is not None]
    if tr is None or not calls:
        return None
    kernels = [k for k in tr.in_stretch(tr.kernels) if KERNEL in k[2]]
    if len(kernels) != len(calls):
        return None
    busy = sum(e - s for s, e, *_ in kernels) * 1e-6
    bound = sum(roofline.bound_seconds(b, f, dt) for b, f, dt in calls)
    return 100.0 * bound / busy if busy > 0 else None
