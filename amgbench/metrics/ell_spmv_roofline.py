"""The padded-ELL matvec (``sparse/ell.py``, plain torch gathers) over its
roofline: the sum of each call's bound over the device time of the
kernels each call launched.

A call's bound is its values and int32 columns read once, x read once
and y written once over HBM bandwidth (``roofline.ell_bytes``).  A hook
on ``SparseELL.matvec`` during the stretch records each call's shape and
wraps it in the span ``ell_matvec``; the profiler ties each kernel to
the span its launch lay in."""

from amgbench import roofline


def _record(ell, x):
    n, m = ell.shape
    return (roofline.ell_bytes(n, ell.width, m, ell.data.element_size(),
                               ell.cols.element_size()),
            roofline.ell_flops(n, ell.width),
            str(ell.data.dtype).replace("torch.", ""))


HOOKS = [{"name": "ell", "target": "pyamg_tpu_torch.sparse.ell:SparseELL.matvec",
          "span": "ell_matvec", "record": _record}]


def read(record):
    tr = record.trace
    calls = record.calls.get("ell", [])
    if tr is None or not calls:
        return None
    kernels = tr.kernels_launched_in("ell_matvec")
    if not kernels:
        return None
    busy = sum(e - s for s, e, *_ in kernels) * 1e-6
    bound = sum(roofline.bound_seconds(b, f, dt) for b, f, dt in calls)
    return 100.0 * bound / busy if busy > 0 else None
