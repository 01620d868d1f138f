"""The readers of the set-up's masked products (``spgemm.py``,
``spgemm_roofline`` and ``spgemm_s``) on span logs made by hand."""

import types

import pytest

from amgbench import program_spans, roofline, spec, spgemm
from amgbench.harness import Record

US = 1000          # program records are in nanoseconds


def product(i, parent, device_us=None, **shape):
    attrs = dict(route="gather", n=1000, nb=3000, w_a=125, w_b=27, w_out=27,
                 dtype="float32")
    attrs.update(shape)
    if device_us is not None:
        attrs["device_us"] = device_us
    return (i, parent, "spgemm", i * US, (i + 1) * US, attrs)


def made_record(products):
    setup = [(1, None, "setup", 0, 10 ** 9, {"constructor": "c",
                                            "rows": 3000}),
             (2, 1, "galerkin", 0, 10 ** 8, {"host": False})] + products
    log = types.SimpleNamespace(setup=setup, solves=[])
    r = Record()
    r.calls = {"program": [log, log]}
    return r


def test_bytes_and_operations():
    # R (A P) of the 27-point operator at 104^3 in float32, by hand:
    # R 41,600 x 125, A P 1,124,864 x 27, the pattern 41,600 x 27
    got = spgemm.spgemm_bytes(41_600, 1_124_864, 125, 27, 27, 4)
    assert got == 41_600 * 125 * 8 + 1_124_864 * 27 * 8 + 41_600 * 27 * 8
    assert spgemm.spgemm_flops(41_600, 125, 27) == 2 * 41_600 * 125 * 27
    # bound by bytes: 293 MB over 3.35 TB/s
    attrs = product(3, 2)[5]
    assert spgemm.bound_seconds(attrs) == pytest.approx(
        spgemm.spgemm_bytes(1000, 3000, 125, 27, 27, 4)
        / roofline.HBM_BYTES_PER_S)
    f64 = dict(attrs, dtype="float64")
    assert spgemm.bound_seconds(f64) == pytest.approx(
        spgemm.spgemm_bytes(1000, 3000, 125, 27, 27, 8)
        / roofline.HBM_BYTES_PER_S)


def test_readers():
    prods = [product(3, 2, device_us=40.0),
             product(4, 2, device_us=60.0, n=2000, w_a=5, w_b=4, w_out=6,
                     route="banded"),
             product(5, 2)]                # no device time: left out
    r = made_record(prods)
    assert spec.metric_reader("spgemm_s").read(r) == pytest.approx(100e-6)
    bound = sum(spgemm.bound_seconds(p[5]) for p in prods[:2])
    assert spec.metric_reader("spgemm_roofline").read(r) == \
        pytest.approx(100.0 * bound / 100e-6)
    for m in ("spgemm_s", "spgemm_roofline"):
        assert spec.metric_reader(m).HOOKS == program_spans.HOOKS


def test_readers_find_nothing():
    # products with no device time, as on the CPU
    r = made_record([product(3, 2), product(4, 2)])
    # a program without spgemm spans, and one without spans at all
    empty = made_record([])
    bare = Record()
    bare.calls = {"program": [None]}
    for m in ("spgemm_s", "spgemm_roofline"):
        for rec in (r, empty, bare, Record()):
            assert spec.metric_reader(m).read(rec) is None, m
    # device times of zero give no share
    zero = made_record([product(3, 2, device_us=0.0)])
    assert spec.metric_reader("spgemm_roofline").read(zero) is None
    assert spec.metric_reader("spgemm_s").read(zero) == 0.0
