"""The byte and operation counts against counts by hand."""

import pytest

from amgbench import roofline


def test_dia_bytes_by_hand():
    # 4096^2 level 0 in float32: 5 diagonals, x and y
    n = 4096 ** 2
    assert roofline.dia_bytes(5, n, n, 4, 4) == (5 + 2) * n * 4 == 469762048
    # the float64 residual operator
    assert roofline.dia_bytes(5, n, n, 8, 8) == 7 * n * 8
    # bf16 diagonals with a float32 x
    assert roofline.dia_bytes(5, 10, 10, 2, 4) == 5 * 10 * 2 + 20 * 4
    # a rectangular operator reads x of its columns
    assert roofline.dia_bytes(3, 100, 40, 4, 4) == 3 * 100 * 4 + 140 * 4
    assert roofline.dia_flops(5, n) == 10 * n


def test_ell_bytes_by_hand():
    n = 104 ** 3
    # values and int32 columns of 27 slots, x and y, float32
    assert roofline.ell_bytes(n, 27, n, 4, 4) == n * 27 * 8 + 2 * n * 4
    assert roofline.ell_bytes(10, 3, 4, 8, 4) == 10 * 3 * 12 + 14 * 8
    assert roofline.ell_flops(n, 27) == 54 * n


def test_bound_takes_the_larger_side():
    assert roofline.bound_seconds(3.35e12, 1.0, "float32") == \
        pytest.approx(1.0)
    assert roofline.bound_seconds(1.0, 67e12, "float32") == \
        pytest.approx(1.0)
    assert roofline.bound_seconds(1.0, 34e12, "float64") == \
        pytest.approx(1.0)
    assert roofline.L2_BYTES * 4 < roofline.dia_bytes(5, 4096 ** 2,
                                                      4096 ** 2, 4, 4)
