"""The trace reader and the per-layer readers on a trace made by hand."""

import pytest

from amgbench import roofline, spec
from amgbench.harness import Record
from amgbench.trace import Trace


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def made_trace():
    """A stretch of 0-100 us: two solves (10-40, 50-90), a generate
    (0-10), one ELL call at 12-14 launching kernels 1-2, K1' as kernel 3;
    device busy 12-20, 22-30, 55-60 (a copy)."""
    return Trace([
        ev("user_annotation", "amgbench.stretch", 0, 100),
        ev("user_annotation", "amgbench.generate", 0, 10),
        ev("user_annotation", "amgbench.solve", 10, 30),
        ev("user_annotation", "amgbench.solve", 50, 40),
        ev("user_annotation", "amgbench.ell_matvec", 12, 2),
        ev("user_annotation", "other_annotation", 0, 100),
        ev("cuda_runtime", "cudaLaunchKernel", 12.5, 0.5, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 13.0, 0.5, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 20.5, 0.5, 3),
        ev("kernel", "index_kernel", 12, 4, 1),
        ev("kernel", "reduce_kernel", 16, 4, 2),
        ev("kernel", "void dia_matvec_kernel<float, float>", 22, 8, 3),
        ev("gpu_memcpy", "Memcpy DtoH", 55, 5, 4),
        ev("kernel", "outside", 200, 5, 5),
    ])


def test_stretch_busy_and_gaps():
    tr = made_trace()
    assert tr.stretch() == (0, 100)
    assert tr.busy_us() == pytest.approx(21)
    gaps = tr.idle_gaps()
    assert gaps[0] == (60, 100) and (0, 12) in gaps and (20, 22) in gaps
    assert tr.span_at(5) == "generate" and tr.span_at(13) == "ell_matvec"
    assert tr.span_at(45) == "other"
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["dia_matvec_kernel<float, float>",
                                   pytest.approx(8e-6)]
    assert bd["idle_gaps"][0] == ["solve", pytest.approx(40e-6)]
    assert len(tr.kernels_during("solve")) == 3
    assert [k[2] for k in tr.kernels_launched_in("ell_matvec")] == [
        "index_kernel", "reduce_kernel"]


def record(calls):
    rec = Record()
    rec.trace = made_trace()
    rec.calls = calls
    rec.stretch_infos = [{"inner_iterations": 16, "rounds": 2},
                         {"inner_iterations": 17, "rounds": 2}]
    rec.amg_setup_s = 1.5
    # the stretch holds 2 requests; 4 before it took 60 us each
    rec.traced, rec.untraced, rec.untraced_s = 2, 4, 240e-6
    return rec


def test_readers():
    k1 = (roofline.dia_bytes(5, 1000, 1000, 4, 4), 10000, "float32")
    ell = (roofline.ell_bytes(100, 27, 100, 4, 4), 5400, "float32")
    rec = record({"k1": [k1], "ell": [ell]})
    read = {m: spec.metric_reader(m).read(rec) for m in (
        "inner_iters", "amg_setup_s", "launches_per_solve", "k1_roofline",
        "ell_spmv_roofline", "device_idle_pct")}
    assert read["inner_iters"] == 14.5
    assert read["amg_setup_s"] == 1.5
    assert read["launches_per_solve"] == 1.5
    assert read["k1_roofline"] == pytest.approx(
        100 * roofline.bound_seconds(*k1) / 8e-6)
    assert read["ell_spmv_roofline"] == pytest.approx(
        100 * roofline.bound_seconds(*ell) / 8e-6)
    # 21 us busy over 2 requests, against 60 us a request untraced
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 10.5 / 60))


def test_readers_find_nothing():
    rec = record({})
    assert spec.metric_reader("k1_roofline").read(rec) is None
    assert spec.metric_reader("ell_spmv_roofline").read(rec) is None
    # a launch count that differs from the kernels gives nothing
    rec = record({"k1": [(1, 1, "float32")] * 2})
    assert spec.metric_reader("k1_roofline").read(rec) is None
    rec = record({})
    rec.untraced = 0          # the stretch took the whole window
    assert spec.metric_reader("device_idle_pct").read(rec) is None
    empty = Record()
    for m in ("inner_iters", "launches_per_solve", "device_idle_pct",
              "solves_per_s", "solve_ms_p95"):
        assert spec.metric_reader(m).read(empty) is None


def test_end_to_end_readers():
    rec = Record()
    rec.times = [0.1 * (i + 1) for i in range(20)]
    rec.answers, rec.window_s, rec.setup_s = 19, 9.5, 21.25
    read = {m: spec.metric_reader(m).read(rec) for m in (
        "solves_per_s", "solve_ms_p95", "setup_s")}
    assert read["solves_per_s"] == pytest.approx(2.0)
    assert read["solve_ms_p95"] == pytest.approx(1905.0)
    assert read["setup_s"] == 21.25
