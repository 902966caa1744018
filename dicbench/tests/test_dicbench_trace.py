"""The reduction of a Chrome trace: the window, the device's busy union,
kernel counts, device operations by time and idle gaps by label."""

import pytest

from dicbench import roofline, trace


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_reduce():
    events = [
        _ev(trace.WINDOW_SPAN, "user_annotation", 0, 100),
        _ev("dicbench.run_sequence", "user_annotation", 0, 100),
        _ev("aten::copy_", "cpu_op", 5, 10),
        _ev("k1", "kernel", 10, 20, tid=7),
        _ev("step", "kernel", 25, 10, tid=7),  # overlaps k1
        _ev("Memcpy HtoD", "gpu_memcpy", 60, 5, tid=7),
        _ev("k1", "kernel", 90, 20, tid=7),  # runs past the window
        _ev("aten::empty", "cpu_op", 40, 15),
        _ev("aten::mul", "cpu_op", 41, 2, tid=2),  # another thread
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    # busy: [10, 35] + [60, 65] + [90, 100]
    assert r["busy_s"] == pytest.approx(40e-6)
    assert r["kernels"] == 3 and r["sequences"] == 1
    assert r["device_ops"][0] == ("k1", pytest.approx(40e-6))
    gaps = dict(r["idle_gaps"])
    assert gaps["dicbench.run_sequence > aten::empty"] == pytest.approx(25e-6)
    assert gaps["dicbench.run_sequence > aten::copy_"] == pytest.approx(10e-6)
    assert gaps["dicbench.run_sequence > after aten::empty"] == pytest.approx(
        25e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)


def test_reduce_without_window():
    assert trace.reduce([_ev("k", "kernel", 0, 1)]) == {}


def test_bounds():
    assert roofline.bound_ms(3.35e9) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 67e9) == pytest.approx(1.0)
    moved, ops = roofline.assembly_work("AFFINE", "BICUBIC", 1, 441, 900, 1,
                                        6)
    assert moved == 441 * 12 + 900 * 4 + (2 + 6 + 8 + 64) * 4
    assert ops == 441 * 242
    assert roofline.assembly_work("UV", "BILINEAR", 1, 10, 10, 1, 2)[1] == 0
