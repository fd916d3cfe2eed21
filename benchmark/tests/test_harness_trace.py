"""The traced window's reduction: busy time, idle gaps named by the span
the host was in, device time inside spans and by layer."""

from __future__ import annotations

import pytest

from benchmark.trace import Event, Trace, short


@pytest.fixture
def trace():
    spans = [Event("window", 0, 100, 1), Event("a", 10, 50, 1), Event("b", 20, 30, 1),
             Event("c", 60, 90, 1), Event("x", 0, 100, 2)]
    device = [Event("void k1<int>(float*)", 5, 15), Event("k2", 25, 28),
              Event("transe_rank_tma_kernel", 40, 70), Event("k4", 95, 120)]
    return Trace(device, spans, (0, 100), 1)


def test_busy_and_gaps(trace):
    assert trace.busy == [(5, 15), (25, 28), (40, 70), (95, 100)]
    assert trace.idle_gaps() == [(0, 5), (15, 25), (28, 40), (70, 95)]
    assert trace.busy_s == pytest.approx(48e-9)
    assert trace.window_s == pytest.approx(100e-9)


def test_gaps_by_innermost_span(trace):
    gaps = dict(trace.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"c": 25e-9, "a": 12e-9, "b": 10e-9,
                                  "outside spans": 5e-9})


def test_time_in_spans_and_layers(trace):
    assert trace.time_in_spans("a") == pytest.approx(18e-9)
    assert trace.time_in_spans("c") == pytest.approx(10e-9)
    layers = trace.by_layer([("transe_rank", "K1"), ("k[0-9]", "other kernels")])
    assert layers == pytest.approx({"K1": 30e-9, "other kernels": 18e-9})
    assert trace.time_by("transe_rank") == (pytest.approx(30e-9), 1)
    assert trace.time_by("k4") == (pytest.approx(5e-9), 1)    # clipped to the window


def test_short_names():
    assert short("void k1<int>(float*)") == "k1<int>(float*)"
    assert len(short("x" * 500)) == 120
