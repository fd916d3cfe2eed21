"""The readers of the port's own spans, on a hand-made trace: the loader's
busy and idle shares, the rank loop's host work a call and its share of
the idle window; None where events were lost or the port records no span;
and every other reader unchanged by the spans."""

from __future__ import annotations

import pytest

from benchmark import spec
from benchmark.harness import Window
from benchmark.run import Context
from benchmark.trace import Event, Trace
from blp_tpu_torch import profiling

NEW = ("loader_busy_pct.train", "loader_idle_pct.train", "prep_ms.rank",
       "prep_idle_pct.rank")
MAIN, LOADER = 11, 22


def _span(name, start, end, thread, seq, parent=-1):
    s = profiling.Span(name)
    s.start, s.end, s.thread, s.seq, s.parent = start, end, thread, seq, parent
    return s


#: Window 0..1000 ns; the device busy 100..300 and 600..700 (idle 700 ns).
DEVICE = [Event("transe_rank_tma_kernel", 100, 300), Event("bias_act_fwd", 600, 650),
          Event("indexing_backward_kernel", 650, 700)]
SPANS = [
    # The loader's thread: 50..150 assembling, 150..250 placing, 800..1100
    # assembling (clipped at the window's end).
    _span("prefetch.assemble", 50, 150, LOADER, 1),
    _span("prefetch.place", 150, 250, LOADER, 2),
    _span("prefetch.assemble", 800, 1100, LOADER, 3),
    # The main thread's rank loop: host work 0..100 and 300..400, with a
    # span of another name inside the second (not its self time), and a
    # rank launch 400..600.
    _span("eval.ent2idx", 0, 100, MAIN, 4),
    _span("eval.batch_filters", 300, 400, MAIN, 5),
    _span("inner", 350, 370, MAIN, 6, parent=5),
    _span("eval.rank_batch", 400, 600, MAIN, 7),
    # Outside the window: left out.
    _span("eval.to_device", 2000, 2100, MAIN, 8),
]


def _ctx(lost=False, steps=2):
    bench = [Event("window", 0, 1000, 1), Event("rank.call", 0, 1000, 1)]
    trace = Trace(DEVICE, bench, (0, 1000), 1)
    window = Window(units=10, seconds=1e-6, steps=steps, attempted=10,
                    flops=1e6, rank_ops=1e6)
    return Context(window, trace, 2**30, lost, spec.kernel_layers())


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(profiling, "kept_spans", lambda: list(SPANS))


def test_readers_give_their_values(spans):
    ctx = _ctx()
    # Loader busy 50..250 and 800..1000: 400 of 1,000 ns.
    assert _read("loader_busy_pct.train", ctx) == pytest.approx(40.0)
    # Idle 0..100, 300..600, 700..1000 (700 ns); the loader covers 50..100
    # and 800..1000 of it: 250 ns.
    assert _read("loader_idle_pct.train", ctx) == pytest.approx(100 * 250 / 700)
    # Self time 100 + (100 - 20) ns over 2 calls, in ms.
    assert _read("prep_ms.rank", ctx) == pytest.approx(90e-6)
    # Idle while in 0..100 or 300..400: 200 of 1,000 ns.
    assert _read("prep_idle_pct.rank", ctx) == pytest.approx(20.0)
    assert _read("prep_idle_pct.rank", ctx) <= _read("idle_pct.rank", ctx)


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_when_events_were_lost(spans, name):
    assert _read(name, _ctx(lost=True)) is None


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_without_the_ports_spans(monkeypatch, name):
    monkeypatch.setattr(profiling, "kept_spans", lambda: [])
    assert _read(name, _ctx()) is None
    monkeypatch.delattr(profiling, "kept_spans")      # a port that records none
    assert _read(name, _ctx()) is None


def test_other_readers_are_unchanged_by_the_spans(monkeypatch):
    others = [m["name"] for m in spec.load_benchmark()["per_layer"] if m["name"] not in NEW]
    assert others
    monkeypatch.setattr(profiling, "kept_spans", lambda: [])
    without = {n: _read(n, _ctx()) for n in others}
    monkeypatch.setattr(profiling, "kept_spans", lambda: list(SPANS))
    assert {n: _read(n, _ctx()) for n in others} == without
    assert without["idle_pct.rank"] == pytest.approx(70.0)
