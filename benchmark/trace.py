"""Spans, the traced window and its reduction to device time.

Spans come from the benchmark's own files, around each call into a layer
(`span`): a `torch.profiler.record_function` named `bench::<name>`, which
costs a few microseconds and records only under the profiler. A `--trace 1`
run wraps its window in `torch.profiler.profile` (CPU and CUDA activity) and
reduces the events in memory (`Trace`); no trace file is written.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import re
from collections import defaultdict

import torch

PREFIX = "bench::"
WINDOW = "window"


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


@dataclasses.dataclass
class Event:
    name: str
    start: int          # ns
    end: int            # ns
    thread: int = 0


@dataclasses.dataclass
class Trace:
    """A traced window: device activity (kernels, copies, memsets), the
    benchmark's spans, and the window itself, all in ns on one clock."""

    device: list[Event]
    spans: list[Event]
    window: tuple[int, int]
    main_thread: int

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        device, spans = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            ev = Event(name, int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()),
                       int(e.start_thread_id()))
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation() or name.startswith(PREFIX):
                    continue
                device.append(ev)
            elif name.startswith(PREFIX):
                spans.append(Event(name[len(PREFIX):], ev.start, ev.end, ev.thread))
        win = [s for s in spans if s.name == WINDOW]
        if not win:
            raise RuntimeError("the traced window has no window span")
        w = win[-1]
        return cls(device, spans, (w.start, w.end), w.thread)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @functools.cached_property
    def in_window(self) -> list[Event]:
        """The device's activity that overlaps the window."""
        lo, hi = self.window
        return [e for e in self.device if e.end > lo and e.start < hi]

    @functools.cached_property
    def busy(self) -> list[tuple[int, int]]:
        """The union of the device's activity inside the window."""
        lo, hi = self.window
        iv = sorted((max(e.start, lo), min(e.end, hi)) for e in self.in_window)
        out: list[list[int]] = []
        for s, t in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy) * 1e-9

    def idle_gaps(self) -> list[tuple[int, int]]:
        lo, hi = self.window
        gaps, at = [], lo
        for s, t in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def time_by(self, pattern: str) -> tuple[float, int]:
        """(seconds, launches) of the window's device activity whose name
        matches `pattern` (a regular expression, case ignored)."""
        rx = re.compile(pattern, re.I)
        sel = [e for e in self.in_window if rx.search(e.name)]
        return sum(self._clipped(e) for e in sel) * 1e-9, len(sel)

    def _clipped(self, e: Event) -> int:
        return min(e.end, self.window[1]) - max(e.start, self.window[0])

    def time_in_spans(self, name: str) -> float:
        """Device-busy seconds inside the main thread's spans `name`."""
        spans = sorted((s.start, s.end) for s in self.spans
                       if s.name == name and s.thread == self.main_thread)
        busy, total, i = self.busy, 0, 0
        for ss, st in spans:            # spans of one name do not overlap
            while i < len(busy) and busy[i][1] <= ss:
                i += 1
            j = i
            while j < len(busy) and busy[j][0] < st:
                total += min(busy[j][1], st) - max(busy[j][0], ss)
                j += 1
        return total * 1e-9

    def innermost(self) -> list[tuple[int, int, str]]:
        """The main thread's time cut into segments, each named by the
        innermost span over it (spans nest or are disjoint)."""
        spans = sorted((s for s in self.spans if s.thread == self.main_thread
                        and s.name != WINDOW), key=lambda s: (s.start, s.start - s.end))
        segs, stack, at = [], [], None

        def cut(t):
            nonlocal at
            if stack and at is not None and t > at:
                segs.append((at, t, stack[-1].name))
            at = t

        for s in spans:
            while stack and stack[-1].end <= s.start:
                cut(stack[-1].end)
                stack.pop()
            cut(s.start)
            stack.append(s)
        while stack:
            cut(stack[-1].end)
            stack.pop()
        return segs

    def by_layer(self, layers: list[tuple[str, str]]) -> dict[str, float]:
        """Device seconds by layer: each event goes to the first pattern of
        `layers` that matches its name, else to "other"."""
        compiled = [(re.compile(p, re.I), layer) for p, layer in layers]
        out: dict[str, float] = defaultdict(float)
        for e in self.in_window:
            layer = next((lay for rx, lay in compiled if rx.search(e.name)), "other")
            out[layer] += self._clipped(e) * 1e-9
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the main thread was doing (its innermost span at the middle
        of each gap), each at most `top` entries."""
        ops: dict[str, float] = defaultdict(float)
        for e in self.in_window:
            ops[short(e.name)] += self._clipped(e) * 1e-9
        segs = self.innermost()
        starts = [seg[0] for seg in segs]
        gaps: dict[str, float] = defaultdict(float)
        for s, t in self.idle_gaps():
            mid = (s + t) // 2
            k = bisect.bisect_right(starts, mid) - 1
            name = segs[k][2] if k >= 0 and segs[k][1] > mid else "outside spans"
            gaps[name] += (t - s) * 1e-9
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in top_ops],
                "idle_gaps": [[k, v] for k, v in top_gaps]}


def short(name: str, limit: int = 120) -> str:
    """A kernel's name as the breakdown shows it: without a leading
    "void ", at most `limit` characters (the template arguments that
    tell elementwise kernels apart are kept)."""
    name = name[5:] if name.startswith("void ") else name
    return " ".join(name.split())[:limit]
