"""What the readers of the program's own spans share (not a metric: no
metric is named with a leading underscore).

The port records its spans (`blp_tpu_torch.profiling.span`) while the
profiler runs, on every thread and on the clock the profiler stamps its
host events on, and keeps them in memory (`profiling.kept_spans`). A port
that records none (an older commit) gives None, as does a trace that lost
events.
"""

from __future__ import annotations

from blp_tpu_torch import profiling

#: The loader's thread: the next host batch, then its placement.
LOADER = ("prefetch.assemble", "prefetch.place")
#: The rank loop's host work on the main thread before its launches.
PREP = ("eval.ent2idx", "eval.filters", "eval.batch_filters", "eval.to_device")


def window_spans(ctx, names) -> list | None:
    """The program's closed spans named in `names` that overlap the traced
    window, or None where there are none to read."""
    kept = getattr(profiling, "kept_spans", None)
    if ctx.trace is None or ctx.lost or kept is None:
        return None
    lo, hi = ctx.trace.window
    out = [s for s in kept() if s.name in names and s.end > lo and s.start < hi]
    return out or None


def covered(ctx, names) -> list[tuple[int, int]] | None:
    """The union of the spans `names` inside the window, as sorted disjoint
    (start, end) intervals in ns."""
    spans = window_spans(ctx, names)
    if spans is None:
        return None
    lo, hi = ctx.trace.window
    return union((max(s.start, lo), min(s.end, hi)) for s in spans)


def union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def length(intervals) -> int:
    return sum(t - s for s, t in intervals)


def overlap(a, b) -> int:
    """The time two lists of sorted disjoint intervals share, in ns."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_ns(ctx, names) -> int | None:
    """The spans `names`' self time inside the window: each one's time less
    that of the spans opened inside it on its thread, in ns."""
    spans = window_spans(ctx, names)
    if spans is None:
        return None
    lo, hi = ctx.trace.window
    seqs = {s.seq for s in spans}
    clipped = lambda s: max(0, min(s.end, hi) - max(s.start, lo))  # noqa: E731
    children = sum(clipped(c) for c in profiling.kept_spans() if c.parent in seqs)
    return sum(clipped(s) for s in spans) - children


def window_ns(ctx) -> int:
    lo, hi = ctx.trace.window
    return hi - lo
