"""Tracing and profiling (port of blp_tpu/profiling.py, on torch.profiler,
the host clock and torch.cuda's memory statistics).

  * `span(name)`: the program's spans at its layer boundaries, recorded
    inside `recording()` and while torch.profiler profiles (on every
    thread, on the clock the profiler stamps host events on), and kept in
    memory (`kept_spans()`); otherwise a flag check.
  * `trace(dir)`: a torch.profiler session (CPU ops, and CUDA kernels and
    copies on a card) whose Chrome trace, with the spans recorded in it, is
    written under `dir`, for Perfetto or TensorBoard;
    `summarize_trace_stats(dir)` reads it back as device time by kernel
    group and the top kernels.
  * `StepTimer`: wall-clock step times, with a sync on a probe tensor every
    `sync_every` steps (work is queued asynchronously on a card, so an
    unsynced time is the time to enqueue it).
  * `device_memory_stats()`: per-device memory counters.
  * `kernel_group` / `device_time_by_group`: the kernel groups that
    chip_smoke.py's profiles and `summarize_trace_stats` report.
"""

from __future__ import annotations

import contextlib
import glob
import itertools
import json
import os
import socket
import threading
import time
from collections import defaultdict, deque
from typing import Iterable

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from blp_tpu_torch.utils import resolve_device

#: Trace event categories that are device work (kernels, copies, memsets).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


#: The most spans kept in memory; past it the oldest go.
KEPT_SPANS = 1 << 17

_kept: deque = deque(maxlen=KEPT_SPANS)
_seq = itertools.count()
_local = threading.local()
_lock = threading.Lock()
_recordings = 0
_NULL = contextlib.nullcontext()


class Span:
    """A recorded span: its `name`, its `start` and `end` in ns on
    `time.time_ns()` (the clock torch.profiler stamps its host events on),
    its thread's OS id (`thread`) and Python id (`ident`, pthread_self:
    the profiler's launch events carry its low 32 bits for a thread the
    profiler does not follow), its number `seq` in the order spans opened,
    and the `seq` of its `parent`, the span open on the same thread when it
    opened (-1 for none). `end` is None while it is open."""

    __slots__ = ("name", "start", "end", "thread", "ident", "seq", "parent")

    def __init__(self, name: str):
        self.name = name
        self.end = None

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.parent = stack[-1].seq if stack else -1
        self.thread = threading.get_native_id()
        self.ident = threading.get_ident()
        self.seq = next(_seq)
        stack.append(self)
        _kept.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        _local.stack.pop()
        return False


def span(name: str):
    """A named span of the program, for `with`: recorded inside
    `recording()` and while torch.profiler profiles, on any thread; at
    other times the one shared null context, after a flag check."""
    if _recordings or _autograd_profiler._is_profiler_enabled:
        return Span(name)
    return _NULL


def kept_spans() -> list[Span]:
    """The closed spans kept in memory (the last KEPT_SPANS recorded),
    in the order they opened."""
    return [s for s in list(_kept) if s.end is not None]


@contextlib.contextmanager
def recording():
    """Record spans on every thread in the body. Yields a list that, once
    the body is left, holds the spans opened in it that have closed, in the
    order they opened."""
    global _recordings
    first = next(_seq)
    with _lock:
        _recordings += 1
    out: list[Span] = []
    try:
        yield out
    finally:
        with _lock:
            _recordings -= 1
        out.extend(s for s in kept_spans() if s.seq > first)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body, recording the program's spans; on exit its Chrome
    trace, the spans among its events, is written under `log_dir`. Yields
    the torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording() as spans, profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, spans)


def _add_spans(path: str, spans: Iterable[Span]) -> None:
    """Append `spans` to the Chrome trace at `path` as complete events on
    their threads, on the trace's time base (microseconds after its
    `baseTimeNanoseconds`)."""
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    data["traceEvents"].extend(
        {"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid,
         "tid": s.thread, "ts": (s.start - base) / 1e3, "dur": (s.end - s.start) / 1e3}
        for s in spans)
    with open(path, "w") as f:
        json.dump(data, f)


def realize(x) -> float:
    """The first element of `x` as a Python float: waits for the work that
    computes it and copies it to the host."""
    return float(torch.as_tensor(x).reshape(-1)[0].item())


class StepTimer:
    """Accumulates step wall times; sync on demand.

    with timer.step():
        ... queue a step's work ...
    timer.sync(loss)   # every `sync_every` steps, waits for the device
    """

    def __init__(self, sync_every: int = 10):
        self.sync_every = sync_every
        self.times: list[float] = []
        self._count = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def sync(self, probe) -> float | None:
        """Realize `probe` every sync_every steps; returns its value then."""
        self._count += 1
        if self._count % self.sync_every == 0:
            return realize(probe)
        return None

    def summary(self) -> dict:
        arr = np.asarray(self.times[1:] or self.times)  # drop the first step
        if arr.size == 0:
            return {"steps": 0}
        return {
            "steps": int(arr.size),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
        }


def device_memory_stats(device="cuda") -> list[dict]:
    """One dict per CUDA device (every device for an index-less "cuda", else
    the one named): torch.cuda.memory_stats' counters (for example
    `allocated_bytes.all.peak`, which max_memory_allocated reads) and
    mem_get_info's `free_bytes` and `total_bytes`. Raises without a card
    unless `device` is the CPU, which has no such counters."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [{"device": str(dev)}]
    indices = range(torch.cuda.device_count()) if dev.index is None else [dev.index]
    out = []
    for i in indices:
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({"device": f"cuda:{i}",
                    **{k: int(v) for k, v in stats.items()
                       if isinstance(v, (int, float))},
                    "free_bytes": int(free), "total_bytes": int(total)})
    return out


#: Substrings of a lower-cased kernel name and the group each names, the
#: first match winning after K1-K3: the layers of the benchmark's
#: `benchmark/kernel_layers.json`.
GROUPS = (
    (("bias_act", "add_ln", "attn_softmax", "site_dropout"), "F1 F2 F3 site"),
    (("indexing_backward", "index_put", "radixsort", "radix_sort", "segmented_sort",
      "sort_kernel", "sortpairs", "devicescan"), "index backward"),
    (("gemm", "xmma", "cutlass", "nvjet", "sm90_"), "GEMM (cuBLAS)"),
    (("copy", "memcpy"), "copies"),
    (("memset",), "memsets"),
)


def kernel_group(name: str) -> str:
    """The group a kernel's (or op's) time is reported under: the port's
    three kernels by name, then GROUPS, then the rest."""
    low = name.lower()
    if "packed_attention" in low:
        return "K2 packed_attention"
    if "transe_rank" in low:
        return "K1 transe_rank"
    if "sddmm_bwd" in low:
        return "K3 sddmm backward"
    if "sddmm" in low:
        return "K3 sddmm forward"
    for keys, group in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, reductions)"


def device_time_by_group(times: Iterable[tuple[str, float]]) -> dict[str, float]:
    """Sum (kernel name, time) pairs by kernel_group, largest group first."""
    groups: dict[str, float] = defaultdict(float)
    for name, t in times:
        groups[kernel_group(name)] += t
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def _self_times(events: list[dict]) -> list[tuple[str, float]]:
    """(name, self time in us) of nested host events: each event's duration
    less that of the events directly inside it on its thread."""
    out = []
    by_thread = defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: list[list] = []   # [end, name, self time]
        for e in evs:
            ts, dur = float(e["ts"]), float(e["dur"])
            while stack and stack[-1][0] <= ts:
                _, name, self_us = stack.pop()
                out.append((name, self_us))
            if stack:
                stack[-1][2] -= dur
            stack.append([ts + dur, e["name"], dur])
        out.extend((name, self_us) for _, name, self_us in stack)
    return out


def summarize_trace_stats(trace_dir: str, top: int = 15) -> dict | None:
    """The newest Chrome trace under `trace_dir` (written by `trace`) as
    per-op stats: total device time, time by kernel group, and the `top`
    ops by self time, each with its name, group (`category`), occurrences
    and self time. The ops are the device's kernels, copies and memsets;
    a trace without device work (a CPU run) counts its CPU ops by self
    time instead. None when the directory holds no trace."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        return None
    with open(paths[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    device = [(e["name"], float(e["dur"])) for e in events
              if e.get("cat") in DEVICE_CATEGORIES]
    if not device:
        device = _self_times([e for e in events if e.get("cat") == "cpu_op"])
    ops: dict[str, dict] = {}
    for name, us in device:
        op = ops.setdefault(name, {"name": name, "category": kernel_group(name),
                                   "occurrences": 0, "self_time_us": 0.0})
        op["occurrences"] += 1
        op["self_time_us"] += us
    ranked = sorted(ops.values(), key=lambda o: -o["self_time_us"])
    by_category = device_time_by_group(device)
    return {
        "total_device_time_us": sum(by_category.values()),
        "by_category_us": by_category,
        "top_ops": ranked[:top],
    }
