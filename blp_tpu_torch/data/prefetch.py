"""Background host-to-device batch prefetching (port of
blp_tpu/data/prefetch.py).

A daemon thread assembles batches and copies them to the device up to
`size` ahead, so the numpy gathers and the host-to-device copies overlap the
train steps already queued on the card. On CUDA the copy goes from pinned
memory with `non_blocking=True`; the caching host allocator keeps the pinned
buffer alive until the copy has run. The thread's spans (`profiling.span`):
`prefetch.assemble`, the next host batch (the generator's gathers), and
`prefetch.place`, its placement (pinning and the copy's enqueue).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from blp_tpu_torch.profiling import span

_END = object()


def to_device(batch: dict, device) -> dict:
    """Every array of a host batch as a tensor on `device` (pinned and
    non-blocking when the device is CUDA)."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[k] = t
    return out


def prefetch_to_device(
    batches: Iterable,
    *,
    size: int = 2,
    placement: Callable | None = None,
    device="cuda",
) -> Iterator:
    """Yield device-resident batches, assembled and copied `size` ahead.

    `batches` is any iterable of host batches (it runs on the background
    thread, so assembly work inside a generator is overlapped too).
    `placement` maps a host batch to the device; the default is `to_device`
    on `device`. Exceptions from the producer are raised again at the
    consuming `next()`. The thread is a daemon and owns no files, so
    abandoning the iterator early leaks only a bounded queue.
    """
    if placement is None:
        placement = lambda b: to_device(b, device)  # noqa: E731
    q: queue.Queue = queue.Queue(maxsize=max(1, size))

    def producer():
        try:
            it = iter(batches)
            while True:
                with span("prefetch.assemble"):
                    b = next(it, _END)
                if b is _END:
                    break
                with span("prefetch.place"):
                    b = placement(b)
                q.put(b)
        except BaseException as e:  # surfaced to the consumer
            q.put(_END)
            q.put(e)
            return
        q.put(_END)
        q.put(None)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            err = q.get()
            if err is not None:
                raise err
            return
        yield item
