"""Multi-host start-up and the per-host data path (port of
blp_tpu/parallel/multihost.py).

1. `initialize` joins the world from the multi-host keys
   (`coordinator_address`, `num_processes`, `process_id`), as
   `jax.distributed.initialize` does; a world started by
   `torch.distributed.run` needs none of them.
2. Per-host data: every process derives the SAME global permutation of the
   edges from the shared seed and materializes only its data rank's
   contiguous block of each global batch (`LocalBatcher`; the global row
   layout is data-rank-major, the layout of train_parallel's `local_rows`).
3. `global_batch` puts a rank's rows on its device. The train step needs no
   more: the rows' place in the global batch is data rank x local rows.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from blp_tpu_torch.data import prefetch
from blp_tpu_torch.parallel import comm


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> None:
    """Join the world at tcp://`coordinator_address` as rank `process_id` of
    `num_processes` (a no-op without an address, or when the world is
    already up, e.g. started by an outer launcher)."""
    if coordinator_address is None:
        return
    if dist.is_initialized():
        return
    if num_processes is None or process_id is None:
        raise ValueError("coordinator_address needs num_processes and "
                         "process_id")
    comm.init_world(device, init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)


def partition_edges(num_edges: int, num_hosts: int, host_id: int) -> np.ndarray:
    """Deterministic balanced contiguous partition of edge indices.

    Contiguous slices keep host-local file reads sequential; balance is
    within 1 edge. Returns the host's edge-index array.
    """
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} out of range [0, {num_hosts})")
    counts = np.full(num_hosts, num_edges // num_hosts, np.int64)
    counts[: num_edges % num_hosts] += 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(starts[host_id], starts[host_id] + counts[host_id])


class LocalBatcher:
    """Host-local view of globally-shuffled fixed-shape batches.

    Every host computes the SAME global permutation of edge indices from the
    shared seed, then materializes only the rows of each global batch that
    fall in its contiguous row block (global batch row layout = host-major).
    """

    def __init__(self, num_edges: int, global_batch_size: int,
                 num_hosts: int, host_id: int):
        if global_batch_size % num_hosts != 0:
            raise ValueError("global batch size must divide by host count")
        self.num_edges = num_edges
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // num_hosts
        self.num_hosts = num_hosts
        self.host_id = host_id

    def num_batches(self) -> int:
        return self.num_edges // self.global_batch_size

    def epoch(self, seed: int):
        """Yield (global_batch_index, local_edge_indices) per batch."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(self.num_edges)
        lo = self.host_id * self.local_batch_size
        hi = lo + self.local_batch_size
        for b in range(self.num_batches()):
            rows = order[b * self.global_batch_size:(b + 1) * self.global_batch_size]
            yield b, rows[lo:hi]


def global_batch(local_arrays: dict, device) -> dict:
    """This rank's rows of a global batch (numpy), as tensors on `device`."""
    return prefetch.to_device(local_arrays, device)
