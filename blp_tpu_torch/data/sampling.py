"""In-batch negative sampling on the device (port of blp_tpu/data/sampling.py).

A batch of B positive pairs yields 2B entity slots laid out row-major
([[0, 1], [2, 3], ...]). For each of the K negatives of row i, one column
(head or tail, fair coin) is replaced by a slot drawn uniformly from the
2B - 2 slots outside row i: draw r ~ U[0, 2B - 2) and shift it past the
row's own pair, r + 2·[r >= 2i], an exact bijection onto the complement.

The draws come from an explicit `torch.Generator` on the device, so the
sampler runs inside the train step with no host work. Its numbers differ
from JAX's threefry stream; `corrupt_pairs` (the bijection and the coin) is a
pure function so both packages can be fed the same draws.
"""

from __future__ import annotations

import torch

from blp_tpu_torch.utils import resolve_device


def corrupt_pairs(r: torch.Tensor, coin: torch.Tensor) -> torch.Tensor:
    """(B, K, 2) int32 slot indices from the uniform draws r (B, K) in
    [0, 2B - 2) and the coin (B, K) bool (True: corrupt the head)."""
    batch_size, num_negatives = r.shape
    r = r.to(torch.int32)
    row = torch.arange(batch_size, dtype=torch.int32, device=r.device)[:, None]
    sampled = r + torch.where(r >= 2 * row, 2, 0).to(torch.int32)
    head_slot = (2 * row).expand(batch_size, num_negatives)
    tail_slot = head_slot + 1
    neg_head = torch.where(coin, sampled, head_slot)
    neg_tail = torch.where(coin, tail_slot, sampled)
    return torch.stack([neg_head, neg_tail], dim=-1)


def sample_negative_indices(generator: torch.Generator, batch_size: int,
                            num_negatives: int, device=None) -> torch.Tensor:
    """(B, K, 2) int32 indices into the flattened (2B,) entity-slot axis;
    column 0 is the (possibly corrupted) head slot, column 1 the tail slot.
    Runs on `device` (default cuda), where `generator` must live."""
    if batch_size < 2:
        raise ValueError("In-batch negative sampling requires batch_size >= 2.")
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the sampler "
                         f"runs on {dev}")
    shape = (batch_size, num_negatives)
    r = torch.randint(0, 2 * batch_size - 2, shape, generator=generator,
                      device=dev, dtype=torch.int32)
    coin = torch.rand(shape, generator=generator, device=dev) < 0.5
    return corrupt_pairs(r, coin)
