"""Fixed-shape batch iteration for training (copy of blp_tpu/data/loader.py).

Every batch an epoch yields has the same shape (drop_last, as the
reference's training DataLoader). Negatives are sampled on the device inside
the train step (data/sampling.py), so the host only gathers token rows.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from blp_tpu_torch.data.datasets import GraphData, TextGraphData


def epoch_batches(
    data: GraphData,
    batch_size: int,
    *,
    rng: np.random.Generator | None = None,
    shuffle: bool = True,
    drop_last: bool = True,
) -> Iterator[np.ndarray]:
    """Yield (batch_size, 3) triple batches for one epoch."""
    n = data.num_triples
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        yield data.triples[order[start : start + batch_size]]


def text_train_batch(data: TextGraphData, triples: np.ndarray) -> dict:
    """Host-side assembly of a text-model train batch.

    Returns text_tok (B, 2, L) int32, text_mask (B, 2, L) float32,
    rels (B,) int32. neg_idx is sampled on the device.
    """
    pairs = triples[:, :2]  # (B, 2)
    tok, mask = data.get_entity_descriptions(pairs.reshape(-1))
    L = tok.shape[-1]
    return {
        "text_tok": tok.reshape(len(triples), 2, L),
        "text_mask": mask.reshape(len(triples), 2, L),
        "rels": triples[:, 2],
    }


def transductive_train_batch(data: GraphData, triples: np.ndarray) -> dict:
    return {"pos_pairs": triples[:, :2], "rels": triples[:, 2]}


def num_batches(data: GraphData, batch_size: int, drop_last: bool = True) -> int:
    n = data.num_triples
    return n // batch_size if drop_last else -(-n // batch_size)
