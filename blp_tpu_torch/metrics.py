"""Ranking metrics with tie-aware average ranks.

Port of blp_tpu/metrics.py (after PyKEEN):

    best_rank  = #(scores >  score_true) + 1
    worst_rank = #(scores >= score_true)
    rank       = (best_rank + worst_rank) / 2
    hits@k     = rank <= k

Both counts are plain sums over the candidate axis, so they can be
accumulated tile by tile without ever materializing (B, N) scores.
"""

from __future__ import annotations

import torch


def rank_counts(scores, true_scores, valid_mask=None):
    """Partial rank counts for a tile of candidate scores.

    scores: (B, N_tile); true_scores: (B, 1); valid_mask: optional (B, N_tile)
    bool, False for excluded candidates. Returns (gt, geq), (B,) int32.
    """
    gt = scores > true_scores
    geq = scores >= true_scores
    if valid_mask is not None:
        gt = gt & valid_mask
        geq = geq & valid_mask
    return gt.sum(-1, dtype=torch.int32), geq.sum(-1, dtype=torch.int32)


def ranks_from_counts(gt, geq):
    """Tie-aware average rank from global counts (float32)."""
    return (gt.to(torch.float32) + 1.0 + geq.to(torch.float32)) * 0.5


def metrics_from_ranks(ranks, k_values=(1, 3, 10)):
    """(reciprocals (B,) float32, hits (B, len(k_values)) bool)."""
    reciprocals = 1.0 / ranks
    ks = torch.tensor(k_values, dtype=torch.float32, device=ranks.device)
    return reciprocals, ranks[:, None] <= ks[None, :]


# The breakdowns below add float32 reciprocals in a fixed order: the order of
# XLA's CPU backend, which computes the TPU package's breakdowns wherever the
# two packages are compared, so the two agree to the bit. A reduce there runs
# in windows of 32 (the axis zero-padded evenly at both ends to a multiple of
# 32), each window left to right, then the window sums the same way; a
# vector-matrix product adds left to right.
_REDUCE_WINDOW = 32


def _sum_left_to_right(x):
    """Sum over the last axis, one add at a time from 0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _window_sum(x):
    """Sum over the last axis in 32-wide windows, recursively (above)."""
    while x.shape[-1] > _REDUCE_WINDOW:
        pad = -x.shape[-1] % _REDUCE_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _sum_left_to_right(x.unflatten(-1, (-1, _REDUCE_WINDOW)))
    return _sum_left_to_right(x)


def split_by_new_position(triples, reciprocals, new_entity_mask):
    """MRR sums and counts by where the unseen entity sits.

    triples: (B, 3) (head, tail, rel); reciprocals: (2B,) head-corruption
    half first; new_entity_mask: (max_ent_id+1,) bool. Returns (sums, counts),
    each (3,) float32 — [both new, head new, tail new].
    """
    triples = torch.as_tensor(triples)
    reciprocals = torch.as_tensor(reciprocals)
    new_entity_mask = torch.as_tensor(new_entity_mask)
    b = triples.shape[0]
    head_new = new_entity_mask[triples[:, 0].long()]
    tail_new = new_entity_mask[triples[:, 1].long()]
    per_triple = (reciprocals[:b] + reciprocals[b:2 * b]) / 2.0
    masks = torch.stack([head_new & tail_new, head_new & ~tail_new,
                         ~head_new & tail_new])                   # (3, B)
    sums = _window_sum(masks * per_triple[None, :])
    counts = masks.sum(dim=1).to(torch.float32)
    return sums, counts


def split_by_category(triples, reciprocals, rel_categories,
                      num_categories: int = 4):
    """MRR sums by relation category x prediction side.

    Returns sums (2, num_categories) — row 0 head prediction, row 1 tail
    prediction — and counts (1, num_categories).
    """
    triples = torch.as_tensor(triples)
    reciprocals = torch.as_tensor(reciprocals)
    rel_categories = torch.as_tensor(rel_categories)
    b = triples.shape[0]
    cats = rel_categories[triples[:, 2].long()].long()
    onehot = torch.nn.functional.one_hot(cats, num_categories).to(torch.float32)
    head_sums = _sum_left_to_right((reciprocals[:b, None] * onehot).T)
    tail_sums = _sum_left_to_right((reciprocals[b:2 * b, None] * onehot).T)
    counts = onehot.sum(dim=0, keepdim=True)
    return torch.stack([head_sums, tail_sums]), counts
