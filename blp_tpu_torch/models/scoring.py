"""Relational scoring functions, losses and regularization.

Port of blp_tpu/models/scoring.py. Pure functions over broadcastable tensors
so the same code serves

  * positive-edge scoring           (B, d)        -> (B,)
  * in-batch negative scoring       (B, K, d)     -> (B, K)
  * rank-against-all-entities       (1, N, d) vs (B, 1, d) -> (B, N)

All functions broadcast on leading axes and reduce the trailing feature axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def transe_score(heads, tails, rels):
    """TransE: -||h + r - t||_1."""
    diff = heads + rels - tails
    return -torch.sum(torch.abs(diff), dim=-1)


def distmult_score(heads, tails, rels):
    """DistMult: sum(h * r * t)."""
    return torch.sum(heads * rels * tails, dim=-1)


def complex_score(heads, tails, rels):
    """ComplEx: Re(<h, r, conj(t)>) with re/im stored as the two halves of the
    feature axis."""
    h_re, h_im = torch.chunk(heads, 2, dim=-1)
    t_re, t_im = torch.chunk(tails, 2, dim=-1)
    r_re, r_im = torch.chunk(rels, 2, dim=-1)
    return torch.sum(
        r_re * h_re * t_re
        + r_re * h_im * t_im
        + r_im * h_re * t_im
        - r_im * h_im * t_re,
        dim=-1,
    )


def simple_score(heads, tails, rels):
    """SimplE: (<h_h, r_a, t_t> + <t_h, r_b, h_t>) / 2 with head/tail halves
    of the feature axis."""
    h_h, h_t = torch.chunk(heads, 2, dim=-1)
    t_h, t_t = torch.chunk(tails, 2, dim=-1)
    r_a, r_b = torch.chunk(rels, 2, dim=-1)
    return torch.sum(h_h * r_a * t_t + t_h * r_b * h_t, dim=-1) / 2.0


SCORE_FNS = {
    "transe": transe_score,
    "distmult": distmult_score,
    "complex": complex_score,
    "simple": simple_score,
}

#: Relational models whose entity embeddings are L2-normalized before scoring.
NORMALIZED_REL_MODELS = frozenset({"transe"})


def get_score_fn(rel_model: str):
    try:
        return SCORE_FNS[rel_model]
    except KeyError:
        raise ValueError(f"Unknown relational model {rel_model!r}.") from None


def margin_loss(pos_scores, neg_scores, margin: float = 1.0):
    """mean(relu(margin - pos + neg)); pass pos as (B, 1) and neg as (B, K)."""
    return torch.mean(F.relu(margin - pos_scores + neg_scores))


def nll_loss(pos_scores, neg_scores):
    """(mean softplus(-pos) + mean softplus(neg)) / 2."""
    return (torch.mean(F.softplus(-pos_scores))
            + torch.mean(F.softplus(neg_scores))) / 2.0


LOSS_FNS = {"margin": margin_loss, "nll": nll_loss}


def get_loss_fn(loss_fn: str):
    try:
        return LOSS_FNS[loss_fn]
    except KeyError:
        raise ValueError(f"Unknown loss function {loss_fn!r}") from None


def l2_regularization(heads, tails, rels):
    """Mean of the per-tensor mean squares, averaged over the three tensors."""
    return (torch.mean(torch.square(heads)) + torch.mean(torch.square(tails))
            + torch.mean(torch.square(rels))) / 3.0


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """x / max(||x||_2, eps), as torch.nn.functional.normalize."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def compute_loss(ent_embs, rel_embs, neg_idx, *, rel_model: str, loss_fn: str,
                 regularizer: float = 0.0):
    """Positive + in-batch-negative loss for one batch of B edges.

    ent_embs: (B, 2, d) [head, tail] embeddings; rel_embs: (B, d); neg_idx:
    (B, K, 2) indices into the flattened (2B, d) entity view (column 0 the
    corrupted head, column 1 the corrupted tail).
    """
    score = get_score_fn(rel_model)
    loss = get_loss_fn(loss_fn)

    heads = ent_embs[:, 0, :]
    tails = ent_embs[:, 1, :]
    pos_scores = score(heads, tails, rel_embs)[:, None]         # (B, 1)

    flat = ent_embs.reshape(-1, ent_embs.shape[-1])             # (2B, d)
    neg_idx = neg_idx.long()
    neg_heads = flat[neg_idx[..., 0]]                           # (B, K, d)
    neg_tails = flat[neg_idx[..., 1]]
    neg_scores = score(neg_heads, neg_tails, rel_embs[:, None, :])

    total = loss(pos_scores, neg_scores)
    if regularizer:
        total = total + regularizer * l2_regularization(heads, tails, rel_embs)
    return total
