"""Rank-against-all-entities scoring as tiled streaming counts, and top-k.

Port of blp_tpu/ops/ranking.py in plain PyTorch: the `lax.scan` over
candidate tiles becomes a Python loop over tiles, peak memory stays (B, tile)
and independent of N. The bilinear scorers (distmult/complex/simple) collapse
each tile into one (B, d) x (d, tile) matmul through a per-query "dual
vector". TransE keeps the broadcast L1 form, computed in candidate slices so
that no (B, tile, d) tensor larger than _TRANSE_ELEMS elements is made (at
Wikidata5M scale the full (B, Np, d) broadcast would be 157 GB). The TransE
evaluation stream on the card is the K1 kernel (ops/transe_rank.py); this
stream serves the bilinear scorers and is the plain cross-check.

Exactness policy for tie-aware ranks: the true entity and the filtered
known-true answers are handled BY POSITION — the self column is excluded
from the streamed counts (the caller adds the self-tie), and the filtered
columns' contributions are gathered from the very tile scores being counted,
so the filtered subtraction is exact by construction.
"""

from __future__ import annotations

import torch

from blp_tpu_torch.models import scoring

#: Largest (B, slice, d) broadcast TransE scoring makes at once.
_TRANSE_ELEMS = 1 << 24


def dual_query(fixed_emb, rel_emb, *, rel_model: str, corrupt: str):
    """For bilinear scorers, the vector q with score(candidate) = cand @ q.
    Returns None for TransE."""
    if rel_model == "distmult":
        return rel_emb * fixed_emb
    if rel_model == "complex":
        r_re, r_im = torch.chunk(rel_emb, 2, dim=-1)
        f_re, f_im = torch.chunk(fixed_emb, 2, dim=-1)
        if corrupt == "head":
            return torch.cat([r_re * f_re + r_im * f_im,
                              r_re * f_im - r_im * f_re], dim=-1)
        return torch.cat([r_re * f_re - r_im * f_im,
                          r_re * f_im + r_im * f_re], dim=-1)
    if rel_model == "simple":
        r_a, r_b = torch.chunk(rel_emb, 2, dim=-1)
        f_h, f_t = torch.chunk(fixed_emb, 2, dim=-1)
        if corrupt == "head":
            return torch.cat([r_a * f_t, r_b * f_h], dim=-1) / 2.0
        return torch.cat([r_b * f_t, r_a * f_h], dim=-1) / 2.0
    return None


def _transe_tile(tile_emb, fixed_emb, rel_emb, corrupt: str):
    """TransE scores of every candidate for every query, (B, T), computed in
    candidate slices of at most _TRANSE_ELEMS broadcast elements."""
    b, d = fixed_emb.shape
    step = max(1, _TRANSE_ELEMS // max(1, b * d))
    out = []
    for s in range(0, tile_emb.shape[0], step):
        c = tile_emb[s:s + step][None, :, :]
        if corrupt == "head":
            out.append(scoring.transe_score(c, fixed_emb[:, None, :],
                                            rel_emb[:, None, :]))
        else:
            out.append(scoring.transe_score(fixed_emb[:, None, :], c,
                                            rel_emb[:, None, :]))
    if not out:
        return fixed_emb.new_zeros((b, 0))
    return torch.cat(out, dim=1)


def score_tile(tile_emb, fixed_emb, rel_emb, *, rel_model: str, corrupt: str):
    """Scores of a candidate tile for every query: (B, tile).
    tile_emb: (T, d); fixed_emb/rel_emb: (B, d)."""
    q = dual_query(fixed_emb, rel_emb, rel_model=rel_model, corrupt=corrupt)
    if q is not None:
        return torch.matmul(q, tile_emb.T)
    scoring.get_score_fn(rel_model)
    return _transe_tile(tile_emb, fixed_emb, rel_emb, corrupt)


def score_pairs(own_emb, fixed_emb, rel_emb, *, rel_model: str, corrupt: str):
    """Score of each query's own (true) candidate, (B,): the pivot of the
    tie-aware counts."""
    q = dual_query(fixed_emb, rel_emb, rel_model=rel_model, corrupt=corrupt)
    if q is not None:
        return torch.sum(q * own_emb, dim=-1)
    score = scoring.get_score_fn(rel_model)
    if corrupt == "head":
        return score(own_emb, fixed_emb, rel_emb)
    return score(fixed_emb, own_emb, rel_emb)


def _direction_counts(s, true_scores, true_pos, filter_pos, start, tile,
                      num_valid):
    cols = start + torch.arange(s.shape[1], device=s.device)[None, :]
    valid = (cols < num_valid) & (cols != true_pos.reshape(-1, 1))
    gt = ((s > true_scores) & valid).sum(-1, dtype=torch.int32)
    geq = ((s >= true_scores) & valid).sum(-1, dtype=torch.int32)
    local = filter_pos - start
    in_tile = (filter_pos >= 0) & (local >= 0) & (local < tile)
    s_f = torch.gather(s, 1, local.clamp(0, tile - 1).long())
    fgt = ((s_f > true_scores) & in_tile).sum(-1, dtype=torch.int32)
    fgeq = ((s_f >= true_scores) & in_tile).sum(-1, dtype=torch.int32)
    return gt, geq, fgt, fgeq


def tiled_rank_counts(table, fixed_emb, rel_emb, true_scores, true_pos,
                      filter_pos, num_valid, *, rel_model: str, corrupt: str,
                      tile: int = 65536) -> dict:
    """Stream over the candidate table accumulating tie-aware rank counts.

    table: (Np, d), Np a multiple of `tile`; fixed_emb/rel_emb: (B, d);
    true_scores: (B, 1); true_pos: (B,); filter_pos: (B, F) -1 padded;
    num_valid: number of real candidates. Returns dict of (B,) int32
    gt/geq (raw, self excluded) and fgt/fgeq (the filtered columns' share).
    """
    n_pad = table.shape[0]
    if n_pad % tile:
        raise ValueError(f"table rows {n_pad} not a multiple of tile {tile}")
    b = fixed_emb.shape[0]
    acc = [torch.zeros(b, dtype=torch.int32, device=table.device)
           for _ in range(4)]
    for start in range(0, n_pad, tile):
        s = score_tile(table[start:start + tile], fixed_emb, rel_emb,
                       rel_model=rel_model, corrupt=corrupt)
        c = _direction_counts(s, true_scores, true_pos, filter_pos, start,
                              tile, int(num_valid))
        acc = [a + x for a, x in zip(acc, c)]
    return dict(zip(("gt", "geq", "fgt", "fgeq"), acc))


def tiled_rank_counts_bidir(table, head_emb, tail_emb, rel_emb, h_true_scores,
                            t_true_scores, head_pos, tail_pos, heads_filter,
                            tails_filter, num_valid, *, rel_model: str,
                            tile: int = 65536) -> dict:
    """Both-direction rank counts in ONE stream over the candidate table (for
    the bilinear scorers the two directions' dual queries are stacked into one
    (2B, d) x (d, tile) matmul). Returns dict with 'h_'/'t_' prefixed
    gt/geq/fgt/fgeq, each (B,) int32."""
    n_pad = table.shape[0]
    if n_pad % tile:
        raise ValueError(f"table rows {n_pad} not a multiple of tile {tile}")
    b = head_emb.shape[0]
    q_h = dual_query(tail_emb, rel_emb, rel_model=rel_model, corrupt="head")
    if q_h is not None:
        q_t = dual_query(head_emb, rel_emb, rel_model=rel_model, corrupt="tail")
        q_both = torch.cat([q_h, q_t], dim=0)
    acc = [torch.zeros(b, dtype=torch.int32, device=table.device)
           for _ in range(8)]
    nv = int(num_valid)
    for start in range(0, n_pad, tile):
        tile_emb = table[start:start + tile]
        if q_h is not None:
            s_both = torch.matmul(q_both, tile_emb.T)
            s_h, s_t = s_both[:b], s_both[b:]
        else:
            s_h = score_tile(tile_emb, tail_emb, rel_emb, rel_model=rel_model,
                             corrupt="head")
            s_t = score_tile(tile_emb, head_emb, rel_emb, rel_model=rel_model,
                             corrupt="tail")
        h_c = _direction_counts(s_h, h_true_scores, head_pos, heads_filter,
                                start, tile, nv)
        t_c = _direction_counts(s_t, t_true_scores, tail_pos, tails_filter,
                                start, tile, nv)
        acc = [a + x for a, x in zip(acc, h_c + t_c)]
    names = ("h_gt", "h_geq", "h_fgt", "h_fgeq",
             "t_gt", "t_geq", "t_fgt", "t_fgeq")
    return dict(zip(names, acc))


def dense_top_k(table, fixed_emb, rel_emb, num_valid, *, k: int,
                rel_model: str, corrupt: str, approx: bool = False):
    """Top-k via one dense (B, Np) score pass and one selection: the
    small-batch serving path. Memory is O(B * Np); TransE scoring is sliced
    so no (B, Np, d) tensor is made. `approx` is accepted for the signature
    and selects exactly (exact top-k is a superset of the approximate
    recall). Returns (scores (B, k) desc-sorted, ids (B, k) int32)."""
    del approx
    s = score_tile(table, fixed_emb, rel_emb, rel_model=rel_model,
                   corrupt=corrupt)
    cols = torch.arange(table.shape[0], device=s.device)[None, :]
    s = torch.where(cols < int(num_valid), s, float("-inf"))
    ts, ti = torch.topk(s, k, dim=1)
    return ts, ti.to(torch.int32)


def tiled_top_k(table, fixed_emb, rel_emb, num_valid, *, k: int,
                rel_model: str, corrupt: str, tile: int = 65536,
                approx: bool = False):
    """Streaming top-k per query: the in-tile top-k is merged with the
    running best through a (B, 2k) top-k, so peak memory is O(B * (tile + k)).
    `approx` selects exactly (see dense_top_k). Returns (scores (B, k) f32
    desc-sorted, ids (B, k) int32 global columns); padding columns
    (>= num_valid) are excluded."""
    del approx
    n_pad = table.shape[0]
    if n_pad % tile:
        raise ValueError(f"table rows {n_pad} not a multiple of tile {tile}; "
                         f"pad the table")
    b = fixed_emb.shape[0]
    nv = int(num_valid)
    best_s = torch.full((b, k), float("-inf"), device=table.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=table.device)
    for start in range(0, n_pad, tile):
        s = score_tile(table[start:start + tile], fixed_emb, rel_emb,
                       rel_model=rel_model, corrupt=corrupt)
        cols = start + torch.arange(tile, device=s.device)[None, :]
        s = torch.where(cols < nv, s, float("-inf"))
        ts, ti = torch.topk(s, k, dim=1)
        merged_s = torch.cat([best_s, ts], dim=1)
        merged_i = torch.cat([best_i, ti + start], dim=1)
        best_s, mi = torch.topk(merged_s, k, dim=1)
        best_i = torch.gather(merged_i, 1, mi)
    return best_s, best_i.to(torch.int32)
