"""Candidate-sharded full-ranking evaluation (port of
blp_tpu/parallel/eval_parallel.py).

The candidate table's rows are split over every rank of the mesh (its axes
flattened), one contiguous block each:
- phase 1: each rank encodes its own block of the padded table, as its own
  allocation (`Shard.encode`), so the BERT encode launches K2 on every rank;
- phase 2: for each eval batch, the head and tail rows are gathered bit for
  bit from the ranks that own them (`Shard.rows`); every rank counts its
  block with positions shifted into its frame — TransE through K1
  (ops/transe_rank.py) against pivots computed once from the gathered rows
  (`bidir_pivot_dists`), the other scorers through the plain tiled stream —
  and the int32 counts are summed over the world, which is exact. The rank
  decomposes into per-block sums (metrics.py), so the result equals the
  one-device evaluator's bit for bit; no (B, N) anything, no gather of the
  table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blp_tpu_torch.ops import ranking, transe_rank
from blp_tpu_torch.parallel import comm

_COUNT_KEYS = ("h_gt", "h_geq", "h_fgt", "h_fgeq",
               "t_gt", "t_geq", "t_fgt", "t_fgeq")


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's block of an (n_pad, d) candidate table over `world`
    ranks: rows [offset, offset + rows)."""
    index: int
    world: int
    rows: int

    @property
    def offset(self) -> int:
        return self.index * self.rows

    @staticmethod
    def of(mesh, n_pad: int) -> "Shard":
        """The block of this rank (its mesh coordinate, row-major) in a
        table of n_pad rows, n_pad a multiple of the mesh size."""
        world = mesh.size()
        if n_pad % world:
            raise ValueError(f"{n_pad} rows do not split over {world} ranks")
        index = int(np.ravel_multi_index(mesh.get_coordinate(), mesh.shape))
        return Shard(index, world, n_pad // world)

    def ids(self, entities: np.ndarray) -> np.ndarray:
        """The candidate entities of this block (fewer than `rows` at the
        padded end)."""
        return entities[self.offset:self.offset + self.rows]

    def pad(self, rows: torch.Tensor) -> torch.Tensor:
        """The block's table from its real rows: (rows, d), zero-padded, a
        contiguous allocation of its own (K1's "tma" variant needs one)."""
        out = torch.zeros((self.rows, rows.shape[1]), dtype=torch.float32,
                          device=rows.device)
        out[:len(rows)] = rows
        return out

    def whole(self, table_l: torch.Tensor) -> torch.Tensor:
        """The whole (n_pad, d) table, from every rank's block."""
        return torch.cat(comm.all_gather(table_l), dim=0)

    def rows_of(self, table_l: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """table[pos] of the whole table, bit for bit: each rank supplies the
        rows it owns, and the owner's copy is picked from the gather."""
        local = pos - self.offset
        mine = (local >= 0) & (local < self.rows)
        part = torch.where(mine[:, None],
                           table_l[local.clamp(0, self.rows - 1).long()], 0.0)
        every = torch.stack(comm.all_gather(part))          # (world, B, d)
        owner = (pos // self.rows).long()
        return every[owner, torch.arange(len(pos), device=pos.device)]

    def localize(self, pos: torch.Tensor) -> torch.Tensor:
        """Positions in this block's frame; filter padding (-1) stays -1.
        Positions of other blocks fall outside [0, rows) and count nowhere."""
        return torch.where(pos >= 0, pos - self.offset, -1)

    def num_valid(self, n: int) -> int:
        return int(np.clip(n - self.offset, 0, self.rows))


def rank_counts(shard: Shard, table_l, fixed_emb, rel_emb, true_pos,
                filter_pos, n: int, *, rel_model: str, corrupt: str,
                tile: int) -> dict:
    """One-direction raw and filtered counts {gt, geq, fgt, fgeq} of a batch
    over the sharded table, summed over the world (the self-tie not yet
    added): the counterpart of the TPU package's `make_sharded_rank_counts`.
    Positions are global; the true rows are gathered bit for bit from the
    ranks that own them, and each rank counts its block as
    `rank_counts_bidir` does (TransE through K1)."""
    true_emb = shard.rows_of(table_l, true_pos)
    lt, lf = shard.localize(true_pos), shard.localize(filter_pos)
    nv = shard.num_valid(n)
    if rel_model == "transe":
        pivot = transe_rank.pivot_dists(true_emb, fixed_emb, rel_emb, corrupt)
        c = transe_rank.transe_tiled_rank_counts(
            table_l, fixed_emb, rel_emb, None, lt, lf, nv, corrupt=corrupt,
            pivot=pivot)
    else:
        true_scores = ranking.score_pairs(true_emb, fixed_emb, rel_emb,
                                          rel_model=rel_model,
                                          corrupt=corrupt)[:, None]
        c = ranking.tiled_rank_counts(
            table_l, fixed_emb, rel_emb, true_scores, lt, lf, nv,
            rel_model=rel_model, corrupt=corrupt, tile=tile)
    keys = ("gt", "geq", "fgt", "fgeq")
    summed = comm.all_reduce(torch.stack([c[k] for k in keys]))
    return dict(zip(keys, summed))


def rank_counts_bidir(shard: Shard, table_l, head_pos, tail_pos, rel_emb,
                      heads_filter, tails_filter, n: int, *, rel_model: str,
                      tile: int) -> dict:
    """Both-direction raw and filtered counts of one eval batch over the
    sharded table, summed over the world (the self-tie not yet added). All
    positions are global."""
    head_emb = shard.rows_of(table_l, head_pos)
    tail_emb = shard.rows_of(table_l, tail_pos)
    lh, lt = shard.localize(head_pos), shard.localize(tail_pos)
    hf, tf = shard.localize(heads_filter), shard.localize(tails_filter)
    nv = shard.num_valid(n)
    if rel_model == "transe":
        pivot = transe_rank.bidir_pivot_dists(head_emb, tail_emb, rel_emb)
        c = transe_rank.transe_tiled_rank_counts_bidir(
            table_l, head_emb, tail_emb, rel_emb, None, None, lh, lt, hf, tf,
            nv, pivot_dists=pivot)
    else:
        h_true = ranking.score_pairs(head_emb, tail_emb, rel_emb,
                                     rel_model=rel_model, corrupt="head")[:, None]
        t_true = ranking.score_pairs(tail_emb, head_emb, rel_emb,
                                     rel_model=rel_model, corrupt="tail")[:, None]
        c = ranking.tiled_rank_counts_bidir(
            table_l, head_emb, tail_emb, rel_emb, h_true, t_true, lh, lt, hf,
            tf, nv, rel_model=rel_model, tile=tile)
    summed = comm.all_reduce(torch.stack([c[k] for k in _COUNT_KEYS]))
    return dict(zip(_COUNT_KEYS, summed))
