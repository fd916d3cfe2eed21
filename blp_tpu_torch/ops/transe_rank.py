"""K1: TransE rank-vs-all counting for filtered full-ranking evaluation.

Port of blp_tpu/ops/pallas_ranking.py. The CUDA kernel
(csrc/transe_rank.cu) streams the (Np, d) candidate table once per eval batch
for both corruption directions (the 2B query offsets are stacked) and counts,
per query, the candidates whose L1 distance is below / at most the true
entity's. The distance is accumulated in a FIXED fp32 add order, an explicit
chain over each 32-dim chunk and then a chain over chunks, and everything
outside the kernel that is compared with it (the pivot, the filtered columns'
distances) is computed here in the same order by `_seq_abs_scores`. Both are
plain IEEE fp32 adds with no multiplies, so the distances are bit-identical
and the filtered subtraction gt - fgt is exact.

score(c; b) = -sum_d |c_d + u_d|  with  u = rel_b - fixed_b    (head corrupt)
                                        u = -(rel_b + fixed_b) (tail corrupt)
The kernel accumulates the positive distance and compares it with
r_b = -true_score_b:  score > true  <=>  dist < r.

Routing: `raw_counts` runs the plain version for a tensor on the CPU and the
kernel for a CUDA tensor, with no fallback between them. The TPU package's
Mosaic-only conditions are gone: there is no interpret mode, no transposed
(d_pad, Np) table copy and no "tile % 128" gate sending small tables to the
XLA stream. The kernel masks its own ragged edge, so on the card TransE
always goes through it. The kernel has two variants, "tma" (a TMA-fed ring
and 8 x 8 register tiles) and "scalar" (scalar staging, for a width that is
not a multiple of 4 or a view that is not 16-byte aligned); `variant` is the
rule that picks one, a function of shape and alignment alone (the .cu's
`pick_variant`).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from blp_tpu_torch.ops import _cuda

#: d-chunk length of the fixed add order (same as the TPU kernel's).
_DC = 32
#: Largest (Q, C, d) term tensor the plain stream makes at once.
_PLAIN_ELEMS = 1 << 26

#: The kernel's variants, in the order of the .cu's variant numbers.
VARIANTS = ("tma", "scalar")
#: Rows the "tma" variant takes (int32 row coordinates, with a tile to spare).
_TMA_MAX_ROWS = 1 << 30

#: Kernel launches since the last reset (a plain counter; chip_smoke.py reads
#: it to show the main path went through the kernel), and the same launches
#: by (variant, d).
launches = 0
launches_by_variant: collections.Counter = collections.Counter()


def _seq_abs_scores(rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """L1 distances accumulated over d in EXACTLY the kernel's order.

    rows: (B, F, d) candidate embeddings (or anything broadcastable, e.g.
    (1, C, d) for a table slice against every query); u: (B, d). Returns
    (B, F) float32. A chain over each _DC-dim chunk, then a chain over the
    chunks. The terms |c_d + u_d| are formed in one elementwise pass and
    the chunks' chains advance side by side, so a call issues about _DC +
    d / _DC adds rather than 3 d ops; each distance still sees the same adds
    in the same order. A partial last chunk is padded with +0.0 terms,
    which leave a non-negative sum unchanged, as in the kernel.
    """
    d = rows.shape[-1]
    terms = torch.abs(rows + u[:, None, :])                  # (B, F, d)
    if d % _DC:
        terms = torch.nn.functional.pad(terms, (0, _DC - d % _DC))
    terms = terms.unflatten(-1, (-1, _DC))                   # (B, F, nc, DC)
    part = terms[..., 0]
    for j in range(1, _DC):
        part = part + terms[..., j]
    acc = part[..., 0]
    for c in range(1, part.shape[-1]):
        acc = acc + part[..., c]
    return acc


def _offset(fixed_emb: torch.Tensor, rel_emb: torch.Tensor, corrupt: str):
    if corrupt == "head":
        return rel_emb - fixed_emb       # score(c) = -sum|c + r - t|
    return -(rel_emb + fixed_emb)        # score(c) = -sum|c - (h + r)|


def pivot_dists(own_emb, fixed_emb, rel_emb, corrupt: str) -> torch.Tensor:
    """The (B, 1) order-matched pivot distances of one direction: each
    query's own (true) candidate row against its offset."""
    return _seq_abs_scores(own_emb[:, None, :],
                           _offset(fixed_emb, rel_emb, corrupt))


def bidir_pivot_dists(head_emb, tail_emb, rel_emb) -> torch.Tensor:
    """The (2B, 1) order-matched pivot distances of the bidirectional stream:
    head-corruption rows first, then tail-corruption."""
    u = torch.cat([_offset(tail_emb, rel_emb, "head"),
                   _offset(head_emb, rel_emb, "tail")], dim=0)
    own = torch.cat([head_emb, tail_emb], dim=0)
    return _seq_abs_scores(own[:, None, :], u)


def _filter_counts(table, u, r, filter_pos):
    """Filtered-column correction, order-matched to the stream. Positions
    outside [0, len(table)) are ignored."""
    n_pad = table.shape[0]
    rows = table[filter_pos.clamp(0, n_pad - 1).long()]      # (B, F, d)
    dist = _seq_abs_scores(rows, u)                          # (B, F)
    present = (filter_pos >= 0) & (filter_pos < n_pad)
    fgt = ((dist < r) & present).sum(1, dtype=torch.int32)
    fgeq = ((dist <= r) & present).sum(1, dtype=torch.int32)
    return fgt, fgeq


def raw_counts_plain(table, u, r, true_pos, num_valid: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (2, Q) int32 [gt; geq] over
    columns < num_valid that are not the query's own. The table is walked in
    slices of at most _PLAIN_ELEMS / (Q d) rows, so no (Q, Np, d) or
    (Q, Np) tensor is made."""
    q, d = u.shape
    step = max(1, _PLAIN_ELEMS // (q * d))
    counts = torch.zeros((2, q), dtype=torch.int32, device=u.device)
    n_live = min(int(num_valid), table.shape[0])
    tp = true_pos.reshape(q, 1).long()
    for start in range(0, n_live, step):
        chunk = table[start:min(start + step, n_live)]
        dist = _seq_abs_scores(chunk[None], u)                # (Q, C)
        cols = torch.arange(start, start + chunk.shape[0], device=u.device)
        valid = cols[None, :] != tp
        counts[0] += ((dist < r) & valid).sum(1, dtype=torch.int32)
        counts[1] += ((dist <= r) & valid).sum(1, dtype=torch.int32)
    return counts


def variant(n_rows: int, d: int, table_ptr: int, u_ptr: int) -> str:
    """The variant csrc/transe_rank.cu's `pick_variant` runs for a (n_rows, d)
    table at address table_ptr and offsets at u_ptr: "tma" where d is a
    multiple of 4, both are 16-byte aligned and n_rows < 2**30; else
    "scalar"."""
    if (d % 4 == 0 and table_ptr % 16 == 0 and u_ptr % 16 == 0
            and n_rows < _TMA_MAX_ROWS):
        return "tma"
    return "scalar"


def _raw_counts_kernel(table, u, r, true_pos, num_valid: int) -> torch.Tensor:
    global launches
    q, d = u.shape
    if table.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("transe_rank: table and offsets must be float32")
    if table.dim() != 2 or table.shape[1] != d:
        raise ValueError(f"transe_rank: table {tuple(table.shape)} does not "
                         f"match offsets {tuple(u.shape)}")
    if q == 0:
        raise ValueError("transe_rank: no queries")
    dev = table.device
    table = table.contiguous()
    u = u.to(dev).contiguous()
    r = r.reshape(q).to(dev, torch.float32).contiguous()
    tp = true_pos.reshape(q).to(dev, torch.int32).contiguous()
    counts = torch.zeros((2, q), dtype=torch.int32, device=dev)
    if min(int(num_valid), table.shape[0]) <= 0:   # no column can count
        return counts
    fn = _cuda.load("transe_rank").transe_rank_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    err = fn(table.data_ptr(), u.data_ptr(), r.data_ptr(), tp.data_ptr(),
             table.shape[0], int(num_valid), q, d, counts.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "transe_rank launch")
    launches += 1
    launches_by_variant[variant(table.shape[0], d, table.data_ptr(),
                                u.data_ptr()), d] += 1
    return counts


def raw_counts(table, u, r, true_pos, num_valid: int) -> torch.Tensor:
    """(2, Q) int32 [gt; geq] of the stream: the kernel on a CUDA table, the
    plain version on a CPU one."""
    if table.is_cuda:
        return _raw_counts_kernel(table, u, r, true_pos, num_valid)
    return raw_counts_plain(table, u, r, true_pos, num_valid)


def transe_tiled_rank_counts(table, fixed_emb, rel_emb, true_scores, true_pos,
                             filter_pos, num_valid, *, corrupt: str,
                             pivot=None) -> dict:
    """One-direction TransE rank counts; same return dict as
    ops.ranking.tiled_rank_counts (gt, geq, fgt, fgeq; each (B,) int32).

    The pivot is recomputed order-matched to the stream rather than taken
    from `true_scores` (kept for the signature), so entities whose distance
    equals the true entity's compare equal (a tie) and not greater.
    pivot: optionally the (B, 1) order-matched pivots (`pivot_dists`), for a
    table that does not hold the true rows (a shard); computed here from
    table[true_pos] when omitted.
    """
    del true_scores
    b = fixed_emb.shape[0]
    u = _offset(fixed_emb, rel_emb, corrupt)
    tp = true_pos.reshape(b).long()
    r = (pivot_dists(table[tp], fixed_emb, rel_emb, corrupt) if pivot is None
         else pivot.reshape(b, 1))
    counts = raw_counts(table, u, r, tp, int(num_valid))
    fgt, fgeq = _filter_counts(table, u, r, filter_pos)
    return {"gt": counts[0], "geq": counts[1], "fgt": fgt, "fgeq": fgeq}


def transe_tiled_rank_counts_bidir(table, head_emb, tail_emb, rel_emb,
                                   h_true_scores, t_true_scores, head_pos,
                                   tail_pos, heads_filter, tails_filter,
                                   num_valid, *, pivot_dists=None) -> dict:
    """Both-direction TransE rank counts in one stream over the table (the
    2B offsets stacked on the query axis). Same return dict as
    ops.ranking.tiled_rank_counts_bidir ('h_'/'t_' prefixed gt/geq/fgt/fgeq).

    pivot_dists: optionally the (2B, 1) order-matched pivots
    (bidir_pivot_dists); computed here from the table when omitted.
    """
    del h_true_scores, t_true_scores
    b = head_emb.shape[0]
    u = torch.cat([_offset(tail_emb, rel_emb, "head"),
                   _offset(head_emb, rel_emb, "tail")], dim=0)
    pos = torch.cat([head_pos.reshape(b), tail_pos.reshape(b)]).long()
    if pivot_dists is None:
        r = _seq_abs_scores(table[pos][:, None, :], u)
    else:
        r = pivot_dists.reshape(2 * b, 1)
    counts = raw_counts(table, u, r, pos, int(num_valid))
    filt = torch.cat([heads_filter, tails_filter], dim=0)
    fgt, fgeq = _filter_counts(table, u, r, filt)
    return {
        "h_gt": counts[0, :b], "h_geq": counts[1, :b],
        "h_fgt": fgt[:b], "h_fgeq": fgeq[:b],
        "t_gt": counts[0, b:], "t_geq": counts[1, b:],
        "t_fgt": fgt[b:], "t_fgeq": fgeq[b:],
    }
