"""K1 port (blp_tpu_torch/ops/transe_rank.py) against the JAX package's
Pallas TransE rank kernel (interpret mode on the CPU) and the plain tiled
stream (blp_tpu_torch/ops/ranking.py) against JAX's. Counts must be
identical: the port's plain version adds in the kernel's fixed order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu.ops import pallas_ranking, ranking
from blp_tpu_torch.ops import ranking as t_ranking
from blp_tpu_torch.ops import transe_rank


def _t(a):
    return torch.from_numpy(np.array(a))


def _table(rng, n, n_pad, d, kind):
    table = np.zeros((n_pad, d), np.float32)
    if kind == "normal":
        x = rng.standard_normal((n, d)).astype(np.float32)
        table[:n] = x / np.linalg.norm(x, axis=1, keepdims=True)
    else:  # integer-valued: many exact ties
        table[:n] = rng.integers(-2, 3, (n, d)).astype(np.float32)
    return table


def test_seq_abs_scores_bit_equal():
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((4, 6, 70)).astype(np.float32)
    u = rng.standard_normal((4, 70)).astype(np.float32)
    want = np.asarray(pallas_ranking._seq_abs_scores(jnp.asarray(rows),
                                                     jnp.asarray(u)))
    got = transe_rank._seq_abs_scores(_t(rows), _t(u)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["normal", "integer"])
@pytest.mark.parametrize("d", [16, 40])
def test_bidir_counts_identical_to_pallas(kind, d):
    rng = np.random.default_rng(d)
    B, N, Np, tile = 8, 45, 64, 16
    table = _table(rng, N, Np, d, kind)
    head_pos = rng.integers(0, N, B).astype(np.int32)
    tail_pos = rng.integers(0, N, B).astype(np.int32)
    head, tail = table[head_pos], table[tail_pos]
    rel = (rng.integers(-1, 2, (B, d)) if kind == "integer"
           else 0.3 * rng.standard_normal((B, d))).astype(np.float32)
    hf = np.full((B, 8), -1, np.int32)
    tf = np.full((B, 8), -1, np.int32)
    hf[0, :3] = [1, 17, 39]
    hf[5, :2] = [3, 44]
    tf[2, :2] = [5, 20]
    true_s = np.zeros((B, 1), np.float32)  # unused: both recompute the pivot

    want = pallas_ranking.transe_tiled_rank_counts_bidir(
        *(jnp.asarray(a) for a in (table, head, tail, rel, true_s, true_s,
                                   head_pos, tail_pos, hf, tf)),
        jnp.asarray(N, jnp.int32), tile=tile, interpret=True)
    got = transe_rank.transe_tiled_rank_counts_bidir(
        *(_t(a) for a in (table, head, tail, rel, true_s, true_s, head_pos,
                          tail_pos, hf, tf)), N)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert transe_rank.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("corrupt", ["head", "tail"])
def test_one_direction_counts_identical_to_pallas(corrupt):
    rng = np.random.default_rng(7)
    B, d, N, Np, tile = 6, 33, 40, 48, 16
    table = _table(rng, N, Np, d, "normal")
    fixed = rng.standard_normal((B, d)).astype(np.float32)
    rel = rng.standard_normal((B, d)).astype(np.float32)
    true_pos = rng.integers(0, N, B).astype(np.int32)
    fp = np.full((B, 8), -1, np.int32)
    fp[0, :3] = [1, 17, 39]
    ts = np.zeros((B, 1), np.float32)
    want = pallas_ranking.transe_tiled_rank_counts(
        *(jnp.asarray(a) for a in (table, fixed, rel, ts, true_pos, fp)),
        jnp.asarray(N, jnp.int32), corrupt=corrupt, tile=tile, interpret=True)
    got = transe_rank.transe_tiled_rank_counts(
        *(_t(a) for a in (table, fixed, rel, ts, true_pos, fp)), N,
        corrupt=corrupt)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("rel_model", ["transe", "distmult", "complex", "simple"])
def test_plain_stream_identical_to_jax(rel_model):
    rng = np.random.default_rng(3)
    n, d, b, tile = 64, 8, 5, 16
    table = rng.integers(-2, 3, (n, d)).astype(np.float32)
    num_valid = n - 7
    head_pos = rng.integers(0, num_valid, b)
    tail_pos = rng.integers(0, num_valid, b)
    rel = rng.integers(-1, 2, (b, d)).astype(np.float32)
    hf = rng.integers(-1, num_valid, (b, 3)).astype(np.int32)
    tf = rng.integers(-1, num_valid, (b, 3)).astype(np.int32)
    head, tail = table[head_pos], table[tail_pos]

    j_h = ranking.score_pairs(jnp.asarray(head), jnp.asarray(tail),
                              jnp.asarray(rel), rel_model=rel_model,
                              corrupt="head")[:, None]
    j_t = ranking.score_pairs(jnp.asarray(tail), jnp.asarray(head),
                              jnp.asarray(rel), rel_model=rel_model,
                              corrupt="tail")[:, None]
    want = ranking.tiled_rank_counts_bidir(
        jnp.asarray(table), jnp.asarray(head), jnp.asarray(tail),
        jnp.asarray(rel), j_h, j_t, jnp.asarray(head_pos),
        jnp.asarray(tail_pos), jnp.asarray(hf), jnp.asarray(tf),
        jnp.asarray(num_valid, jnp.int32), rel_model=rel_model, tile=tile)

    t_h = t_ranking.score_pairs(_t(head), _t(tail), _t(rel),
                                rel_model=rel_model, corrupt="head")[:, None]
    t_t = t_ranking.score_pairs(_t(tail), _t(head), _t(rel),
                                rel_model=rel_model, corrupt="tail")[:, None]
    np.testing.assert_array_equal(t_h.numpy(), np.asarray(j_h))
    got = t_ranking.tiled_rank_counts_bidir(
        _t(table), _t(head), _t(tail), _t(rel), t_h, t_t, _t(head_pos),
        _t(tail_pos), _t(hf), _t(tf), num_valid, rel_model=rel_model,
        tile=tile)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_raw_counts_padding_and_self_exclusion():
    """Columns at or past num_valid and each query's own column never count;
    a duplicate of the true row counts as a tie (geq, not gt)."""
    d = 4
    table = torch.tensor([[0.0] * d, [1.0] * d, [0.0] * d, [5.0] * d])
    u = torch.zeros((1, d))
    r = transe_rank._seq_abs_scores(table[[0]][:, None, :], u)   # 0.0
    counts = transe_rank.raw_counts(table, u, r, torch.tensor([0]), 3)
    assert counts.tolist() == [[0], [1]]


def test_bilinear_tiled_rank_counts_match_jax():
    rng = np.random.default_rng(11)
    n, d, b, tile = 48, 8, 4, 16
    table = rng.integers(-2, 3, (n, d)).astype(np.float32)
    fixed = rng.integers(-1, 2, (b, d)).astype(np.float32)
    rel = rng.integers(-1, 2, (b, d)).astype(np.float32)
    pos = rng.integers(0, n, b)
    fp = rng.integers(-1, n, (b, 4)).astype(np.int32)
    ts = np.asarray(ranking.score_pairs(
        jnp.asarray(table[pos]), jnp.asarray(fixed), jnp.asarray(rel),
        rel_model="distmult", corrupt="tail"))[:, None]
    want = ranking.tiled_rank_counts(
        jnp.asarray(table), jnp.asarray(fixed), jnp.asarray(rel),
        jnp.asarray(ts), jnp.asarray(pos), jnp.asarray(fp),
        jnp.asarray(n, jnp.int32), rel_model="distmult", corrupt="tail",
        tile=tile)
    got = t_ranking.tiled_rank_counts(
        _t(table), _t(fixed), _t(rel), _t(ts), _t(pos), _t(fp), n,
        rel_model="distmult", corrupt="tail", tile=tile)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
