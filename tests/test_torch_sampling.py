"""The port's negative sampler (blp_tpu_torch/data/sampling.py): its
bijection and coin against the JAX package's formula on the same draws
(bit-equal), and the invariants of tests/test_sampling.py on its own draws
(the RNG streams differ, so the samplers are compared by invariants and by
distribution)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from blp_tpu_torch.data import sampling


def _jax_corrupt(r, coin):
    """blp_tpu/data/sampling.py's formula after its two draws."""
    B, K = r.shape
    row = jnp.arange(B, dtype=jnp.int32)[:, None]
    sampled = r + jnp.where(r >= 2 * row, 2, 0)
    head_slot = jnp.broadcast_to(2 * row, (B, K))
    neg_head = jnp.where(coin, sampled, head_slot)
    neg_tail = jnp.where(coin, head_slot + 1, sampled)
    return np.asarray(jnp.stack([neg_head, neg_tail], axis=-1))


@pytest.mark.parametrize("B,K", [(2, 5), (16, 8), (64, 64)])
def test_corrupt_pairs_bit_equal_to_jax(B, K):
    rng = np.random.default_rng(B * K)
    r = rng.integers(0, 2 * B - 2, (B, K)).astype(np.int32)
    coin = rng.random((B, K)) < 0.5
    got = sampling.corrupt_pairs(torch.from_numpy(r), torch.from_numpy(coin))
    want = _jax_corrupt(jnp.asarray(r), jnp.asarray(coin))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _sample(seed, B, K):
    g = torch.Generator().manual_seed(seed)
    return sampling.sample_negative_indices(g, B, K, device="cpu").numpy()


def test_shapes_and_dtype():
    idx = _sample(0, 16, 8)
    assert idx.shape == (16, 8, 2) and idx.dtype == np.int32


def test_exactly_one_column_corrupted_and_never_own_row():
    B, K = 32, 64
    idx = _sample(1, B, K)
    rows = np.arange(B)[:, None]
    head_kept = idx[..., 0] == 2 * rows
    tail_kept = idx[..., 1] == 2 * rows + 1
    assert np.all(head_kept ^ tail_kept)
    corrupted = np.where(head_kept, idx[..., 1], idx[..., 0])
    assert np.all(corrupted // 2 != rows)
    assert corrupted.min() >= 0 and corrupted.max() < 2 * B


def test_uniform_over_complement_chi_square():
    B, K = 4, 20000
    idx = _sample(2, B, K)
    rows = np.arange(B)[:, None]
    head_kept = idx[..., 0] == 2 * rows
    corrupted = np.where(head_kept, idx[..., 1], idx[..., 0])
    for i in range(B):
        counts = np.bincount(corrupted[i], minlength=2 * B)
        assert counts[2 * i] == 0 and counts[2 * i + 1] == 0
        others = np.delete(counts, [2 * i, 2 * i + 1])
        assert stats.chisquare(others).pvalue > 1e-3
    assert stats.binomtest(int((~head_kept).sum()), B * K, 0.5).pvalue > 1e-3


def test_same_seed_same_draws_and_small_batch_raises():
    np.testing.assert_array_equal(_sample(5, 8, 4), _sample(5, 8, 4))
    with pytest.raises(ValueError, match="batch_size >= 2"):
        _sample(0, 1, 4)
