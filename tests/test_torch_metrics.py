"""Rank metrics of the port (blp_tpu_torch/metrics.py) against the JAX
package's, all exactly equal: counts and ranks are integers or exact, and the
breakdown sums add the same float32 values in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu import metrics as j_metrics
from blp_tpu_torch import metrics as t_metrics


def test_counts_ranks_and_hits_match():
    rng = np.random.default_rng(0)
    scores = rng.integers(-3, 4, (6, 20)).astype(np.float32)
    true = scores[:, [2]]
    valid = rng.random((6, 20)) < 0.8
    for mask in (None, valid):
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else torch.from_numpy(mask)
        j_gt, j_geq = j_metrics.rank_counts(jnp.asarray(scores), jnp.asarray(true), jm)
        t_gt, t_geq = t_metrics.rank_counts(torch.from_numpy(scores),
                                            torch.from_numpy(true), tm)
        np.testing.assert_array_equal(t_gt.numpy(), np.asarray(j_gt))
        np.testing.assert_array_equal(t_geq.numpy(), np.asarray(j_geq))
    ranks_j = j_metrics.ranks_from_counts(j_gt, j_geq)
    ranks_t = t_metrics.ranks_from_counts(t_gt, t_geq)
    np.testing.assert_array_equal(ranks_t.numpy(), np.asarray(ranks_j))
    rec_j, hits_j = j_metrics.metrics_from_ranks(ranks_j)
    rec_t, hits_t = t_metrics.metrics_from_ranks(ranks_t)
    np.testing.assert_array_equal(rec_t.numpy(), np.asarray(rec_j))
    np.testing.assert_array_equal(hits_t.numpy(), np.asarray(hits_j))


# 1,513 triples take two levels of 32-wide windows in the position sum.
@pytest.mark.parametrize("B", [7, 50, 1513])
def test_breakdowns_match(B):
    rng = np.random.default_rng(B)
    triples = np.stack([rng.integers(0, 30, B), rng.integers(0, 30, B),
                        rng.integers(0, 5, B)], axis=1).astype(np.int32)
    rec = (1.0 / rng.integers(1, 40, 2 * B)).astype(np.float32)
    new = rng.random(30) < 0.4
    cats = rng.integers(0, 4, 5).astype(np.int32)
    js, jc = j_metrics.split_by_new_position(triples, rec, jnp.asarray(new))
    ts, tc = t_metrics.split_by_new_position(torch.from_numpy(triples),
                                             torch.from_numpy(rec),
                                             torch.from_numpy(new))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    js, jc = j_metrics.split_by_category(triples, rec, jnp.asarray(cats))
    ts, tc = t_metrics.split_by_category(torch.from_numpy(triples),
                                         torch.from_numpy(rec),
                                         torch.from_numpy(cats))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
