"""Scorers and losses of the port (blp_tpu_torch/models/scoring.py) against
the JAX package's, fp32, rtol = atol = 1e-6, for the (B, d), (B, K, d) and
broadcast rank-vs-all shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu.models import scoring as j_scoring
from blp_tpu_torch.models import scoring as t_scoring

SHAPES = {
    "pairs": ((6, 8), (6, 8), (6, 8)),
    "negatives": ((6, 5, 8), (6, 5, 8), (6, 1, 8)),
    "rank_vs_all": ((1, 20, 8), (6, 1, 8), (6, 1, 8)),
}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("rel_model", ["transe", "distmult", "complex", "simple"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_scorers_match(rel_model, shape):
    rng = np.random.default_rng(0)
    h, t, r = (rng.standard_normal(s).astype(np.float32) for s in SHAPES[shape])
    want = j_scoring.get_score_fn(rel_model)(jnp.asarray(h), jnp.asarray(t),
                                             jnp.asarray(r))
    got = t_scoring.get_score_fn(rel_model)(torch.from_numpy(h),
                                            torch.from_numpy(t),
                                            torch.from_numpy(r))
    _close(got, want)


@pytest.mark.parametrize("loss_fn", ["margin", "nll"])
@pytest.mark.parametrize("rel_model", ["transe", "distmult", "complex", "simple"])
@pytest.mark.parametrize("regularizer", [0.0, 0.01])
def test_compute_loss_matches(loss_fn, rel_model, regularizer):
    rng = np.random.default_rng(1)
    B, K, d = 5, 4, 8
    ent = rng.standard_normal((B, 2, d)).astype(np.float32)
    rel = rng.standard_normal((B, d)).astype(np.float32)
    neg = rng.integers(0, 2 * B, (B, K, 2)).astype(np.int32)
    want = j_scoring.compute_loss(jnp.asarray(ent), jnp.asarray(rel),
                                  jnp.asarray(neg), rel_model=rel_model,
                                  loss_fn=loss_fn, regularizer=regularizer)
    got = t_scoring.compute_loss(torch.from_numpy(ent), torch.from_numpy(rel),
                                 torch.from_numpy(neg), rel_model=rel_model,
                                 loss_fn=loss_fn, regularizer=regularizer)
    _close(got, want)


def test_l2_normalize_and_unknown_names():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    x[1] = 0.0  # eps branch
    _close(t_scoring.l2_normalize(torch.from_numpy(x)),
           j_scoring.l2_normalize(jnp.asarray(x)))
    with pytest.raises(ValueError):
        t_scoring.get_score_fn("rotate")
    with pytest.raises(ValueError):
        t_scoring.get_loss_fn("hinge")
