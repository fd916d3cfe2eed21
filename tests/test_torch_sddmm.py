"""K3 (blp_tpu_torch/ops/sddmm.py) against the JAX package's
pallas_sddmm.sddmm_scores (Pallas interpret mode) and its _sddmm_xla
formulation, on the same numpy inputs.

Forward: rtol = atol = 1e-5, the tolerance of tests/test_pallas_sddmm.py
(fp32 sums in another order). Gradients of a margin loss through
_SddmmScores against jax.grad through the custom_vjp: rtol 1e-5, atol 1e-6.
On the CPU `sddmm_scores` runs the plain versions of the forward and the
backward (the kernels need a CUDA tensor; tests/test_torch_cuda.py holds
them against these plain versions, tests/test_torch_sddmm_backward.py the
plain backward against JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu.ops import pallas_sddmm
from blp_tpu_torch.data import sampling
from blp_tpu_torch.ops import sddmm

B, K, D = 16, 8, 32
MODELS = ["transe", "distmult", "complex", "simple"]


def _inputs(seed, b=B, k=K, d=D):
    rng = np.random.default_rng(seed)
    ent = rng.standard_normal((2 * b, d)).astype(np.float32)
    rel = rng.standard_normal((b, d)).astype(np.float32)
    r = rng.integers(0, 2 * b - 2, (b, k)).astype(np.int32)
    coin = rng.random((b, k)) < 0.5
    neg = sampling.corrupt_pairs(torch.from_numpy(r), torch.from_numpy(coin))
    return ent, rel, neg.numpy()


@pytest.mark.parametrize("rel_model", MODELS)
def test_forward_matches_pallas_and_xla(rel_model):
    ent, rel, neg = _inputs(0)
    got_pos, got_neg = sddmm.sddmm_scores(torch.from_numpy(ent),
                                          torch.from_numpy(rel),
                                          torch.from_numpy(neg), rel_model)
    assert got_pos.shape == (B, 1) and got_neg.shape == (B, K)
    k_pos, k_neg = pallas_sddmm.sddmm_scores(jnp.asarray(ent), jnp.asarray(rel),
                                             jnp.asarray(neg), rel_model, 8, True)
    x_pos, x_neg = pallas_sddmm._sddmm_xla(jnp.asarray(ent), jnp.asarray(rel),
                                           jnp.asarray(neg), rel_model=rel_model)
    for got, want in ((got_pos, k_pos), (got_neg, k_neg), (got_pos, x_pos),
                      (got_neg, x_neg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("rel_model", MODELS)
def test_gradients_match_jax_custom_vjp(rel_model):
    ent, rel, neg = _inputs(1)

    def loss_jax(e, r):
        pos, negs = pallas_sddmm.sddmm_scores(e, r, jnp.asarray(neg),
                                              rel_model, 8, True)
        return jnp.mean(jax.nn.relu(1 - pos + negs))

    want = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(ent), jnp.asarray(rel))
    e = torch.from_numpy(ent).requires_grad_()
    r = torch.from_numpy(rel).requires_grad_()
    pos, negs = sddmm.sddmm_scores(e, r, torch.from_numpy(neg), rel_model)
    torch.relu(1 - pos + negs).mean().backward()
    for got, w in ((e.grad, want[0]), (r.grad, want[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_gradients_equal_plain_autograd():
    """The Function's backward (explicit partials added in a fixed order,
    tests/test_torch_sddmm_backward.py) is within fp32 rounding of autograd
    through sddmm_scores_plain for every scorer, rtol 1e-5 / atol 1e-6,
    and gives the same bits on two calls."""
    ent, rel, neg = _inputs(2)
    idx = torch.from_numpy(neg)
    for rel_model in MODELS:
        grads = []
        for fn in (sddmm.sddmm_scores, sddmm.sddmm_scores,
                   sddmm.sddmm_scores_plain):
            e = torch.from_numpy(ent).requires_grad_()
            r = torch.from_numpy(rel).requires_grad_()
            pos, negs = fn(e, r, idx, rel_model)
            torch.relu(1 - pos + negs).mean().backward()
            grads.append((e.grad, r.grad))
        for once, twice, autograd in zip(*grads):
            assert torch.equal(once, twice), rel_model
            torch.testing.assert_close(once, autograd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b", [5, 3])
def test_any_batch_size_runs(b):
    """No B % block_b condition (the TPU kernel's tiling artifact, whose
    test_batch_divisibility_check therefore has no counterpart here)."""
    ent, rel, neg = _inputs(3, b=b, k=4)
    pos, negs = sddmm.sddmm_scores(torch.from_numpy(ent), torch.from_numpy(rel),
                                   torch.from_numpy(neg), "transe")
    x_pos, x_neg = pallas_sddmm._sddmm_xla(jnp.asarray(ent), jnp.asarray(rel),
                                           jnp.asarray(neg), rel_model="transe")
    np.testing.assert_allclose(pos.numpy(), np.asarray(x_pos), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(negs.numpy(), np.asarray(x_neg), rtol=1e-5, atol=1e-5)


def test_cpu_routes_to_plain_without_launch():
    ent, rel, neg = _inputs(4)
    before = sddmm.launches, sddmm.backward_launches
    e = torch.from_numpy(ent).requires_grad_()
    pos, negs = sddmm.sddmm_scores(e, torch.from_numpy(rel),
                                   torch.from_numpy(neg), "distmult")
    (pos.sum() + negs.sum()).backward()
    assert (sddmm.launches, sddmm.backward_launches) == before
