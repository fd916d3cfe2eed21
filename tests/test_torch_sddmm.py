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


@pytest.mark.parametrize("units,d,ent_off,want", [
    (128, 128, 0, 4), (300, 300, 0, 4), (768, 768, 0, 4),
    (257, 257, 0, 1),      # odd unit count
    (514, 514, 0, 2),      # even, not a multiple of 4
    (128, 128, 8, 2),      # ent 8 bytes off 16
    (128, 128, 4, 1),      # ent 4 bytes off 16
    (150, 300, 0, 2),      # complex/simple: 150 pairs of d 300
])
def test_vector_width_follows_the_launch_rule(units, d, ent_off, want):
    assert sddmm.vector_width(units, d, 4096 + ent_off, 8192) == want
    assert sddmm.vector_width(units, d, 4096, 8192 + ent_off) == want


@pytest.mark.parametrize("d,offset,rel_model,limit", [
    (257, 0, "transe", 256),      # odd: vector width 1
    (514, 0, "distmult", 512),    # 2 mod 4: vector width 2
    (516, 1, "transe", 256),      # ent view 4 bytes off 16: width 1
    (1028, 2, "transe", 512),     # ent view 8 bytes off 16: width 2
    (1030, 0, "complex", 256),    # 515 pairs: odd, width 1
    (2052, 0, "simple", 512),     # 1,026 pairs: 2 mod 4, width 2
])
def test_too_wide_for_k3_raises_with_the_real_limit(d, offset, rel_model, limit):
    """The width check runs before any launch: a CPU tensor shows it."""
    b, k = 2, 3
    buf = torch.zeros(2 * b * d + offset)
    ent = buf[offset:].view(2 * b, d)
    rel = torch.zeros((b, d))
    neg = torch.zeros((b, k, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"at most {limit} units"):
        sddmm._checked(ent, rel, neg, rel_model)


@pytest.mark.parametrize("d,rel_model", [(256, "transe"), (300, "transe"),
                                         (768, "distmult"), (1024, "transe"),
                                         (2048, "complex")])
def test_widths_the_kernel_takes_pass_the_check(d, rel_model):
    ent, rel = torch.zeros((4, d)), torch.zeros((2, d))
    neg = torch.zeros((2, 3, 2), dtype=torch.int32)
    out = sddmm._checked(ent, rel, neg, rel_model)
    assert out[0].data_ptr() == ent.data_ptr()     # nothing copied
