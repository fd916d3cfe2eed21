"""K3's backward: `sddmm_scores_backward_plain` (what `_SddmmScores.backward`
runs for a CPU tensor, and what csrc/sddmm.cu's backward kernel computes
bit for bit on the card) against the JAX package on the same numpy inputs:
`jax.vjp` of `pallas_sddmm._sddmm_xla` and of the custom_vjp
`pallas_sddmm.sddmm_scores` with its Pallas kernel in interpret mode.

Tolerance rtol 1e-5, atol 1e-6, as tests/test_torch_sddmm.py holds the
gradients: fp32 sums of the same terms in another order. Cotangents are the
size a mean margin loss gives them (about 1 / (B·K)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu.ops import pallas_sddmm
from blp_tpu_torch.data import sampling
from blp_tpu_torch.ops import sddmm

MODELS = ["transe", "distmult", "complex", "simple"]
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, b, k, d, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        ent = rng.integers(-2, 3, (2 * b, d)).astype(np.float32)
        rel = rng.integers(-1, 2, (b, d)).astype(np.float32)
    else:
        ent = rng.standard_normal((2 * b, d)).astype(np.float32)
        rel = rng.standard_normal((b, d)).astype(np.float32)
    r = rng.integers(0, 2 * b - 2, (b, k)).astype(np.int32)
    coin = rng.random((b, k)) < 0.5
    neg = sampling.corrupt_pairs(torch.from_numpy(r), torch.from_numpy(coin))
    scale = 1.0 / (b * max(k, 1))
    g_pos = (scale * rng.standard_normal((b, 1))).astype(np.float32)
    g_neg = (scale * rng.standard_normal((b, k))).astype(np.float32)
    return ent, rel, neg.numpy(), g_pos, g_neg


def _plain(ent, rel, neg, g_pos, g_neg, rel_model):
    d_ent, d_rel = sddmm.sddmm_scores_backward_plain(
        *(torch.from_numpy(x) for x in (ent, rel, neg, g_pos, g_neg)), rel_model)
    return d_ent.numpy(), d_rel.numpy()


def _jax_vjp(fn, ent, rel, g_pos, g_neg):
    _, vjp = jax.vjp(fn, jnp.asarray(ent), jnp.asarray(rel))
    return [np.asarray(x) for x in vjp((jnp.asarray(g_pos), jnp.asarray(g_neg)))]


def _xla_vjp(ent, rel, neg, g_pos, g_neg, rel_model):
    return _jax_vjp(lambda e, r: pallas_sddmm._sddmm_xla(
        e, r, jnp.asarray(neg), rel_model=rel_model), ent, rel, g_pos, g_neg)


@pytest.mark.parametrize("rel_model", MODELS)
@pytest.mark.parametrize("b", [2, 5, 8])
@pytest.mark.parametrize("k", [0, 4])
@pytest.mark.parametrize("d", [8, 16])
def test_backward_plain_matches_jax_vjp(rel_model, b, k, d):
    ent, rel, neg, g_pos, g_neg = _inputs(b * 100 + k * 10 + d, b, k, d)
    got = _plain(ent, rel, neg, g_pos, g_neg, rel_model)
    want = _xla_vjp(ent, rel, neg, g_pos, g_neg, rel_model)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x, w, **TOL)


@pytest.mark.parametrize("rel_model", MODELS)
@pytest.mark.parametrize("b", [2, 5, 8])
def test_backward_plain_matches_pallas_custom_vjp(rel_model, b):
    """The TPU package's custom_vjp with its kernel in interpret mode
    (block_b 1 divides every B; the Pallas kernel takes K >= 1)."""
    ent, rel, neg, g_pos, g_neg = _inputs(b, b, 4, 16)
    got = _plain(ent, rel, neg, g_pos, g_neg, rel_model)
    want = _jax_vjp(lambda e, r: pallas_sddmm.sddmm_scores(
        e, r, jnp.asarray(neg), rel_model, 1, True), ent, rel, g_pos, g_neg)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x, w, **TOL)


@pytest.mark.parametrize("b,k", [(2, 4), (5, 0), (8, 4)])
def test_transe_exact_ties(b, k):
    """(h + r) - t is exactly 0 in column 0 of every task (1 + 0 - 1); the
    other columns are integers in [-2, 2] with many ties too, and rows differ.

    At a tie the port takes d|x|/dx = sign(0) = 0, as torch's abs does (so
    K3 agrees with autograd through sddmm_scores_plain and with the
    sddmm_pallas=False path); jax's abs takes +1 there
    (lax._abs_jvp_rule: select(x >= 0, g, -g)). The test pins both: the
    port against torch autograd everywhere and 0 in column 0, and JAX's
    column 0 against the +1 rule written out."""
    ent, rel, neg, g_pos, g_neg = _inputs(30 + b, b, k, 8, integer=True)
    ent[:, 0] = 1.0
    rel[:, 0] = 0.0
    got = _plain(ent, rel, neg, g_pos, g_neg, "transe")
    e = torch.from_numpy(ent).requires_grad_()
    r = torch.from_numpy(rel).requires_grad_()
    pos, negs = sddmm.sddmm_scores_plain(e, r, torch.from_numpy(neg), "transe")
    auto = torch.autograd.grad((pos, negs), (e, r), (torch.from_numpy(g_pos),
                                                     torch.from_numpy(g_neg)))
    for x, a in zip(got, auto):
        assert (x[:, 0] == 0).all()
        np.testing.assert_allclose(x, a.numpy(), **TOL)
    want = _xla_vjp(ent, rel, neg, g_pos, g_neg, "transe")
    tasks = np.concatenate([np.arange(2 * b).reshape(b, 1, 2), neg], axis=1)
    g = np.concatenate([g_pos, g_neg], axis=1)
    col0 = np.zeros(2 * b, np.float32)
    np.add.at(col0, tasks[..., 0].ravel(), -g.ravel())
    np.add.at(col0, tasks[..., 1].ravel(), g.ravel())
    np.testing.assert_allclose(want[0][:, 0], col0, **TOL)
    np.testing.assert_allclose(want[1][:, 0], -g.sum(axis=1), **TOL)


def _adversarial(kind, b, k):
    own = 2 * np.arange(b, dtype=np.int32)
    if kind == "hot_row":           # every task's head and tail: row 3
        return np.full((b, k, 2), 3, np.int32)
    neg = np.zeros((b, k, 2), np.int32)
    neg[:, 0::3] = np.stack([own, own], axis=1)[:, None]          # own head twice
    neg[:, 1::3] = np.stack([own + 1, own], axis=1)[:, None]      # swapped
    neg[:, 2::3] = np.stack([own + 1, own + 1], axis=1)[:, None]  # own tail twice
    return neg


@pytest.mark.parametrize("rel_model", MODELS)
@pytest.mark.parametrize("kind,k", [("hot_row", 6), ("own_slots", 6),
                                    ("hot_row", 0)])
def test_backward_plain_adversarial_indices(rel_model, kind, k):
    b, d = 6, 16
    ent, rel, _, g_pos, g_neg = _inputs(40 + k, b, k, d)
    neg = _adversarial(kind, b, k)
    got = _plain(ent, rel, neg, g_pos, g_neg, rel_model)
    want = _xla_vjp(ent, rel, neg, g_pos, g_neg, rel_model)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x, w, **TOL)


def test_function_backward_is_the_plain_backward():
    ent, rel, neg, g_pos, g_neg = _inputs(3, 7, 5, 16)
    e = torch.from_numpy(ent).requires_grad_()
    r = torch.from_numpy(rel).requires_grad_()
    pos, negs = sddmm.sddmm_scores(e, r, torch.from_numpy(neg), "complex")
    got = torch.autograd.grad((pos, negs), (e, r),
                              (torch.from_numpy(g_pos), torch.from_numpy(g_neg)))
    want = _plain(ent, rel, neg, g_pos, g_neg, "complex")
    for x, w in zip(got, want):
        assert torch.equal(x, torch.from_numpy(w))


def test_backward_order_bookkeeping():
    """slots in (b, j, side) order with the own pair first; order a stable
    argsort; starts the run boundaries of each entity row."""
    _, _, neg, _, _ = _inputs(5, 9, 7, 8)
    slots, sorted_slots, order, starts = sddmm._backward_order(
        torch.from_numpy(neg), 9)
    assert slots.shape == (9, 8, 2) and slots.dtype == torch.int32
    assert torch.equal(slots[:, 0], torch.arange(18, dtype=torch.int32).reshape(9, 2))
    assert torch.equal(slots[:, 1:], torch.from_numpy(neg))
    flat = slots.reshape(-1)
    assert torch.equal(flat[order], sorted_slots)
    counts = torch.bincount(flat.long(), minlength=18)
    assert torch.equal(starts, torch.cat([torch.zeros(1, dtype=torch.long),
                                          counts.cumsum(0)]))
    for e in range(18):                    # stable: positions increase in a run
        run = order[starts[e]:starts[e + 1]]
        assert (run[1:] > run[:-1]).all()
