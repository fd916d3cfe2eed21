"""The port's word-embedding encoders (blp_tpu_torch/models/encoders.py)
against the JAX package's (blp_tpu/models/encoders.py) on the same numpy
inputs and weights.

Tolerances: `bow_encode` rtol 1e-5 / atol 1e-6 (an fp32 masked mean, summed
in another order); `dkrl_encode`'s output and its gradients (jax.grad against
autograd, in the table and every conv leaf) rtol 1e-4 / atol 1e-5 (two fp32
matmuls and a masked mean). The gradient case holds a pool window whose four
positions tie at exactly 0: JAX splits the cotangent evenly among tied
maxima, and so must the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu.models import encoders as j_enc
from blp_tpu_torch.models import encoders as t_enc

V, E, D, B, L = 50, 12, 8, 5, 16


def _data(seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, E)).astype(np.float32)
    table[0] = 0.0                       # padding row, and the tie below
    tok = rng.integers(1, V, size=(B, L))
    lengths = rng.integers(4, L + 1, size=B)
    lengths[0] = L
    lengths[1] = 4
    lengths[2] = 9      # position 8 opens a pool window with 3 masked ones
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    tok = tok * mask.astype(np.int64)
    tok[2, 8] = 0       # a real token with a zero embedding
    return table, tok, mask


def _dkrl_params(seed, zero_conv1_bias=False):
    p = jax.tree.map(np.asarray, j_enc.init_dkrl_params(jax.random.key(seed), E, D))
    if zero_conv1_bias:
        p["conv1_b"] = np.zeros_like(p["conv1_b"])
    return p


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("with_mask", [True, False])
def test_bow_encode_matches_jax(with_mask):
    table, tok, mask = _data(1)
    m = mask if with_mask else None
    want = j_enc.bow_encode(jnp.asarray(table), jnp.asarray(tok),
                            None if m is None else jnp.asarray(m))
    got = t_enc.bow_encode(torch.from_numpy(table), torch.from_numpy(tok),
                           None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == (B, E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_mask", [True, False])
def test_dkrl_encode_matches_jax(with_mask):
    table, tok, mask = _data(2)
    p = _dkrl_params(0)
    m = mask if with_mask else None
    want = j_enc.dkrl_encode(jax.tree.map(jnp.asarray, p), jnp.asarray(table),
                             jnp.asarray(tok), None if m is None else jnp.asarray(m))
    got = t_enc.dkrl_encode(_t(p), torch.from_numpy(table), torch.from_numpy(tok),
                            None if m is None else torch.from_numpy(m))
    assert got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_dkrl_gradients_match_jax_with_a_tied_pool_window():
    table, tok, mask = _data(3)
    p = _dkrl_params(1, zero_conv1_bias=True)
    probe = np.random.default_rng(3).standard_normal((B, D)).astype(np.float32)

    # The window of positions 8-11 of row 2 holds four exact zeros after
    # conv1 and the mask: a 4-way tie in every channel.
    h = t_enc._conv_k2_same_right(
        torch.from_numpy(table)[torch.from_numpy(tok)] * torch.from_numpy(mask)[..., None],
        torch.from_numpy(p["conv1_w"]), torch.from_numpy(p["conv1_b"]))
    h = h * torch.from_numpy(mask)[..., None]
    assert torch.all(h[2, 8:12] == 0)

    def j_loss(tree):
        out = j_enc.dkrl_encode(tree["dkrl"], tree["table"], jnp.asarray(tok),
                                jnp.asarray(mask))
        return jnp.sum(out * probe)

    want = jax.grad(j_loss)(jax.tree.map(jnp.asarray, {"dkrl": p, "table": table}))

    tp = {"dkrl": {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()},
          "table": torch.from_numpy(table).requires_grad_()}
    out = t_enc.dkrl_encode(tp["dkrl"], tp["table"], torch.from_numpy(tok),
                            torch.from_numpy(mask))
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(tp["table"].grad.numpy(), np.asarray(want["table"]),
                               rtol=1e-4, atol=1e-5)
    for k, v in tp["dkrl"].items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(want["dkrl"][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_dkrl_requires_len_multiple_of_pool():
    table, tok, mask = _data(4)
    with pytest.raises(ValueError, match="divisible by 4"):
        t_enc.dkrl_encode(_t(_dkrl_params(0)), torch.from_numpy(table),
                          torch.from_numpy(tok[:, :14]),
                          torch.from_numpy(mask[:, :14]))


def test_init_dkrl_params_shapes_and_bounds():
    p = t_enc.init_dkrl_params(torch.Generator().manual_seed(0), 300, 128)
    want = jax.tree.map(np.asarray, j_enc.init_dkrl_params(jax.random.key(0), 300, 128))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in want.items()}
    for k, bound in (("conv1_w", 600 ** -0.5), ("conv1_b", 600 ** -0.5),
                     ("conv2_w", 256 ** -0.5), ("conv2_b", 256 ** -0.5)):
        assert p[k].abs().max().item() <= bound
        assert p[k].abs().max().item() > 0.9 * bound     # U(-b, b), not narrower


def test_init_entity_table_is_xavier_uniform():
    t = t_enc.init_entity_table(torch.Generator().manual_seed(0), 1000, 24)
    bound = (6.0 / 1024) ** 0.5
    assert t.shape == (1000, 24) and t.dtype == torch.float32
    assert 0.95 * bound < t.abs().max().item() <= bound
    assert abs(t.mean().item()) < 0.01
