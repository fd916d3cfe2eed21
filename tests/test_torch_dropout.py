"""The port's training pass of BERT (blp_tpu_torch/models/bert.py): dropout
and rematerialisation, held against the JAX package where the two can be
compared on the same inputs.

The dropout RNG streams differ (threefry/rbg vs the port's counter-based
generator, ops/dropout_rng.py), so the masks are held by their quantization
(threshold and keep probability equal to JAX's), their keep fraction and
the backward's regeneration; gradients
are compared with JAX at dropout 0 (fp32: rtol 1e-4, atol 1e-6, fp32 sums in
another order). `remat` must not change gradients with dropout on: the
checkpointed layers draw the same masks again, so the gradients are
identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu.models import bert as j_bert
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models.blp import params_from_jax
from blp_tpu_torch.ops import dropout_rng

TINY = dict(vocab_size=128, hidden_size=32, num_layers=3, num_heads=4,
            intermediate_size=64, max_position_embeddings=64)


@pytest.mark.parametrize("nbits", [8, 16, 32])
@pytest.mark.parametrize("rate", [0.1, 0.999])
def test_threshold_and_keep_probability_equal_jax(rate, nbits):
    _, want_keep_p = j_bert._dropout_keep(jax.random.key(0), rate, nbits, (4,))
    t, keep_p = dropout_rng.threshold(rate, nbits)
    assert keep_p == want_keep_p
    if nbits == 32:
        assert t is None
    else:
        levels = 1 << nbits
        assert t == round((1.0 - want_keep_p) * levels) and 0 < t < levels
    assert dropout_rng.site_keep(0, rate, nbits, (4,))[1] == want_keep_p


@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_empirical_keep_fraction(nbits):
    n = 400_000
    keep, keep_p = dropout_rng.site_keep(nbits, 0.1, nbits, (n,))
    assert keep.dtype == torch.bool
    sigma = (keep_p * (1 - keep_p) / n) ** 0.5
    assert abs(keep.float().mean().item() - keep_p) < 5 * sigma
    jkeep, _ = j_bert._dropout_keep(jax.random.key(1), 0.1, nbits, (n,))
    assert abs(float(jnp.mean(jkeep)) - keep_p) < 5 * sigma


@pytest.mark.parametrize("nbits", [8, 32])
def test_rng_dropout_forward_and_backward_use_one_mask(nbits):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, (64, 33)).astype(np.float32))
    x.requires_grad_()
    y = t_bert._rng_dropout(x, 1234, 0.3, nbits)
    keep, keep_p = dropout_rng.site_keep(1234, 0.3, nbits, x.shape)
    assert torch.equal(y, torch.where(keep, x / keep_p, 0.0))
    y.backward(torch.ones_like(y))
    assert torch.equal(x.grad, torch.where(keep, 1.0 / keep_p, 0.0))
    assert 0 < keep.sum() < keep.numel()


def _tcfg(**kw):
    return t_bert.BertConfig(**{**TINY, **kw})


def _setup(seed=0, **kw):
    jcfg = j_bert.BertConfig(**TINY)
    jp = jax.tree.map(np.asarray, j_bert.init_bert_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 128, (8, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < rng.integers(2, 17, 8)[:, None]).astype(np.float32)
    probe = rng.standard_normal((8, 16, TINY["hidden_size"])).astype(np.float32)
    return jcfg, jp, ids, mask, probe


def _torch_grads(tp, cfg, ids, mask, probe, seed):
    live = {}

    def req(tree, path=()):
        if isinstance(tree, dict):
            return {k: req(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(req(v, path + (i,)) for i, v in enumerate(tree))
        t = tree.clone().requires_grad_()
        live[path] = t
        return t

    p = req(tp)
    out = t_bert.bert_encode(p, torch.from_numpy(ids), torch.from_numpy(mask), cfg,
                             deterministic=False, dropout_seed=seed)
    (out.float() * torch.from_numpy(probe)).mean().backward()
    return out.detach(), {k: v.grad for k, v in live.items()}


@pytest.mark.parametrize("remat", [True, 1, 2])
@pytest.mark.parametrize("dtype,nbits", [("f32", 32), ("bf16", 8)])
def test_remat_gradients_equal_no_remat_with_dropout(remat, dtype, nbits):
    _, jp, ids, mask, probe = _setup(1)
    tp = params_from_jax(j_bert.unstack_layers(jp))
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    base = _tcfg(compute_dtype=dt, dropout_bits=nbits)
    out0, g0 = _torch_grads(tp, base, ids, mask, probe, seed=7)
    out1, g1 = _torch_grads(tp, dataclasses.replace(base, remat=remat), ids,
                            mask, probe, seed=7)
    assert torch.equal(out0, out1)
    for k in g0:
        if g0[k] is None:    # the pooler: not on the encode path
            assert g1[k] is None and k[0] == "pooler"
            continue
        assert torch.equal(g0[k], g1[k]), k
    # Dropout is on: another seed gives another output.
    out2, _ = _torch_grads(tp, base, ids, mask, probe, seed=8)
    assert not torch.equal(out0, out2)


def test_remat_policy_strings_raise():
    # "dots" and "names" run (tests/test_torch_remat.py); any other policy
    # string raises.
    _, jp, ids, mask, probe = _setup(2)
    with pytest.raises(ValueError, match="dots"):
        _torch_grads(params_from_jax(jp), _tcfg(remat="everything"), ids, mask,
                     probe, seed=1)


def test_deterministic_output_unchanged_and_without_graph():
    jcfg, jp, ids, mask, _ = _setup(3)
    want = np.asarray(j_bert.bert_encode(jp, jnp.asarray(ids), jnp.asarray(mask),
                                         jcfg))
    tp = params_from_jax(jp)
    tp["embeddings"]["word"].requires_grad_()
    got = t_bert.bert_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                             _tcfg())
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # The training pass at dropout 0 computes the same function.
    train = t_bert.bert_encode(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                               _tcfg(hidden_dropout=0.0, attention_dropout=0.0),
                               deterministic=False, dropout_seed=3)
    assert train.requires_grad
    np.testing.assert_allclose(train.detach().numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
def test_fp32_gradients_match_jax_at_dropout_zero(layout):
    jcfg, jp, ids, mask, probe = _setup(4)
    jcfg = dataclasses.replace(jcfg, hidden_dropout=0.0, attention_dropout=0.0)
    if layout == "unstacked":
        jp = j_bert.unstack_layers(jp)

    def loss(p):
        out = j_bert.bert_encode(p, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                 deterministic=False,
                                 dropout_rng=jax.random.key(0))
        return jnp.mean(out * probe)

    want = jax.grad(loss)(jax.tree.map(jnp.asarray, jp))
    _, got = _torch_grads(params_from_jax(jp),
                          _tcfg(hidden_dropout=0.0, attention_dropout=0.0),
                          ids, mask, probe, seed=0)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(got)
    for path, w in flat:
        key = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        g = got[key]
        if g is None:   # a leaf the loss does not reach (the pooler)
            assert not np.any(np.asarray(w))
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=str(key))


@pytest.mark.parametrize("fast_train", [False, True])
def test_bf16_gradients_match_jax_at_dropout_zero(fast_train):
    """The bf16 training pass, leaf by leaf: the port's gradients within
    1.5% of each leaf's largest JAX gradient. On these inputs both
    packages' bf16 gradients lie 0.4-1.1% from fp32 truth and 0.4-1.0%
    from each other. `k_b` is left out: its exact gradient is 0 (softmax
    is invariant to a key bias), so its computed value is rounding noise."""
    _, jp, ids, mask, probe = _setup(0)
    jcfg = j_bert.BertConfig(**TINY, compute_dtype=jnp.bfloat16,
                             fast_train=fast_train, hidden_dropout=0.0,
                             attention_dropout=0.0)

    def loss(p):
        out = j_bert.bert_encode(p, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                 deterministic=False,
                                 dropout_rng=jax.random.key(0))
        return jnp.mean(out * probe)

    want = jax.grad(loss)(jax.tree.map(jnp.asarray, jp))
    _, got = _torch_grads(params_from_jax(jp),
                          _tcfg(compute_dtype=torch.bfloat16, fast_train=fast_train,
                                hidden_dropout=0.0, attention_dropout=0.0),
                          ids, mask, probe, seed=0)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(got)
    checked = 0
    for path, w in flat:
        key = tuple(p.key if hasattr(p, "key") else p.idx for p in path)
        w = np.asarray(w, np.float32)
        g = got[key]
        if g is None:   # the pooler: not on the encode path
            assert not np.any(w)
            continue
        if "k_b" in key:
            continue
        err = np.abs(g.float().numpy() - w).max()
        assert err <= 0.015 * np.abs(w).max(), (key, err / np.abs(w).max())
        checked += 1
    assert checked >= 16
