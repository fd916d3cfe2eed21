"""The string `remat` policies of the port's BERT training pass
(blp_tpu_torch/models/bert.py): "dots" saves the matmul outputs, "names"
saves only the tensors tagged q, k, v, ctx and ffn_pre, as the TPU package's
`dots_saveable` and `save_only_these_names` do.

A policy changes what the backward keeps, never a value: with dropout on,
the gradients equal remat=False bit for bit (one CPU thread, so the index
backward adds in one order), in fp32 and in bf16 with 8-bit masks, on both
layer layouts. At dropout 0 they are held to JAX's gradients under the same
policy (fp32: rtol 1e-4, atol 1e-6, as tests/test_torch_dropout.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from blp_tpu.models import bert as j_bert
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models.blp import params_from_jax

TINY = dict(vocab_size=128, hidden_size=32, num_layers=3, num_heads=4,
            intermediate_size=64, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=0):
    jcfg = j_bert.BertConfig(**TINY)
    jp = jax.tree.map(np.asarray, j_bert.init_bert_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 128, (8, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < rng.integers(2, 17, 8)[:, None]).astype(np.float32)
    probe = rng.standard_normal((8, 16, TINY["hidden_size"])).astype(np.float32)
    return jcfg, jp, ids, mask, probe


def _grads(tp, cfg, ids, mask, probe, seed):
    live = {}

    def req(tree, path=()):
        if isinstance(tree, dict):
            return {k: req(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(req(v, path + (i,)) for i, v in enumerate(tree))
        t = tree.clone().requires_grad_()
        live[path] = t
        return t

    out = t_bert.bert_encode(req(tp), torch.from_numpy(ids),
                             torch.from_numpy(mask), cfg, deterministic=False,
                             dropout_seed=seed)
    (out.float() * torch.from_numpy(probe)).mean().backward()
    return out.detach(), {k: v.grad for k, v in live.items()}


@pytest.mark.parametrize("layout", ["unstacked", "stacked"])
@pytest.mark.parametrize("dtype,nbits", [("f32", 32), ("bf16", 8)])
@pytest.mark.parametrize("remat", ["dots", "names"])
def test_policy_gradients_equal_no_remat_with_dropout(remat, dtype, nbits, layout):
    _, jp, ids, mask, probe = _setup(1)
    tree = j_bert.unstack_layers(jp) if layout == "unstacked" else jp
    tp = params_from_jax(tree)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    base = t_bert.BertConfig(**TINY, compute_dtype=dt, dropout_bits=nbits)
    out0, g0 = _grads(tp, base, ids, mask, probe, seed=7)
    out1, g1 = _grads(tp, dataclasses.replace(base, remat=remat), ids, mask,
                      probe, seed=7)
    assert torch.equal(out0, out1)
    checked = 0
    for k in g0:
        if g0[k] is None:    # the pooler: not on the encode path
            assert g1[k] is None and k[0] == "pooler"
            continue
        assert torch.equal(g0[k], g1[k]), k
        checked += 1
    assert checked >= 16
    # Dropout is on: another seed gives another output.
    out2, _ = _grads(tp, base, ids, mask, probe, seed=8)
    assert not torch.equal(out0, out2)


@pytest.mark.parametrize("remat", ["dots", "names"])
def test_policy_gradients_match_jax_at_dropout_zero(remat):
    jcfg, jp, ids, mask, probe = _setup(2)
    jcfg = dataclasses.replace(jcfg, hidden_dropout=0.0, attention_dropout=0.0,
                               remat=remat)

    def loss(p):
        out = j_bert.bert_encode(p, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                 deterministic=False,
                                 dropout_rng=jax.random.key(0))
        return jnp.mean(out * probe)

    want = jax.grad(loss)(jax.tree.map(jnp.asarray, jp))
    tcfg = t_bert.BertConfig(**TINY, hidden_dropout=0.0, attention_dropout=0.0,
                             remat=remat)
    _, got = _grads(params_from_jax(jp), tcfg, ids, mask, probe, seed=3)
    for name in ("q_w", "k_b", "v_w", "attn_out_w", "ffn_in_w", "ffn_out_b",
                 "ffn_ln_scale"):
        np.testing.assert_allclose(got[("layers", name)].numpy(),
                                   np.asarray(want["layers"][name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got[("embeddings", "word")].numpy(),
                               np.asarray(want["embeddings"]["word"]),
                               rtol=1e-4, atol=1e-6)


def test_policies_pick_what_jax_saves():
    """"dots" saves every matmul torch.matmul lowers to and recomputes the
    rest; "names" saves only the tag op, which the layer applies to exactly
    q, k, v, ctx and ffn_pre."""
    cases = {"dots": [torch.ops.aten.mm.default, torch.ops.aten.bmm.default],
             "names": [torch.ops.blp_tpu_torch.checkpoint_name.default]}
    others = [torch.ops.aten.add.Tensor, torch.ops.aten.gelu.default,
              torch.ops.aten._softmax.default, torch.ops.aten.rand.default]
    for name, saved in cases.items():
        fwd_ctx, _ = t_bert._REMAT_POLICIES[name]()
        policy = fwd_ctx.policy_fn
        for op in saved:
            assert policy(None, op) == CheckpointPolicy.MUST_SAVE, (name, op)
        for op in others + cases["names" if name == "dots" else "dots"]:
            assert policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE, (name, op)

    tags = []

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == torch.ops.blp_tpu_torch.checkpoint_name.default:
                tags.append(args[1])
            return func(*args, **(kwargs or {}))

    _, jp, ids, mask, probe = _setup(3)
    cfg = t_bert.BertConfig(**TINY, remat="names")
    with Count():
        t_bert.bert_encode(params_from_jax(jp), torch.from_numpy(ids),
                           torch.from_numpy(mask), cfg, deterministic=False,
                           dropout_seed=1)
    assert tags == ["q", "k", "v", "ctx", "ffn_pre"] * TINY["num_layers"]


@pytest.mark.parametrize("remat,want", [(False, 0), (True, 3), (2, 2),
                                        ("dots", 3), ("names", 3)])
def test_remat_layer_count_follows_jax(remat, want):
    """JAX's remat_k rule: an int k checkpoints the first k layers, True and
    the policy strings every layer."""
    assert t_bert._remat_layers(t_bert.BertConfig(**TINY, remat=remat)) == want
