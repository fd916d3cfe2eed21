"""The port's optimizer, schedule and training step (blp_tpu_torch/
training.py, models/blp.py::train_loss) against the JAX package's
(blp_tpu/training.py, optax) on the same numpy inputs and weights.

- the schedule: equal at every step;
- Adam: equal to optax.adam(..., eps=1e-8) on identical gradients within
  atol 1e-7 (f32; the same formula, one ulp of the bias corrections apart);
- trajectories of the tiny BLP-TransE, of bert-dkrl and glove-bow, and of
  the transductive model (fp32, dropout 0, injected negatives, constant lr): the first loss within rtol 1e-6, later ones within 1e-4
  (Adam turns the last-bit differences of near-zero gradients into
  lr-sized steps, so raw parameters are not compared after several steps);
- bf16: one loss within 2e-2 relative (bf16 GEMMs round before the bias
  add here, after it in JAX).

With sddmm_pallas=True the JAX side runs its Pallas kernel in interpret
mode, as tests/test_pallas_sddmm.py does (patched in here at test time)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blp_tpu import training as j_training
from blp_tpu.models import bert as j_bert
from blp_tpu.models import blp as j_blp
from blp_tpu.ops import pallas_sddmm
from blp_tpu_torch import checkpoint as t_ckpt
from blp_tpu_torch import training as t_training
from blp_tpu_torch.data import sampling
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models import blp as t_blp

B, K, L, NUM_RELS, NUM_ENTS = 8, 4, 8, 3, 40


@pytest.mark.parametrize("total_steps", [1, 5, 10])
def test_linear_warmup_schedule_equals_jax(total_steps):
    want = j_training.linear_warmup_schedule(2e-5, total_steps)
    got = t_training.linear_warmup_schedule(2e-5, total_steps)
    for step in range(total_steps + 1):
        w = np.asarray(want(step))
        g = got(torch.tensor(step, dtype=torch.int32))
        assert g.dtype == torch.float32
        assert g.item() == w.item(), step
    assert got(0).item() == 0.0 or int(0.2 * total_steps) == 0


def _tree(rng):
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32),
                  "d": (rng.standard_normal((3,)).astype(np.float32),)}}


@pytest.mark.parametrize("opt_kw", [dict(use_scheduler=True),
                                    dict(use_scheduler=False),
                                    dict(use_scheduler=True, bf16_mu=True)])
def test_adam_equals_optax_on_identical_gradients(opt_kw):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    j_opt = j_training.make_optimizer(1e-2, 10, **opt_kw)
    t_opt = t_training.make_optimizer(1e-2, 10, **opt_kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = t_blp.params_from_jax(params)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    assert len(jax.tree.leaves(js)) == len(t_ckpt.tree_leaves(ts))
    for _ in range(5):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                         params)
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = t_opt.update(t_blp.params_from_jax(g), ts, tp)
        tp = t_training.apply_updates(tp, tu)
        for w, x in zip(jax.tree.leaves(jp), t_ckpt.tree_leaves(tp)):
            np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=0, atol=1e-7)
    for w, x in zip(jax.tree.leaves(js), t_ckpt.tree_leaves(ts)):
        assert x.dtype == {"float32": torch.float32, "int32": torch.int32,
                           "bfloat16": torch.bfloat16}[str(w.dtype)]
        np.testing.assert_allclose(x.float().numpy(), np.asarray(w, np.float32),
                                   rtol=0, atol=1e-7)


def test_first_warmup_step_moves_nothing():
    tp = t_blp.params_from_jax(_tree(np.random.default_rng(1)))
    opt = t_training.make_optimizer(1e-2, 10)
    grads = jax.tree.map(np.ones_like, _tree(np.random.default_rng(1)))
    upd, _ = opt.update(t_blp.params_from_jax(grads), opt.init(tp), tp)
    assert all(not u.any() for u in t_ckpt.tree_leaves(upd))


def _configs(model, sddmm, dtype="f32"):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    kw = dict(model=model, rel_model="transe", loss_fn="margin", dim=16,
              num_relations=NUM_RELS, num_entities=NUM_ENTS, sddmm_pallas=sddmm,
              emb_dim=24, vocab_size=128)
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    if model == "blp":
        return (j_blp.ModelConfig(**kw, encoder=j_bert.BertConfig.tiny(
                    compute_dtype=jdt, **enc)),
                t_blp.ModelConfig(**kw, encoder=t_bert.BertConfig.tiny(
                    compute_dtype=tdt, **enc)))
    return j_blp.ModelConfig(**kw), t_blp.ModelConfig(**kw)


def _batches(model, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.integers(0, 2 * B - 2, (B, K)).astype(np.int32)
        coin = rng.random((B, K)) < 0.5
        b = {"rels": rng.integers(0, NUM_RELS, B).astype(np.int32),
             "neg_idx": sampling.corrupt_pairs(torch.from_numpy(r),
                                               torch.from_numpy(coin)).numpy()}
        if model != "transductive":
            b["text_tok"] = rng.integers(1, 128, (B, 2, L)).astype(np.int32)
            lens = rng.integers(2, L + 1, (B, 2))
            b["text_mask"] = (np.arange(L) < lens[..., None]).astype(np.float32)
        else:
            b["pos_pairs"] = rng.integers(0, NUM_ENTS, (B, 2)).astype(np.int32)
        out.append(b)
    return out


@pytest.fixture
def interpret_sddmm(monkeypatch):
    """The JAX package's K3 in Pallas interpret mode (the CPU has no TPU)."""
    monkeypatch.setattr(pallas_sddmm, "sddmm_scores", functools.partial(
        pallas_sddmm.sddmm_scores, block_b=8, interpret=True))


def _trajectories(model, sddmm, steps, dtype="f32"):
    jcfg, tcfg = _configs(model, sddmm, dtype)
    jp = j_training.unstack_params(j_blp.init_params(jax.random.key(3), jcfg))
    tp = t_blp.params_from_jax(jax.tree.map(np.asarray, jp))
    j_opt = j_training.make_optimizer(5e-3, 100, use_scheduler=False)
    t_opt = t_training.make_optimizer(5e-3, 100, use_scheduler=False)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    j_grad = jax.jit(jax.value_and_grad(lambda p, b: j_blp.train_loss(
        p, jcfg, b, deterministic=False, rng=jax.random.key(0))))
    j_losses, t_losses = [], []
    for b in _batches(model, steps, seed=5):
        loss, g = j_grad(jp, {k: jnp.asarray(v) for k, v in b.items()})
        u, js = j_opt.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        j_losses.append(float(loss))
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        loss, g = t_training.value_and_grad(tp, tcfg, tb, dropout_seed=0)
        u, ts = t_opt.update(g, ts, tp)
        tp = t_training.apply_updates(tp, u)
        t_losses.append(loss.item())
    return np.asarray(j_losses), np.asarray(t_losses)


@pytest.mark.parametrize("model,sddmm", [("blp", False), ("blp", True),
                                         ("transductive", False),
                                         ("transductive", True),
                                         ("bert-dkrl", False), ("bert-dkrl", True),
                                         ("glove-bow", False), ("glove-bow", True)])
def test_five_step_trajectory_matches_jax(model, sddmm, interpret_sddmm):
    want, got = _trajectories(model, sddmm, 5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-4)
    assert not np.allclose(want[0], want[-1])   # the weights did move


def test_bf16_step_loss_within_bf16_noise(interpret_sddmm):
    want, got = _trajectories("blp", True, 1, dtype="bf16")
    np.testing.assert_allclose(got, want, rtol=2e-2)


def test_make_train_step_is_sampler_plus_update():
    _, tcfg = _configs("blp", True)
    params = t_training.unstack_params(t_blp.init_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    opt = t_training.make_optimizer(1e-3, 10)
    b = {k: torch.from_numpy(v) for k, v in _batches("blp", 1, 7)[0].items()
         if k != "neg_idx"}
    step = t_training.make_train_step(tcfg, opt, batch_size=B, num_negatives=K,
                                      device="cpu")
    p1, s1, loss1 = step(params, opt.init(params), (4, 2), b)
    # The same step by hand: the sampler from the step's seed, then Adam.
    neg_seed, drop_seed = t_training.step_seeds((4, 2))
    neg = sampling.sample_negative_indices(
        torch.Generator().manual_seed(neg_seed), B, K, device="cpu")
    loss2, g = t_training.value_and_grad(params, tcfg, {**b, "neg_idx": neg},
                                         dropout_seed=drop_seed)
    u, s2 = opt.update(g, opt.init(params), params)
    p2 = t_training.apply_updates(params, u)
    assert loss1.dim() == 0 and torch.equal(loss1, loss2)
    for x, y in zip(t_ckpt.tree_leaves((p1, s1)), t_ckpt.tree_leaves((p2, s2))):
        assert torch.equal(x, y)


def test_opt_state_restack_roundtrip_and_leaf_order_matches_optax():
    jcfg, tcfg = _configs("blp", False)
    jp = j_blp.init_params(jax.random.key(1), jcfg)
    j_state = j_training.make_optimizer(1e-3, 10).init(jp)
    tp = t_blp.params_from_jax(jax.tree.map(np.asarray, jp))
    opt = t_training.make_optimizer(1e-3, 10)
    t_state = opt.init(tp)
    jl, tl = jax.tree.leaves((jp, j_state)), t_ckpt.tree_leaves((tp, t_state))
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
    unstacked = t_training.unstack_opt_state(t_state)
    assert isinstance(unstacked[0][1]["bert"]["layers"], tuple)
    back = t_training.restack_opt_state(unstacked)
    for x, y in zip(t_ckpt.tree_leaves(t_state), t_ckpt.tree_leaves(back)):
        assert torch.equal(x, y)
