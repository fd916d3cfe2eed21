"""The port's data- and tensor-parallel train step
(blp_tpu_torch/parallel/{comm,mesh,train_parallel}.py) on gloo worlds of 2
and 4 CPU ranks, against the TPU package's `make_parallel_train_step` on a
mesh of the same shape (the first D x M of the 8 virtual CPU devices), and
against the port's own one-rank step.

The same numpy weights and batch go to both packages (`params_from_jax`).
Against JAX: fp32, dropout 0, JAX's negatives injected into the port; the
step's loss within rtol 1e-5 and every leaf of the gradient Adam is handed
within rtol 2e-5, atol 2e-6 (tests/test_parallel.py:58-62) — among them
`rel_emb` (read after the gather over "data", not summed) and BERT layer
weights (summed over "data"), and the same against the one-rank port. The
parameters after that step are not compared: Adam's first step maps a
gradient difference d at |g| near eps = 1e-8 to lr·d·eps/(|g| + eps)², so
one element of v_w (|g| = 1.2e-8) lands 6.5e-6 apart between the two
packages already on one device, and 8.8e-6 between the port's one-rank and
tensor-parallel sums (tests/test_torch_training.py compares losses for the
same reason). Against the one-rank port, the whole step with dropout ON
(the sampler, K3 on the global batch, the ranks drawing their slices of the
one-device masks): the loss, and every parameter leaf after the Adam step.
One world per world size serves every case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from blp_tpu import training as j_training
from blp_tpu.data.sampling import sample_negative_indices
from blp_tpu.models import bert as j_bert
from blp_tpu.models import blp as j_blp
from blp_tpu.parallel import mesh as j_mesh
from blp_tpu.parallel import train_parallel as j_tp
from blp_tpu_torch import training as t_training
from blp_tpu_torch.checkpoint import tree_leaves
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models import blp as t_blp
from blp_tpu_torch.parallel import mesh as t_mesh

B, K, L = 16, 8, 16
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
KEY = (5, 3)          # the port's step key: (seed, global step)


def _jax_model():
    enc = j_bert.BertConfig.tiny(num_heads=4, hidden_dropout=0.0,
                                 attention_dropout=0.0)
    cfg = j_blp.ModelConfig(model="blp", rel_model="transe", loss_fn="margin",
                            dim=16, num_relations=3, encoder=enc)
    return cfg, j_blp.init_params(jax.random.key(0), cfg)


def _port_cfg(dropout: float, sddmm: bool):
    enc = t_bert.BertConfig.tiny(num_heads=4, hidden_dropout=dropout,
                                 attention_dropout=dropout)
    return t_blp.ModelConfig(model="blp", rel_model="transe", loss_fn="margin",
                             dim=16, num_relations=3, encoder=enc,
                             sddmm_pallas=sddmm)


def _batch():
    rng = np.random.default_rng(0)
    return {"text_tok": rng.integers(1, 128, size=(B, 2, L)).astype(np.int32),
            "text_mask": ((rng.random((B, 2, L)) < 0.9)
                          | (np.arange(L) == 0)).astype(np.float32),
            "rels": rng.integers(0, 3, size=(B,)).astype(np.int32)}


def _jax_step(shape):
    """JAX's parallel step on a mesh of `shape`: (loss, params, grads, neg)."""
    cfg, params = _jax_model()
    opt = j_training.make_optimizer(1e-3, 10, use_scheduler=False)
    key = jax.random.key(42)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    neg = sample_negative_indices(jax.random.split(key)[0], B, K)

    def loss_fn(p):
        return j_blp.train_loss(p, cfg, {**batch, "neg_idx": neg},
                                deterministic=True)

    grads = jax.grad(loss_fn)(params)
    d, m = shape
    mesh = j_mesh.make_mesh(d, m, devices=jax.devices()[:d * m])
    pp, ss, _ = j_tp.init_parallel_state(params, opt, mesh,
                                         tensor_parallel=m > 1)
    step = j_tp.make_parallel_train_step(cfg, opt, batch_size=B, num_negatives=K)
    p1, _, loss = step(pp, ss, key, j_tp.shard_batch(batch, mesh))
    return (float(loss), [np.asarray(x) for x in jax.tree.leaves(p1)],
            [np.asarray(x) for x in jax.tree.leaves(grads)], np.asarray(neg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of every world, run once: {(D, M): {"jax": ..., "dropout":
    ...}} with the ranks' results."""
    _, jparams = _jax_model()
    jnp_params = jax.tree.map(np.asarray, jparams)
    out = {}
    jax_runs = {shape: _jax_step(shape) for shapes in MESHES.values()
                for shape in shapes}
    for world, shapes in MESHES.items():
        cases = []
        for shape in shapes:
            cases.append(dict(mesh=shape, cfg=_port_cfg(0.0, False),
                              params=jnp_params, batch=_batch(),
                              neg=jax_runs[shape][3]))
            cases.append(dict(mesh=shape, cfg=_port_cfg(0.1, True),
                              params=jnp_params, batch=_batch(), key=KEY, k=K))
        ranks = workers.run_world(workers.parallel_steps, world,
                                  tmp_path_factory.mktemp(f"w{world}"), cases)
        for i, shape in enumerate(shapes):
            out[shape] = {"jax": jax_runs[shape],
                          "exact": [r[2 * i] for r in ranks],
                          "dropout": [r[2 * i + 1] for r in ranks]}
    return out


ALL = [s for shapes in MESHES.values() for s in shapes]


def _close(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6, err_msg=str(i))


@pytest.mark.parametrize("shape", ALL)
def test_parallel_step_matches_jax(runs, shape):
    loss, _, grads, _ = runs[shape]["jax"]
    for rank in runs[shape]["exact"]:
        assert np.isclose(rank["loss"], loss, rtol=1e-5)
        _close(rank["grads"], grads)


@pytest.mark.parametrize("shape", ALL)
def test_gradients_of_rel_emb_and_a_layer_weight_match_jax(runs, shape):
    _, jparams = _jax_model()
    names = [".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(jparams)]
    _, _, grads, _ = runs[shape]["jax"]
    for rank in runs[shape]["exact"]:
        for name in ("rel_emb", "bert.layers.q_w", "bert.layers.ffn_out_w",
                     "proj"):
            i = names.index(name)
            assert np.abs(grads[i]).max() > 0, name
            np.testing.assert_allclose(rank["grads"][i], grads[i], rtol=2e-5,
                                       atol=2e-6, err_msg=name)


@pytest.mark.parametrize("shape", ALL)
def test_parallel_gradients_match_one_rank_port(runs, shape):
    """The JAX comparison's step (dropout 0, JAX's negatives) on one rank of
    the port: the same loss and gradients at JAX's tolerance."""
    cfg = _port_cfg(0.0, False)
    _, jparams = _jax_model()
    params = t_training.unstack_params(
        t_blp.params_from_jax(jax.tree.map(np.asarray, jparams)))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["neg_idx"] = torch.from_numpy(np.array(runs[shape]["jax"][3]))
    loss, grads = t_training.value_and_grad(params, cfg, batch, dropout_seed=0)
    want = workers.numpy_tree(t_training.restack_params(grads))
    for rank in runs[shape]["exact"]:
        assert np.isclose(rank["loss"], float(loss), rtol=1e-5)
        _close(rank["grads"], want)


def _one_rank_port_step():
    cfg = _port_cfg(0.1, True)
    _, jparams = _jax_model()
    params = t_training.unstack_params(
        t_blp.params_from_jax(jax.tree.map(np.asarray, jparams)))
    opt = t_training.make_optimizer(1e-3, 10, use_scheduler=False)
    step = t_training.make_train_step(cfg, opt, batch_size=B, num_negatives=K,
                                      device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    p1, _, loss = step(params, opt.init(params), KEY, batch)
    return float(loss), workers.numpy_tree(t_training.restack_params(p1))


@pytest.mark.parametrize("shape", ALL)
def test_parallel_step_matches_one_rank_port_with_dropout(runs, shape):
    loss, params = _one_rank_port_step()
    for rank in runs[shape]["dropout"]:
        assert np.isclose(rank["loss"], loss, rtol=1e-5)
        _close(rank["params"], params)
    # every rank holds the same loss
    assert len({r["loss"] for r in runs[shape]["dropout"]}) == 1


@pytest.mark.parametrize("shape", ALL)
def test_tp_params_actually_sharded(runs, shape):
    d, m = shape
    h, i = 32, 64          # BertConfig.tiny's hidden and FFN widths
    for rank in runs[shape]["exact"]:
        s = rank["shapes"]
        assert s["q_w"] == (h, h // m) and s["q_b"] == (h // m,)
        assert s["ffn_in_w"] == (h, i // m)
        assert s["attn_out_w"] == (h // m, h) and s["ffn_out_w"] == (i // m, h)
        assert s["attn_out_b"] == (h,) and s["ffn_ln_scale"] == (h,)


@pytest.mark.parametrize("stacked", [True, False])
def test_split_rules_follow_jax_specs(stacked):
    """The slicing rule is the TPU package's _BERT_TP_SPECS on both layer
    layouts and on an optimizer state holding the tree."""
    cfg = _port_cfg(0.0, False)
    params = t_blp.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if not stacked:
        params = t_training.unstack_params(params)
    opt_state = t_training.make_optimizer(1e-3, 10).init(params)
    for tree in (params, opt_state):
        part = t_mesh.shard_tree(tree, 2, 1, t_mesh.tp_split)
        whole = {id(x) for x in tree_leaves(tree)}
        for spec_key, spec in j_mesh._BERT_TP_SPECS.items():
            axes = [i for i, a in enumerate(spec) if a == "model"]
            dim = None if not axes else axes[0] - len(spec)
            assert t_mesh.TP_SPLIT.get(spec_key) == dim, spec_key
        for a, b in zip(tree_leaves(tree), tree_leaves(part)):
            if a.shape != b.shape:
                assert id(b) not in whole and b.is_contiguous()
    with pytest.raises(ValueError, match="stacked"):
        if not stacked:
            t_mesh.shard_tree(params, 2, 0, t_mesh.pipe_split)
        else:
            raise ValueError("stacked")


def test_mesh_size_must_equal_world_size():
    with pytest.raises(ValueError, match=r"\(2 ranks\) != world size 1"):
        t_mesh.make_mesh(2, 1)
