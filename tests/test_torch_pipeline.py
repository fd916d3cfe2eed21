"""The port's GPipe pipeline (blp_tpu_torch/parallel/pipeline.py) on gloo
worlds of 2 and 4 CPU ranks — (data, pipe) meshes (1, 2) and (2, 2), 2 and
4 microbatches — against the TPU package's pipeline on a mesh of the same
shape, and against the port's one-rank step.

Against JAX: fp32, deterministic, JAX's negatives injected; the loss and
every gradient leaf within rtol 2e-5, atol 2e-6. Against the one-rank port:
with dropout ON the loss and gradients within the same tolerances (each
microbatch draws its rows of the one-device masks), and the whole train step
(sampler, Adam) — the loss and every parameter leaf after it. One world per
world size serves every case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from blp_tpu.data.sampling import sample_negative_indices
from blp_tpu.models import bert as j_bert
from blp_tpu.models import blp as j_blp
from blp_tpu.parallel import pipeline as j_pipe
from blp_tpu.parallel import train_parallel as j_tp
from blp_tpu_torch import training as t_training
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models import blp as t_blp
from blp_tpu_torch.parallel import pipeline as t_pipe

B, K, L, LAYERS = 16, 4, 16, 4
SHAPES = {2: [(1, 2)], 4: [(2, 2)]}
MICRO = (2, 4)
ALL = [(s, m) for shapes in SHAPES.values() for s in shapes for m in MICRO]
KEY = (11, 2)


def _jax_setup():
    cfg = j_blp.ModelConfig(
        model="blp", rel_model="transe", loss_fn="margin", dim=16,
        num_relations=4,
        encoder=j_bert.BertConfig.tiny(num_heads=4, num_layers=LAYERS))
    return cfg, j_blp.init_params(jax.random.key(0), cfg)


def _port_cfg(**kw):
    return t_blp.ModelConfig(
        model="blp", rel_model="transe", loss_fn="margin", dim=16,
        num_relations=4,
        encoder=t_bert.BertConfig.tiny(num_heads=4, num_layers=LAYERS, **kw))


def _batch():
    rng = np.random.default_rng(0)
    return {"text_tok": rng.integers(1, 128, (B, 2, L)).astype(np.int32),
            "text_mask": ((rng.random((B, 2, L)) < 0.9)
                          | (np.arange(L) == 0)).astype(np.float32),
            "rels": rng.integers(0, 4, (B,)).astype(np.int32)}


def _jax_pipeline(shape, micro):
    cfg, params = _jax_setup()
    key = jax.random.key(7)
    d, p = shape
    mesh = j_pipe.make_pipeline_mesh(d, p, devices=jax.devices()[:d * p])
    loss_fn = j_pipe.make_pipeline_loss(
        cfg, mesh=mesh, batch_size=B, num_negatives=K,
        num_microbatches=micro, deterministic=True)
    pp = j_pipe.shard_pipeline_params(params, mesh)
    b = j_tp.shard_batch({k: jnp.asarray(v) for k, v in _batch().items()}, mesh)
    loss, grads = jax.jit(jax.value_and_grad(lambda q: loss_fn(q, key, b)))(pp)
    neg = sample_negative_indices(jax.random.split(key)[0], B, K)
    return (float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)],
            np.asarray(neg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, jparams = _jax_setup()
    jp = jax.tree.map(np.asarray, jparams)
    jax_runs = {(s, m): _jax_pipeline(s, m) for s, m in ALL}
    out = {}
    for world, shapes in SHAPES.items():
        cases, keys = [], []
        for shape in shapes:
            for micro in MICRO:
                neg = jax_runs[(shape, micro)][2]
                base = dict(mesh=shape, params=jp, batch=_batch(), micro=micro)
                cases += [dict(base, cfg=_port_cfg(), neg=neg),
                          dict(base, cfg=_port_cfg(), neg=neg, dropout_seed=3),
                          dict(base, cfg=_port_cfg(), key=KEY, k=K)]
                keys.append((shape, micro))
        ranks = workers.run_world(workers.pipeline_runs, world,
                                  tmp_path_factory.mktemp(f"pp{world}"), cases)
        for i, key in enumerate(keys):
            out[key] = {"jax": jax_runs[key],
                        "exact": [r[3 * i] for r in ranks],
                        "dropout": [r[3 * i + 1] for r in ranks],
                        "step": [r[3 * i + 2] for r in ranks]}
    return out


def _close(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-6, err_msg=str(i))


@pytest.mark.parametrize("shape,micro", ALL)
def test_pipeline_loss_and_grads_match_jax(runs, shape, micro):
    loss, grads, _ = runs[(shape, micro)]["jax"]
    for rank in runs[(shape, micro)]["exact"]:
        assert rank["layers"][0] == LAYERS // shape[1]
        assert np.isclose(rank["loss"], loss, rtol=2e-5, atol=2e-6)
        _close(rank["grads"], grads)


def _one_rank(neg, dropout_seed):
    _, jparams = _jax_setup()
    params = t_training.unstack_params(
        t_blp.params_from_jax(jax.tree.map(np.asarray, jparams)))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    batch["neg_idx"] = torch.from_numpy(np.array(neg))
    loss, grads = t_training.value_and_grad(params, _port_cfg(), batch,
                                            dropout_seed=dropout_seed)
    return float(loss), workers.numpy_tree(t_training.restack_params(grads))


@pytest.mark.parametrize("shape,micro", ALL)
def test_pipeline_with_dropout_matches_one_rank_port(runs, shape, micro):
    loss, grads = _one_rank(runs[(shape, micro)]["jax"][2], dropout_seed=3)
    for rank in runs[(shape, micro)]["dropout"]:
        assert np.isclose(rank["loss"], loss, rtol=2e-5, atol=2e-6)
        _close(rank["grads"], grads)


@pytest.mark.parametrize("shape,micro", ALL)
def test_pipeline_train_step_matches_one_rank_step(runs, shape, micro):
    _, jparams = _jax_setup()
    params = t_training.unstack_params(
        t_blp.params_from_jax(jax.tree.map(np.asarray, jparams)))
    opt = t_training.make_optimizer(1e-3, 10, use_scheduler=False)
    step = t_training.make_train_step(_port_cfg(), opt, batch_size=B,
                                      num_negatives=K, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    p1, _, loss = step(params, opt.init(params), KEY, batch)
    want = workers.numpy_tree(t_training.restack_params(p1))
    for rank in runs[(shape, micro)]["step"]:
        assert np.isclose(rank["loss"], float(loss), rtol=1e-5)
        _close(rank["params"], want)


def test_pipeline_validates_model_and_layers():
    with pytest.raises(ValueError, match="not divisible"):
        t_pipe.check_config(_port_cfg(), 3)
    word = t_blp.ModelConfig(model="bert-bow", emb_dim=8, vocab_size=10)
    with pytest.raises(ValueError, match="model='blp'"):
        t_pipe.check_config(word, 2)
