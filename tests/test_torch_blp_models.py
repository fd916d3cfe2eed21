"""The four word-embedding models (bert-bow, bert-dkrl, glove-bow,
glove-dkrl) of the port's models/blp.py against the JAX package's, from the
same parameters (JAX's init_params through params_from_jax) on the same
numpy batches: `encode`, `train_loss` and every gradient leaf, under TransE
and DistMult, with the fused K3 scorer off and on. With sddmm_pallas=True
the JAX side runs its Pallas kernel in interpret mode (patched in at test
time), the port its plain version (CPU tensors).

Tolerances: encode rtol 1e-5 / atol 1e-6 (fp32, sums in another order);
loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6 (the word table's
gradient is an index backward that adds in another order).

Also: word-embedding injection, the stopword set, the word table loaders
of train.py, and init/encode/train_loss running for all six models."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu import train as j_train
from blp_tpu.config import ExperimentConfig as JConfig
from blp_tpu.models import blp as j_blp
from blp_tpu.ops import pallas_sddmm
from blp_tpu_torch import train as t_train
from blp_tpu_torch import training as t_training
from blp_tpu_torch.checkpoint import tree_leaves
from blp_tpu_torch.config import ExperimentConfig as TConfig
from blp_tpu_torch.data import sampling
from blp_tpu_torch.data.synth import write_synth_dataset, write_tiny_glove
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models import blp as t_blp

WORD_MODELS = ["bert-bow", "bert-dkrl", "glove-bow", "glove-dkrl"]
B, K, L, VOCAB, NUM_RELS = 8, 4, 8, 60, 3


@pytest.fixture
def interpret_sddmm(monkeypatch):
    """The JAX package's K3 in Pallas interpret mode (the CPU has no TPU)."""
    monkeypatch.setattr(pallas_sddmm, "sddmm_scores", functools.partial(
        pallas_sddmm.sddmm_scores, block_b=8, interpret=True))


def _configs(model, rel_model="transe", sddmm=False):
    kw = dict(model=model, rel_model=rel_model, loss_fn="margin", dim=12,
              num_relations=NUM_RELS, emb_dim=16, vocab_size=VOCAB,
              regularizer=1e-2, sddmm_pallas=sddmm)
    return j_blp.ModelConfig(**kw), t_blp.ModelConfig(**kw)


def _batch(seed):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 2 * B - 2, (B, K)).astype(np.int32)
    coin = rng.random((B, K)) < 0.5
    tok = rng.integers(1, VOCAB, (B, 2, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, (B, 2))
    mask = (np.arange(L) < lens[..., None]).astype(np.float32)
    return {"text_tok": tok * mask.astype(np.int32), "text_mask": mask,
            "rels": rng.integers(0, NUM_RELS, B).astype(np.int32),
            "neg_idx": sampling.corrupt_pairs(torch.from_numpy(r),
                                              torch.from_numpy(coin)).numpy()}


def _params(jcfg, seed=0):
    jp = jax.tree.map(np.asarray, j_blp.init_params(jax.random.key(seed), jcfg))
    return jp, t_blp.params_from_jax(jp)


@pytest.mark.parametrize("rel_model", ["transe", "distmult"])
@pytest.mark.parametrize("model", WORD_MODELS)
def test_encode_matches_jax(model, rel_model):
    jcfg, tcfg = _configs(model, rel_model)
    jp, tp = _params(jcfg)
    b = _batch(1)
    tok, mask = b["text_tok"][:, 0], b["text_mask"][:, 0]
    want = j_blp.encode(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(tok),
                        jnp.asarray(mask))
    got = t_blp.encode(t_blp.encode_view(tp, tcfg), tcfg, tok, mask, device="cpu")
    assert got.shape == (B, tcfg.entity_dim) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sddmm", [False, True])
@pytest.mark.parametrize("rel_model", ["transe", "distmult"])
@pytest.mark.parametrize("model", WORD_MODELS)
def test_train_loss_and_gradients_match_jax(model, rel_model, sddmm,
                                            interpret_sddmm):
    jcfg, tcfg = _configs(model, rel_model, sddmm)
    jp, tp = _params(jcfg, seed=2)
    b = _batch(3)
    want_loss, want_g = jax.value_and_grad(lambda p: j_blp.train_loss(
        p, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
        deterministic=False, rng=jax.random.key(0)))(jax.tree.map(jnp.asarray, jp))
    loss, grads = t_training.value_and_grad(
        tp, tcfg, {k: torch.from_numpy(v) for k, v in b.items()}, dropout_seed=0)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(want_g)[0]
    got = tree_leaves(grads)
    assert len(flat) == len(got)
    for (path, w), g in zip(flat, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    assert np.abs(np.asarray(want_g["word_emb"])).max() > 0   # the table learns


@pytest.mark.parametrize("model", ["blp", "transductive", *WORD_MODELS])
def test_init_encode_and_train_loss_run_for_every_model(model):
    kw = dict(model=model, dim=8, num_relations=2, num_entities=20,
              emb_dim=16, vocab_size=VOCAB)
    if model == "blp":
        kw["encoder"] = t_bert.BertConfig.tiny()
    cfg = t_blp.ModelConfig(**kw)
    p = t_blp.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    if model == "transductive":
        b = {"pos_pairs": torch.randint(0, 20, (B, 2)), "rels": b["rels"] % 2,
             "neg_idx": b["neg_idx"]}
        out = t_blp.encode_entity_ids(p, cfg, np.arange(5))
    else:
        b["rels"] = b["rels"] % 2
        out = t_blp.encode(t_blp.encode_view(p, cfg), cfg, b["text_tok"][:, 0],
                           b["text_mask"][:, 0], device="cpu")
    assert out.shape[1] == cfg.entity_dim and torch.isfinite(out).all()
    loss = t_blp.train_loss(p, cfg, b, dropout_seed=0)
    assert loss.dim() == 0 and torch.isfinite(loss)


def test_word_embedding_injection():
    _, tcfg = _configs("glove-dkrl")
    table = torch.randn((VOCAB + 7, 16))
    p = t_blp.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu",
                          word_embeddings=table.numpy())
    assert torch.equal(p["word_emb"], table)
    assert set(p["dkrl"]) == {"conv1_w", "conv1_b", "conv2_w", "conv2_b"}
    assert p["dkrl"]["conv1_w"].shape == (32, 12)
    with pytest.raises(ValueError, match="emb_dim"):
        t_blp.init_params(tcfg, torch.Generator(), device="cpu",
                          word_embeddings=torch.zeros((5, 15)))
    _, bow = _configs("bert-bow")
    p = t_blp.init_params(bow, torch.Generator().manual_seed(1), device="cpu")
    assert set(p) == {"rel_emb", "word_emb"} and p["rel_emb"].shape == (3, 16)
    assert 0.015 < p["word_emb"].std().item() < 0.025        # 0.02 * N(0, 1)
    with pytest.raises(ValueError, match="vocab_size"):
        t_blp.init_params(dataclasses.replace(bow, vocab_size=0),
                          torch.Generator(), device="cpu")


def test_stopword_models_match_jax():
    assert t_blp.DROP_STOPWORD_MODELS == j_blp.DROP_STOPWORD_MODELS


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("word_models")
    d = write_synth_dataset(str(root / "data" / "synth"), num_entities=40,
                            num_relations=4, num_triples=160, seed=3)
    write_tiny_glove(str(root / "glove"), f"{d}/vocab.txt", dim=300, seed=1)
    sd = {"embeddings.word_embeddings.weight": torch.randn((50, 768))}
    torch.save(sd, root / "hf.pt")
    return root


@pytest.mark.parametrize("model", ["glove-bow", "bert-dkrl", "bert-bow"])
def test_load_word_embeddings_matches_jax(model, data_dir):
    kw = dict(model=model, data_dir=str(data_dir / "data"), dataset="synth",
              glove_file=str(data_dir / "glove.pt"),
              hf_weights=str(data_dir / "hf.pt"))
    want = j_train.load_word_embeddings(JConfig(**kw), None)
    got = t_train.load_word_embeddings(TConfig(**kw))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if model.startswith("bert"):   # no local BERT weights: random init
        assert t_train.load_word_embeddings(TConfig(**{**kw, "hf_weights": None})) is None


@pytest.mark.parametrize("model,extra", [
    ("glove-bow", {}), ("bert-dkrl", {"encoder_name": "tiny"})])
def test_link_prediction_runs_a_word_model(model, extra, data_dir, capsys):
    out = data_dir / f"out-{model}"
    args = dict(dataset="synth", data_dir=str(data_dir / "data"), model=model,
                glove_file=str(data_dir / "glove.pt"), dim=8, max_len=8,
                num_negatives=4, batch_size=16, emb_batch_size=16,
                eval_batch_size=8, lr=1e-3, tile=16, max_epochs=1,
                out_dir=str(out), run_id="w", device="cpu", **extra)
    assert t_train.main(["link_prediction", "with"]
                        + [f"{k}={v}" for k, v in args.items()]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(res["test_mrr_filt"])
    emb = np.load(out / "ent_emb-w.npz")["ent_emb"]
    assert emb.shape[1] == (300 if model == "glove-bow" else 8)
    # The description cache was built with stopwords dropped.
    assert list((data_dir / "data" / "synth").glob("text_8_1_*.npz"))
