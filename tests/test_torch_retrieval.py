"""The port's IR reranker (blp_tpu_torch/retrieval.py) against the JAX
package's (blp_tpu/retrieval.py): trec_eval-style NDCG equal on random runs
and on the hand-computed cases of tests/test_retrieval.py; `rerank_queries`
equal; and `rerank` end to end with model=bert-dkrl on a checkpoint the JAX
package wrote, on a small DBpedia-Entity-style dataset: the same ranking in
the run file, scores within 1e-5, NDCG and p-values within 1e-6."""

import json
import shutil

import jax
import numpy as np
import pytest

from blp_tpu import checkpoint as j_ckpt
from blp_tpu import retrieval as j_ret
from blp_tpu.models import blp as j_blp
from blp_tpu_torch import retrieval as t_ret


def test_ndcg_hand_computed():
    qrel = {"a": 3, "b": 2, "c": 0, "d": 1}
    run = {"a": 0.9, "c": 0.5, "b": 0.4}
    num = 3 / np.log2(2) + 0 / np.log2(3) + 2 / np.log2(4)
    ideal = 3 / np.log2(2) + 2 / np.log2(3) + 1 / np.log2(4)
    assert np.isclose(t_ret.ndcg_at_k(run, qrel, 10), num / ideal)
    assert np.isclose(t_ret.ndcg_at_k({"a": 1.0, "b": 0.5}, {"a": 2, "b": 1}, 10), 1.0)
    assert t_ret.ndcg_at_k({"a": 1.0}, {}, 10) == 0.0
    assert t_ret.ndcg_at_k({"x": 0.9, "y": 0.8, "a": 0.7, "b": 0.6},
                           {"a": 1, "b": 1}, 2) == 0.0
    assert t_ret.mean_ndcg({}, {}, 10) == 0.0


def test_ndcg_equals_jax_on_random_runs():
    rng = np.random.default_rng(0)
    docs = [f"d{i}" for i in range(40)]
    runs, qrels = {}, {}
    for q in range(25):
        n = int(rng.integers(1, 40))
        picked = rng.choice(docs, n, replace=False)
        runs[f"q{q}"] = {d: float(s) for d, s in zip(picked, rng.standard_normal(n))}
        qrels[f"q{q}"] = {d: int(r) for d, r in zip(docs, rng.integers(0, 4, 40)) if r}
        for k in (1, 5, 10, 100):
            assert t_ret.ndcg_at_k(runs[f"q{q}"], qrels[f"q{q}"], k) == \
                j_ret.ndcg_at_k(runs[f"q{q}"], qrels[f"q{q}"], k)
    for k in (10, 100):
        assert t_ret.mean_ndcg(runs, qrels, k) == j_ret.mean_ndcg(runs, qrels, k)


def test_rerank_queries_equals_jax_and_alpha_zero_is_baseline():
    rng = np.random.default_rng(1)
    ents = [f"e{i}" for i in range(30)]
    entity2idx = {e: i for i, e in enumerate(ents[:25])}   # 5 without text
    embs = t_ret._normalize(rng.standard_normal((25, 6)).astype(np.float32))
    baseline = {f"q{q}": {e: float(s) for e, s in
                          zip(rng.choice(ents, 12, replace=False),
                              rng.uniform(0, 20, 12))} for q in range(4)}
    query_embs = {q: t_ret._normalize(rng.standard_normal(6).astype(np.float32))
                  for q in baseline}
    queries = ["q0", "q2", "q3", "missing"]
    for alpha in (0.0, 0.3, 1.0):
        got = t_ret.rerank_queries(queries, baseline, query_embs, entity2idx,
                                   embs, alpha)
        want = j_ret.rerank_queries(queries, baseline, query_embs, entity2idx,
                                    embs, alpha)
        assert got == want and list(got) == list(want)
    assert t_ret.rerank_queries(["q1"], baseline, query_embs, entity2idx, embs,
                                0.0) == {"q1": baseline["q1"]}


@pytest.fixture(scope="module")
def ir_data(tmp_path_factory):
    """A small DBpedia-Entity-style setup: 60 entities with descriptions
    (some with stopwords), 12 queries of 20 BM25-ranked candidates each
    (a few candidates without a description), 3 folds, graded qrels; and a
    bert-dkrl checkpoint written by the JAX package."""
    root = tmp_path_factory.mktemp("ir")
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
             "theta", "iota", "kappa", "the", "of", "and"]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    ents = [f"<dbpedia:E{i}>" for i in range(64)]
    with open(root / "descriptions.txt", "w") as f:
        for e in ents[:60]:
            f.write(f"{e}\t{' '.join(rng.choice(words, size=int(rng.integers(3, 12))))}\n")
    qids = [f"Q{i}" for i in range(12)]
    with open(root / "queries.txt", "w") as f:
        for q in qids:
            f.write(f"{q}\t{' '.join(rng.choice(words, size=3))}\n")
    with open(root / "baseline.run", "w") as f:
        for q in qids:
            for rank, ei in enumerate(rng.permutation(64)[:20]):
                f.write(f"{q} Q0 {ents[ei]} {rank + 1} {20 - rank + rng.random():.4f} bm25\n")
    with open(root / "qrels.txt", "w") as f:
        for q in qids:
            for ei in rng.permutation(64)[:6]:
                f.write(f"{q} 0 {ents[ei]} {int(rng.integers(0, 3))}\n")
    folds = {str(i): {"training": [q for j, q in enumerate(qids) if j % 3 != i],
                      "testing": [q for j, q in enumerate(qids) if j % 3 == i]}
             for i in range(3)}
    (root / "folds.json").write_text(json.dumps(folds))

    cfg = j_blp.ModelConfig(model="bert-dkrl", rel_model="transe", dim=16,
                            num_relations=1, emb_dim=32, vocab_size=len(vocab))
    params = j_blp.init_params(jax.random.key(7), cfg)
    for side in ("jax", "port"):   # one copy each: the embedding cache sits beside it
        (root / side).mkdir()
        j_ckpt.save_pytree(str(root / side / "model.npz"),
                           jax.tree.map(np.asarray, params), {"epoch": 1})
    return root


def _cfg(module, root, side):
    kw = dict(model="bert-dkrl", rel_model="transe", dim=16, max_len=8,
              emb_batch_size=16, encoder_name="tiny",
              checkpoint=str(root / side / "model.npz"),
              run_file=str(root / "baseline.run"),
              queries_file=str(root / "queries.txt"),
              descriptions_file=str(root / "descriptions.txt"),
              qrels_file=str(root / "qrels.txt"),
              folds_file=str(root / "folds.json"),
              vocab_file=str(root / "vocab.txt"),
              out_dir=str(root / side / "out"), run_id="r", num_alphas=7)
    return module.RetrievalConfig(**kw, **({} if side == "jax" else {"device": "cpu"}))


def _run_file(path):
    rows = [line.split() for line in open(path)]
    return [(q, e, int(r)) for q, _, e, r, _, _ in rows], \
        np.array([float(s) for *_, s, _ in rows])


def test_rerank_end_to_end_matches_jax(ir_data):
    want = j_ret.rerank(_cfg(j_ret, ir_data, "jax"))
    got = t_ret.rerank(_cfg(t_ret, ir_data, "port"))
    for k in (10, 100):
        for key in (f"ndcg@{k}_baseline", f"ndcg@{k}", f"ndcg@{k}_pvalue"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                       err_msg=key)
    ranking, scores = _run_file(got["run_file"])
    want_ranking, want_scores = _run_file(want["run_file"])
    assert ranking == want_ranking and len(ranking) == 12 * 20
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-5)
    assert set(got["seconds"]) == {"load_s", "embed_entities_s",
                                   "embed_queries_s", "sweep_s", "metrics_s"}
    # The entity embeddings equal the JAX package's (its cache file).
    np.testing.assert_allclose(
        np.load(ir_data / "port" / "baseline-qent-model.npz.npz")["embs"],
        np.load(ir_data / "jax" / "baseline-qent-model.npz.npz")["embs"],
        rtol=1e-5, atol=1e-6)


def test_cli_runs_and_reuses_the_embedding_cache(ir_data, capsys):
    side = ir_data / "cli"
    side.mkdir()
    shutil.copy(ir_data / "port" / "model.npz", side / "model.npz")
    cfg = _cfg(t_ret, ir_data, "cli")
    argv = ["with"] + [f"{k}={v}" for k, v in vars(cfg).items() if v is not None]
    assert t_ret.main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (side / "baseline-qent-model.npz.npz").exists()
    assert t_ret.main(argv) == 0       # second run loads the cache
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["ndcg@10"] == second["ndcg@10"]
    with pytest.raises(ValueError, match="Unknown config key"):
        t_ret.main(["with", "nope=1"])
