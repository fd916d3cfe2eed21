"""Entity-retrieval reranking with a frozen BLP encoder.

Port of blp_tpu/retrieval.py, the DBpedia-Entity pipeline: encode the
candidate entities' descriptions with a frozen link-prediction encoder
(relation table dropped), embed each query, rerank a BM25F baseline run by
interpolating cosine similarity with the baseline score (alpha * s_blp +
(1 - alpha) * s_bm25), sweep alpha per fold for the best NDCG@100 on the
training queries, report NDCG@10/@100 against the baseline with a paired
t-test (`scipy.stats.ttest_rel`), and write a TREC run file. NDCG follows
trec_eval (linear gains, log2 discount, ideal ranking from the qrels).

The encoder runs on `device` (default cuda); the rerank is host work. The
cosine term of each (query, entity) pair is computed once and reused for
every alpha of the sweep, with the same arithmetic as the TPU package's
`rerank_queries`, so the scores are the same.

CLI:
    python -m blp_tpu_torch.retrieval with model=bert-dkrl checkpoint=... \\
        run_file=... queries_file=... descriptions_file=... qrels_file=... \\
        folds_file=... vocab_file=... [device=cpu]
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import os.path as osp
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from blp_tpu_torch import checkpoint as ckpt
from blp_tpu_torch.data.text import remove_stopwords
from blp_tpu_torch.data.tokenizers import GloVeTokenizer, WordPieceTokenizer
from blp_tpu_torch.models import bert, blp
from blp_tpu_torch.utils import get_logger, resolve_device

log = get_logger()


# -- trec_eval-style NDCG ----------------------------------------------------

def dcg(gains: list[float]) -> float:
    return sum(g / math.log2(i + 2) for i, g in enumerate(gains))


def ndcg_at_k(run: dict[str, float], qrel: dict[str, int], k: int) -> float:
    """NDCG@k for one query: linear gains, log2 discount (trec_eval ndcg_cut).

    run: doc -> score (ranking by descending score); qrel: doc -> relevance.
    """
    ranked = sorted(run.items(), key=lambda kv: kv[1], reverse=True)[:k]
    gains = [qrel.get(doc, 0) for doc, _ in ranked]
    ideal = sorted(qrel.values(), reverse=True)[:k]
    idcg = dcg([g for g in ideal if g > 0])
    if idcg == 0:
        return 0.0
    return dcg(gains) / idcg


def mean_ndcg(runs: dict[str, dict[str, float]],
              qrels: dict[str, dict[str, int]], k: int) -> float:
    vals = [ndcg_at_k(runs[q], qrels.get(q, {}), k) for q in runs]
    return float(np.mean(vals)) if vals else 0.0


# -- config ------------------------------------------------------------------

@dataclasses.dataclass
class RetrievalConfig:
    dim: int = 128
    model: str = "bert-dkrl"
    rel_model: str = "transe"
    max_len: int = 64
    emb_batch_size: int = 512
    checkpoint: str = "output/model-348.npz"
    run_file: str = "data/DBpedia-Entity/runs/v2/bm25f-ca_v2.run"
    queries_file: str = "data/DBpedia-Entity/collection/v2/queries-v2_stopped.txt"
    descriptions_file: str = "data/DBpedia-Entity/runs/v2/bm25f-ca_v2-descriptions.txt"
    qrels_file: str = "data/DBpedia-Entity/collection/v2/qrels-v2.txt"
    folds_file: str = "data/DBpedia-Entity/collection/v2/folds/all_queries.json"
    vocab_file: str | None = None
    glove_file: str | None = None
    out_dir: str = "output"
    run_id: str | None = None
    num_alphas: int = 20
    encoder_name: str = "bert-base-cased"
    device: str = "cuda"                # "cpu" runs the plain PyTorch paths


# -- encoder loading ---------------------------------------------------------

def load_frozen_encoder(cfg: RetrievalConfig, vocab_size: int):
    """The model config and params on `cfg.device`: a template from a seeded
    CPU generator, overwritten by the link-prediction checkpoint when it
    exists, minus its relation table (unused here)."""
    encoder = None
    emb_dim = 300
    if cfg.model == "blp":
        encoder = (bert.BertConfig.tiny(vocab_size=max(vocab_size, 128))
                   if cfg.encoder_name == "tiny"
                   else bert.BertConfig(vocab_size=vocab_size))
    elif cfg.model.startswith("bert"):
        emb_dim = 768 if cfg.encoder_name != "tiny" else 32
    mcfg = blp.ModelConfig(
        model=cfg.model, rel_model=cfg.rel_model, loss_fn="margin",
        dim=cfg.dim, num_relations=1, emb_dim=emb_dim, vocab_size=vocab_size,
        encoder=encoder)
    params = blp.init_params(mcfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.checkpoint and osp.exists(cfg.checkpoint):
        loaded, _ = ckpt.load_pytree(cfg.checkpoint, template=params)
        loaded["rel_emb"] = params["rel_emb"]  # unused downstream
        params = loaded
        log.info(f"Loaded frozen encoder from {cfg.checkpoint}")
    return mcfg, blp.to_device(params, resolve_device(cfg.device))


def make_tokenizer(cfg: RetrievalConfig):
    if cfg.model in ("blp", "bert-bow", "bert-dkrl"):
        if not cfg.vocab_file or not osp.exists(cfg.vocab_file):
            raise FileNotFoundError("vocab_file required (offline WordPiece)")
        return WordPieceTokenizer(cfg.vocab_file, do_lower_case=False)
    path = cfg.glove_file
    if not path or not osp.exists(path):
        raise FileNotFoundError("glove_file (vocab maps .pt) required")
    return GloVeTokenizer(path)


def embed_texts(params, mcfg, tokenizer, texts: list[str], *, max_len: int,
                batch_size: int, drop_stopwords: bool,
                device=None) -> np.ndarray:
    """Encode a list of texts with the frozen encoder on `device` (default
    cuda), in fixed-shape batches (the last one padded; its padded rows get
    mask[:, 0] = 1). Returns (N, d) float32."""
    dev = resolve_device(device)
    params_enc = blp.encode_view(params, mcfg)
    out = []
    for start in range(0, len(texts), batch_size):
        chunk = texts[start:start + batch_size]
        if drop_stopwords:
            chunk = [remove_stopwords(t) for t in chunk]
        ids, mask = tokenizer.batch_encode(chunk, max_len)
        real = len(chunk)
        if real < batch_size:
            ids = np.pad(ids, ((0, batch_size - real), (0, 0)))
            mask = np.pad(mask, ((0, batch_size - real), (0, 0)))
            mask[real:, 0] = 1.0
        out.append(blp.encode(params_enc, mcfg, ids, mask, device=dev)[:real])
    if not out:
        return np.zeros((0, mcfg.entity_dim), np.float32)
    return torch.cat(out).cpu().numpy()


def embed_entities(cfg: RetrievalConfig, params, mcfg, tokenizer,
                   drop_stopwords: bool):
    """Encode the candidate descriptions, cached per (run file, checkpoint)
    next to the checkpoint."""
    run_name = osp.splitext(osp.basename(cfg.run_file))[0]
    ckpt_name = osp.basename(cfg.checkpoint)
    cache = osp.join(osp.dirname(cfg.checkpoint) or ".",
                     f"{run_name}-qent-{ckpt_name}.npz")

    entity2idx: dict[str, int] = {}
    texts: list[str] = []
    with open(cfg.descriptions_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            values = line.rstrip("\n").split("\t")
            entity2idx[values[0]] = i
            texts.append(" ".join(values[1:]))

    if osp.exists(cache):
        log.info(f"Loading entity embeddings from {cache}")
        embs = np.load(cache)["embs"]
    else:
        log.info(f"Encoding {len(texts):,} candidate descriptions")
        embs = embed_texts(params, mcfg, tokenizer, texts,
                           max_len=cfg.max_len, batch_size=cfg.emb_batch_size,
                           drop_stopwords=drop_stopwords, device=cfg.device)
        np.savez(cache, embs=embs)
        log.info(f"Saved entity embeddings to {cache}")
    return embs, entity2idx


# -- reranking ---------------------------------------------------------------

def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def blp_scores(queries, baseline_run, query_embs, entity2idx, ent_embs_norm):
    """{qid: {entity: cosine term}} over each query's baseline results
    (0.0 for an entity without a description); queries without results are
    left out."""
    out = {}
    for qid in queries:
        results = baseline_run.get(qid, {})
        if not results:
            continue
        q = query_embs[qid]
        out[qid] = {}
        for entity in results:
            idx = entity2idx.get(entity)
            out[qid][entity] = (float(ent_embs_norm[idx] @ q)
                                if idx is not None else 0.0)
    return out


def _interpolate(cosines, baseline_run, queries, alpha: float):
    return {qid: {entity: alpha * s_blp + (1 - alpha) * baseline_run[qid][entity]
                  for entity, s_blp in cosines[qid].items()}
            for qid in queries if qid in cosines}


def rerank_queries(fold_queries, baseline_run, query_embs, entity2idx,
                   ent_embs_norm, alpha: float):
    """Interpolated rerank for a set of queries. Entities without a
    description keep score 0 from the embedding term."""
    cosines = blp_scores(fold_queries, baseline_run, query_embs, entity2idx,
                         ent_embs_norm)
    return _interpolate(cosines, baseline_run, fold_queries, alpha)


def rerank(cfg: RetrievalConfig) -> dict:
    resolve_device(cfg.device)   # fail before any work without the card
    times: dict[str, float] = {}
    t0 = time.perf_counter()
    drop_stopwords = cfg.model in blp.DROP_STOPWORD_MODELS
    tokenizer = make_tokenizer(cfg)
    vocab_size = (len(tokenizer.vocab) if hasattr(tokenizer, "vocab")
                  else max(tokenizer.word2idx.values()) + 1)
    mcfg, params = load_frozen_encoder(cfg, vocab_size)
    times["load_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ent_embs, entity2idx = embed_entities(cfg, params, mcfg, tokenizer,
                                          drop_stopwords)
    ent_embs_norm = _normalize(ent_embs)
    times["embed_entities_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    id2query = {}
    with open(cfg.queries_file, encoding="utf-8") as f:
        for line in f:
            values = line.rstrip("\n").split("\t")
            id2query[values[0]] = " ".join(values[1:])

    # Baseline run + qrels (TREC formats).
    baseline_run: dict = defaultdict(dict)
    qrels: dict = defaultdict(dict)
    for target, path, cast in ((baseline_run, cfg.run_file, float),
                               (qrels, cfg.qrels_file, int)):
        with open(path, encoding="utf-8") as f:
            for line in f:
                values = line.split()
                if len(values) >= 6:
                    qid, _, entity, _, score, *_ = values
                else:
                    qid, _, entity, score = values
                target[qid][entity] = cast(score)

    with open(cfg.folds_file) as f:
        folds = json.load(f)

    # Restrict to queries covered by the folds' test sets.
    covered = {q for fold in folds.values() for q in fold["testing"]}
    baseline_run = {q: baseline_run[q] for q in covered if q in baseline_run}
    qrels = {q: qrels[q] for q in covered}

    qids = sorted(id2query)
    q_embs = embed_texts(params, mcfg, tokenizer, [id2query[q] for q in qids],
                         max_len=cfg.max_len, batch_size=cfg.emb_batch_size,
                         drop_stopwords=drop_stopwords, device=cfg.device)
    q_embs = _normalize(q_embs)
    query_embs = dict(zip(qids, q_embs))
    times["embed_queries_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cosines = blp_scores(list(baseline_run), baseline_run, query_embs,
                         entity2idx, ent_embs_norm)
    alphas = np.linspace(0, 1, cfg.num_alphas)
    test_run: dict = {}
    for i, fold in enumerate(folds.values()):
        train_q = [q for q in fold["training"] if q in baseline_run]
        best_ndcg, best_alpha = -1.0, alphas[0]
        for alpha in alphas:
            run = _interpolate(cosines, baseline_run, train_q, float(alpha))
            score = mean_ndcg(run, qrels, 100)
            if score > best_ndcg:
                best_ndcg, best_alpha = score, float(alpha)
        log.info(f"[Fold {i + 1}/{len(folds)}] best train NDCG@100 "
                 f"{best_ndcg:.3f} at alpha={best_alpha:.3f}")
        test_q = [q for q in fold["testing"] if q in baseline_run]
        test_run.update(_interpolate(cosines, baseline_run, test_q, best_alpha))
    times["sweep_s"] = time.perf_counter() - t0

    run_id = cfg.run_id or time.strftime("%Y%m%d-%H%M%S")
    os.makedirs(cfg.out_dir, exist_ok=True)
    run_path = osp.join(cfg.out_dir, f"{run_id}.run")
    with open(run_path, "w") as f:
        for qid, results in test_run.items():
            ranking = sorted(results.items(), key=lambda kv: kv[1], reverse=True)
            for rank, (entity, score) in enumerate(ranking):
                f.write(f"{qid} Q0 {entity} {rank + 1} {score} "
                        f"{cfg.model}-{cfg.rel_model}\n")
    log.info(f"Wrote TREC run to {run_path}")

    t0 = time.perf_counter()
    out = {"run_file": run_path}
    from scipy import stats
    for k in (10, 100):
        base = mean_ndcg(baseline_run, qrels, k)
        ours = mean_ndcg(test_run, qrels, k)
        qlist = sorted(test_run)
        pair_base = [ndcg_at_k(baseline_run[q], qrels.get(q, {}), k) for q in qlist]
        pair_ours = [ndcg_at_k(test_run[q], qrels.get(q, {}), k) for q in qlist]
        t = stats.ttest_rel(pair_base, pair_ours)
        out[f"ndcg@{k}_baseline"] = base
        out[f"ndcg@{k}"] = ours
        out[f"ndcg@{k}_pvalue"] = float(t.pvalue)
        log.info(f"NDCG@{k}: baseline {base:.3f} -> ours {ours:.3f} "
                 f"(p={t.pvalue:.4f})")
    times["metrics_s"] = time.perf_counter() - t0
    log.info("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))
    out["seconds"] = times
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    fields = {f.name: f for f in dataclasses.fields(RetrievalConfig)}
    cfg = RetrievalConfig()
    for arg in [a for a in argv if a != "with"]:
        key, value = arg.split("=", 1)
        if key not in fields:
            raise ValueError(f"Unknown config key {key!r}")
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            value = value.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            value = int(value)
        elif isinstance(cur, float):
            value = float(value)
        setattr(cfg, key, value)
    result = rerank(cfg)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
