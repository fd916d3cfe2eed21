"""The slice as a whole, part 2: serving. The port's LinkPredictor and
serve_loop (blp_tpu_torch/serve.py) against the JAX package's on the same
checkpoint file: the same ids, scores within 1e-5 (fp32 sums in another
order), and the same error lines for bad requests. Then the port's serve
CLI end to end on a synthetic dataset."""

import json
import queue

import jax
import numpy as np
import pytest

from blp_tpu import checkpoint as j_ckpt
from blp_tpu import serve as j_serve
from blp_tpu.data.synth import write_synth_dataset
from blp_tpu.data.tokenizers import WordPieceTokenizer
from blp_tpu.models import bert as j_bert
from blp_tpu.models import blp as j_blp
from blp_tpu_torch import serve as t_serve
from blp_tpu_torch.data.tokenizers import WordPieceTokenizer as TWordPieceTokenizer
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models import blp as t_blp

NUM_RELS = 3


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    d = write_synth_dataset(str(tmp / "data"), num_entities=24,
                            num_relations=NUM_RELS, num_triples=80, seed=2)
    jcfg = j_blp.ModelConfig(model="blp", rel_model="transe", dim=8,
                             num_relations=NUM_RELS,
                             encoder=j_bert.BertConfig.tiny())
    tcfg = t_blp.ModelConfig(model="blp", rel_model="transe", dim=8,
                             num_relations=NUM_RELS,
                             encoder=t_bert.BertConfig.tiny())
    path = str(tmp / "model.npz")
    j_ckpt.save_pytree(path, j_blp.init_params(jax.random.key(4), jcfg))
    jsrv = j_serve.LinkPredictor.from_checkpoint(
        path, jcfg, tokenizer=WordPieceTokenizer(f"{d}/vocab.txt"),
        max_len=12, tile=16)
    tsrv = t_serve.LinkPredictor.from_checkpoint(
        path, tcfg, tokenizer=TWordPieceTokenizer(f"{d}/vocab.txt"),
        max_len=12, tile=16, device="cpu")
    texts = [line.rstrip("\n").split("\t")[1]
             for line in open(f"{d}/entity2text.txt")]
    ids = np.arange(100, 100 + len(texts))
    jsrv.set_candidates_from_texts(ids, texts, batch_size=8)
    tsrv.set_candidates_from_texts(ids, texts, batch_size=8)
    return jsrv, tsrv, texts


def _same(got, want, k):
    (gs, ge), (ws, we) = got, want
    assert gs.shape == (len(ws), k) and ge.shape == (len(we), k)
    np.testing.assert_array_equal(ge, we)
    np.testing.assert_allclose(gs, np.asarray(ws), atol=1e-5, rtol=0)


def test_candidate_tables_close(servers):
    jsrv, tsrv, _ = servers
    np.testing.assert_allclose(tsrv._table.numpy(), np.asarray(jsrv._table),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dense", [True, False])
def test_predict_tails_heads_match(servers, dense, monkeypatch):
    jsrv, tsrv, texts = servers
    if not dense:  # force the tiled top-k path in both
        monkeypatch.setattr(jsrv, "DENSE_TOPK_BUDGET", 0)
        monkeypatch.setattr(tsrv, "DENSE_TOPK_BUDGET", 0)
    table = np.asarray(jsrv._table)[:24]
    _same(tsrv.predict_tails(head_emb=table[[3, 7]], rels=[1, 2], k=5),
          jsrv.predict_tails(head_emb=table[[3, 7]], rels=[1, 2], k=5), 5)
    _same(tsrv.predict_heads(tail_texts=texts[:3], rels=[0, 1, 2], k=4),
          jsrv.predict_heads(tail_texts=texts[:3], rels=[0, 1, 2], k=4), 4)


def test_serve_loop_responses_match(servers):
    jsrv, tsrv, texts = servers
    ent_ids = {f"ent_{i:04d}": 100 + i for i in range(24)}
    rel_ids = {"rel_0": 0, "rel_1": 1, "rel_2": 2}
    reqs = [
        {"id": 1, "op": "tails", "rel": "rel_0", "head": "ent_0003", "k": 4},
        {"id": 2, "op": "tails", "rel": 1, "head": "ent_0007", "k": 4},
        {"id": 3, "op": "heads", "rel": "rel_2", "tail": "ent_0000", "k": 3},
        {"id": 4, "op": "tails", "rel": "rel_1", "head_text": texts[5], "k": 4},
        {"id": 5, "op": "tails", "rel": "nope", "head": "ent_0001"},
        {"id": 6, "op": "tails", "rel": 0, "head": "Zed"},
        {"id": 7, "op": "sideways", "rel": 0, "head": "ent_0001"},
        {"id": 8, "rel": 0},
        {"id": 9, "op": "tails", "rel": 999, "head": "ent_0001"},
    ]

    def run(srv, mod):
        q = queue.Queue()
        for r in reqs:
            q.put(json.dumps(r))
        q.put("not json at all")
        q.put(None)
        out = []
        stats = mod.serve_loop(srv, q, out.append, ent_ids=ent_ids,
                               rel_ids=rel_ids, max_batch=64, linger_s=0.01)
        return stats, {json.loads(o).get("id"): json.loads(o) for o in out}

    j_stats, want = run(jsrv, j_serve)
    t_stats, got = run(tsrv, t_serve)
    assert t_stats == j_stats
    assert t_stats["served"] == 4 and t_stats["errors"] == 6
    assert set(got) == set(want)
    for rid, w in want.items():
        g = got[rid]
        if "error" in w:
            assert g == w, rid
        else:
            assert g["entities"] == w["entities"], rid
            np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5)
    assert "out of range" in got[9]["error"]


def test_candidates_from_export(servers, tmp_path):
    """An ent_emb-<run>.npz export installs as the candidate table."""
    _, tsrv, _ = servers
    table = tsrv._table[:24].numpy()
    np.savez(tmp_path / "ent_emb-r1.npz", ent_emb=table,
             entities=np.arange(500, 524))
    srv = t_serve.LinkPredictor(params=tsrv.params, cfg=tsrv.cfg, tile=16,
                                device="cpu")
    srv.set_candidates_from_export(str(tmp_path), "r1")
    _, ents = srv.predict_tails(head_emb=table[[0]], rels=[0], k=3)
    _, want = tsrv.predict_tails(head_emb=table[[0]], rels=[0], k=3)
    np.testing.assert_array_equal(ents, want + 400)


def test_serve_cli_main(tmp_path, capsys, monkeypatch):
    """The port's CLI on a synthetic dataset, with a checkpoint the JAX
    package wrote (random-init tiny BLP-TransE)."""
    from blp_tpu import train as j_train
    from blp_tpu.config import ExperimentConfig

    data_dir = tmp_path / "data"
    write_synth_dataset(str(data_dir / "srv"), num_entities=40,
                        num_relations=4, num_triples=200, seed=3)
    cfg = ExperimentConfig(dataset="srv", data_dir=str(data_dir), model="blp",
                           encoder_name="tiny", rel_model="transe", dim=16,
                           max_len=16, emb_batch_size=16, tile=16)
    tokenizer = j_train.make_tokenizer(cfg)
    mcfg = j_train.make_model_config(cfg, tokenizer, 4, 40)
    ck = tmp_path / "model.npz"
    j_ckpt.save_pytree(str(ck), j_blp.init_params(jax.random.key(0), mcfg))

    monkeypatch.chdir(tmp_path)
    t_serve.main([f"dataset=srv", f"data_dir={data_dir}", "model=blp",
                  "encoder_name=tiny", "rel_model=transe", "dim=16",
                  "max_len=16", "emb_batch_size=16", "tile=16",
                  f"checkpoint={ck}", "device=cpu"])
    out = capsys.readouterr().out
    assert out.count("-> [") == 4 and "true=" in out
