"""The slice as a whole, part 1: two-phase filtered evaluation of the port
(blp_tpu_torch/evaluation.py) against the JAX package's on a synthetic graph
with a tiny fp32 BLP-TransE encoder and the same weights.

With one precomputed table both rank the same floats: the JAX package's
Pallas TransE path (interpret mode) and the port's K1 plain version add in
the same fixed order, so every count is equal, and the breakdowns add the
same reciprocals in the same order, so the whole EvalResult is exactly
equal. With the encode inside, the two tables differ by fp32
summation order (within 1e-5), and the MRRs within 1e-4."""

import jax
import numpy as np
import pytest

from blp_tpu import evaluation as j_eval
from blp_tpu.data.datasets import GraphData, TextGraphData
from blp_tpu.data.filtering import FilterIndex
from blp_tpu.data.synth import write_synth_dataset
from blp_tpu.data.tokenizers import WordPieceTokenizer
from blp_tpu.models import bert as j_bert
from blp_tpu.models import blp as j_blp
from blp_tpu_torch import evaluation as t_eval
from blp_tpu_torch.data.datasets import TextGraphData as TTextGraphData
from blp_tpu_torch.data.filtering import FilterIndex as TFilterIndex
from blp_tpu_torch.data.tokenizers import WordPieceTokenizer as TWordPieceTokenizer
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models import blp as t_blp


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = write_synth_dataset(str(tmp_path_factory.mktemp("synth")),
                            num_entities=48, num_relations=4,
                            num_triples=220, seed=3)
    tok = WordPieceTokenizer(f"{d}/vocab.txt")
    train = TextGraphData.load(f"{d}/ind-train.tsv", tokenizer=tok,
                               max_len=16, write_maps=True)
    dev = GraphData.load(f"{d}/ind-dev.tsv")
    test = GraphData.load(f"{d}/ind-test.tsv")
    t_train = TTextGraphData.load(f"{d}/ind-train.tsv",
                                  tokenizer=TWordPieceTokenizer(f"{d}/vocab.txt"),
                                  max_len=16)
    np.testing.assert_array_equal(t_train.text_data, train.text_data)
    jcfg = j_blp.ModelConfig(model="blp", rel_model="transe", dim=16,
                             num_relations=len(train.rel_ids),
                             encoder=j_bert.BertConfig.tiny())
    tcfg = t_blp.ModelConfig(model="blp", rel_model="transe", dim=16,
                             num_relations=len(train.rel_ids),
                             encoder=t_bert.BertConfig.tiny())
    jp = jax.tree.map(np.asarray, j_blp.init_params(jax.random.key(0), jcfg))
    tp = t_blp.params_from_jax(jp)
    all_triples = np.concatenate([train.triples, dev.triples, test.triples])
    entities = np.unique(np.concatenate([train.entities, dev.entities]))
    new_ents = np.setdiff1d(entities, train.entities)
    return dict(train=train, t_train=t_train, dev=dev, jcfg=jcfg, tcfg=tcfg,
                jp=jp, tp=tp, all_triples=all_triples, entities=entities,
                new_ents=new_ents)


def _run_both(s, **kw):
    common = dict(batch_size=7, emb_batch_size=16,
                  new_entities=s["new_ents"],
                  rel_categories=s["train"].rel_categories)
    # tile=256 sends the JAX package's TransE ranking through its Pallas
    # kernel (interpret mode), the path K1 ports.
    want = j_eval.eval_link_prediction(
        s["jp"], s["jcfg"], s["dev"].triples, s["train"], s["entities"],
        tile=256, filter_index=FilterIndex(s["all_triples"]),
        return_embeddings=True, **common, **kw.get("jax", {}))
    got = t_eval.eval_link_prediction(
        s["tp"], s["tcfg"], s["dev"].triples, s["t_train"], s["entities"],
        filter_index=TFilterIndex(s["all_triples"]), return_embeddings=True,
        device="cpu", **common, **kw.get("port", {}))
    return want, got


def test_shared_table_eval_exactly_equal(setup):
    s = setup
    table = j_eval.eval_link_prediction(
        s["jp"], s["jcfg"], s["dev"].triples[:1], s["train"], s["entities"],
        tile=256, return_embeddings=True).ent_emb
    want, got = _run_both(s, jax={"ent_emb": jax.numpy.asarray(table)},
                          port={"ent_emb": table})
    assert got.mrr == want.mrr and got.mrr_filt == want.mrr_filt
    assert got.hits == want.hits and got.hits_filt == want.hits_filt
    np.testing.assert_array_equal(got.mrr_by_category, want.mrr_by_category)
    np.testing.assert_array_equal(got.mrr_by_position, want.mrr_by_position)
    assert got.scalars("dev") == want.scalars("dev")
    assert got.mrr_filt >= got.mrr  # filtering only removes competitors


def test_two_phase_eval_close(setup):
    want, got = _run_both(setup)
    np.testing.assert_allclose(got.ent_emb, want.ent_emb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.ent_emb, axis=1), 1.0, rtol=1e-5)
    assert abs(got.mrr - want.mrr) <= 1e-4
    assert abs(got.mrr_filt - want.mrr_filt) <= 1e-4
    assert set(got.scalars("x")) == set(want.scalars("x"))


@pytest.mark.parametrize("rel_model", ["distmult", "complex"])
def test_transductive_bilinear_eval_exactly_equal(rel_model):
    """The bilinear scorers rank through the plain tiled stream; on an
    integer-valued transductive table the counts are exact in both."""
    rng = np.random.default_rng(5)
    n, d, b = 40, 8, 6
    entities = np.sort(rng.choice(100, n, replace=False)).astype(np.int32)
    trip = np.stack([entities[rng.integers(0, n, 3 * b)],
                     entities[rng.integers(0, n, 3 * b)],
                     rng.integers(0, 3, 3 * b)], axis=1).astype(np.int32)
    params = {"rel_emb": rng.integers(-1, 2, (3, d)).astype(np.float32),
              "ent_emb": rng.integers(-2, 3, (101, d)).astype(np.float32)}
    jcfg = j_blp.ModelConfig(model="transductive", rel_model=rel_model, dim=d,
                             num_relations=3, num_entities=101)
    tcfg = t_blp.ModelConfig(model="transductive", rel_model=rel_model, dim=d,
                             num_relations=3, num_entities=101)
    want = j_eval.eval_link_prediction(
        params, jcfg, trip, None, entities, batch_size=b, tile=16,
        filter_index=FilterIndex(trip))
    got = t_eval.eval_link_prediction(
        t_blp.params_from_jax(params), tcfg, trip, None, entities,
        batch_size=b, tile=16, filter_index=TFilterIndex(trip), device="cpu")
    assert got.scalars("t") == want.scalars("t")


def test_mesh_not_ported(setup):
    s = setup
    with pytest.raises(NotImplementedError):
        t_eval.eval_link_prediction(s["tp"], s["tcfg"], s["dev"].triples,
                                    s["t_train"], s["entities"], mesh=object(),
                                    device="cpu")
