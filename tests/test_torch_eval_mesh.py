"""The port's candidate-sharded evaluation (evaluation.py with `mesh=`,
parallel/eval_parallel.py) on gloo worlds of 2 and 4 CPU ranks, against the
TPU package's evaluator on a mesh of the same shape and against the port on
one device (tests/test_eval_mesh.py's cases).

The sharded pass counts each block of the table with positions in its own
frame and sums the int32 counts, so raw and filtered MRR and hits are equal
bit for bit (abs=0): TransE through K1's plain version (JAX through its
Pallas kernel at tile 128, the path K1 ports) and SimplE through the tiled
stream, with the word-model (glove-bow) encoder, which encodes each row on
its own — the sharded table equals the one-device table exactly. With the
tiny BERT encoder the ranks encode other batches of rows, so the tables may
differ in the last bits; the MRRs are held within rel 1e-6, as JAX's own
test holds them."""

import jax
import numpy as np
import pytest

import torch_dist_workers as workers
from blp_tpu import evaluation as j_eval
from blp_tpu.data.datasets import GraphData, TextGraphData
from blp_tpu.data.filtering import FilterIndex
from blp_tpu.data.synth import write_synth_dataset
from blp_tpu.data.tokenizers import WordPieceTokenizer
from blp_tpu.models import bert as j_bert
from blp_tpu.models import blp as j_blp
from blp_tpu.parallel import mesh as j_mesh
from blp_tpu_torch import evaluation as t_eval
from blp_tpu_torch.data.datasets import TextGraphData as TTextGraphData
from blp_tpu_torch.data.filtering import FilterIndex as TFilterIndex
from blp_tpu_torch.data.tokenizers import WordPieceTokenizer as TWordPiece
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models import blp as t_blp

SHAPES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
ALL = [s for shapes in SHAPES.values() for s in shapes]
#: case name -> (model, rel_model, tile); glove-bow at the vocabulary's size.
CASES = {"transe": ("glove-bow", "transe", 128),
         "simple": ("glove-bow", "simple", 8),
         "blp": ("blp", "transe", 8)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = write_synth_dataset(str(tmp_path_factory.mktemp("evalmesh")),
                            num_entities=48, num_relations=4,
                            num_triples=220, seed=9)
    tok = WordPieceTokenizer(f"{d}/vocab.txt")
    train = TextGraphData.load(f"{d}/ind-train.tsv", tokenizer=tok,
                               max_len=16, write_maps=True)
    dev = GraphData.load(f"{d}/ind-dev.tsv")
    test = GraphData.load(f"{d}/ind-test.tsv")
    return dict(dir=d, train=train, dev=dev, test=test,
                vocab=len(open(f"{d}/vocab.txt").read().splitlines()),
                entities=np.unique(np.concatenate([train.entities, dev.entities])),
                fidx=FilterIndex(np.concatenate([train.triples, dev.triples,
                                                 test.triples])))


def _configs(data, name):
    model, rel_model, _ = CASES[name]
    nrel = len(data["train"].rel_ids)
    if model == "blp":
        kw = dict(model="blp", rel_model=rel_model, dim=8, num_relations=nrel)
        return (j_blp.ModelConfig(**kw, encoder=j_bert.BertConfig.tiny(
                    vocab_size=data["vocab"])),
                t_blp.ModelConfig(**kw, encoder=t_bert.BertConfig.tiny(
                    vocab_size=data["vocab"])), jax.random.key(3))
    kw = dict(model="glove-bow", rel_model=rel_model, dim=0, num_relations=nrel,
              emb_dim=16, vocab_size=data["vocab"])
    return j_blp.ModelConfig(**kw), t_blp.ModelConfig(**kw), jax.random.key(2)


def _kw(name):
    return dict(batch_size=8, emb_batch_size=16, tile=CASES[name][2])


@pytest.fixture(scope="module")
def runs(data):
    """{(name, shape): (JAX on that mesh, the port's ranks)} and the port on
    one device under (name, None)."""
    out = {}
    for world, shapes in SHAPES.items():
        cases, keys = [], []
        for shape in shapes:
            for name in CASES:
                jcfg, tcfg, key = _configs(data, name)
                jp = jax.tree.map(np.asarray, j_blp.init_params(key, jcfg))
                cases.append((shape, tcfg, jp, _kw(name)))
                keys.append((name, shape))
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            ranks = workers.run_world(workers.mesh_evals, world, tmp,
                                      data["dir"], cases)
        for i, key in enumerate(keys):
            out[key] = [r[i] for r in ranks]
    return out


def _jax(data, name, shape):
    jcfg, _, key = _configs(data, name)
    mesh = None
    if shape is not None:
        d, m = shape
        mesh = j_mesh.make_mesh(d, m, devices=jax.devices()[:d * m])
    return j_eval.eval_link_prediction(
        j_blp.init_params(key, jcfg), jcfg, data["dev"].triples, data["train"],
        data["entities"], filter_index=data["fidx"], mesh=mesh, **_kw(name))


def _port_one_device(data, name):
    jcfg, tcfg, key = _configs(data, name)
    d = data["dir"]
    train = TTextGraphData.load(f"{d}/ind-train.tsv", tokenizer=TWordPiece(
        f"{d}/vocab.txt"), max_len=16)
    fidx = TFilterIndex(np.concatenate([data["train"].triples,
                                        data["dev"].triples,
                                        data["test"].triples]))
    tp = t_blp.params_from_jax(jax.tree.map(np.asarray,
                                            j_blp.init_params(key, jcfg)))
    return t_eval.eval_link_prediction(
        tp, tcfg, data["dev"].triples, train, data["entities"],
        filter_index=fidx, return_embeddings=True, device="cpu", **_kw(name))


def _assert_equal(got: dict, want, exact: bool):
    pairs = [("x_mrr", want.mrr), ("x_mrr_filt", want.mrr_filt)]
    pairs += [(f"x_hits@{k}", v) for k, v in want.hits.items()]
    pairs += [(f"x_hits@{k}_filt", v) for k, v in want.hits_filt.items()]
    for key, w in pairs:
        if exact:
            assert got[key] == pytest.approx(w, abs=0), key
        else:
            assert got[key] == pytest.approx(w, rel=1e-6), key


@pytest.mark.parametrize("shape", ALL)
@pytest.mark.parametrize("name", ["transe", "simple"])
def test_mesh_eval_bit_identical(data, runs, name, shape):
    want_jax = _jax(data, name, shape)
    one = _port_one_device(data, name)
    for rank in runs[(name, shape)]:
        _assert_equal(rank["scalars"], want_jax, exact=True)
        _assert_equal(rank["scalars"], one, exact=True)
        assert rank["scalars"] == one.scalars("x")


@pytest.mark.parametrize("shape", ALL)
def test_mesh_phase1_table_identical(data, runs, shape):
    """Each rank's block, encoded on its own, makes up the one-device table
    exactly (the word model encodes each row on its own)."""
    one = _port_one_device(data, "transe")
    for rank in runs[("transe", shape)]:
        np.testing.assert_array_equal(rank["table"], one.ent_emb)


@pytest.mark.parametrize("shape", ALL)
def test_mesh_eval_blp_end_to_end(data, runs, shape):
    """Sharded phase 1 with the BERT encoder (sequence packing inside each
    rank's block) and sharded phase 2, against JAX on the same mesh and the
    port on one device."""
    want_jax = _jax(data, "blp", shape)
    one = _port_one_device(data, "blp")
    for rank in runs[("blp", shape)]:
        _assert_equal(rank["scalars"], want_jax, exact=False)
        _assert_equal(rank["scalars"], one, exact=False)
        np.testing.assert_allclose(rank["table"], one.ent_emb, rtol=0, atol=1e-5)
