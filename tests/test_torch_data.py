"""The port's training host modules against the JAX package's: the batch
loader (the same numpy batches for the same shuffle seed), the prefetch
thread (order, placement, producer errors) and the metric observers (the
same JSONL rows)."""

import json

import numpy as np
import pytest
import torch

from blp_tpu import observers as j_observers
from blp_tpu.data import loader as j_loader
from blp_tpu.data.datasets import TextGraphData as JTextGraphData
from blp_tpu.data.synth import write_synth_dataset
from blp_tpu.data.tokenizers import WordPieceTokenizer as JWordPieceTokenizer
from blp_tpu_torch import observers as t_observers
from blp_tpu_torch.data import loader as t_loader
from blp_tpu_torch.data import prefetch
from blp_tpu_torch.data.datasets import TextGraphData as TTextGraphData
from blp_tpu_torch.data.tokenizers import WordPieceTokenizer as TWordPieceTokenizer


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    d = write_synth_dataset(str(tmp_path_factory.mktemp("loader") / "synth"),
                            num_entities=30, num_relations=3, num_triples=100,
                            seed=4)
    j = JTextGraphData.load(f"{d}/ind-train.tsv", max_len=12, write_maps=True,
                            tokenizer=JWordPieceTokenizer(f"{d}/vocab.txt"))
    t = TTextGraphData.load(f"{d}/ind-train.tsv", max_len=12,
                            tokenizer=TWordPieceTokenizer(f"{d}/vocab.txt"))
    return j, t


@pytest.mark.parametrize("drop_last", [True, False])
def test_epoch_batches_and_text_batches_equal_jax(datasets, drop_last):
    j, t = datasets
    assert t_loader.num_batches(t, 16, drop_last) == j_loader.num_batches(
        j, 16, drop_last)
    want = list(j_loader.epoch_batches(j, 16, rng=np.random.default_rng(3),
                                       drop_last=drop_last))
    got = list(t_loader.epoch_batches(t, 16, rng=np.random.default_rng(3),
                                      drop_last=drop_last))
    assert len(got) == len(want) == t_loader.num_batches(t, 16, drop_last)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        tb, jb = t_loader.text_train_batch(t, g), j_loader.text_train_batch(j, w)
        assert tb.keys() == jb.keys()
        for k in tb:
            np.testing.assert_array_equal(tb[k], jb[k])
        for k, v in t_loader.transductive_train_batch(t, g).items():
            np.testing.assert_array_equal(v, j_loader.transductive_train_batch(j, w)[k])


def test_prefetch_yields_tensors_in_order():
    batches = [{"x": np.full((4,), i, np.int32)} for i in range(7)]
    out = list(prefetch.prefetch_to_device(iter(batches), size=3, device="cpu"))
    assert [int(b["x"][0]) for b in out] == list(range(7))
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].dtype == torch.int32
               for b in out)


def test_prefetch_custom_placement_and_empty():
    out = list(prefetch.prefetch_to_device(
        (np.float32(i) for i in range(3)),
        placement=lambda b: torch.tensor(b) * 2))
    assert [float(x) for x in out] == [0.0, 2.0, 4.0]
    assert list(prefetch.prefetch_to_device(iter([]), device="cpu")) == []


def test_prefetch_reraises_producer_exception():
    def gen():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("boom")

    it = prefetch.prefetch_to_device(gen(), size=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_jsonl_rows_match_jax(tmp_path):
    rows = []
    for mod, name in ((j_observers, "j"), (t_observers, "t")):
        obs = mod.ObserverSet.from_env(str(tmp_path), name)
        obs.log_config({"dim": 128, "model": "blp"})
        obs.log(3, loss=0.5, mrr=0.25)
        obs.close()
        lines = [json.loads(x) for x in open(tmp_path / f"metrics-{name}.jsonl")]
        for line in lines:
            del line["time"]
        rows.append(lines)
    assert rows[0] == rows[1]


def test_optional_sink_failure_is_nonfatal_primary_is_fatal(tmp_path):
    class Boom:
        def log(self, step, **kw):
            raise OSError("sink down")

        def log_config(self, c):
            raise OSError("sink down")

        def close(self):
            raise OSError("sink down")

    primary = t_observers.JsonlObserver(str(tmp_path / "m.jsonl"))
    obs = t_observers.ObserverSet([primary, Boom()])
    obs.log(1, loss=2.0)
    obs.log_config({})
    obs.close()
    assert json.loads(open(tmp_path / "m.jsonl").readline())["loss"] == 2.0
    with pytest.raises(OSError):
        t_observers.ObserverSet([Boom()]).log(1, loss=1.0)
    try:
        import pymongo  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="pymongo"):
            t_observers.MongoObserver("mongodb://localhost:1", "db", "run")
