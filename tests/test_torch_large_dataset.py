"""The Wikidata5M mode of `link_prediction` (`large_dataset=True`, set by
every scripts/*-wikidata5m*.sh) in the port (blp_tpu_torch/train.py)
against the JAX package's, on the CPU: a tiny fp32 BLP-TransE encoder on a
synthetic inductive graph with 3% of its entities held out (the held-out
share of tools/w5m_mode_rehearsal.py).

The mode builds no global filter graph and skips the train-sample
evaluation; each split's candidates are that split's own entities, and the
final evaluation filters each split by its own triples alone, after
reloading the best checkpoint. Also the text cache
(`text_{max_len}_{drop}_{vocab_sig}.npz`) that `use_cached_text=True`
runs, such as every `-pretrained` script, read: one package reads the other's.

Tolerance between the packages: from one weights file both encode the same
entities in fp32 with sums in different orders, so the tables differ in the
last bits; every rank here comes out the same integer in both, so the MRRs
and hits differ at most by the order in which the reciprocals are summed:
rtol 1e-6 (a rank that moved by one would shift an MRR of these ~45-triple
splits by more than 1e-4). Within one package, runs that see the same
inputs are held equal exactly."""

import glob
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

import blp_tpu.native as j_native
from blp_tpu import checkpoint as j_ckpt
from blp_tpu import evaluation as j_eval
from blp_tpu import train as j_train
from blp_tpu.config import ExperimentConfig as JExperimentConfig
from blp_tpu.data import tokenizers as j_tokenizers
from blp_tpu.data.datasets import GraphData as JGraphData
from blp_tpu_torch import checkpoint as t_ckpt
from blp_tpu_torch import evaluation as t_eval
from blp_tpu_torch import native as t_native
from blp_tpu_torch import train as t_train
from blp_tpu_torch.config import ExperimentConfig
from blp_tpu_torch.data import tokenizers as t_tokenizers
from blp_tpu_torch.data.datasets import GraphData, TextGraphData
from blp_tpu_torch.data.filtering import FilterIndex
from blp_tpu_torch.data.synth import write_synth_dataset


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: torch's intra-op threads, one per
    core in each of several test workers on one machine, oversubscribe its
    cores and slow this module's runs several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARGS = dict(model="blp", rel_model="transe", encoder_name="tiny", dim=16,
            max_len=16, num_negatives=8, batch_size=64, emb_batch_size=64,
            eval_batch_size=8, lr=1e-3, tile=16, seed=0)
PACKAGES = ("jax", "torch")
SPLITS = {"valid": "dev", "test": "test"}
#: The final evaluation's scalars compared between runs.
METRICS = [f"{split}_{m}{f}" for split in SPLITS
           for m in ("mrr", "hits@1", "hits@3", "hits@10") for f in ("", "_filt")]
#: Rows of the train-sample evaluation, which the mode skips.
TRAIN_EVAL = re.compile(r"^train_(mrr|hits)")


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    """The graph (seed 5: 400 entities, 3% held out; 1,513 train, 40 valid,
    49 test triples) and a weights file written by the JAX package."""
    root = tmp_path_factory.mktemp("w5m_mode")
    write_synth_dataset(str(root / "graph"), num_entities=400, num_relations=6,
                        num_triples=1600, num_types=6, inductive_frac=0.03,
                        seed=5)
    cfg = JExperimentConfig(**ARGS, dataset="graph", data_dir=str(root))
    train = JGraphData.load(cfg.triples_file("train"), write_maps=True)
    mcfg = j_train.make_model_config(cfg, j_train.make_tokenizer(cfg),
                                     len(train.rel_ids), len(train.ent_ids))
    weights = str(root / "weights.npz")
    j_ckpt.save_pytree(weights, j_train.init_model_params(
        cfg, mcfg, jax.random.key(0)), {"epoch": 0})
    return root, weights


def _copy(root, name: str, extra_train: list[str] = ()) -> str:
    """A copy of the graph's files without token caches or id maps, with
    `extra_train` lines appended to its ind-train.tsv."""
    dst = root / "data" / name
    shutil.copytree(root / "graph", dst,
                    ignore=shutil.ignore_patterns("text_*.npz", "maps.json"))
    with open(dst / "ind-train.tsv", "a") as f:
        f.writelines(extra_train)
    return name


def _run(pkg: str, root, dataset: str, run_id: str, **kw):
    """link_prediction of package `pkg`: (its result, its metrics rows)."""
    out = root / "out" / pkg
    args = {**ARGS, "dataset": dataset, "data_dir": str(root / "data"),
            "out_dir": str(out), "run_id": run_id, **kw}
    if pkg == "jax":
        res = j_train.link_prediction(JExperimentConfig(**args))
    else:
        res = t_train.link_prediction(ExperimentConfig(**args, device="cpu"))
    with open(out / f"metrics-{run_id}.jsonl") as f:
        return res, [json.loads(line) for line in f]


def _final(rows: list[dict], epochs: int = 0) -> dict:
    """The final evaluation's scalars (logged at step max_epochs + 1)."""
    return {k: v for r in rows if r["step"] == epochs + 1
            for k, v in r.items() if k in METRICS}


def _spy(mp, module) -> list:
    """Record (triples, candidates, filter) of each evaluation."""
    calls, real = [], module.eval_link_prediction

    def spy(params, cfg, triples, text, entities, **kw):
        calls.append((np.asarray(triples), np.asarray(entities),
                      kw.get("filter_index")))
        return real(params, cfg, triples, text, entities, **kw)

    mp.setattr(module, "eval_link_prediction", spy)
    return calls


@pytest.fixture(scope="module")
def evals(graph):
    """`max_epochs=0 checkpoint=<JAX weights> large_dataset=True` in each
    package, on a copy of the graph of its own (each tokenizes and writes
    its own text cache): {pkg: (result, rows, evaluations)}."""
    root, weights = graph
    out = {}
    for pkg in PACKAGES:
        with pytest.MonkeyPatch.context() as mp:
            calls = _spy(mp, j_eval if pkg == "jax" else t_eval)
            res, rows = _run(pkg, root, _copy(root, f"w5m-{pkg}"), "w5m",
                             max_epochs=0, checkpoint=weights,
                             large_dataset=True)
        out[pkg] = (res, rows, calls)
    return out


def test_same_weights_give_the_same_metrics(evals):
    jax_final, port_final = (_final(evals[p][1]) for p in PACKAGES)
    assert sorted(jax_final) == sorted(port_final) == sorted(METRICS)
    for key in METRICS:
        np.testing.assert_allclose(port_final[key], jax_final[key],
                                   rtol=1e-6, err_msg=key)
    for key in ("test_mrr", "test_mrr_filt"):
        np.testing.assert_allclose(evals["torch"][0][key], evals["jax"][0][key],
                                   rtol=1e-6)
    assert 0 < jax_final["test_mrr"] < 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_mode_skips_train_eval_and_ranks_each_split_alone(graph, evals, pkg):
    root, _ = graph
    _, rows, calls = evals[pkg]
    assert not [k for r in rows for k in r if TRAIN_EVAL.match(k)]
    # Two evaluations, valid then test, each over its split's own
    # entities, filtered by its own triples and nothing else.
    assert len(calls) == 2
    for (triples, entities, fidx), split in zip(calls, SPLITS.values()):
        own = GraphData.load(str(root / "data" / f"w5m-{pkg}" / f"ind-{split}.tsv"))
        np.testing.assert_array_equal(triples, own.triples)
        np.testing.assert_array_equal(entities, own.entities)
        np.testing.assert_array_equal(entities, np.unique(own.triples[:, :2]))
        for h, t, r in own.triples:
            assert t in fidx.true_tails(h, r) and h in fidx.true_heads(t, r)
        pairs = {(h, r) for h, _, r in own.triples}
        assert sum(len(fidx.true_tails(h, r)) for h, r in pairs) == len(
            {tuple(x) for x in own.triples})


def _train_only_lines(root) -> list[str]:
    """Train triples (a, r, x) for the first test triple (a, r, b) and every
    other test entity x: true in train only."""
    lines = (root / "graph" / "ind-test.tsv").read_text().splitlines()
    a, r, b = lines[0].split("\t")
    ents = {e for line in lines for e in line.split("\t")[::2]}
    return [f"{a}\t{r}\t{x}\n" for x in sorted(ents - {b})]


@pytest.fixture(scope="module")
def constructed(graph, evals):
    """The final test metrics of four runs in each package: the graph as
    it is (D0) and with the train-only triples (D1), with large_dataset
    True and False. {pkg: {(graph, large): scalars}}."""
    root, weights = graph
    extra = _train_only_lines(root)
    out = {}
    for pkg in PACKAGES:
        out[pkg] = {("D0", True): _final(evals[pkg][1])}
        for name, lines in (("D0", []), ("D1", extra)):
            dataset = _copy(root, f"{name}-{pkg}", lines)
            for large in (True, False):
                if (name, large) in out[pkg]:
                    continue
                _, rows = _run(pkg, root, dataset, f"{name}-{large}",
                               max_epochs=0, checkpoint=weights,
                               large_dataset=large)
                out[pkg][name, large] = _final(rows)
    return out


@pytest.mark.parametrize("pkg", PACKAGES)
def test_train_only_triple_is_filtered_only_outside_the_mode(constructed, pkg):
    runs = constructed[pkg]
    test_keys = [k for k in METRICS if k.startswith("test_")]
    # large_dataset=True: test filtered by test triples alone, so the
    # train-only triples change nothing.
    assert {k: runs["D1", True][k] for k in test_keys} == {
        k: runs["D0", True][k] for k in test_keys}
    # large_dataset=False: the global filter drops them, so b's tail rank
    # for (a, r, ?) rises to 1; the raw metrics stay as they were.
    assert runs["D1", False]["test_mrr"] == runs["D0", False]["test_mrr"]
    assert runs["D1", False]["test_mrr_filt"] > runs["D0", False]["test_mrr_filt"]


def test_constructed_case_agrees_between_packages(constructed):
    """The mode's runs within rtol 1e-6, as above. Outside it every split
    is ranked against all 400 entities, whose random-encoder embeddings lie
    close together: there one of the 98 test ranks lands one place apart
    between the packages (MRR 3.7e-6 apart), so those runs are held within
    atol 1e-5."""
    for (name, large), want in constructed["jax"].items():
        tol = dict(rtol=1e-6) if large else dict(rtol=0, atol=1e-5)
        for key in METRICS:
            np.testing.assert_allclose(constructed["torch"][name, large][key],
                                       want[key], **tol,
                                       err_msg=f"{name} large={large} {key}")


def test_port_trains_in_the_mode_resumes_and_evaluates_the_best_checkpoint(graph):
    root, _ = graph
    dataset = _copy(root, "train-torch")
    _run("torch", root, dataset, "t", max_epochs=1, large_dataset=True)
    _, rows = _run("torch", root, dataset, "t", max_epochs=2,
                   large_dataset=True, resume="auto")
    out = root / "out" / "torch"
    assert [r["step"] for r in rows if "train_loss" in r] == [1, 2]
    assert not [k for r in rows for k in r if TRAIN_EVAL.match(k)]
    valid = {r["step"]: r["valid_mrr"] for r in rows
             if "valid_mrr" in r and r["step"] <= 2}
    model = str(out / "model-t.npz")
    best_epoch = t_ckpt.peek_metadata(model)["epoch"]
    assert best_epoch == max(valid, key=valid.get)
    assert t_ckpt.peek_metadata(str(out / "train_state-t.npz"))["epoch"] == 2

    # The final test evaluation is that of the best checkpoint, filtered by
    # the test triples alone over the test entities.
    cfg = ExperimentConfig(**ARGS, dataset=dataset, data_dir=str(root / "data"),
                           device="cpu")
    tok = t_train.make_tokenizer(cfg)
    train = TextGraphData.load(cfg.triples_file("train"), tokenizer=tok,
                               max_len=cfg.max_len)
    test = GraphData.load(cfg.triples_file("test"))
    mcfg = t_train.make_model_config(cfg, tok, len(train.rel_ids),
                                     len(train.ent_ids))
    params, _ = t_ckpt.load_pytree(model)
    ref = t_eval.eval_link_prediction(
        params, mcfg, test.triples, train, test.entities,
        batch_size=cfg.eval_batch_size, emb_batch_size=cfg.emb_batch_size,
        tile=cfg.tile, filter_index=FilterIndex(test.triples),
        rel_categories=train.rel_categories, device="cpu").scalars("test")
    final = _final(rows, epochs=2)
    assert {k: final[k] for k in METRICS if k.startswith("test_")} == {
        k: ref[k] for k in METRICS if k.startswith("test_")}


def _forbid_tokenizing(mp, pkg: str) -> None:
    """Make any tokenization by `pkg` fail: the run must read the cache."""
    def refuse(*args, **kw):
        raise AssertionError("tokenized instead of reading the text cache")

    tok, native = ((j_tokenizers, j_native) if pkg == "jax"
                   else (t_tokenizers, t_native))
    mp.setattr(tok.WordPieceTokenizer, "encode", refuse)
    mp.setattr(native, "wordpiece_encode_file", refuse)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_text_cache_written_by_one_package_is_read_by_the_other(
        graph, evals, writer, reader, monkeypatch):
    root, weights = graph
    dataset = _copy(root, f"cache-{writer}-{reader}")
    _run(writer, root, dataset, f"cache-{writer}", max_epochs=0,
         checkpoint=weights, large_dataset=True)
    (cache,) = glob.glob(str(root / "data" / dataset / "text_16_0_*.npz"))
    stat = os.stat(cache)
    written = np.load(cache)["text_data"]
    # Bit-equal to the matrix the reader tokenized itself (its own copy).
    (own,) = glob.glob(str(root / "data" / f"w5m-{reader}" / "text_16_0_*.npz"))
    assert os.path.basename(own) == os.path.basename(cache)
    np.testing.assert_array_equal(written, np.load(own)["text_data"])
    assert written.dtype == np.int32 and written.shape == (400, 17)

    _forbid_tokenizing(monkeypatch, reader)
    res, rows = _run(reader, root, dataset, f"cache-{reader}", max_epochs=0,
                     checkpoint=weights, large_dataset=True,
                     use_cached_text=True)
    assert (os.stat(cache).st_mtime_ns, os.stat(cache).st_size) == (
        stat.st_mtime_ns, stat.st_size)
    # The results equal the reader's own run, which tokenized (no cache).
    assert _final(rows) == _final(evals[reader][1])
    assert res["test_mrr_filt"] == evals[reader][0]["test_mrr_filt"]
