"""The port's logistic regression and scores (blp_tpu_torch/linear_model.py)
against scikit-learn, and `node_classification` against the JAX package's
(which fits scikit-learn's LogisticRegression) on the same embedding export.

- the function is scikit-learn's default `LogisticRegression(C,
  max_iter=1000)`; the reference fit is that estimator solved to tol 1e-10
  in float64, the optimum it approaches (its default stops at a gradient of
  1e-4 and, on float32 inputs, computes its loss in float32, which leaves it
  up to ~4e-3 from that optimum and moves the odd prediction near a class
  boundary). For 3 classes and for 2, at several C: predictions, accuracy
  and balanced accuracy equal; coefficients and intercepts within 1e-4 of
  the largest coefficient;
- node_classification after a tiny CPU link_prediction: the same selected C
  and the same four accuracies as the same sweep with that reference fit on
  that export, and the JAX package's node_classification runs on it too.
"""

import json

import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression as SkLogisticRegression
from sklearn.metrics import accuracy_score, balanced_accuracy_score

from blp_tpu import train as j_train
from blp_tpu.config import ExperimentConfig as JConfig
from blp_tpu_torch import linear_model, train as t_train
from blp_tpu_torch.data.synth import write_synth_dataset, write_tiny_glove


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: torch's intra-op threads, one per
    core in each of several test workers on one machine, oversubscribe its
    cores and slow the fits here by over an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(n_classes, n, d, seed):
    centers = 1.2 * np.random.default_rng(n_classes).standard_normal((n_classes, d))
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    x = centers[y] + rng.standard_normal((n, d))
    return x.astype(np.float32), y * 3 + 1          # labels need not be 0..K-1


@pytest.mark.parametrize("C", [0.1, 1.0, 100.0, 1e4])
@pytest.mark.parametrize("n_classes", [2, 3])
def test_matches_sklearn(n_classes, C):
    x, y = _blobs(n_classes, 300, 8, seed=n_classes)
    xt, yt = _blobs(n_classes, 400, 8, seed=10 + n_classes)
    ours = linear_model.LogisticRegression(C=C, max_iter=1000, device="cpu").fit(x, y)
    exact = SkLogisticRegression(C=C, max_iter=1000, tol=1e-10).fit(
        x.astype(np.float64), y)
    np.testing.assert_array_equal(ours.classes_, exact.classes_)
    for data, labels in ((x, y), (xt, yt)):
        pred, want = ours.predict(data), exact.predict(data)
        np.testing.assert_array_equal(pred, want)
        assert linear_model.accuracy_score(labels, pred) == accuracy_score(labels, want)
        assert linear_model.balanced_accuracy_score(labels, pred) == \
            balanced_accuracy_score(labels, want)
    assert 0.5 < linear_model.accuracy_score(yt, ours.predict(xt)) < 1.0
    assert ours.coef_.shape == exact.coef_.shape == \
        ((1 if n_classes == 2 else n_classes), 8)
    scale = np.abs(exact.coef_).max()
    np.testing.assert_allclose(ours.coef_, exact.coef_, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(ours.intercept_, exact.intercept_, rtol=0,
                               atol=1e-4 * scale)


def test_two_classes_fit_one_binomial_vector():
    """Two classes are the binomial loss on one weight vector, not a
    two-class softmax (whose optimum is the binomial one at 2C)."""
    x, y = _blobs(2, 200, 5, seed=7)
    ours = linear_model.LogisticRegression(C=0.05, device="cpu").fit(x, y)
    assert ours.coef_.shape == (1, 5) and ours.intercept_.shape == (1,)
    softmax_2c = SkLogisticRegression(C=0.1, tol=1e-10).fit(
        x.astype(np.float64), y)
    np.testing.assert_allclose(ours.coef_, softmax_2c.coef_ / 1.0, atol=0.5)
    exact = SkLogisticRegression(C=0.05, tol=1e-10).fit(x.astype(np.float64), y)
    np.testing.assert_allclose(ours.coef_, exact.coef_,
                               atol=1e-4 * np.abs(exact.coef_).max())


def test_balanced_accuracy_ignores_classes_only_predicted():
    y_true = np.array([0, 0, 1, 1, 1, 2])
    y_pred = np.array([0, 3, 1, 1, 0, 2])
    with pytest.warns(UserWarning):
        want = balanced_accuracy_score(y_true, y_pred)
    assert linear_model.balanced_accuracy_score(y_true, y_pred) == want


def test_single_class_raises():
    with pytest.raises(ValueError, match="2 classes"):
        linear_model.LogisticRegression(device="cpu").fit(np.ones((4, 2)), np.zeros(4))


@pytest.fixture(scope="module")
def lp_run(tmp_path_factory):
    """A tiny CPU link_prediction run whose export node_classification
    reads (typed graph: the class is the entity's type)."""
    root = tmp_path_factory.mktemp("nodeclass")
    d = write_synth_dataset(str(root / "data" / "synth"), num_entities=240,
                            num_relations=6, num_triples=900, num_types=3, seed=5)
    write_tiny_glove(str(root / "glove"), f"{d}/vocab.txt", dim=300, seed=2)
    args = dict(dataset="synth", data_dir=str(root / "data"), model="glove-bow",
                glove_file=str(root / "glove.pt"), dim=8, max_len=8,
                num_negatives=4, batch_size=32, emb_batch_size=64,
                eval_batch_size=32, lr=1e-2, tile=64, max_epochs=1,
                out_dir=str(root / "out"), run_id="nc", device="cpu")
    assert t_train.main(["link_prediction", "with"]
                        + [f"{k}={v}" for k, v in args.items()]) == 0
    return root


def _sklearn_node_classification(root) -> dict:
    """blp_tpu.train.node_classification's sweep with the reference fit."""
    from blp_tpu.data.datasets import load_maps
    from blp_tpu.utils import load_embedding_export, make_ent2idx

    emb, ids = load_embedding_export(str(root / "out"), "nc")
    ent_ids, _ = load_maps(str(root / "data" / "synth"))
    ent2idx = make_ent2idx(ids, int(ids.max()))
    classes: dict = {}
    xy = {}
    for split in ("train", "dev", "test"):
        rows = [line.split() for line in
                open(root / "data" / "synth" / f"{split}-ents-class.txt")]
        xy[split] = (emb[[ent2idx[ent_ids[e]] for e, _ in rows]].astype(np.float64),
                     np.array([classes.setdefault(c, len(classes)) for _, c in rows]))

    def fit(c, x, y):
        return SkLogisticRegression(C=c, max_iter=1000, tol=1e-10).fit(x, y)

    best_acc, best_c = 0.0, 1.0
    for k in range(-4, 2):
        acc = accuracy_score(xy["dev"][1], fit(10.0 ** -k, *xy["train"]).predict(xy["dev"][0]))
        if acc > best_acc:
            best_acc, best_c = acc, 10.0 ** -k
    x_all = np.concatenate([xy["train"][0], xy["dev"][0]])
    y_all = np.concatenate([xy["train"][1], xy["dev"][1]])
    clf = fit(best_c, x_all, y_all)
    out = {"best_c": best_c}
    for name, fn in (("accuracy", accuracy_score),
                     ("balanced_accuracy", balanced_accuracy_score)):
        out[f"train_{name}"] = float(fn(y_all, clf.predict(x_all)))
        out[f"test_{name}"] = float(fn(xy["test"][1], clf.predict(xy["test"][0])))
    return out


def test_node_classification_matches_sklearn_on_the_same_export(lp_run, capsys):
    kw = dict(dataset="synth", data_dir=str(lp_run / "data"),
              out_dir=str(lp_run / "out"), checkpoint="nc")
    assert t_train.main(["node_classification", "with", "device=cpu"]
                        + [f"{k}={v}" for k, v in kw.items()]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ours == _sklearn_node_classification(lp_run)
    assert 0.0 < ours["test_accuracy"] <= 1.0
    assert set(j_train.node_classification(JConfig(**kw))) == set(ours)
    saved = np.load(lp_run / "out" / "classifier-nc.npz")
    assert saved["coef"].shape == (3, 300) and saved["intercept"].shape == (3,)
    np.testing.assert_array_equal(saved["classes"], [0, 1, 2])
    assert sorted(json.loads(str(saved["id_to_class"])).values()) == \
        ["class_0", "class_1", "class_2"]
