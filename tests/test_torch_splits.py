"""The port's offline split tooling (blp_tpu_torch/data/splits.py) against
the JAX package's: each scenario of tests/test_splits.py runs through both
packages, each in a copy of the same input directory, and must return the
same values and write byte-identical files."""

import filecmp
import os
import shutil
from collections import Counter

import numpy as np
import pytest

from blp_tpu.data import splits as j_splits
from blp_tpu_torch.data import splits as t_splits


def _graph(d):
    """Dense-ish random graph where entity dropping is feasible."""
    rng = np.random.default_rng(0)
    n, rels = 60, 3
    lines = [f"e{i}\tr{i % rels}\te{(i + 1) % n}" for i in range(n)]
    for _ in range(500):
        h, t = rng.integers(n, size=2)
        if h != t:
            lines.append(f"e{h}\tr{rng.integers(rels)}\te{t}")
    (d / "all-triples.tsv").write_text("\n".join(lines) + "\n")


def _categories(d):
    lines = []
    for i in range(10):
        for j in range(3):
            lines.append(f"h{i}\tr0\tt{i}_{j}")
        lines.append(f"a{i}\tr1\tb{i}")
    (d / "train.tsv").write_text("\n".join(lines) + "\n")


def _glove(d):
    (d / "glove.txt").write_text("cat 1.0 2.0 3.0\ndog 4.0 5.0 6.0\n")


def _ranking(d):
    (d / "test.run").write_text("Q1 Q0 <dbpedia:Cat> 1 1.0 x\n"
                                "Q1 Q0 <dbpedia:Dog> 2 0.9 x\n")
    (d / "dump.nt").write_text(
        '<http://dbpedia.org/resource/Cat> '
        '<http://www.w3.org/2000/01/rdf-schema#comment> '
        '"The cat is a small animal."@en .\n'
        '<http://dbpedia.org/resource/Bird> '
        '<http://www.w3.org/2000/01/rdf-schema#comment> "A bird."@en .\n')


SCENARIOS = {
    # name: (write the inputs, run one package's module in a directory)
    "drop_entities_invariants": (_graph, lambda m, d: m.drop_entities(
        str(d / "all-triples.tsv"), train_size=0.8, seed=1, min_edges_left=10)),
    "drop_entities_min_edges_cli": (_graph, lambda m, d: m.main(
        ["drop_entities", "--file", str(d / "all-triples.tsv"), "--seed", "2",
         "--min_edges_left", "50"])),
    "safely_removed_edges_none_when_orphaning": (lambda d: None, lambda m, d:
        m.get_safely_removed_edges(
            m.MultiGraph([("e1", "e2", "r0"), ("e2", "e3", "r0")]), "e2",
            Counter(r0=2), 1)),
    "categorize_relations": (_categories, lambda m, d: m.categorize_relations(
        str(d / "train.tsv"))),
    "load_embeddings": (_glove, lambda m, d: m.load_embeddings(
        str(d / "glove.txt"))),
    "get_ranking_descriptions": (_ranking, lambda m, d: m.get_ranking_descriptions(
        str(d / "test.run"), str(d / "dump.nt"))),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_outputs_byte_identical_to_jax(scenario, tmp_path, capsys):
    write_inputs, run = SCENARIOS[scenario]
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    write_inputs(inputs)
    dirs = {}
    for name, module in (("jax", j_splits), ("port", t_splits)):
        dirs[name] = tmp_path / name
        shutil.copytree(inputs, dirs[name])
        dirs[name] = (dirs[name], run(module, dirs[name]),
                      capsys.readouterr().out)
    (j_dir, j_out, j_log), (t_dir, t_out, t_log) = dirs["jax"], dirs["port"]
    assert t_out == j_out
    assert t_log.replace(str(t_dir), "") == j_log.replace(str(j_dir), "")
    names = sorted(os.listdir(j_dir))
    assert sorted(os.listdir(t_dir)) == names
    written = [n for n in names if not (inputs / n).exists()]
    assert written or scenario == "safely_removed_edges_none_when_orphaning"
    match, mismatch, errors = filecmp.cmpfiles(j_dir, t_dir, names, shallow=False)
    assert (mismatch, errors) == ([], []), (mismatch, errors)
