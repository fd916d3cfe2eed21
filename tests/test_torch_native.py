"""The port's native C++ packer (blp_tpu_torch/native) against the JAX
package's native packer and against both packages' pure-Python paths:
`pack_triples` with 4-column and `-1` rows, `wordpiece_encode_file` and the
dataset loads with non-ASCII rows, and two processes building the library
at once. Skips only where there is no g++; a failed build fails."""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from blp_tpu import native as j_native
from blp_tpu.data import datasets as j_datasets
from blp_tpu.data.synth import write_synth_dataset
from blp_tpu.data.tokenizers import WordPieceTokenizer as JWordPieceTokenizer
from blp_tpu_torch import native as t_native
from blp_tpu_torch.data import datasets as t_datasets
from blp_tpu_torch.data.tokenizers import WordPieceTokenizer as TWordPieceTokenizer


@pytest.fixture(scope="module")
def gxx(tmp_path_factory):
    """Both packages' native libraries, built. The JAX package's is built
    into a directory of this module's own (unless this process has loaded
    it already): its loader builds straight to its output path without a
    lock between processes, and tests/test_native.py may be building
    native/build/ in another worker at the same time."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native packer cannot be built here")
    assert t_native.available(), f"the native build failed:\n{t_native.build_error}"
    with pytest.MonkeyPatch.context() as mp:
        if j_native._lib is None:
            lib_dir = tmp_path_factory.mktemp("jax_native")
            mp.setattr(j_native, "_LIB_DIR", str(lib_dir))
            mp.setattr(j_native, "_LIB", str(lib_dir / "libblp_packer.so"))
            mp.setattr(j_native, "_tried", False)
        assert j_native.available(), "the JAX package's native build failed"
    return shutil.which("g++")


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """A synthetic graph whose train split gains 4-column rows (one `-1`,
    one `1`) and whose descriptions gain non-ASCII rows."""
    d = write_synth_dataset(str(tmp_path_factory.mktemp("native") / "synth"),
                            num_entities=60, num_relations=4, num_triples=240,
                            seed=5)
    with open(f"{d}/train.tsv") as f:
        h, r, t = f.readline().split()
    with open(f"{d}/train.tsv", "a") as f:
        f.write(f"{h}\t{r}\t{t}\t-1\n{t}\t{r}\t{h}\t1\n\n")
    with open(f"{d}/entity2text.txt", encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i in (2, 17, 41):   # accents, a CJK character, a curly quote
        name, text = lines[i].split("\t", 1)
        lines[i] = f"{name}\t{text} café 東 “quoted”"
    with open(f"{d}/entity2text.txt", "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return d


def _python_only(monkeypatch):
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(t_native, "available", lambda: False)


@pytest.mark.parametrize("split", ["train.tsv", "ind-train.tsv", "test.tsv"])
def test_pack_triples_equals_jax(gxx, dataset_dir, split, monkeypatch):
    args = [f"{dataset_dir}/{split}", f"{dataset_dir}/entities.txt",
            f"{dataset_dir}/relations.txt"]
    before = t_native.calls
    got = t_native.pack_triples(*args)
    assert t_native.calls == before + 1
    assert got.dtype == np.int32 and got.shape[1] == 3
    np.testing.assert_array_equal(got, j_native.pack_triples(*args))
    ent_ids, rel_ids = t_datasets.load_maps(dataset_dir, write=True)
    # Both packages' Python parses give the same array.
    _python_only(monkeypatch)
    for parse in (t_datasets.GraphData._parse_triples,
                  j_datasets.GraphData._parse_triples):
        np.testing.assert_array_equal(
            got, parse(args[0], dataset_dir, ent_ids, rel_ids))
    if split == "train.tsv":   # the -1 row is skipped, the 1 row kept
        assert len(got) == sum(1 for ln in open(args[0]) if ln.strip()) - 1


def test_wordpiece_encode_file_equals_jax(gxx, dataset_dir):
    tok = TWordPieceTokenizer(f"{dataset_dir}/vocab.txt")
    n = len(open(f"{dataset_dir}/entities.txt").read().splitlines())
    args = (f"{dataset_dir}/entity2text.txt", f"{dataset_dir}/entities.txt",
            tok.vocab_file)
    got = np.zeros((n, 17), np.int32)
    want = np.zeros((n, 17), np.int32)
    mask = t_native.wordpiece_encode_file(*args, max_len=16, do_lower=False,
                                          text_data=got)
    j_mask = j_native.wordpiece_encode_file(*args, max_len=16, do_lower=False,
                                            text_data=want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mask, j_mask)
    assert mask.sum() == 3 and (got[mask] == 0).all()
    with pytest.raises(ValueError, match="C-contiguous int32"):
        t_native.wordpiece_encode_file(*args, max_len=16, do_lower=False,
                                       text_data=got.astype(np.int64))


@pytest.mark.parametrize("native_on", [True, False])
def test_text_graph_data_equals_jax(gxx, dataset_dir, tmp_path, native_on,
                                    monkeypatch):
    """The port's loads, native and Python, equal the JAX package's Python
    load: the Python pass fills the non-ASCII rows the native pass left."""
    d = str(tmp_path / "copy")   # a directory of its own: the load caches
    shutil.copytree(dataset_dir, d)
    monkeypatch.setattr(j_native, "available", lambda: False)
    want = j_datasets.TextGraphData.load(
        f"{d}/ind-train.tsv", tokenizer=JWordPieceTokenizer(f"{d}/vocab.txt"),
        max_len=16, write_maps=True)
    for cache in os.listdir(d):
        if cache.startswith("text_"):
            os.remove(os.path.join(d, cache))
    if not native_on:
        monkeypatch.setattr(t_native, "available", lambda: False)
    before = t_native.calls
    got = t_datasets.TextGraphData.load(
        f"{d}/ind-train.tsv", tokenizer=TWordPieceTokenizer(f"{d}/vocab.txt"),
        max_len=16)
    # Two native calls (the triples and the descriptions) or none.
    assert t_native.calls - before == (2 if native_on else 0)
    np.testing.assert_array_equal(got.text_data, want.text_data)
    np.testing.assert_array_equal(got.triples, want.triples)


_BUILD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
ok = m.available()
out = m.pack_triples(sys.argv[2], sys.argv[3], sys.argv[4]) if ok else None
print(ok, m.library_path().name, None if out is None else out.shape[0],
      m.build_error)
"""


def test_two_processes_building_at_once_share_one_library(gxx, dataset_dir,
                                                          tmp_path):
    pkg = tmp_path / "root" / "blp_tpu_torch" / "native"
    pkg.mkdir(parents=True)
    src = os.path.dirname(t_native.__file__)
    for name in ("__init__.py", "packer.cpp"):
        shutil.copy(os.path.join(src, name), pkg / name)
    args = [sys.executable, "-c", _BUILD, str(pkg / "__init__.py"),
            f"{dataset_dir}/test.tsv", f"{dataset_dir}/entities.txt",
            f"{dataset_dir}/relations.txt"]
    procs = [subprocess.Popen(args, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lines = {o.strip() for o, _ in outs}
    n = len(j_native.pack_triples(f"{dataset_dir}/test.tsv",
                                  f"{dataset_dir}/entities.txt",
                                  f"{dataset_dir}/relations.txt"))
    assert lines == {f"True {t_native.library_path().name} {n} None"}, outs
    built = sorted(os.listdir(tmp_path / "root" / "build" / "native"))
    assert built == [t_native.library_path().name, "packer.lock"]


def test_module_loads_by_file_path_without_building(gxx):
    """Importing the module builds nothing: the build runs at first use."""
    spec = importlib.util.spec_from_file_location("native_probe", t_native.__file__)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    assert m._lib is None and not m._tried
